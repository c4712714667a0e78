"""Host-side tamper masks (port of vwfd_tpu/data/masks.py).

``free_form_stroke_mask`` re-creates the free-form brush generator
(models/IRNcrop_model.py:932-978): random polylines with thick round caps,
added until the mask covers a target fraction. The JAX package draws the
strokes with ``cv2.line`` / ``cv2.circle``; the port has no OpenCV, so it
rasterises the same strokes in numpy — each segment as the pixels within
brush/2 of it (a thick segment with round caps), each vertex disc as the
pixels within brush//2 of it. It makes the same draws from the same
``rng`` in the same order and stops at the same coverage rule, but its
pixels are not cv2's bit for bit (edges of the strokes differ).
``random_rect_mask`` is an exact copy.
"""

import numpy as np

__all__ = ["free_form_stroke_mask", "random_rect_mask"]


def _fill_within(mask, pa, pb, radius):
    """Set to 1 every pixel whose centre lies within ``radius`` of the
    segment from pa to pb ((x, y) = (column, row), cv2's convention)."""
    h, w = mask.shape
    (ax, ay), (bx, by) = pa, pb
    r0 = max(int(np.floor(min(ay, by) - radius)), 0)
    r1 = min(int(np.ceil(max(ay, by) + radius)) + 1, h)
    c0 = max(int(np.floor(min(ax, bx) - radius)), 0)
    c1 = min(int(np.ceil(max(ax, bx) + radius)) + 1, w)
    if r0 >= r1 or c0 >= c1:
        return
    rr, cc = np.mgrid[r0:r1, c0:c1].astype(np.float64)
    dx, dy = float(bx - ax), float(by - ay)
    l2 = dx * dx + dy * dy
    t = 0.0 if l2 == 0 else np.clip(((cc - ax) * dx + (rr - ay) * dy) / l2,
                                    0.0, 1.0)
    d2 = (cc - (ax + t * dx)) ** 2 + (rr - (ay + t * dy)) ** 2
    mask[r0:r1, c0:c1][d2 <= radius * radius] = 1.0


def free_form_stroke_mask(rng: np.random.Generator, size, max_vertex=4,
                          percent_range=(0.2, 0.3)):
    h, w = size
    max_length = int(h / 5)
    max_brush = int(h / 5)
    mask = np.zeros((h, w), dtype=np.float32)
    lo, hi = percent_range
    target = lo + (hi - lo) * rng.random()
    while True:
        mask = np.minimum(mask + _one_stroke(rng, h, w, max_vertex, max_length,
                                             max_brush), 1.0)
        if mask.mean() >= target:
            break
    return mask


def _one_stroke(rng, h, w, max_vertex, max_length, max_brush):
    mask = np.zeros((h, w), dtype=np.float32)
    num_vertex = int(rng.integers(1, max_vertex + 1))
    y = int(rng.integers(h))
    x = int(rng.integers(w))
    brush = 8
    # the reference draws in [8, max]; the floor is clamped so that images
    # smaller than 40 px (max = size/5 < 8) still work
    lo_len = min(8, max(1, max_length))
    lo_brush = min(8, max(2, max_brush))
    for i in range(num_vertex):
        angle = rng.integers(0, 361) / 360.0 * 2 * np.pi
        if i % 2 == 0:
            angle = 2 * np.pi - angle
        length = int(rng.integers(lo_len, max_length + 1))
        brush = max(2, int(rng.integers(lo_brush, max_brush + 1)) // 2 * 2)
        ny = int(np.clip(y + length * np.cos(angle), 0, h - 1))
        nx = int(np.clip(x + length * np.sin(angle), 0, w - 1))
        # cv2.line(mask, (y, x), (ny, nx), 1.0, brush) and
        # cv2.circle(mask, (y, x), brush // 2, 1.0, -1) in the JAX package
        _fill_within(mask, (y, x), (ny, nx), brush / 2)
        _fill_within(mask, (y, x), (y, x), brush // 2)
        y, x = ny, nx
    _fill_within(mask, (y, x), (y, x), brush // 2)
    return mask


def random_rect_mask(rng: np.random.Generator, size, min_rate=0.1,
                     max_rate=0.4):
    """Axis-aligned rectangular tamper mask (splice-style)."""
    h, w = size
    hr = min_rate + (max_rate - min_rate) * rng.random()
    wr = min_rate + (max_rate - min_rate) * rng.random()
    ch, cw = max(1, int(hr * h)), max(1, int(wr * w))
    y0 = int(rng.integers(0, h - ch + 1))
    x0 = int(rng.integers(0, w - cw + 1))
    mask = np.zeros((h, w), dtype=np.float32)
    mask[y0:y0 + ch, x0:x0 + cw] = 1.0
    return mask
