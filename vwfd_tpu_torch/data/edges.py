"""Host canny without OpenCV: the image family's watermark channel.

The JAX package's image data compute ``cv2.Canny(cv2.cvtColor(u8,
COLOR_RGB2GRAY), 100, 200) / 255`` on ``u8 = (img·255).astype(uint8)``
(``train.py:133-135``, ``vwfd_tpu/data/images.py:46-48``,
``tools/run_family_convergence.py:83-85``). The machine with the card has
no OpenCV, so the port computes the same map in numpy and scipy, bit for
bit (``tests/test_torch_image_ops.py`` holds it to ``cv2``):

* ``rgb_to_gray_u8``: OpenCV's fixed-point luma, ``(9798·R + 19235·G +
  3735·B + 16384) >> 15`` (the 15-bit constants of the OpenCV the JAX
  side runs here, 5.0; the 14-bit ``(4899, 9617, 1868)`` of older builds
  differ on about 0.3 % of pixels);
* ``canny_u8``: OpenCV's Canny with aperture 3 and the L1 gradient: Sobel
  dx and dy under a replicated border (int), the magnitude |dx| + |dy|,
  OpenCV's four-direction non-maximum suppression (tan 22.5° and tan 67.5°
  in 15-bit fixed point; horizontal and vertical neighbours compared with
  ``>`` on one side and ``≥`` on the other, the diagonals with ``>`` on
  both; the magnitude 0 outside the image), the pixels above ``low`` that
  pass as candidates, and the 8-connected components of candidates that
  hold a pixel above ``high`` as the edges, 255.
"""

import numpy as np

__all__ = ["rgb_to_gray_u8", "canny_u8", "canny_map"]

_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)


def rgb_to_gray_u8(u8: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)`` of (H, W, 3) uint8."""
    x = u8.astype(np.int32)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2]
             + 16384) >> 15).astype(np.uint8)


def _sobel(g: np.ndarray):
    """3×3 Sobel dx, dy (int32) under a replicated border."""
    p = np.pad(g.astype(np.int32), 1, mode="edge")
    h, w = g.shape

    def s(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    dx = (s(-1, 1) + 2 * s(0, 1) + s(1, 1)) - (s(-1, -1) + 2 * s(0, -1)
                                               + s(1, -1))
    dy = (s(1, -1) + 2 * s(1, 0) + s(1, 1)) - (s(-1, -1) + 2 * s(-1, 0)
                                               + s(-1, 1))
    return dx, dy


def canny_u8(gray: np.ndarray, low: float = 100, high: float = 200
             ) -> np.ndarray:
    """``cv2.Canny(gray, low, high)`` (aperture 3, L1) of (H, W) uint8:
    uint8 0 / 255."""
    from scipy import ndimage

    if low > high:
        low, high = high, low
    lo, hi = int(np.floor(low)), int(np.floor(high))
    dx, dy = _sobel(gray)
    mag = np.abs(dx) + np.abs(dy)
    h, w = gray.shape
    m = np.pad(mag, 1)  # the magnitude is 0 outside the image

    def nb(oy, ox):
        return m[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]

    x = np.abs(dx)
    y = np.abs(dy) << 15
    tg22x = x * _TG22
    tg67x = tg22x + (x << 16)
    horiz = y < tg22x
    vert = ~horiz & (y > tg67x)
    s = np.where((dx ^ dy) < 0, -1, 1)
    keep_h = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    keep_v = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    # diagonal: the row above at column −s, the row below at column +s
    keep_d = np.where(s > 0, (mag > nb(-1, -1)) & (mag > nb(1, 1)),
                      (mag > nb(-1, 1)) & (mag > nb(1, -1)))
    cand = (mag > lo) & np.where(horiz, keep_h,
                                 np.where(vert, keep_v, keep_d))
    strong = cand & (mag > hi)
    labels, n = ndimage.label(cand, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros((h, w), np.uint8)
    hit = np.zeros(n + 1, bool)
    hit[labels[strong]] = True
    hit[0] = False
    return np.where(hit[labels], 255, 0).astype(np.uint8)


def canny_map(img: np.ndarray) -> np.ndarray:
    """The image family's watermark channel of a float (H, W, 3) image in
    [0, 1]: ``canny_u8(rgb_to_gray_u8((img·255).astype(uint8)), 100, 200)
    / 255``, float32 (H, W, 1)."""
    u8 = (np.asarray(img) * 255).astype(np.uint8)
    return (canny_u8(rgb_to_gray_u8(u8)).astype(np.float32)
            / 255.0)[..., None]
