"""The DCT-domain transforms (port of vwfd_tpu/data/cvtransforms.py): the
host-side numpy pipeline of the "learning in the frequency domain" loaders
(datasets/dataloader_imagenet_dct.py:24-37 and their val variants):
Compose, Lambda, UpsampleCbCr, SubsetDCT/SubsetDCT2, Aggregate/Aggregate2,
RandomResizedCropDCT, CenterCropDCT, Resize, RandomHorizontalFlip /
RandomVerticalFlip, ToTensorDCT/ToTensorDCT2, NormalizeDCT and
``subset_indices``.

A DCT item is a tuple (y, cb, cr) of (H/8, W/8, 64) float arrays
(``jpeg_data.DCTDomainDataset``; chroma at half the grid before
UpsampleCbCr).

Two pinned divergences from the JAX module:

* **No cv2.** The JAX module resizes planes with ``cv2.resize`` (INTER_LINEAR
  or INTER_CUBIC). The port computes the same resampling itself in numpy
  float32 (``resize_plane``): OpenCV's source positions
  ``(d + 0.5)·scale − 0.5`` rounded to float32, its tap clamps (a linear
  column tap outside the image takes the edge pixel with weight 1, rows
  clamp their indices), its cubic weights (a = −0.75, the fourth ``1 −`` the
  other three), the horizontal pass, then the vertical one, each a sum in
  tap order; an exact 2× linear downscale is OpenCV's 2×2 area mean. OpenCV's
  vector code may contract products into FMAs, so the two agree to float32
  rounding, not bit for bit (``tests/test_torch_dct_data.py``).
* **An explicit ``random.Random``.** The JAX module draws from Python's
  global ``random``; each random transform here takes its ``rng`` (a
  ``random.Random``), so that a caller seeds it. Seeded alike, the draws are
  the same sequence.
"""

import math
import random
from typing import Sequence

import numpy as np

__all__ = ["subset_indices", "resize_plane", "Compose", "Lambda",
           "UpsampleCbCr", "SubsetDCT2", "SubsetDCT", "Aggregate2",
           "Aggregate", "RandomResizedCropDCT", "CenterCropDCT", "Resize",
           "RandomHorizontalFlip", "RandomVerticalFlip", "ToTensorDCT2",
           "ToTensorDCT", "NormalizeDCT"]


def _zigzag_order(n: int = 8):
    order = sorted(((x, y) for x in range(n) for y in range(n)),
                   key=lambda p: (p[0] + p[1],
                                  -p[1] if (p[0] + p[1]) % 2 else p[1]))
    return [x * n + y for x, y in order]


def subset_indices(channels: int, pattern: str = "square"):
    """Per-plane channel indices for a budget of ``channels`` (Y : Cb : Cr
    split 2 : 1 : 1): ``"square"`` the k×k low-frequency corner, otherwise
    (``"triangle"``, ``"learned"``) the zig-zag prefix."""
    cy = (channels + 1) // 2
    cc = (channels - cy) // 2
    cy = channels - 2 * cc

    def pick(k):
        if pattern == "square":
            side = max(1, int(math.ceil(math.sqrt(k))))
            grid = [i * 8 + j for i in range(side) for j in range(side)]
            return sorted(grid[:k])
        return sorted(_zigzag_order()[:k])

    return pick(cy), pick(cc), pick(cc)


def _positions(n_in: int, n_out: int):
    """OpenCV's source position of each output index: ``(float)((d + 0.5)
    · scale − 0.5)`` in double, ``scale = 1 / (n_out / n_in)``; its floor
    and the float32 fraction."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _cubic_weights(f: np.ndarray):
    """OpenCV's ``interpolateCubic`` in float32 (a = −0.75)."""
    a = np.float32(-0.75)
    one = np.float32(1.0)
    x1 = f + one
    w0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 \
        - np.float32(4) * a
    w1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    g = one - f
    w2 = ((a + np.float32(2)) * g - (a + np.float32(3))) * g * g + one
    w3 = one - w0 - w1 - w2
    return [w.astype(np.float32) for w in (w0, w1, w2, w3)]


def _bcast(w: np.ndarray, ndim: int, axis: int) -> np.ndarray:
    shape = [1] * ndim
    shape[axis] = w.shape[0]
    return w.reshape(shape)


def _linear_cols(a: np.ndarray, n_out: int) -> np.ndarray:
    w_in = a.shape[1]
    s, f = _positions(w_in, n_out)
    f = np.where(s < 0, np.float32(0), f)
    s = np.maximum(s, 0)
    edge = s >= w_in - 1
    f = np.where(edge, np.float32(0), f).astype(np.float32)
    s = np.where(edge, w_in - 1, s)
    a0 = _bcast(np.float32(1) - f, a.ndim, 1)
    a1 = _bcast(f, a.ndim, 1)
    two = a[:, s] * a0 + a[:, np.minimum(s + 1, w_in - 1)] * a1
    return np.where(_bcast(edge, a.ndim, 1), a[:, s], two)


def _linear_rows(a: np.ndarray, n_out: int) -> np.ndarray:
    h_in = a.shape[0]
    s, f = _positions(h_in, n_out)
    r0, r1 = np.clip(s, 0, h_in - 1), np.clip(s + 1, 0, h_in - 1)
    b0 = _bcast(np.float32(1) - f, a.ndim, 0)
    b1 = _bcast(f, a.ndim, 0)
    return a[r0] * b0 + a[r1] * b1


def _cubic_axis(a: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    n_in = a.shape[axis]
    s, f = _positions(n_in, n_out)
    ws = _cubic_weights(f)
    out = None
    for k, w in zip(range(-1, 3), ws):
        i = np.clip(s + k, 0, n_in - 1)
        term = np.take(a, i, axis=axis) * _bcast(w, a.ndim, axis)
        out = term if out is None else out + term
    return out


def _area_2x(a: np.ndarray) -> np.ndarray:
    """OpenCV's fast 2×2 area mean: ``(a + b + c + d)·0.25``."""
    h, w = a.shape[0] // 2, a.shape[1] // 2
    p = a[:2 * h, :2 * w]
    return (((p[0::2, 0::2] + p[0::2, 1::2]) + p[1::2, 0::2])
            + p[1::2, 1::2]) * np.float32(0.25)


def resize_plane(a: np.ndarray, hw: Sequence[int],
                 interpolation: str = "BILINEAR") -> np.ndarray:
    """``cv2.resize(a, (w, h), interpolation=INTER_LINEAR | INTER_CUBIC)``
    of a float32 (H, W) or (H, W, C) array, channels kept (module
    docstring). ``interpolation``: ``"BILINEAR"`` or anything else for
    bicubic, as the JAX module reads it."""
    h, w = int(hw[0]), int(hw[1])
    a = np.asarray(a, np.float32)
    if (h, w) == a.shape[:2]:
        return a.copy()
    if interpolation.upper() == "BILINEAR":
        if 2 * h == a.shape[0] and 2 * w == a.shape[1]:
            return _area_2x(a)
        return _linear_rows(_linear_cols(a, w), h)
    return _cubic_axis(_cubic_axis(a, w, 1), h, 0)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, item):
        for t in self.transforms:
            item = t(item)
        return item


class Lambda:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, item):
        return self.fn(item)


class UpsampleCbCr:
    """The chroma coefficient grids resized to Y's (cvtransforms.py:
    249-262)."""

    def __init__(self, upscale_factor=2, interpolation="BILINEAR"):
        self.interpolation = interpolation

    def __call__(self, item):
        y, cb, cr = item
        hw = y.shape[:2]
        return (y, resize_plane(cb, hw, self.interpolation),
                resize_plane(cr, hw, self.interpolation))


class SubsetDCT2:
    """A frequency-pattern channel subset per plane (cvtransforms.py:
    472-490)."""

    def __init__(self, channels=24, pattern="square"):
        self.sy, self.scb, self.scr = subset_indices(channels, pattern)

    def __call__(self, item):
        y, cb, cr = item
        return y[:, :, self.sy], cb[:, :, self.scb], cr[:, :, self.scr]


SubsetDCT = SubsetDCT2


class Aggregate2:
    """The planes concatenated on the channel axis (cvtransforms.py:
    498-505)."""

    def __call__(self, item):
        return np.concatenate(item, axis=2)


class Aggregate(Aggregate2):
    pass


def _planes(item):
    single = not isinstance(item, (tuple, list))
    return single, ((item,) if single else item)


class RandomResizedCropDCT:
    """Inception-style random resized crop of the coefficient grid
    (cvtransforms.py:992-1100); ``size`` in pixels, the grid crop size/8.
    Draws from ``rng``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 interpolation="BILINEAR", *, rng: random.Random):
        self.size = (size // 8, size // 8)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation
        self.rng = rng

    def _params(self, shape):
        r = self.rng
        for _ in range(10):
            area = shape[0] * shape[1]
            target = r.uniform(*self.scale) * area
            ar = r.uniform(*self.ratio)
            w = int(round(math.sqrt(target * ar)))
            h = int(round(math.sqrt(target / ar)))
            if r.random() < 0.5:
                w, h = h, w
            if 0 < w <= shape[1] and 0 < h <= shape[0]:
                i = r.randint(0, shape[0] - h)
                j = r.randint(0, shape[1] - w)
                return i, j, h, w
        s = min(shape[0], shape[1])
        return (shape[0] - s) // 2, (shape[1] - s) // 2, s, s

    def __call__(self, item):
        single, planes = _planes(item)
        i, j, h, w = self._params(planes[0].shape)
        out = tuple(resize_plane(p[i:i + h, j:j + w], self.size,
                                 self.interpolation) for p in planes)
        return out[0] if single else out


class CenterCropDCT:
    """Centre crop of the coefficient grid (cvtransforms.py:368-399);
    ``size`` in pixels."""

    def __init__(self, size):
        self.size = size // 8

    def __call__(self, item):
        single, planes = _planes(item)
        s = self.size
        h, w = planes[0].shape[:2]
        i, j = max(0, (h - s) // 2), max(0, (w - s) // 2)
        out = tuple(p[i:i + s, j:j + s] for p in planes)
        return out[0] if single else out


class Resize:
    """Every plane resized (cvtransforms.py:684-716); ``size`` is the
    coefficient grid's."""

    def __init__(self, size, interpolation="BILINEAR"):
        self.size = (size, size) if isinstance(size, int) else size
        self.interpolation = interpolation

    def __call__(self, item):
        single, planes = _planes(item)
        out = tuple(resize_plane(p, self.size, self.interpolation)
                    for p in planes)
        return out[0] if single else out


class RandomHorizontalFlip:
    def __init__(self, p=0.5, *, rng: random.Random):
        self.p = p
        self.rng = rng

    def _flip(self, a):
        return np.ascontiguousarray(a[:, ::-1])

    def __call__(self, item):
        if self.rng.random() >= self.p:
            return item
        if isinstance(item, (tuple, list)):
            return tuple(self._flip(p) for p in item)
        return self._flip(item)


class RandomVerticalFlip(RandomHorizontalFlip):
    def _flip(self, a):
        return np.ascontiguousarray(a[::-1])


class ToTensorDCT2:
    """HWC float grid → CHW float32 (cvtransforms.py:421-438)."""

    def __call__(self, item):
        return np.ascontiguousarray(item.transpose(2, 0, 1)).astype(
            np.float32)


class ToTensorDCT:
    def __call__(self, item):
        t = ToTensorDCT2()
        return tuple(t(p) for p in item)


class NormalizeDCT:
    """Per-channel standardisation, the mean/std vectors indexed by the
    aggregated Y + 64·Cb + 128·Cr layout when a subset is configured
    (cvtransforms.py:507-557)."""

    def __init__(self, mean, std, cb_mean=None, cb_std=None, cr_mean=None,
                 cr_std=None, channels=None, pattern="square"):
        mean, std = np.asarray(mean, np.float32), np.asarray(std, np.float32)
        if channels is not None and channels < 192 and mean.size >= 192:
            sy, scb, scr = subset_indices(channels, pattern)
            idx = list(sy) + [64 + c for c in scb] + [128 + c for c in scr]
            mean, std = mean[idx], std[idx]
        self.mean, self.std = mean, std
        self.cb = (None if cb_mean is None else
                   (np.asarray(cb_mean, np.float32),
                    np.asarray(cb_std, np.float32)))
        self.cr = (None if cr_mean is None else
                   (np.asarray(cr_mean, np.float32),
                    np.asarray(cr_std, np.float32)))

    @staticmethod
    def _norm(t, mean, std):
        return (t - mean[:, None, None]) / std[:, None, None]

    def __call__(self, item):
        if isinstance(item, (tuple, list)):
            y, cb, cr = item
            return (self._norm(y, self.mean, self.std),
                    self._norm(cb, *self.cb), self._norm(cr, *self.cr))
        return self._norm(item, self.mean, self.std)
