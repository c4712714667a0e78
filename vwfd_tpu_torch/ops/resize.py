"""Separable resampling matrices (port of vwfd_tpu/ops/resize.py:23-72).

Numpy only: a dense (out, in) bicubic (a = −0.75) matrix, half-pixel centres
and edge clamp as ``F.interpolate(align_corners=False)``. The JAX package's
bilinear and Lanczos kernels and its antialias option serve attacks the
port has not taken over, and are not ported.
"""

import functools

import numpy as np

__all__ = ["resize_matrix"]


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1.0, (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
        np.where(t < 2.0,
                 a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) float32 bicubic resampling matrix."""
    support = 2.0
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    idx = np.arange(in_size)
    w = _cubic_kernel(src[:, None] - idx[None, :])
    if (src - support).min() < 0 or (src + support).max() > in_size - 1:
        # fold the out-of-range taps onto the clamped edge pixels
        reach = int(np.ceil(support)) + 1
        idx_ext = np.arange(-reach, in_size + reach)
        w_ext = _cubic_kernel(src[:, None] - idx_ext[None, :])
        w = np.zeros((out_size, in_size))
        np.add.at(w.T, np.clip(idx_ext, 0, in_size - 1), w_ext.T)
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)
