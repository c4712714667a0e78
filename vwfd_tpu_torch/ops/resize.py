"""Separable resampling (port of vwfd_tpu/ops/resize.py:23-90).

Dense (out, in) resampling matrices in numpy, half-pixel centres and edge
clamp as ``F.interpolate(align_corners=False)``: bicubic (a = −0.75) and
bilinear. ``resize_bilinear`` applies the bilinear matrices as two float32
products, as the JAX package's two einsums at HIGHEST precision; the int8
server's self-calibration clips use it (``serving.py``). The JAX package's
Lanczos kernel and its antialias option serve attacks the port has not
taken over, and are not ported.

``crop_resize`` (``resize.py:97-152``) resamples a crop window, whose apex
is a tensor (no host sync), back onto the full grid, bilinear, with the
taps clamped to the window: the plain version of K17
(``kernels/crop_resize.py``), which HiDDeN's crop attack calls. The JAX
package's bicubic variant of it serves attacks the port has not taken
over.
"""

import functools
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["resize_matrix", "resize_bilinear", "crop_resize"]


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1.0, (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
        np.where(t < 2.0,
                 a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


def _linear_kernel(t: np.ndarray) -> np.ndarray:
    t = np.abs(t)
    return np.maximum(0.0, 1.0 - t)


_KERNELS = {"bicubic": (_cubic_kernel, 2.0), "bilinear": (_linear_kernel, 1.0)}


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int,
                  method: str = "bicubic") -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix (``method``
    ``"bicubic"`` or ``"bilinear"``)."""
    kernel, support = _KERNELS[method]
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    idx = np.arange(in_size)
    w = kernel(src[:, None] - idx[None, :])
    if (src - support).min() < 0 or (src + support).max() > in_size - 1:
        # fold the out-of-range taps onto the clamped edge pixels
        reach = int(np.ceil(support)) + 1
        idx_ext = np.arange(-reach, in_size + reach)
        w_ext = kernel(src[:, None] - idx_ext[None, :])
        w = np.zeros((out_size, in_size))
        np.add.at(w.T, np.clip(idx_ext, 0, in_size - 1), w_ext.T)
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., out_h, out_w, C), float32
    (float64 stays float64, for the CPU parity tests): the rows' matrix,
    then the columns'."""
    h, w = x.shape[-3], x.shape[-2]
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    mh = torch.from_numpy(resize_matrix(h, out_hw[0], "bilinear")).to(
        x.device, dt)
    mw = torch.from_numpy(resize_matrix(w, out_hw[1], "bilinear")).to(
        x.device, dt)
    x = torch.einsum("oh,...hwc->...owc", mh, x.to(dt))
    return torch.einsum("pw,...owc->...opc", mw, x)


def _sample_axis(x: torch.Tensor, coords: torch.Tensor, axis: int,
                 bounds) -> torch.Tensor:
    """Bilinear resample of ``x`` along ``axis`` at the float32 positions
    ``coords`` (out,), the two taps of each clamped into ``bounds = (lo,
    hi)`` (0-dim float tensors, truncated to integers as the JAX package's
    ``astype(int32)``). Each output is ``x[i0]·(1 − t) + x[i1]·t``."""
    base = torch.floor(coords)
    t = coords - base
    lo, hi = (b.to(torch.int64) for b in bounds)
    b = base.to(torch.int64)
    i0 = torch.minimum(torch.maximum(b, lo), hi)
    i1 = torch.minimum(torch.maximum(b + 1, lo), hi)
    shape = [1] * x.dim()
    shape[axis] = coords.shape[0]
    return (torch.index_select(x, axis, i0) * (1.0 - t).view(shape)
            + torch.index_select(x, axis, i1) * t.view(shape))


def crop_resize(x: torch.Tensor, apex: torch.Tensor,
                out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Crop the window ``apex = (h0, h1, w0, w1)`` (a (4,) float32 tensor
    of pixel bounds, half-open, shared by the batch) of (..., H, W, C) and
    resample it bilinearly to ``out_hw`` (default the input's size):
    half-pixel centres, rows first, then columns."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw if out_hw is not None else (h, w)
    h0, h1, w0, w1 = apex.to(torch.float32).unbind()
    f32 = dict(dtype=torch.float32, device=x.device)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal (F14), and K17 divides
    ys = h0 + (torch.arange(oh, **f32) + 0.5) * (h1 - h0) \
        / torch.full((), oh, **f32) - 0.5
    xs = w0 + (torch.arange(ow, **f32) + 0.5) * (w1 - w0) \
        / torch.full((), ow, **f32) - 0.5
    x = _sample_axis(x, ys, x.dim() - 3, (h0, h1 - 1))
    return _sample_axis(x, xs, x.dim() - 2, (w0, w1 - 1))
