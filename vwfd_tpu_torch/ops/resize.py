"""Separable resampling (port of vwfd_tpu/ops/resize.py:23-152).

Dense (out, in) resampling matrices in numpy, half-pixel centres and edge
clamp as ``F.interpolate(align_corners=False)``: bicubic (a = −0.75),
bilinear and Lanczos-3 (``resize.py:36-42``); ``antialias=True`` widens the
kernel by the downscale factor (``:50-51``, like PIL's and torch's
antialias). ``resize_bilinear`` applies the bilinear matrices as two float32
products, as the JAX package's two einsums at HIGHEST precision; the int8
server's self-calibration clips use it (``serving.py``). ``resize`` takes
any of the three methods.

``crop_resize`` (``resize.py:97-152``) resamples a crop window, whose apex
is a tensor (no host sync), back onto the full grid with the taps clamped
to the window: bilinear, the plain version of K17
(``kernels/crop_resize.py``), which HiDDeN's crop attack calls; bicubic
(four taps, a = −0.75), the plain version of K20
(``kernels/crop_cubic.py``), which CLR's crop tamper calls.
``_sample_axis`` with ``bounds=None`` clamps the taps to the image (CLR's
paste back, ``attacks/spatial.py::paste_resize``). ``resize_bicubic`` is
the two bicubic products (the apex regressor's mask head).
"""

import functools
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["resize_matrix", "resize", "resize_bilinear", "resize_bicubic",
           "crop_resize", "cubic_weights"]


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


def _lanczos_kernel(t: np.ndarray, a: int = 3) -> np.ndarray:
    """Lanczos-3 (utils/imresize.py's lanczos path)."""
    t = np.abs(t)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.sinc(t) * np.sinc(t / a)
    return np.where(t < a, k, 0.0)


_KERNELS = {"bicubic": (_cubic_kernel, 2.0), "bilinear": (_linear_kernel, 1.0),
            "lanczos": (_lanczos_kernel, 3.0)}


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, method: str = "bicubic",
                  antialias: bool = False) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix (``method``
    ``"bicubic"``, ``"bilinear"`` or ``"lanczos"``); ``antialias`` widens
    the kernel by the downscale factor."""
    kernel, support = _KERNELS[method]
    scale = in_size / out_size
    width = max(scale, 1.0) if antialias else 1.0
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    idx = np.arange(in_size)
    w = kernel((src[:, None] - idx[None, :]) / width)
    if (src - support * width).min() < 0 or \
            (src + support * width).max() > in_size - 1:
        # fold the out-of-range taps onto the clamped edge pixels
        reach = int(np.ceil(support * width)) + 1
        idx_ext = np.arange(-reach, in_size + reach)
        w_ext = kernel((src[:, None] - idx_ext[None, :]) / width)
        w = np.zeros((out_size, in_size))
        np.add.at(w.T, np.clip(idx_ext, 0, in_size - 1), w_ext.T)
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str,
           antialias: bool = False) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., out_h, out_w, C) with ``method``'s
    matrices: the rows' product, then the columns', float32 (float64
    stays float64, for the CPU parity tests)."""
    h, w = x.shape[-3], x.shape[-2]
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    mh = torch.from_numpy(resize_matrix(h, out_hw[0], method, antialias)).to(
        x.device, dt)
    mw = torch.from_numpy(resize_matrix(w, out_hw[1], method, antialias)).to(
        x.device, dt)
    x = torch.einsum("oh,...hwc->...owc", mh, x.to(dt))
    return torch.einsum("pw,...owc->...opc", mw, x)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) (``resize``)."""
    return resize(x, out_hw, "bilinear", antialias)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int],
                   antialias: bool = False) -> torch.Tensor:
    """Bicubic (a = −0.75) resize of (..., H, W, C) (``resize.py:92-94``).
    """
    return resize(x, out_hw, "bicubic", antialias)


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` of float32 tensors rounded once (a fused multiply-add):
    the product is exact in float64 and the sum rounds to float64 and then
    to float32 (the two roundings part from one only about once in 2²⁸)."""
    return (a.double() * b + c.double()).to(a.dtype)


def cubic_weights(t: torch.Tensor, a: float = -0.75):
    """The four bicubic weights of offsets −1, 0, 1, 2 at fractions ``t``
    (``resize.py:121-126``), with the float32 operations XLA:CPU compiles
    the JAX expression to: ``ad³ = (ad·ad)·ad``; inside ``|d| ≤ 1``
    ``fma(ad³, a + 2, −(a + 3)·ad²) + 1``; inside ``|d| < 2``
    ``fma(ad, 8a, fma(ad³, a, −5a·ad²)) − 4a`` (XLA contracts the
    products into FMAs; the outer taps' terms of order 10 cancel to below
    0.1, so the contraction moves a weight by up to 1.4e-6). K20 and K21
    compute the same operations (``csrc/cubic.cuh``)."""
    out = []
    for off in (-1, 0, 1, 2):
        ad = torch.abs(t - float(off))
        c2 = ad * ad
        c3 = c2 * ad
        w1 = _fma(c3, a + 2.0, -((a + 3.0) * c2)) + 1.0
        w2 = _fma(ad, 8 * a, _fma(c3, a, -((5 * a) * c2))) - 4 * a
        out.append(torch.where(ad <= 1.0, w1, torch.where(
            ad < 2.0, w2, torch.zeros_like(ad))))
    return out


def _sample_axis(x: torch.Tensor, coords: torch.Tensor, axis: int,
                 bounds=None, method: str = "bilinear") -> torch.Tensor:
    """Resample ``x`` along ``axis`` at the float32 positions ``coords``
    (out,), each tap clamped into ``bounds = (lo, hi)`` (0-dim float
    tensors, truncated to integers as the JAX package's ``astype(int32)``)
    or, with ``bounds=None``, into the image. Bilinear: ``x[i0]·(1 − t) +
    x[i1]·t``; bicubic: the four taps' products summed in tap order."""
    base = torch.floor(coords)
    t = coords - base
    b = base.to(torch.int64)
    if bounds is None:
        lo, hi = 0, x.shape[axis] - 1
    else:
        lo, hi = (v.to(torch.int64) for v in bounds)
    shape = [1] * x.dim()
    shape[axis] = coords.shape[0]

    def tap(off):
        if bounds is None:
            i = torch.clamp(b + off, lo, hi)
        else:
            i = torch.minimum(torch.maximum(b + off, lo), hi)
        return torch.index_select(x, axis, i)

    if method == "bilinear":
        return tap(0) * (1.0 - t).view(shape) + tap(1) * t.view(shape)
    if method != "bicubic":
        raise ValueError(f"method must be bilinear or bicubic, got {method!r}")
    ws = cubic_weights(t)
    out = tap(-1) * ws[0].view(shape)
    for off, wt in zip((0, 1, 2), ws[1:]):
        out = out + tap(off) * wt.view(shape)
    return out


def crop_resize(x: torch.Tensor, apex: torch.Tensor,
                out_hw: Optional[Tuple[int, int]] = None,
                method: str = "bilinear") -> torch.Tensor:
    """Crop the window ``apex = (h0, h1, w0, w1)`` (a (4,) float32 tensor
    of pixel bounds, half-open, shared by the batch) of (..., H, W, C) and
    resample it (``method`` bilinear or bicubic) to ``out_hw`` (default
    the input's size): half-pixel centres, rows first, then columns."""
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
    x = _sample_axis(x, ys, x.dim() - 3, (h0, h1 - 1), method)
    return _sample_axis(x, xs, x.dim() - 2, (w0, w1 - 1), method)
