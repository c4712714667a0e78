"""Spatial filters of the attack pool and the localizer (port of
vwfd_tpu/ops/filters.py:15-185).

NHWC throughout. ``gaussian_blur`` is the depthwise 3×3, σ = 2 blur with
zero padding, summed over the nine shifted views in raster order as the
JAX package does. ``median_blur`` is the 3×3 median through the kernel
set's ``median3`` (K6, ``kernels/median.py``: the Paeth network and its
first-match backward); other odd sizes take the JAX package's sort path
(``:117-131``): the k² reflect-padded views stacked and sorted, the middle
one taken, its gradient to the view it came from (a stable sort, as
``jnp.sort``'s). ``avg_pool_2x2`` is DiffJPEG's chroma subsampling
(``:133-138``).

``SRM_FILTERS``, ``srm_conv`` and ``bayar_constrain`` are the localizer's
forensic front end (``:139-185``). ``srm_conv`` is one fixed ``F.conv2d``
whose (9, 3, 5, 5) bank puts each SRM kernel on each colour channel
(output channel ``3·f + c``, the JAX concatenation's order); JAX sums its
25 shifted views in raster order, so the two agree to float32 rounding.
``bayar_constrain`` is applied functionally on every call: the centre tap
zeroed, the taps divided by their sum (the gradient flows through the
division), the centre set to −1 (no gradient there).
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel_2d", "gaussian_blur", "median_blur",
           "avg_pool_2x2", "SRM_FILTERS", "srm_conv", "bayar_constrain"]


@functools.lru_cache(maxsize=None)
def gaussian_kernel_2d(kernel_size: int = 3, sigma: float = 2.0) -> np.ndarray:
    """Normalised 2-D gaussian (noise_layers/gaussian_blur.py:17-41)."""
    ax = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax, indexing="ij")
    k = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma ** 2)) \
        / (2.0 * math.pi * sigma ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, kernel_size: int = 3,
                  sigma: float = 2.0) -> torch.Tensor:
    """Depthwise gaussian blur of (..., H, W, C), zero padding."""
    k = gaussian_kernel_2d(kernel_size, sigma)
    pad = kernel_size // 2
    h, w = x.shape[-3], x.shape[-2]
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    out = torch.zeros_like(x)
    for dy in range(kernel_size):
        for dx in range(kernel_size):
            out = out + float(k[dy, dx]) * xp[..., dy:dy + h, dx:dx + w, :]
    return out


def _reflect_views(x: torch.Tensor, k: int):
    """The k² shifted views of (..., H, W, C) under reflect padding, in
    raster order of the offsets."""
    p = k // 2
    h, w = x.shape[-3], x.shape[-2]
    xp = torch.cat([x[..., 1:p + 1, :, :].flip(-3), x,
                    x[..., -p - 1:-1, :, :].flip(-3)], -3)
    xp = torch.cat([xp[..., 1:p + 1, :].flip(-2), xp,
                    xp[..., -p - 1:-1, :].flip(-2)], -2)
    return [xp[..., dy:dy + h, dx:dx + w, :]
            for dy in range(k) for dx in range(k)]


def median_blur(x: torch.Tensor, kernel_size: int = 3, kernels=None
                ) -> torch.Tensor:
    """Depthwise k×k median of an NHWC batch under reflect padding
    (kornia MedianBlur, noise_layers/middle_filter.py:5-13): k = 3 through
    ``kernels.median3`` (K6; default ``kernels.KERNELS``), any other odd k
    by a stable sort of the k² views."""
    if kernel_size == 3:
        if kernels is None:
            from ..kernels import KERNELS as kernels
        return kernels.median3(x)
    if kernel_size % 2 == 0 or kernel_size < 1:
        raise ValueError(f"median_blur takes an odd kernel size, got "
                         f"{kernel_size}")
    stack = torch.stack(_reflect_views(x, kernel_size), -1)
    vals = torch.sort(stack, dim=-1, stable=True).values
    return vals[..., (kernel_size * kernel_size) // 2]


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pool, stride 2, of (..., H, W, C): DiffJPEG's chroma
    subsampling (utils/JPEG.py:139-160)."""
    *lead, h, w, c = x.shape
    return x.reshape(*lead, h // 2, 2, w // 2, 2, c).mean(dim=(-4, -2))


# SRM noise-residual bank (the public MantraNet initialisation; the
# reference loads it from MantraNetv4.pt, models/networks.py:909)
_SRM_KV = np.array([
    [-1, 2, -2, 2, -1],
    [2, -6, 8, -6, 2],
    [-2, 8, -12, 8, -2],
    [2, -6, 8, -6, 2],
    [-1, 2, -2, 2, -1],
], dtype=np.float32) / 12.0
_SRM_LAP = np.zeros((5, 5), dtype=np.float32)
_SRM_LAP[1:4, 1:4] = np.array([[-1, 2, -1], [2, -4, 2], [-1, 2, -1]]) / 4.0
_SRM_DOT = np.zeros((5, 5), dtype=np.float32)
_SRM_DOT[2, 1:4] = np.array([1, -2, 1]) / 2.0

SRM_FILTERS = np.stack([_SRM_KV, _SRM_LAP, _SRM_DOT])  # (3, 5, 5)


@functools.lru_cache(maxsize=None)
def _srm_bank() -> np.ndarray:
    """(9, 3, 5, 5) OIHW: output 3·f + c is SRM kernel f on channel c."""
    bank = np.zeros((9, 3, 5, 5), np.float32)
    for f in range(3):
        for c in range(3):
            bank[3 * f + c, c] = SRM_FILTERS[f]
    return bank


def srm_conv(x: torch.Tensor) -> torch.Tensor:
    """Fixed SRM residuals of (N, H, W, 3): 'valid' 5×5, (N, H − 4, W − 4,
    9), each kernel on each channel (``nn.Conv2d(3, 9, 5, padding=0)``,
    models/networks.py:907-909)."""
    w = torch.from_numpy(_srm_bank()).to(x.device, x.dtype)
    return F.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)


def bayar_constrain(w: torch.Tensor) -> torch.Tensor:
    """The Bayar constraint on a (5, 5, Cin, Cout) kernel, functionally
    (the reference rewrites ``weight.data`` every forward,
    networks.py:1058-1061)."""
    centre = torch.zeros((5, 5) + (1,) * (w.dim() - 2), dtype=torch.bool,
                         device=w.device)
    centre[2, 2] = True
    w = torch.where(centre, torch.zeros((), dtype=w.dtype, device=w.device),
                    w)
    w = w / torch.sum(w, dim=(0, 1), keepdim=True)
    return torch.where(centre, torch.full((), -1.0, dtype=w.dtype,
                                          device=w.device), w)
