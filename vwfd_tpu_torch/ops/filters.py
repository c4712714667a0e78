"""Spatial filters of the attack pool (port of vwfd_tpu/ops/filters.py:15-130).

NHWC throughout. ``gaussian_blur`` is the depthwise 3×3, σ = 2 blur with
zero padding, summed over the nine shifted views in raster order as the
JAX package does. ``median_blur`` is the 3×3 median through the kernel
set's ``median3`` (K6, ``kernels/median.py``: the Paeth network and its
first-match backward); the JAX package's sort path for other sizes is not
ported (no attack of the port uses it).
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel_2d", "gaussian_blur", "median_blur"]


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


def median_blur(x: torch.Tensor, kernel_size: int = 3, kernels=None
                ) -> torch.Tensor:
    """3×3 depthwise median of an NHWC batch under reflect padding (kornia
    MedianBlur, noise_layers/middle_filter.py:5-13) through
    ``kernels.median3`` (default ``kernels.KERNELS``)."""
    if kernel_size != 3:
        raise NotImplementedError(f"median_blur(kernel_size={kernel_size}) "
                                  f"is not ported; the port runs k = 3")
    if kernels is None:
        from ..kernels import KERNELS as kernels
    return kernels.median3(x)
