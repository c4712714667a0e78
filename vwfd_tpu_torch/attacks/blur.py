"""Blur attacks (port of vwfd_tpu/attacks/blur.py)."""

from ..ops.filters import gaussian_blur, median_blur

__all__ = ["gaussian_blur_attack", "median_blur_attack", "gf_attack"]


def gaussian_blur_attack(img, kernel_size: int = 3, sigma: float = 2.0):
    """3×3 σ = 2 depthwise gaussian (noise_layers/gaussian_blur.py)."""
    return gaussian_blur(img, kernel_size, sigma)


def median_blur_attack(img, kernel_size: int = 3, kernels=None):
    """k = 3 median filter (noise_layers/middle_filter.py, kornia
    MedianBlur), through K6 for k = 3."""
    return median_blur(img, kernel_size, kernels)


def gf_attack(img, sigma: float = 1.0, kernel_size: int = 7):
    """Kornia-style GaussianBlur2d((7, 7), (σ, σ)): the reference's ``GF``
    (noise_layers/gaussian_filter.py:5-13), zero padding."""
    return gaussian_blur(img, kernel_size, sigma)
