"""Differentiable edge map (port of vwfd_tpu/ops/canny.py:20-72).

``canny_soft`` is the image model's mid-step canny of the attacked copies:
gaussian smoothing, Sobel, the magnitude over its per-image max, soft
non-maximum suppression and a soft double threshold, (N, H, W, 3) float32
→ (N, H, W, 1). It runs the kernel set's ``canny_soft`` (K19,
``kernels/canny.py``, whose plain version is the JAX form in torch);
``sobel_edges`` is the Sobel step alone.
"""

import torch

from ..kernels.canny import sobel_edges

__all__ = ["canny_soft", "sobel_edges"]


def canny_soft(img: torch.Tensor, kernels=None) -> torch.Tensor:
    """Soft canny edge map of (N, H, W, 3) float32 images in [0, 1]
    through ``kernels.canny_soft`` (default ``kernels.KERNELS``)."""
    if kernels is None:
        from ..kernels import KERNELS as kernels
    return kernels.canny_soft(img)
