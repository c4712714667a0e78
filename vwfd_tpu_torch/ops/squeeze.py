"""Space↔depth squeezes (port of vwfd_tpu/ops/squeeze.py:45-66).

Channel order matches the JAX package exactly: space-to-depth output channel
`(p·s + q)·C + c` holds input channel `c` at sub-pixel (row p, col q);
depth-to-space is its exact inverse. `F.pixel_unshuffle` uses the order
`c·s² + p·s + q` and would silently permute converted weights, so these are
written as reshape/permute. Layout NHWC, any number of leading dims.
"""

import torch

__all__ = ["space_to_depth", "depth_to_space"]


def space_to_depth(x: torch.Tensor, s: int = 2) -> torch.Tensor:
    """(..., H, W, C) → (..., H/s, W/s, s²C)."""
    *lead, h, w, c = x.shape
    x = x.reshape(-1, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(*lead, h // s, w // s, s * s * c)


def depth_to_space(x: torch.Tensor, s: int = 2) -> torch.Tensor:
    """(..., H, W, s²C) → (..., sH, sW, C): exact inverse of
    `space_to_depth`."""
    *lead, h, w, cf = x.shape
    c = cf // (s * s)
    x = x.reshape(-1, h, w, s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(*lead, h * s, w * s, c)
