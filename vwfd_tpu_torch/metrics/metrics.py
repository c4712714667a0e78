"""Quality metrics (port of vwfd_tpu/metrics/metrics.py:21-40).

PSNR is taken on images post-processed with ``(x·255).int()`` — truncation
toward zero, not rounding (models/IRNcrop_model.py:660-664) — and is 0, not
∞, when the MSE is 0 (metrics.py:30-46).
"""

import math

import torch

__all__ = ["postprocess_int", "psnr", "psnr255_int"]


def postprocess_int(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float → int-truncated [0, 255], kept as float."""
    return torch.trunc(img01 * 255.0)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0
         ) -> torch.Tensor:
    """PSNR of post-processed images; 0 when the MSE is 0."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    val = 20.0 * math.log10(max_val) - 10.0 * torch.log10(mse)
    return torch.where(mse == 0, torch.zeros_like(val), val)


def psnr255_int(img01_a: torch.Tensor, img01_b: torch.Tensor
                ) -> torch.Tensor:
    """``psnr(postprocess_int(a), postprocess_int(b))``."""
    return psnr(postprocess_int(img01_a), postprocess_int(img01_b))
