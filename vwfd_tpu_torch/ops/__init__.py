"""Tensor ops of the port (counterparts of vwfd_tpu/ops)."""

from .quantize import clamp_with_grad, ste_quantize_255
from .squeeze import depth_to_space, space_to_depth

__all__ = ["clamp_with_grad", "ste_quantize_255", "depth_to_space",
           "space_to_depth"]
