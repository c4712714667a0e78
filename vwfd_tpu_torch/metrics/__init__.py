"""Metrics and losses of the port (counterparts of vwfd_tpu/metrics)."""

from .losses import absolute, bce_with_logits, l1_loss
from .metrics import postprocess_int, psnr, psnr255_int

__all__ = ["absolute", "bce_with_logits", "l1_loss", "postprocess_int", "psnr", "psnr255_int"]
