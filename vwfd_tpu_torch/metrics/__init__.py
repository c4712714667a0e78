"""Metrics and losses of the port (counterparts of vwfd_tpu/metrics)."""

from .losses import absolute, bce_with_logits, l1_loss
from .metrics import (DEFAULT_THRESHOLDS, edge_accuracy, f1_from_confusion,
                      f1_sweep, mask_confusion, mask_scores, postprocess_int,
                      psnr, psnr255_int, ssim, threshold_level)

__all__ = ["absolute", "bce_with_logits", "l1_loss", "postprocess_int", "psnr",
           "psnr255_int", "ssim", "edge_accuracy", "threshold_level",
           "mask_confusion", "f1_from_confusion", "mask_scores", "f1_sweep",
           "DEFAULT_THRESHOLDS"]
