"""Metrics and losses of the port (counterparts of vwfd_tpu/metrics)."""

from .losses import (absolute, adversarial_loss, bce_loss, bce_with_logits,
                     gan_loss, l1_loss, l2_loss)
from .metrics import (DEFAULT_THRESHOLDS, bitwise_message_error,
                      edge_accuracy, f1_from_confusion,
                      f1_sweep, mask_confusion, mask_scores, postprocess_int,
                      psnr, psnr255_int, ssim, threshold_level)

__all__ = ["absolute", "bce_loss", "bce_with_logits", "l1_loss", "l2_loss",
           "gan_loss", "adversarial_loss",
           "bitwise_message_error", "postprocess_int", "psnr",
           "psnr255_int", "ssim", "edge_accuracy", "threshold_level",
           "mask_confusion", "f1_from_confusion", "mask_scores", "f1_sweep",
           "DEFAULT_THRESHOLDS"]
