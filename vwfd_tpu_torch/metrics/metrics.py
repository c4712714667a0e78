"""Quality and localization metrics (port of vwfd_tpu/metrics/metrics.py).

The reference's subtle parts are kept as written:

* PSNR is taken on images post-processed with ``(x·255).int()`` —
  truncation toward zero, not rounding (models/IRNcrop_model.py:660-664) —
  and is 0, not ∞, when the MSE is 0 (metrics.py:30-46).
* SSIM uses the 11×11, σ = 1.5 gaussian window with zero padding
  (pytorch_ssim/__init__.py:7-63).
* A mask pixel is on at threshold t iff ``trunc(x·255.0) > floor(255·t)``
  (calculate_f1.py:5-50; ``cv2.threshold`` on uint8 at ``int(255·t)``),
  float32 multiplies (F8); NaN is never on. The F1 is ``(2·tp) / (2·tp +
  fp + fn + 1e-12)`` in float32, in that order.

``mask_confusion``, ``f1_sweep`` and ``ssim`` take a kernel set, as the
attack pool does: on CUDA tensors ``kernels.KERNELS`` launches K7
(``f1_sweep``) and K8 (``ssim``); on CPU tensors, or with ``kernels.PLAIN``,
they run the plain versions. The confusion counts are exact int64 (the JAX
package sums them in float32, exact only below 2²⁴ pixels: F12).

Under data parallelism ``f1_sweep`` (``mesh=``, a ``parallel.Mesh``)
sums the counts over the ranks (F30); a model takes the global PSNR as
``psnr_from_mse`` of the ranks' ``mse255_int`` averaged (F28's form) and
the global SSIM as the ranks' means averaged, each rank holding equally
many rows.
"""

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels.ssim import depthwise_same_conv as _depthwise_same_conv
from ..parallel import global_sum
from ..kernels.ssim import window_2d as _ssim_window

__all__ = ["postprocess_int", "psnr", "psnr_from_mse", "mse255_int",
           "psnr255_int", "ssim", "edge_accuracy",
           "threshold_level", "mask_confusion", "f1_from_confusion",
           "mask_scores", "f1_sweep", "DEFAULT_THRESHOLDS",
           "bitwise_message_error",
           "_ssim_window", "_depthwise_same_conv"]

# calculate_f1.py:52-72: 0.1, 0.2, ..., 0.9 (float64, cast to float32 at use)
DEFAULT_THRESHOLDS = tuple(np.arange(0.1, 0.95, 0.1))


def _kernel_set(kernels):
    if kernels is None:
        from ..kernels import KERNELS as kernels
    return kernels


def postprocess_int(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float → int-truncated [0, 255], kept as float."""
    return torch.trunc(img01 * 255.0)


def psnr_from_mse(mse: torch.Tensor, max_val: float = 255.0
                  ) -> torch.Tensor:
    """``20·log10(max_val) − 10·log10(mse)``; 0 when the MSE is 0."""
    val = 20.0 * math.log10(max_val) - 10.0 * torch.log10(mse)
    return torch.where(mse == 0, torch.zeros_like(val), val)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0
         ) -> torch.Tensor:
    """PSNR of post-processed images; 0 when the MSE is 0."""
    return psnr_from_mse(torch.mean((a.float() - b.float()) ** 2), max_val)


def mse255_int(img01_a: torch.Tensor, img01_b: torch.Tensor
               ) -> torch.Tensor:
    """The MSE that ``psnr255_int`` takes: of the int-truncated [0, 255]
    images, in float32."""
    return torch.mean((postprocess_int(img01_a).float()
                       - postprocess_int(img01_b).float()) ** 2)


def psnr255_int(img01_a: torch.Tensor, img01_b: torch.Tensor
                ) -> torch.Tensor:
    """``psnr(postprocess_int(a), postprocess_int(b))``."""
    return psnr_from_mse(mse255_int(img01_a, img01_b))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True, kernels=None) -> torch.Tensor:
    """Windowed SSIM of (N, H, W, C) float32 images in [0, 1]: the mean
    over everything, or with ``size_average=False`` the mean of each image
    (N,). Runs ``kernels.ssim`` (K8; default ``kernels.KERNELS``)."""
    means, mean = _kernel_set(kernels).ssim(img1, img2, window_size)
    return mean if size_average else means


def edge_accuracy(inputs: torch.Tensor, outputs: torch.Tensor,
                  threshold: float = 0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(precision, recall) of thresholded masks (metrics.py:5-27); both 1
    when neither mask has a pixel on."""
    labels = inputs > threshold
    preds = outputs > threshold
    relevant = labels.float().sum()
    selected = preds.float().sum()
    tp = ((preds == labels) & labels).float().sum()
    recall = tp / (relevant + 1e-8)
    precision = tp / (selected + 1e-8)
    both_empty = (relevant == 0) & (selected == 0)
    one = torch.ones_like(precision)
    return (torch.where(both_empty, one, precision),
            torch.where(both_empty, one, recall))


def threshold_level(thresh) -> float:
    """``floor(255·thresh)`` as the reference takes it: a Python number
    multiplies in float64 and is cast to float32 before the floor; a float32
    array (``f1_sweep``'s thresholds) multiplies in float32."""
    if isinstance(thresh, (int, float)):
        return float(np.floor(np.float32(255.0 * thresh)))
    return float(np.floor(np.float32(255.0) * np.float32(thresh)))


def mask_confusion(pred01: torch.Tensor, gt01: torch.Tensor,
                   thresh: float = 0.5, kernels=None):
    """Pixel ``(tn, tp, fn, fp)`` at one threshold (calculate_f1.py:5-19),
    each a 0-dim int64 tensor. Runs ``kernels.f1_sweep`` (K7)."""
    counts = _kernel_set(kernels).f1_sweep(pred01, gt01,
                                           [threshold_level(thresh)])[0]
    tp, fp, fn = counts.unbind()
    return pred01.numel() - tp - fp - fn, tp, fn, fp


def f1_from_confusion(tn, tp, fn, fp) -> torch.Tensor:
    """``(2·tp) / (2·tp + fp + fn + 1e-12)`` in float32 (``tn`` unused)."""
    tp, fn, fp = (torch.as_tensor(v).float() for v in (tp, fn, fp))
    return (2 * tp) / (2 * tp + fp + fn + 1e-12)


def mask_scores(pred01: torch.Tensor, gt01: torch.Tensor,
                thresh: float = 0.5, kernels=None):
    """ACC/FPR/TPR/TNR/FNR/F1/BER in float32 (calculate_f1.py:24-37)."""
    tn, tp, fn, fp = (v.float() for v in mask_confusion(pred01, gt01, thresh,
                                                        kernels))
    eps = 1e-12
    return {
        "ACC": (tp + tn) / (tp + fp + fn + tn + eps),
        "FPR": fp / (fp + tn + eps),
        "TPR": tp / (tp + fn + eps),
        "TNR": tn / (fp + tn + eps),
        "FNR": fn / (tp + fn + eps),
        "F1": f1_from_confusion(tn, tp, fn, fp),
        "BER": 0.5 * (fp / (fp + tn + eps) + fn / (fn + tp + eps)),
    }


def f1_sweep(pred01: torch.Tensor, gt01: torch.Tensor,
             thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
             kernels=None, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The F1 at every threshold (calculate_f1.py:52-72), from one pass of
    ``kernels.f1_sweep`` (K7) over the prediction and the mask; with a
    ``parallel.Mesh``, the counts summed over its ranks (int64) first.
    Returns ``(thresholds, f1s)``, float32 (L,) each, on the inputs'
    device."""
    ts = np.asarray(thresholds, np.float32)
    counts = global_sum(_kernel_set(kernels).f1_sweep(
        pred01, gt01, [threshold_level(t) for t in ts]), mesh)
    tp, fp, fn = counts.unbind(-1)
    return (torch.from_numpy(ts).to(pred01.device),
            f1_from_confusion(None, tp, fn, fp))


def bitwise_message_error(decoded: torch.Tensor, messages: torch.Tensor
                          ) -> torch.Tensor:
    """Mean |round(clip(decoded, 0, 1)) − message|, rounding half to even
    as ``jnp.round`` (metrics.py:143-146; hidden_models/hidden.py:105-107)."""
    d = torch.round(torch.clamp(decoded, 0.0, 1.0))
    return torch.mean(torch.abs(d - messages))
