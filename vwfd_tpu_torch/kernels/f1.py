"""K7 `f1_sweep`: confusion counts of a tamper-mask prediction at every
threshold of the F1 sweep, in one read of the prediction and the mask.

Replaces ``vwfd_tpu/metrics/metrics.py:96-140``: ``mask_confusion`` vmapped
over ``f1_sweep``'s thresholds. A pixel is on at level ``t`` iff
``trunc(x·255.0) > t`` (float32 multiply; NaN is never on), with ``t =
floor(255·thresh)`` taken by the caller (``metrics.threshold_levels``).
Returns int64 (L, 3): ``(tp, fp, fn)`` per level. The JAX package sums the
counts in float32, exact only below 2²⁴ pixels; these are exact integers
(F12).

Bound: bytes. At the flagship eval step (pred and mask each 64 frames of
256², float32) 33.5 MB read, about 0.010 ms at 3.35 TB/s (H100 SXM data
sheet, 700 W).

Design (``csrc/f1.cu``): a grid-stride loop over 16-byte vectors of both
inputs; per thread and level the counts of p on, g on and both in
registers; a warp reduction (``__reduce_add_sync``), the block's warps in
shared memory, then one 64-bit integer atomic per block and counter into
the zeroed output. Integer sums do not depend on their order, so the
counts equal the plain version's exactly and repeat exactly.
"""

import ctypes
from typing import Sequence

import torch

from . import _lib

__all__ = ["f1_sweep", "f1_sweep_plain", "MAX_LEVELS", "COUNT"]

COUNT = _lib.LaunchCount("f1_sweep")
MAX_LEVELS = 16   # csrc/f1.cu kMaxLevels
_BLOCKS_PER_SM = 8


def _check(pred: torch.Tensor, gt: torch.Tensor, levels: Sequence[float]):
    if pred.shape != gt.shape:
        raise ValueError(f"f1_sweep: prediction {tuple(pred.shape)} and mask "
                         f"{tuple(gt.shape)} differ in shape")
    if pred.dtype != torch.float32 or gt.dtype != torch.float32:
        raise TypeError(f"f1_sweep takes float32, got {pred.dtype} and "
                        f"{gt.dtype}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"f1_sweep: 1 to {MAX_LEVELS} levels, got "
                         f"{len(levels)}")


def f1_sweep_plain(pred: torch.Tensor, gt: torch.Tensor,
                   levels: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version (the transcription of ``mask_confusion``):
    int64 (L, 3) counts ``(tp, fp, fn)`` per level."""
    _check(pred, gt, levels)
    pl = torch.trunc(pred * 255.0)
    gl = torch.trunc(gt * 255.0)
    rows = []
    for t in levels:
        p, g = pl > t, gl > t
        rows.append(torch.stack([(p & g).sum(), (p & ~g).sum(),
                                 (~p & g).sum()]))
    return torch.stack(rows)


def f1_sweep(pred: torch.Tensor, gt: torch.Tensor,
             levels: Sequence[float]) -> torch.Tensor:
    """Confusion counts ``(tp, fp, fn)`` per level, int64 (L, 3): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(pred, gt, levels)
    if not _lib.on_cuda(pred, gt):
        return f1_sweep_plain(pred, gt, levels)
    pred, gt = pred.contiguous(), gt.contiguous()
    dev = pred.device
    counts = torch.zeros(len(levels), 3, device=dev, dtype=torch.int64)
    n = pred.numel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(_BLOCKS_PER_SM * sms, -(-n // (4 * 256))))
    lv = (ctypes.c_float * len(levels))(*map(float, levels))
    _lib.launch("vwfd_f1_sweep", dev, pred.data_ptr(), gt.data_ptr(), n, lv,
                len(levels), counts.data_ptr(), blocks)
    COUNT.n += 1
    return counts
