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

Design (``csrc/f1.cu``): the level count is a template parameter (9 for
``f1_sweep``'s thresholds, 16 for any other count with the unused levels at
+inf; ``level_variant``). One CTA an SM, one wave (``blocks``); each thread
keeps several 16-byte loads of both inputs in flight, then counts p on, g
on and both per level in registers; a warp reduction
(``__reduce_add_sync``), the block's warps in shared memory, one 64-bit
partial per block and counter, and the last block (an integer ticket) sums
the partials and writes ``(tp, fp, fn)`` itself, so the output needs no
memset and the counts no atomics. Integer sums do not
depend on their order, so the counts equal the plain version's exactly and
repeat exactly. The ticket and partials live in scratch kept per device and
stream; the last block leaves the ticket at 0.
"""

import ctypes
from typing import Sequence

import torch

from . import _lib

__all__ = ["f1_sweep", "f1_sweep_plain", "level_variant", "blocks",
           "scratch_sizes", "MAX_LEVELS", "COUNT"]

COUNT = _lib.LaunchCount("f1_sweep")
MAX_LEVELS = 16   # csrc/f1.cu kMaxLevels
_SCRATCH: dict = {}  # per (device, stream): ticket, partials


def level_variant(nl: int) -> int:
    """The level count the kernel is compiled for: 9 exactly, 16 for any
    other count (the unused levels never count)."""
    if not 1 <= nl <= MAX_LEVELS:
        raise ValueError(f"f1_sweep: 1 to {MAX_LEVELS} levels, got {nl}")
    return 9 if nl == 9 else MAX_LEVELS


def _block(nl: int) -> int:
    """Threads of a CTA (``csrc/f1.cu`` ``Shape``): 512 for the 16-level
    variant, whose counters need more registers, else 768."""
    return 512 if level_variant(nl) == MAX_LEVELS else 768


def blocks(n: int, nl: int, sms: int) -> int:
    """The grid: one CTA an SM, fewer when ``n`` pixels do not give each
    thread a 16-byte vector."""
    return max(1, min(sms, -(-n // (4 * _block(nl)))))


def scratch_sizes(nl: int, n: int, sms: int):
    """Elements of the ticket (u32, zeroed once) and the partials (u64: p,
    g and both of every compiled level, per block)."""
    return 1, 3 * level_variant(nl) * blocks(n, nl, sms)


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
    n, nl = pred.numel(), len(levels)
    sms = _lib.sm_count(dev)
    n_ticket, n_partial = scratch_sizes(nl, n, sms)
    ticket, partial = _lib.stream_scratch(
        _SCRATCH, dev, [(n_ticket, torch.int32, True),
                        (n_partial, torch.int64, False)])
    counts = torch.empty(nl, 3, device=dev, dtype=torch.int64)
    lv = (ctypes.c_float * nl)(*map(float, levels))
    _lib.launch("vwfd_f1_sweep", dev, pred.data_ptr(), gt.data_ptr(), n, lv,
                nl, level_variant(nl), blocks(n, nl, sms), partial.data_ptr(),
                ticket.data_ptr(), counts.data_ptr())
    COUNT.n += 1
    return counts
