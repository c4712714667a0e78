"""K4 `mask_pack`: detect epilogue, packed logits → bit-packed tamper mask
and per-clip tamper fraction.

Replaces ``UNetTPU``'s d2s head + sigmoid (``vwfd_tpu/nets/unet.py:298-309``)
and the serving epilogue of ``vwfd_tpu/serving.py``: ``_pack_mask_bits``
(:82-88), ``_mask_u8`` (:157-161) and the threshold + per-clip mean of
``_detect_u8`` (:414-425). From head logits (B·T, H/s, W/s, s²):

* ``p = sigmoid(depth_to_space(logits))`` in f32;
* W % 8 == 0: ``p > threshold`` bit-packed MSB-first along W → u8
  (B,T,H,W/8), the wire format ``unpack_mask_bits`` reads; otherwise a u8
  {0,255} mask (B,T,H,W,1);
* ``tamper_fraction``: the mean of p over each clip, f32 (B,).

Bound: bytes. At the flagship serving shapes (64 frames of 128²×4 bf16
logits) 8.4 MB in, 0.5 MB of bits out: 8.9 MB, about 2.7 µs at 3.35 TB/s
(H100 SXM data sheet, 700 W).

Design (``csrc/mask.cu``): on the fast path (s = 2, W % 8 == 0, 16-byte
aligned logits) one warp per logits row, i.e. two image rows, with 16-byte
loads; each lane writes one byte of each row. Other shapes take the general
path, one thread per output byte. A grid of G blocks per clip; each block
sums its pixels in a fixed order and the last block of a clip, found with
an integer ticket, adds the G partials in a fixed order. No float atomics,
so the mean is deterministic. The last block resets its ticket, so the
ticket and partial scratch live in buffers kept per device and stream, and a
call allocates only its outputs.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.squeeze import depth_to_space
from . import _lib

__all__ = ["mask_pack", "mask_pack_plain", "fast_grid", "COUNT"]

COUNT = _lib.LaunchCount("mask_pack")
_BIT_WEIGHTS = np.array([128, 64, 32, 16, 8, 4, 2, 1], np.uint8)
_WARPS = 8       # warps per block on the fast path (csrc/mask.cu kWarps)
_WAVES = 4       # fast-path grid: about this many blocks per SM
_SCRATCH: dict = {}  # per (device, stream): tickets, partials


def _check(logits: torch.Tensor, frames: int, s: int) -> None:
    _lib.check_nhwc(logits, "logits")
    _lib.dtype_code(logits)
    n, _, _, c = logits.shape
    if c != s * s or frames < 1 or n % frames:
        raise ValueError(f"logits {tuple(logits.shape)} do not hold "
                         f"{frames}-frame clips at s2d {s} (1 output channel)")


def fast_grid(clips: int, rows_per_clip: int, sms: int) -> Tuple[int, int]:
    """Fast-path grid: ``(G, rows per warp)`` so that the B·G blocks of
    ``_WARPS`` warps come to about ``_WAVES`` per SM and G blocks cover a
    clip's ``rows_per_clip`` logits rows."""
    rpw = max(1, -(-clips * rows_per_clip // (_WARPS * _WAVES * sms)))
    return -(-rows_per_clip // (_WARPS * rpw)), rpw


def mask_pack_plain(logits: torch.Tensor, frames: int, s: int,
                    threshold: float, plan_clips: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(mask, tamper_fraction)`` (``plan_clips``
    is the kernel's and changes nothing here)."""
    _check(logits, frames, s)
    n, hs, ws, _ = logits.shape
    b, h, w = n // frames, hs * s, ws * s
    p = torch.sigmoid(depth_to_space(logits, s).float()).reshape(
        b, frames, h, w)
    frac = p.mean(dim=(1, 2, 3))
    hit = p > threshold
    if w % 8:
        return (hit.to(torch.uint8) * 255)[..., None], frac
    bits = hit.to(torch.uint8).reshape(b, frames, h, w // 8, 8)
    weights = torch.from_numpy(_BIT_WEIGHTS).to(bits.device)
    return (bits * weights).sum(-1, dtype=torch.uint8), frac


def mask_pack(logits: torch.Tensor, frames: int, s: int, threshold: float,
              plan_clips: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold + pack the detect head's logits; returns ``(mask,
    tamper_fraction)``: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. The fast path's grid, and with it the order in which
    a clip's mean is summed, is planned for ``plan_clips`` clips (default:
    the call's): a replica that serves part of a request plans for the
    whole request, and so sums each clip as one device would."""
    _check(logits, frames, s)
    if not _lib.on_cuda(logits):
        return mask_pack_plain(logits, frames, s, threshold)
    if logits.numel() >= 2 ** 31:
        raise ValueError(f"mask_pack: {logits.numel()} logits; the kernel "
                         f"indexes in 32 bits (fewer than 2^31)")
    n, hs, ws, _ = logits.shape
    b, h, w = n // frames, hs * s, ws * s
    packed = w % 8 == 0
    dev = logits.device
    mask = torch.empty((b, frames, h, w // 8) if packed
                       else (b, frames, h, w, 1), device=dev,
                       dtype=torch.uint8)
    frac = torch.empty(b, device=dev, dtype=torch.float32)
    if s == 2 and packed and logits.data_ptr() % 16 == 0:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        g, rpw = fast_grid(plan_clips or b, frames * hs, sms)
    else:
        clip_bytes = frames * h * (w // 8 if packed else w)
        g, rpw = max(1, min(64, -(-clip_bytes // 1024))), 0
    tickets, partials = _lib.stream_scratch(
        _SCRATCH, dev, [(b, torch.int32, True),
                        (b * g, torch.float32, False)])
    _lib.launch("vwfd_mask_pack", dev, logits.data_ptr(), mask.data_ptr(),
                partials.data_ptr(), tickets.data_ptr(), frac.data_ptr(), b,
                frames, h, w, s, float(threshold), int(packed), g, rpw,
                _lib.dtype_code(logits))
    COUNT.n += 1
    return mask, frac
