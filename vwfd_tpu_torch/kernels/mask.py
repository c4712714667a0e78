"""K4 `mask_pack`: detect epilogue, packed logits → bit-packed tamper mask
and per-clip tamper fraction.

Replaces ``UNetTPU``'s d2s head + sigmoid (``vwfd_tpu/nets/unet.py:298-309``)
and the serving epilogue of ``vwfd_tpu/serving.py``: ``_pack_mask_bits``
(:82-88), ``_mask_u8`` (:157-161) and the threshold + per-clip mean of
``_detect_u8`` (:420-425). From head logits (B·T, H/s, W/s, s²):

* ``p = sigmoid(depth_to_space(logits))`` in f32;
* W % 8 == 0: ``p > threshold`` bit-packed MSB-first along W → u8
  (B,T,H,W/8), the wire format ``unpack_mask_bits`` reads; otherwise a u8
  {0,255} mask (B,T,H,W,1);
* ``tamper_fraction``: the mean of p over each clip, f32 (B,).

Bound: bytes. At the flagship serving shapes (64 frames of 128²×4 bf16
logits) 8.4 MB in, 0.5 MB of bits out: 8.9 MB, about 2.7 µs at 3.35 TB/s
(H100 SXM data sheet, 700 W).

Design (``csrc/mask.cu``): one thread per output byte (8 pixels, or 1 in the
u8 mode). A grid of G blocks per clip; each block reduces its partial sum in
a fixed tree order and the last block of a clip, found with an integer
ticket, adds the G partials in index order. No float atomics, so the mean
is deterministic.
"""

from typing import Tuple

import numpy as np
import torch

from ..ops.squeeze import depth_to_space
from . import _lib

__all__ = ["mask_pack", "mask_pack_plain", "COUNT"]

COUNT = _lib.LaunchCount("mask_pack")
_BIT_WEIGHTS = np.array([128, 64, 32, 16, 8, 4, 2, 1], np.uint8)


def _check(logits: torch.Tensor, frames: int, s: int) -> None:
    _lib.check_nhwc(logits, "logits")
    _lib.dtype_code(logits)
    n, _, _, c = logits.shape
    if c != s * s or frames < 1 or n % frames:
        raise ValueError(f"logits {tuple(logits.shape)} do not hold "
                         f"{frames}-frame clips at s2d {s} (1 output channel)")


def mask_pack_plain(logits: torch.Tensor, frames: int, s: int,
                    threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(mask, tamper_fraction)``."""
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


def mask_pack(logits: torch.Tensor, frames: int, s: int, threshold: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold + pack the detect head's logits; returns ``(mask,
    tamper_fraction)``: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    _check(logits, frames, s)
    if not _lib.on_cuda(logits):
        return mask_pack_plain(logits, frames, s, threshold)
    n, hs, ws, _ = logits.shape
    b, h, w = n // frames, hs * s, ws * s
    packed = w % 8 == 0
    dev = logits.device
    mask = torch.empty((b, frames, h, w // 8) if packed
                       else (b, frames, h, w, 1), device=dev,
                       dtype=torch.uint8)
    clip_bytes = frames * h * (w // 8 if packed else w)
    g = max(1, min(64, -(-clip_bytes // 1024)))  # blocks per clip
    partial = torch.empty(b * g, device=dev, dtype=torch.float32)
    ticket = torch.zeros(b, device=dev, dtype=torch.int32)
    frac = torch.empty(b, device=dev, dtype=torch.float32)
    _lib.launch("vwfd_mask_pack", dev, logits.data_ptr(), mask.data_ptr(),
                partial.data_ptr(), ticket.data_ptr(), frac.data_ptr(), b,
                frames, h, w, s, float(threshold), int(packed), g,
                _lib.dtype_code(logits))
    COUNT.n += 1
    return mask, frac
