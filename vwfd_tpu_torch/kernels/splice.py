"""K10 `splice`: the embed's epilogue and the splice tamper, forward and
backward.

Replaces ``vwfd_tpu/models/video_model.py:186-193`` (the train step) and
``:146-156`` with ``:262`` (the embed and the eval step's splice): the INN
output (B, H, W, T·3) in the compute dtype → ``_to_frames`` → float32 →
``clamp_with_grad`` → ``ste_quantize_255`` = ``fwd_video`` (B, T, H, W, 3),
and with a mask (B, T, H, W, 1) and the previous batch ``prev``
(B, T, H, W, 3), ``attacked_fwd = fwd_video·(1 − m) + prev·m``. Its
backward (both quantizers straight-through; ``prev`` and the mask take no
gradient) is ``cast(g_fv + g_att·(1 − m))`` relaid out to (B, H, W, T·3).

Bound: bytes. At the training shape (B 16, T 4, 256², bf16 INN output) the
forward reads 25.2 + 16.8 + 50.3 MB and writes 100.7 MB: 193.0 MB, 0.058
ms at 3.35 TB/s; the backward reads 117.4 MB and writes 25.2 MB, 0.043 ms.
There is no library call for it.

Design (``csrc/splice.cu``): K3's row tiling. A block takes one image row
and a chunk of 64 of its pixels, stages the INN output's chunk in shared
memory as float32 (16-byte loads) and writes the T frames' chunks of both
outputs in float4; the backward runs the other way. Every operation is the
plain version's in its order, one IEEE rounding each (the division by 255
too), so forward and backward equal the plain version bit for bit.
"""

from typing import Optional

import torch

from ..ops.quantize import clamp_with_grad, ste_quantize_255
from . import _lib

__all__ = ["splice", "splice_plain", "to_frames", "COUNT"]

COUNT = _lib.LaunchCount("splice")
_MAX_FRAMES = 16  # csrc/splice.cu: frames a staged chunk holds


def to_frames(x: torch.Tensor, t: int) -> torch.Tensor:
    """(B, H, W, T·C) → (B, T, H, W, C)."""
    b, h, w, tc = x.shape
    return x.reshape(b, h, w, t, tc // t).permute(0, 3, 1, 2, 4)


def _check(x, frames, mask, prev):
    _lib.check_nhwc(x, "splice input")
    _lib.dtype_code(x)
    b, h, w, tc = x.shape
    if tc != 3 * frames or not 1 <= frames <= _MAX_FRAMES:
        raise ValueError(f"splice: {tc} channels != 3·{frames} (frames in "
                         f"1..{_MAX_FRAMES})")
    if (mask is None) != (prev is None):
        raise ValueError("splice: pass the mask and prev together")
    if mask is not None:
        for name, t, c in (("mask", mask, 1), ("prev", prev, 3)):
            _lib.check_nhwc(t, f"splice {name}", 5)
            if t.dtype != torch.float32 or t.shape != (b, frames, h, w, c):
                raise ValueError(f"splice {name}: expected float32 "
                                 f"{(b, frames, h, w, c)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    if x.numel() // tc * 3 * frames >= 2 ** 31:
        raise ValueError("splice: the kernels index in 32 bits (fewer than "
                         "2^31 elements a tensor)")


def splice_plain(x: torch.Tensor, frames: int,
                 mask: Optional[torch.Tensor] = None,
                 prev: Optional[torch.Tensor] = None):
    """Plain PyTorch version: ``fwd_video``, and with ``mask`` and ``prev``
    also ``attacked_fwd`` (autograd through both)."""
    _check(x, frames, mask, prev)
    fwd_video = ste_quantize_255(clamp_with_grad(to_frames(x, frames)
                                                 .float()))
    if mask is None:
        return fwd_video
    return fwd_video, fwd_video * (1.0 - mask) + prev * mask


def _null(t):
    return 0 if t is None else t.data_ptr()


class _SpliceKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, frames, mask, prev):
        b, h, w, _ = x.shape
        shape = (b, frames, h, w, 3)
        fv = torch.empty(shape, device=x.device, dtype=torch.float32)
        att = None if mask is None else torch.empty_like(fv)
        _lib.launch("vwfd_splice_fwd", x.device, x.data_ptr(), _null(mask),
                    _null(prev), fv.data_ptr(), _null(att), b, frames, h, w,
                    _lib.dtype_code(x))
        COUNT.n += 1
        ctx.frames, ctx.dtype = frames, x.dtype
        ctx.save_for_backward(mask)
        return fv if att is None else (fv, att)

    @staticmethod
    def backward(ctx, g_fv, g_att=None):
        (mask,) = ctx.saved_tensors
        g_fv = g_fv.contiguous()
        if g_att is not None:
            g_att = g_att.contiguous()
        b, t, h, w, _ = g_fv.shape
        gx = torch.empty((b, h, w, 3 * t), device=g_fv.device,
                         dtype=ctx.dtype)
        _lib.launch("vwfd_splice_bwd", g_fv.device, g_fv.data_ptr(),
                    _null(g_att), _null(mask if g_att is not None else None),
                    gx.data_ptr(), b, t, h, w, _lib.DTYPE_CODES[ctx.dtype])
        COUNT.n += 1
        return gx, None, None, None


def splice(x: torch.Tensor, frames: int,
           mask: Optional[torch.Tensor] = None,
           prev: Optional[torch.Tensor] = None):
    """INN output (B, H, W, 3·frames), float32 or bfloat16 → ``fwd_video``
    (B, T, H, W, 3) float32, and with ``mask`` and ``prev`` the pair
    ``(fwd_video, attacked_fwd)``; differentiable in ``x``. The CUDA kernels
    for CUDA tensors, the plain version for CPU tensors."""
    _check(x, frames, mask, prev)
    ts = (x,) if mask is None else (x, mask, prev)
    if not _lib.on_cuda(*ts):
        return splice_plain(x, frames, mask, prev)
    return _SpliceKernel.apply(x, frames, mask, prev)
