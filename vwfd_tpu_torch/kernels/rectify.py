"""K21 `rectify`: CLR's scale-back rectification of the attacked copies
before the reverse pass, forward and backward.

Replaces ``vwfd_tpu/attacks/spatial.py::rectify_crop_pad`` (:191-201) with
its bicubic ``paste_resize`` (:149-174), as the image model calls it
(``models/image_model.py:429`` train, ``:535`` eval). For copy m of the
attacked batch (M, H, W, 3) and its clean image ``clean[m mod B]`` (B, H,
W, 3): the value of ``ideal + stop_grad(clip(paste)·inside − ideal)``,
``ideal = clean·inside``, where paste resamples the copy back to the window
``apex`` at its place (source row ``((i − h0) + ½)·H/ch − ½``, four
bicubic taps clamped to the image). The gradient flows into ``clean`` only:
``g·inside`` summed over the copies of each clean image (the transpose of
JAX's tile), K21's backward kernel. The plain versions are
``attacks/spatial.py::rectify_crop_pad`` and ``rectify_backward_plain``
(the same backward as PyTorch ops).

Bound: bytes. At CLR's train step (48 copies of 256² RGB, 8 clean images,
f32) the forward reads 44 MB and writes 37.7 MB: about 24 µs at 3.35 TB/s;
the backward reads g (37.7 MB) and writes dclean (6.3 MB): about 13 µs
(H100 SXM data sheet, 700 W).

Design (``csrc/rectify.cu``): the forward is separable. A CTA of 256
threads takes one copy and ``plan``'s band of output rows; per output row a
row pass reads the four source rows of its taps as float4 runs of the W·C
floats and writes the row sums to shared memory, a column pass (a thread
a pixel, its column taps in registers) sums the four column taps there,
and a combine with the clean row writes the output row coalesced; the
next row's loads are issued before the column pass, into registers. The
taps are ``csrc/cubic.cuh``'s, the plain version's float32 operations in
its order (the weights' FMAs written as ``__fmaf_rn``, nothing else
contracted): the output EQUALS the plain version's. The clip keeps NaN
and the window enters as products and sums, so an Inf or NaN attacked pixel
reaches the outputs it reaches in JAX. The backward is a thread per float4
of dclean summing the copies' ``g·inside`` in order: no atomics,
bit-identical over calls, within ``RECT_GRAD_RTOL`` of the plain version.
"""

from typing import Tuple

import torch

from . import _lib
from .crop_resize import SMEM_CTA, as_apex
from ..attacks.spatial import rect_mask, rectify_crop_pad

__all__ = ["rectify", "rectify_plain", "rectify_backward",
           "rectify_backward_plain", "plan", "COUNT"]

COUNT = _lib.LaunchCount("rectify")
_BANDS = (8, 4)       # output rows a CTA, in the order ties keep
_CTAS_PER_SM = 4      # csrc/rectify.cu kMinBlocks


def plan(m: int, h: int, w: int, c: int, sms: int
         ) -> Tuple[int, int, int]:
    """``(band, bands, smem_bytes)`` of the forward: the grid is ``(bands,
    m)``, CTA ``(x, copy)`` takes output rows ``[band·x, band·x + band)``
    of the copy; its dynamic shared memory holds the band's row taps (32
    bytes each) and the row sums and pastes of one row, W·C floats each in
    whole float4s (``csrc/rectify.cu`` ``smem_bytes``). The band minimises
    the waves of CTAs (four an SM) times the rows each walks plus its
    set-up (about 2 rows' time)."""
    best = None
    for band in _BANDS:
        band = min(band, max(h, 1))
        bands = -(-h // band)
        waves = -(-(bands * m) // (_CTAS_PER_SM * sms))
        cost = waves * (band + 2)
        if best is None or cost < best[0]:
            best = (cost, band, bands)
    _, band, bands = best
    return band, bands, 32 * band + 2 * 16 * (-(-(w * c) // 4))


def rectify_plain(attacked: torch.Tensor, clean: torch.Tensor, apex
                  ) -> torch.Tensor:
    """Plain PyTorch version (``attacks.spatial.rectify_crop_pad``)."""
    return rectify_crop_pad(attacked, clean, as_apex(apex, attacked.device))


def rectify_backward_plain(g: torch.Tensor, apex: torch.Tensor, reps: int
                           ) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``g·inside`` (M, H, W, C)
    summed over the ``reps`` copies of each clean image."""
    inside = rect_mask(tuple(g.shape[1:3]), apex.unbind())[..., None]
    return (g * inside).reshape(reps, -1, *g.shape[1:]).sum(0)


def rectify_backward(g: torch.Tensor, apex: torch.Tensor, reps: int
                     ) -> torch.Tensor:
    """The gradient into the clean images (M / reps, H, W, C) of the
    rectified copies' cotangent ``g`` (M, H, W, C): K21's backward kernel
    for CUDA tensors, the plain version for CPU tensors."""
    apex = as_apex(apex, g.device)
    if not _lib.on_cuda(g, apex):
        return rectify_backward_plain(g, apex, reps)
    if g.dtype != torch.float32:
        raise TypeError(f"the rectify kernel takes float32, got {g.dtype}")
    g = g.contiguous()
    m, h, w, c = g.shape
    if reps < 1 or m % reps:
        raise ValueError(f"rectify backward: {m} copies are not {reps} "
                         f"repeats of a batch")
    dclean = torch.empty((m // reps, h, w, c), device=g.device,
                         dtype=torch.float32)
    _lib.launch("vwfd_rectify_bwd", g.device, g.data_ptr(), apex.data_ptr(),
                dclean.data_ptr(), reps, m // reps, h, w, c)
    COUNT.n += 1
    return dclean


class _RectifyFn(torch.autograd.Function):
    """K21 forward and backward (``g·inside`` summed per clean image)."""

    @staticmethod
    def forward(ctx, attacked, clean, apex):
        m, h, w, c = attacked.shape
        b = clean.shape[0]
        band = plan(m, h, w, c, _lib.sm_count(attacked.device))[0]
        out = torch.empty_like(attacked)
        _lib.launch("vwfd_rectify", attacked.device, attacked.data_ptr(),
                    clean.data_ptr(), apex.data_ptr(), out.data_ptr(), m, b,
                    h, w, c, band)
        COUNT.n += 1
        ctx.save_for_backward(apex)
        ctx.reps = m // b
        return out

    @staticmethod
    def backward(ctx, g):
        apex, = ctx.saved_tensors
        return None, rectify_backward(g, apex, ctx.reps), None


def rectify(attacked: torch.Tensor, clean: torch.Tensor, apex
            ) -> torch.Tensor:
    """The rectified copies (M, H, W, C) of ``attacked`` against ``clean``
    (B, H, W, C), M a multiple of B, through the window ``apex``;
    differentiable in ``clean``: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors."""
    _lib.check_nhwc(attacked, "rectify attacked")
    _lib.check_nhwc(clean, "rectify clean")
    if attacked.shape[1:] != clean.shape[1:] or \
            attacked.shape[0] % max(clean.shape[0], 1):
        raise ValueError(f"rectify: {tuple(attacked.shape)} copies do not "
                         f"tile clean {tuple(clean.shape)}")
    apex = as_apex(apex, attacked.device)
    if not _lib.on_cuda(attacked, clean, apex):
        return rectify_plain(attacked, clean, apex)
    if attacked.dtype != torch.float32 or clean.dtype != torch.float32:
        raise TypeError(f"the rectify kernel takes float32, got "
                        f"{attacked.dtype} and {clean.dtype}")
    m, h, w, c = attacked.shape
    if plan(m, h, w, c, 1)[2] > SMEM_CTA or m > 65535:
        raise ValueError(f"rectify kernel: rows of {w}×{c} floats or {m} "
                         f"copies do not fit a CTA's shared memory or the "
                         f"grid")
    return _RectifyFn.apply(attacked.detach(), clean, apex)
