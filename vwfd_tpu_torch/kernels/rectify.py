"""K21 `rectify`: CLR's scale-back rectification of the attacked copies
before the reverse pass.

Replaces ``vwfd_tpu/attacks/spatial.py::rectify_crop_pad`` (:196-201) with
its bicubic ``paste_resize`` (:149-174), as the image model calls it
(``vwfd_tpu/models/image_model.py:354-355, 548-549``). For copy m of the
attacked batch (M, H, W, 3) and its clean image ``clean[m mod B]`` (B, H,
W, 3): the value of ``ideal + stop_grad(clip(paste)·inside − ideal)``,
``ideal = clean·inside``, where paste resamples the copy back to the window
``apex`` at its place (source row ``((i − h0) + ½)·H/ch − ½``, four
bicubic taps clamped to the image). The gradient flows into ``clean`` only:
``g·inside`` summed over the copies of each clean image (the transpose of
JAX's tile), which stays PyTorch ops inside the autograd Function (a
product and a sum over a reshaped axis). The plain version is
``attacks/spatial.py::rectify_crop_pad``.

Bound: bytes. At CLR's train step (48 copies of 256² RGB, 8 clean images,
f32) the forward reads 44 MB and writes 37.7 MB: about 24 µs at 3.35 TB/s
(H100 SXM data sheet, 700 W).

Design (``csrc/rectify.cu``, first version): a thread per output pixel
with its taps in registers (``csrc/cubic.cuh``, the plain version's
float32 operations: the weights' FMAs are the plain version's, written as
``__fmaf_rn``, and nothing else is contracted): the output EQUALS the
plain version's. The clip keeps NaN and the window enters as products and sums,
so an Inf or NaN attacked pixel reaches the outputs it reaches in JAX.
"""

import torch

from . import _lib
from .crop_resize import as_apex
from ..attacks.spatial import rect_mask, rectify_crop_pad

__all__ = ["rectify", "rectify_plain", "COUNT"]

COUNT = _lib.LaunchCount("rectify")


def rectify_plain(attacked: torch.Tensor, clean: torch.Tensor, apex
                  ) -> torch.Tensor:
    """Plain PyTorch version (``attacks.spatial.rectify_crop_pad``)."""
    return rectify_crop_pad(attacked, clean, as_apex(apex, attacked.device))


class _RectifyFn(torch.autograd.Function):
    """K21 forward; the backward is ``g·inside`` summed per clean image."""

    @staticmethod
    def forward(ctx, attacked, clean, apex):
        m, h, w, c = attacked.shape
        b = clean.shape[0]
        out = torch.empty_like(attacked)
        _lib.launch("vwfd_rectify", attacked.device, attacked.data_ptr(),
                    clean.data_ptr(), apex.data_ptr(), out.data_ptr(), m, b,
                    h, w, c)
        COUNT.n += 1
        ctx.save_for_backward(apex)
        ctx.dims = (m // b, b)
        return out

    @staticmethod
    def backward(ctx, g):
        apex, = ctx.saved_tensors
        reps, b = ctx.dims
        inside = rect_mask(tuple(g.shape[1:3]), apex.unbind())[..., None]
        gc = (g * inside).reshape(reps, b, *g.shape[1:]).sum(0)
        return None, gc, None


def rectify(attacked: torch.Tensor, clean: torch.Tensor, apex
            ) -> torch.Tensor:
    """The rectified copies (M, H, W, C) of ``attacked`` against ``clean``
    (B, H, W, C), M a multiple of B, through the window ``apex``;
    differentiable in ``clean``: the CUDA kernel for CUDA tensors, the
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
    return _RectifyFn.apply(attacked.detach(), clean, apex)
