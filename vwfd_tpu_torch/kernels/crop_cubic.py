"""K20 `crop_cubic`: crop a window and resample it bicubically (a = −0.75)
back onto the full grid, forward and backward with respect to the image.

Replaces ``vwfd_tpu/ops/resize.py::crop_resize(method="bicubic")``
(:135-152) with its bicubic ``_sample_axis`` (:97-133), as CLR's crop
tamper calls it (``vwfd_tpu/models/image_model.py:230-231, 535-536``). The
window ``apex = (h0, h1, w0, w1)`` is a (4,) float32 tensor on the image's
device, one per call and shared by the batch: a drawn apex reaches the
kernel with no host sync. Half-pixel centres; each output row's four taps
clamp to the window (``bounds=(h0, h1 − 1)``); rows first, then columns.
The plain version is ``ops/resize.py::crop_resize(..., method="bicubic")``
(``crop_cubic_plain``).

Bound: bytes. At CLR's (8, 256, 256, 3) f32 the forward reads at most the
image and writes 6.3 MB, the backward reads g and writes gx: about 3.8 µs
each way at 3.35 TB/s (H100 SXM data sheet, 700 W), near a launch's fixed
cost.

Design (``csrc/crop_cubic.cu``, first version): a thread per output pixel
computes its taps in registers with the plain version's float32 operations
(``csrc/cubic.cuh``: the weights' FMAs are the plain version's, which
follows XLA's contraction of JAX's expression, written as ``__fmaf_rn``;
nothing else is contracted) and sums its 16 source pixels in
the plain order: the forward is EQUAL to the plain version. The backward
is the separable transpose in two launches through a (N, OH, W, C)
scratch, each input index summing the outputs that tap it (a binary search
of the monotone tap bases), j or i ascending, each tap's term kept apart:
deterministic, no float atomics, NaN where autograd's is; within a stated
tolerance of the plain gradient's max (autograd sums in another order, and
on the card with atomics). No shared memory, so no width is refused.
"""

from typing import Optional, Tuple

import torch

from . import _lib
from .crop_resize import as_apex
from ..ops.resize import crop_resize as _crop_resize

__all__ = ["crop_cubic", "crop_cubic_plain", "COUNT"]

COUNT = _lib.LaunchCount("crop_cubic")


def crop_cubic_plain(x: torch.Tensor, apex,
                     out_hw: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version: ``crop_resize(x, apex, out_hw,
    method="bicubic")``."""
    return _crop_resize(x, as_apex(apex, x.device), out_hw, method="bicubic")


class _CropCubicFn(torch.autograd.Function):
    """K20 under autograd: the backward is K20's separable transpose."""

    @staticmethod
    def forward(ctx, x, apex, oh, ow):
        n, h, w, c = x.shape
        y = torch.empty((n, oh, ow, c), device=x.device, dtype=x.dtype)
        _lib.launch("vwfd_crop_cubic_fwd", x.device, x.data_ptr(),
                    apex.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow)
        COUNT.n += 1
        ctx.save_for_backward(apex)
        ctx.shape = (n, h, w, c)
        return y

    @staticmethod
    def backward(ctx, g):
        apex, = ctx.saved_tensors
        n, h, w, c = ctx.shape
        g = g.contiguous()
        oh, ow = g.shape[1:3]
        gt = torch.empty((n, oh, w, c), device=g.device, dtype=g.dtype)
        gx = torch.empty(ctx.shape, device=g.device, dtype=g.dtype)
        _lib.launch("vwfd_crop_cubic_bwd", g.device, g.data_ptr(),
                    apex.data_ptr(), gt.data_ptr(), gx.data_ptr(), n, h, w,
                    c, oh, ow)
        COUNT.n += 1
        return gx, None, None, None


def crop_cubic(x: torch.Tensor, apex,
               out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Bicubic crop-and-resize of an NHWC float32 batch through the window
    ``apex`` to ``out_hw`` (default the input's size), differentiable in x:
    the CUDA kernels for a CUDA tensor, the plain version for a CPU
    tensor."""
    _lib.check_nhwc(x, "crop_cubic input")
    apex = as_apex(apex, x.device)
    if not _lib.on_cuda(x, apex):
        return crop_cubic_plain(x, apex, out_hw)
    if x.dtype != torch.float32:
        raise TypeError(f"the crop_cubic kernel takes float32, got {x.dtype}")
    oh, ow = (int(v) for v in (out_hw if out_hw is not None
                               else x.shape[1:3]))
    return _CropCubicFn.apply(x, apex, oh, ow)
