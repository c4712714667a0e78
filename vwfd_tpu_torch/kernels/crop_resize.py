"""K17 `crop_resize`: crop a window and resample it bilinearly back onto the
full grid, forward and backward with respect to the image.

Replaces ``vwfd_tpu/ops/resize.py::crop_resize`` (:135-152) with its
bilinear ``_sample_axis`` (:97-133), as ``vwfd_tpu/attacks/spatial.py::
crop_attack`` (:70-77) calls it for HiDDeN's crop member. The window
``apex = (h0, h1, w0, w1)`` is a (4,) float32 tensor on the image's device,
one per call and shared by the batch, so a drawn apex reaches the kernel
with no host sync (the JAX package's fixed-shape design for a traced apex
serves the same end). Half-pixel centres; each output row's two taps clamp
to the window (``bounds=(h0, h1 − 1)``), not to the image; rows first, then
columns. The plain version is ``ops/resize.py::crop_resize``.

Bound: bytes. At the HiDDeN path's (8, 3, 128, 128) f32 the forward reads
at most the whole image and writes 1.57 MB, under a microsecond at 3.35 TB/s
(H100 SXM data sheet, 700 W): below a launch's fixed cost. On the path it
replaces a gather chain (coordinates, floors, clamps, four gathers, the
products and sums) with one launch.

Design (``csrc/crop_resize.cu``): a thread per output pixel, its channels in
a loop, its taps recomputed from the apex with the plain version's float32
operations, each product and sum one IEEE rounding in the plain order: the
forward is EQUAL to the plain version. The backward is the transpose in
gather form, a thread per input pixel summing over the output rows and
columns that tap it (found by binary search; the taps are monotone):
deterministic, no float atomics, within 1e-6 of the plain gradient's max
(autograd sums the same products in another order).
"""

from typing import Optional, Sequence, Tuple, Union

import torch

from . import _lib
from ..ops.resize import crop_resize as crop_resize_plain

__all__ = ["crop_resize", "crop_resize_plain", "as_apex", "COUNT"]

COUNT = _lib.LaunchCount("crop_resize")


def as_apex(apex: Union[torch.Tensor, Sequence], device) -> torch.Tensor:
    """``apex`` as a contiguous (4,) float32 tensor on ``device``: a tensor
    stays where it is (moved only if it lies elsewhere), numbers or 0-dim
    tensors are stacked."""
    if not isinstance(apex, torch.Tensor):
        apex = torch.stack([torch.as_tensor(a, dtype=torch.float32)
                            for a in apex])
    apex = apex.to(device=device, dtype=torch.float32).contiguous()
    if tuple(apex.shape) != (4,):
        raise ValueError(f"apex must hold (h0, h1, w0, w1), got shape "
                         f"{tuple(apex.shape)}")
    return apex


def _check(x: torch.Tensor) -> None:
    _lib.check_nhwc(x, "crop_resize input")
    if not x.is_floating_point():
        raise TypeError(f"crop_resize takes a float tensor, got {x.dtype}")


class _CropResizeFn(torch.autograd.Function):
    """K17 under autograd: the backward is K17's gather-form transpose."""

    @staticmethod
    def forward(ctx, x, apex, oh, ow):
        n, h, w, c = x.shape
        y = torch.empty((n, oh, ow, c), device=x.device, dtype=x.dtype)
        _lib.launch("vwfd_crop_resize_fwd", x.device, x.data_ptr(),
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
        gx = torch.empty(ctx.shape, device=g.device, dtype=g.dtype)
        _lib.launch("vwfd_crop_resize_bwd", g.device, g.data_ptr(),
                    apex.data_ptr(), gx.data_ptr(), n, h, w, c, g.shape[1],
                    g.shape[2])
        COUNT.n += 1
        return gx, None, None, None


def crop_resize(x: torch.Tensor, apex,
                out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Bilinear crop-and-resize of an NHWC float32 batch through the window
    ``apex`` to ``out_hw`` (default the input's size), differentiable in x:
    the CUDA kernels for a CUDA tensor, the plain version for a CPU
    tensor."""
    _check(x)
    apex = as_apex(apex, x.device)
    if not _lib.on_cuda(x, apex):
        return crop_resize_plain(x, apex, out_hw)
    if x.dtype != torch.float32:
        raise TypeError(f"the crop_resize kernel takes float32, got {x.dtype}")
    oh, ow = out_hw if out_hw is not None else x.shape[1:3]
    return _CropResizeFn.apply(x, apex, int(oh), int(ow))
