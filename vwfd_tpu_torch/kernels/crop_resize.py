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

Bound: bytes. At the HiDDeN path's (8, 128, 128, 3) f32 the forward reads
at most the whole image and writes 1.57 MB, under a microsecond at 3.35 TB/s
(H100 SXM data sheet, 700 W): below a launch's fixed cost. On the path it
replaces a gather chain (coordinates, floors, clamps, four gathers, the
products and sums) with one launch.

Design (``csrc/crop_resize.cu``): a CTA owns a band of 4 rows of one image
(256 CTAs at HiDDeN's shape) and builds the tap tables it needs once, in
shared memory, with the plain version's float32 operations. The forward
bulk-copies the run of window rows its output band taps into shared memory,
gathers each output pixel's four taps there, each product and sum one IEEE
rounding in the plain order (EQUAL to the plain version), and bulk-stores
the band. The backward is the separable transpose in autograd's order: the
band of input rows finds the output rows and columns that tap it from the
monotone tables (no search, no division per pixel), bulk-copies that run of
g, sums the W transpose and then the H transpose in shared memory, each
tap's terms apart as autograd's two index_adds keep them (a NaN in g
reaches the same pixels), and bulk-stores the band: deterministic, no
float atomics, within 1e-6 of the plain gradient's max (autograd sums the
same products in another order). Rows not a multiple of 16 bytes take
element-wise copies in the same kernels.

Size limit: a CTA holds whole rows in shared memory, at least one row of
each kind and the tap tables of both axes, within the card's 227 KB a CTA
(``max_width``). RGB images fit up to 2,234 pixels square (1920 × 1080
too); a larger CUDA input raises ``ValueError`` before any launch. The
plain version (CPU tensors) has no limit.
"""

from typing import Optional, Sequence, Tuple, Union

import torch

from . import _lib
from ..ops.resize import crop_resize as crop_resize_plain

__all__ = ["crop_resize", "crop_resize_plain", "as_apex", "smem_bytes",
           "max_width", "COUNT"]

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


SMEM_CTA = 227 * 1024  # sm_90's shared memory a CTA


def smem_bytes(h: int, w: int, c: int, oh: int, ow: int) -> Tuple[int, int]:
    """The shared memory of the kernels' smallest CTAs, (forward,
    backward): one band row, its three staged input rows and its output row;
    one band row, one staged g row and their sums, with the tables of both
    axes (``fwd_smem`` and ``bwd_smem`` of ``csrc/crop_resize.cu`` at one
    row)."""
    head, taps = 64, 16
    fwd = head + (ow + 1) * taps + (min(h, 3) * w + ow) * c * 4
    bwd = (head + (oh + ow + w + 1) * taps + (2 * ow * 4 + 15) // 16 * 16
           + (3 * w + ow) * c * 4)
    return fwd, bwd


def max_width(h: int, c: int, oh: int) -> int:
    """The widest input (and output, of the same width) whose forward and
    backward fit the kernels, for ``h`` rows, ``c`` channels and ``oh``
    output rows."""
    lo, hi = 0, SMEM_CTA
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if max(smem_bytes(h, mid, c, oh, mid)) <= SMEM_CTA:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _check_fits(shape, oh: int, ow: int, backward: bool) -> None:
    _, h, w, c = shape
    need = smem_bytes(h, w, c, oh, ow)[int(backward)]
    if need > SMEM_CTA:
        raise ValueError(
            f"crop_resize kernel: rows too wide for shared memory: "
            f"{tuple(shape)} to ({oh}, {ow}) needs {need} bytes a CTA "
            f"{'backward' if backward else 'forward'}, the card holds "
            f"{SMEM_CTA} (max_width)")


class _CropResizeFn(torch.autograd.Function):
    """K17 under autograd: the backward is K17's separable transpose."""

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
    oh, ow = (int(v) for v in (out_hw if out_hw is not None
                               else x.shape[1:3]))
    _check_fits(x.shape, oh, ow, False)
    if torch.is_grad_enabled() and x.requires_grad:
        _check_fits(x.shape, oh, ow, True)
    return _CropResizeFn.apply(x, apex, oh, ow)
