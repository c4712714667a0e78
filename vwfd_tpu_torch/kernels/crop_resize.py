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

Column tiles (F22): where whole rows do not fit a CTA's shared memory
(``max_width``: RGB up to 2,234 pixels square, 1920 × 1080 too), the grid
takes a second dimension of column tiles, each tile's tap tables and index
ranges limited to the tile (``tiles`` picks the widest tile whose CTA fits
two an SM, in tiles of equal width). The forward CTA owns a band of output
rows × a run of output columns and stages the one run of input columns
their taps reach; the backward CTA owns a band of input rows × a run of
input columns, finds the output rows and columns that tap them by binary
search of the monotone tables (written whole to a scratch tensor by a
first small kernel) and sums them in chunks, each tap's terms
apart, in the whole-row kernel's order: the same results, forward EQUAL,
gradient bit-identical to the whole-row kernel's. Where whole rows fit (the
HiDDeN path's 128²) the whole-row kernels run, one tile a row, as before.
Limit: a tile of one column stages 3 × 3 pixels, so no width or height is
refused; only a pixel of more than about 6,000 float32 channels (9 of them
past the card's 227 KB a CTA) raises ``ValueError`` before any launch. The
plain version (CPU tensors) has no limit.
"""

from typing import Optional, Sequence, Tuple, Union

import torch

from . import _lib
from ..ops.resize import crop_resize as crop_resize_plain

__all__ = ["crop_resize", "crop_resize_plain", "as_apex", "smem_bytes",
           "max_width", "tiles", "COUNT"]

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
SMEM_PAIR = 110 * 1024  # a CTA's share where two fit an SM
_HEAD, _TAPS, _BAND, _CHUNK_TILED = 64, 16, 4, 8  # csrc/crop_resize.cu's


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def smem_bytes(h: int, w: int, c: int, oh: int, ow: int) -> Tuple[int, int]:
    """The shared memory of the whole-row kernels' smallest CTAs, (forward,
    backward): one band row, its three staged input rows and its output
    row; one band row, one staged g row and their sums, with the tables of
    both axes (``fwd_smem`` and ``bwd_smem`` of ``csrc/crop_resize.cu`` at
    one row)."""
    fwd = _HEAD + (ow + 1) * _TAPS + (min(h, 3) * w + ow) * c * 4
    bwd = (_HEAD + (oh + ow + w + 1) * _TAPS + _align16(2 * ow * 4)
           + (3 * w + ow) * c * 4)
    return fwd, bwd


def max_width(h: int, c: int, oh: int) -> int:
    """The widest input (and output, of the same width) whose forward and
    backward rows fit the whole-row kernels, for ``h`` rows, ``c`` channels
    and ``oh`` output rows; wider rows take column tiles."""
    lo, hi = 0, SMEM_CTA
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if max(smem_bytes(h, mid, c, oh, mid)) <= SMEM_CTA:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _fwd_tiled_smem(h, w, c, oh, ow, tw) -> int:
    """``fwd_tiled_smem`` at the band the launcher picks for ``tw``."""
    r = _BAND
    while True:
        kx = min(h, ((r - 1) * h + oh - 1) // oh + 3)
        kwc = min(w, ((tw - 1) * w + ow - 1) // ow + 3) * c
        smem = _HEAD + (tw + r) * _TAPS + kx * kwc * 4
        if smem <= SMEM_PAIR or r == 1:
            return smem
        r //= 2


def _bwd_tiled_smem(c, oh, ow, tq) -> int:
    """``bwd_tiled_smem`` at the chunks the launcher picks for ``tq``."""
    ki, kj = min(oh, _CHUNK_TILED), min(ow, 2 * tq + 8)
    return (_HEAD + (_BAND + tq + ki) * _TAPS + _align16(2 * kj * 4)
            + (ki * kj + 2 * ki * tq + 2 * _BAND * tq) * c * 4)


def _widest(n: int, smem_of) -> int:
    """The widest tile of ``n`` columns whose CTA fits two an SM (else one),
    evened out over the tiles it takes."""
    for cap in (SMEM_PAIR, SMEM_CTA):
        if smem_of(1) <= cap:
            lo, hi = 1, n
            while lo < hi:
                mid = (lo + hi + 1) // 2
                lo, hi = (mid, hi) if smem_of(mid) <= cap else (lo, mid - 1)
            k = -(-n // lo)
            return -(-n // k)
    raise ValueError(f"crop_resize kernel: a tile of one column needs "
                     f"{smem_of(1)} bytes of shared memory, the card holds "
                     f"{SMEM_CTA} a CTA (too many channels)")


def tiles(h: int, w: int, c: int, oh: int, ow: int) -> Tuple[int, int]:
    """The column tile widths of the (forward, backward) launches: ``ow``
    and ``w`` (whole rows, one tile a row) where whole rows fit a CTA,
    else the widest tile that fits."""
    fwd, bwd = smem_bytes(h, w, c, oh, ow)
    return (ow if fwd <= SMEM_CTA else _widest(
                ow, lambda t: _fwd_tiled_smem(h, w, c, oh, ow, t)),
            w if bwd <= SMEM_CTA else _widest(
                w, lambda t: _bwd_tiled_smem(c, oh, ow, t)))


class _CropResizeFn(torch.autograd.Function):
    """K17 under autograd: the backward is K17's separable transpose."""

    @staticmethod
    def forward(ctx, x, apex, oh, ow):
        n, h, w, c = x.shape
        tw, ctx.tq = tiles(h, w, c, oh, ow)
        y = torch.empty((n, oh, ow, c), device=x.device, dtype=x.dtype)
        _lib.launch("vwfd_crop_resize_fwd", x.device, x.data_ptr(),
                    apex.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow, tw)
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
        gx = torch.empty(ctx.shape, device=g.device, dtype=g.dtype)
        # the tiled backward's tap tables, 16 bytes an entry
        tables = (torch.empty(4 * (oh + ow), device=g.device) if ctx.tq < w
                  else None)
        _lib.launch("vwfd_crop_resize_bwd", g.device, g.data_ptr(),
                    apex.data_ptr(), gx.data_ptr(),
                    0 if tables is None else tables.data_ptr(), n, h, w, c,
                    oh, ow, ctx.tq)
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
    return _CropResizeFn.apply(x, apex, oh, ow)
