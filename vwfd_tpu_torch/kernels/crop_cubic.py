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
image and writes 6.3 MB, the backward reads g and writes gx: about 3.5 µs
each way at 3.35 TB/s (H100 SXM data sheet, 700 W), near a launch's fixed
cost.

Design (``csrc/crop_cubic.cu``): a CTA of 256 threads takes one image,
``plan``'s band of rows and a column tile of up to 256 pixels, a thread a
pixel. The forward is separable: per output row a row pass reads the four
source rows of its taps as float4 runs into row sums in shared memory, a
column pass (the pixel's column taps in registers) sums four of them; the
next row's loads are issued before the column pass. The taps are
``csrc/cubic.cuh``'s, the plain version's float32 operations in its order
(the weights' FMAs written as ``__fmaf_rn``, nothing else contracted), and
the row sum is the very sum the plain version forms: the output EQUALS the
plain version. The backward is one launch with no scratch plane: a CTA takes
a band of input rows, finds on the device the output rows whose clamped
taps land on it, tabulates the output columns' taps once, lists each
pixel's column terms into registers, and walks the output rows: the
column sum over the terms (g read through L1, the loads issued together),
then wy times it into four accumulators that roll down the band, each row
stored once no later output row taps it. Terms are added in the first
version's order (j ascending, then i ascending, taps in order), so the
gradient is bit-equal to it: deterministic, no float atomics, NaN where
autograd's is, 0 outside the window; within ``CUBIC_GRAD_RTOL`` of the plain
gradient's max (autograd sums in another order, and on the card with
atomics). Every band row in the window is written, those no output row taps
(a downsampling ``out_hw`` skips rows) as 0. A pixel with more column terms
than registers hold (a window narrower than about 0.44 of the output's
width) has its sums formed by the CTA in shared memory, a thread a pixel and
an output row. The wrapper allocates ``y`` forward and ``gx``
backward and nothing else. Column tiles hold 256 pixels, fewer where a
forward tile's source columns (a downsampling ``out_hw``) would not fit a
CTA's shared memory, so no width or ``out_hw`` is refused.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from . import _lib
from .crop_resize import SMEM_CTA, as_apex
from ..ops.resize import crop_resize as _crop_resize

__all__ = ["crop_cubic", "crop_cubic_plain", "plan", "Plan", "fwd_span",
           "fwd_smem", "BWD_SMEM", "COUNT"]

COUNT = _lib.LaunchCount("crop_cubic")
_THREADS = 256             # csrc/crop_cubic.cu kThreads: a tile's pixels
_FWD_CTAS, _BWD_CTAS = 3, 3    # kFwdBlocks, kBwdBlocks: CTAs an SM
_CTAB, _TERMS, _HEAVY, _SPAN_PAD = 512, 10, 4, 6  # kCtab, kTerms, ...
_FWD_BAND = 8              # output rows a forward CTA
_BWD_BANDS = (8, 16, 4)    # input rows a backward CTA, in the order ties keep
SMEM_SM = 228 * 1024       # an SM's shared memory, 1 KB of it kept per CTA
# the backward CTA's shared memory (kBwdSmem): the row taps of 256 output
# rows (32 bytes each), the column taps of 512 output columns, each pixel's
# 10 column terms (8 bytes each), the CTA's range ends and heavy count, each
# heavy pixel's q and columns (12 bytes), and the heavy pixels' gt at a
# chunk's rows (4 × 256 of them, 4 channels)
BWD_SMEM = ((32 + 8 * _TERMS) * _THREADS + 32 * _CTAB + 16 + 12 * _THREADS
            + 16 * _HEAVY * _THREADS)


def fwd_span(tw: int, w: int, ow: int) -> int:
    """The most source columns a forward tile of ``tw`` output columns
    taps: its ends' bases differ by at most ⌊(tw − 1)·w/ow⌋ + 2 (the
    window is at most w wide; two float32 positions' floors), the taps
    reach 1 below and 2 above (``csrc/crop_cubic.cu`` ``fwd_span``)."""
    return min(w, (tw - 1) * w // ow + _SPAN_PAD)


def fwd_smem(band: int, tw: int, w: int, c: int, ow: int) -> int:
    """The forward CTA's shared memory: the band's row taps (32 bytes each)
    and the row sums, ``fwd_span``·C floats from the float4 boundary below
    the first, in whole float4s."""
    return 32 * band + 16 * ((fwd_span(tw, w, ow) * c + 6) // 4)


def _widest(n: int, fits) -> int:
    """The widest tile of at most 256 of ``n`` columns that ``fits``,
    evened out over the tiles it takes (0 if one column does not)."""
    lo, hi = 1, max(1, min(n, _THREADS))
    if not fits(lo):
        return 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    k = -(-n // lo)
    return -(-n // k) if n > 0 else 1


class Plan(NamedTuple):
    """Forward: CTAs of ``fwd_band`` output rows × ``fwd_tile`` output
    columns (``fwd_smem`` bytes each); backward: ``bwd_band`` input rows ×
    ``bwd_tile`` input columns (``BWD_SMEM`` bytes each)."""
    fwd_band: int
    fwd_tile: int
    bwd_band: int
    bwd_tile: int


def plan(n: int, h: int, w: int, c: int, oh: int, ow: int, sms: int
         ) -> Plan:
    """K20's launches for an (n, h, w, c) image to (oh, ow). A forward CTA
    takes image ``b // (bands·tiles)``, output rows ``[band·k, band·k +
    band)`` of ``k = (b // tiles) mod bands`` and tile ``b mod tiles``; the
    backward likewise over input rows and columns. The tiles are the widest
    of at most 256 pixels, the forward's where its CTA fits a third of an
    SM's shared memory (else a CTA's). The forward takes bands of 8 rows;
    the backward's minimise the waves of CTAs (three an SM) times the
    output rows each walks, (band + 3)·oh/h + 1 with the window the whole
    image, plus its set-up (about 3 rows). Raises ``ValueError`` where a
    pixel of ``c`` channels fits no forward CTA."""
    ow_ = max(ow, 1)
    fband = min(_FWD_BAND, max(oh, 1))
    cap = SMEM_SM // _FWD_CTAS - 1024
    tw = (_widest(ow, lambda t: fwd_smem(fband, t, w, c, ow_) <= cap)
          or _widest(ow, lambda t: fwd_smem(fband, t, w, c, ow_)
                     <= SMEM_CTA))
    if not tw:
        raise ValueError(f"crop_cubic kernel: a pixel of {c} channels does "
                         f"not fit a CTA's shared memory")
    tq = _widest(w, lambda t: True)
    best = None
    for band in _BWD_BANDS:
        band = min(band, max(h, 1))
        ctas = n * -(-h // band) * -(-w // tq)
        waves = -(-ctas // (_BWD_CTAS * sms))
        cost = waves * ((band + 3) * oh / max(h, 1) + 1 + 3)
        if best is None or cost < best[0]:
            best = (cost, band)
    return Plan(fband, tw, best[1], tq)


def crop_cubic_plain(x: torch.Tensor, apex,
                     out_hw: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version: ``crop_resize(x, apex, out_hw,
    method="bicubic")``."""
    return _crop_resize(x, as_apex(apex, x.device), out_hw, method="bicubic")


class _CropCubicFn(torch.autograd.Function):
    """K20 under autograd: the backward is K20's one-launch transpose."""

    @staticmethod
    def forward(ctx, x, apex, oh, ow):
        n, h, w, c = x.shape
        p = plan(n, h, w, c, oh, ow, _lib.sm_count(x.device))
        y = torch.empty((n, oh, ow, c), device=x.device, dtype=x.dtype)
        _lib.launch("vwfd_crop_cubic_fwd", x.device, x.data_ptr(),
                    apex.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow,
                    p.fwd_band, p.fwd_tile)
        COUNT.n += 1
        ctx.save_for_backward(apex)
        ctx.shape, ctx.plan = (n, h, w, c), p
        return y

    @staticmethod
    def backward(ctx, g):
        apex, = ctx.saved_tensors
        n, h, w, c = ctx.shape
        g = g.contiguous()
        oh, ow = g.shape[1:3]
        gx = torch.empty(ctx.shape, device=g.device, dtype=g.dtype)
        _lib.launch("vwfd_crop_cubic_bwd", g.device, g.data_ptr(),
                    apex.data_ptr(), gx.data_ptr(), n, h, w, c, oh, ow,
                    ctx.plan.bwd_band, ctx.plan.bwd_tile)
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
