"""K24 `diffjpeg`: the reference's DiffJPEG (utils/JPEG.py:501-540), forward
and backward with respect to the image.

Replaces ``vwfd_tpu/attacks/jpeg.py::diffjpeg`` (:114-146) with
``ops/color.py``'s DiffJPEG pair (:77-85), ``ops/filters.py::avg_pool_2x2``
(:133) and the centred ``ops/dct.py::dct8x8``/``idct8x8``. Per frame of
(N, H, W, 3) float32, H and W multiples of 16::

    ycc   = YCbCr(255·x) + (0, 128, 128); Cb, Cr → their 2×2 means
    d     = r0(c/t)·t per 8×8 block, c = DCT(plane − 128), t = Tᵀ·factor
    y     = clip(RGB(IDCT(d) + 128, chroma repeated 2×2), 0, 255) / 255

with r0(v) = v³ where |v| < ½, else v, Tᵀ the transposed Annex-K tables and
``factor`` (N,) float32 each frame's quality factor
(``ops/quantize.py::quality_to_factor``), which takes no gradient. The
clip's derivative is JAX's: ½ at exactly 0 or 255 (``jnp.clip`` is
``minimum(maximum(·))``, whose derivatives split ties), which
``torch.clamp`` (1 there) would not give; the plain version takes
``torch.maximum``/``torch.minimum``, which split ties as JAX does.

Bound: bytes (forward x and y, 24 bytes a pixel; backward x, g and gx, 36).
At the JPEG-vs-adversarial study's single 32² image that is 24.6 KB each
way, nanoseconds of bytes: a macroblock's chain of dependent steps and the
launch's fixed cost are its time.

Design (``csrc/diffjpeg.cu``, redesigned for Hopper): two routes, which
``plan`` picks from the shape and the card's SM count, and the launch
follows. The bytes route (a batch: ``BYTES_MBS_PER_SM`` macroblocks an SM
or more, in units on average at least seven eighths full) is K5's
structure on units of 16 rows × up to 128 pixels of one frame: persistent
CTAs, a producer warp's bulk copies into a two-stage mbarrier ring,
sixteen threads a macroblock each running K5's per-thread chain on three
block columns, stores from the stage. The latency route (fewer
macroblocks, as the study's single 32² image, or narrow frames) gives
each macroblock a CTA of 384 threads, a thread per value of each of the
four separable passes. The backward recomputes the forward from x (the clip's
and the soft round's derivatives need its values) and runs the transposed
chain. Both routes take every value through the same operations in the
same order, so they equal each other and the first version (one route)
bit for bit (``port_tools/k24_identity.py --compare`` holds two builds
on the card). The colour maps, the means, c/t, the soft round and the
clip are rounded operation by operation in this plain version's order;
the DCT sums in another order than ``torch.matmul``, so a coefficient within
rounding of r0's jump at |c/t| = ½ may round the other way: kernel and
plain then part on that macroblock. ``tie_macroblocks`` names the
macroblocks where the plain version sits that close to a step; the checks
of the kernel (``chip_smoke.py``, tests/test_torch_gpu.py) excuse those
and no others.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _lib
from ..ops.color import rgb_to_ycbcr_diffjpeg, ycbcr_to_rgb_diffjpeg
from ..ops.dct import (C_TABLE, Y_TABLE, block_merge, block_split,
                       dct_blocks, idct_blocks)
from ..ops.filters import avg_pool_2x2
from ..ops.quantize import clip_ties_half, round_only_at_0

__all__ = ["diffjpeg", "diffjpeg_plain", "tie_macroblocks", "TABLES_T",
           "COUNT", "plan", "Plan", "ROUTES"]

COUNT = _lib.LaunchCount("diffjpeg")

# ``tie_macroblocks``' defaults: how far the kernel's float32 coefficients
# and pre-clip values (0..255 scale) may sit from the plain version's (its
# DCT sums in another order): about four times the plain version's own
# float32-to-float64 distance, 7e-5 for both at 256²
# (tests/test_torch_diffjpeg.py::test_tie_macroblocks_cover_float32_noise)
JUMP_TOL = 3e-4
CLIP_TOL = 3e-4

# DiffJPEG takes the Annex-K tables transposed (utils/JPEG.py:98-111;
# vwfd_tpu/attacks/jpeg.py:110-111): (2, 8, 8), Y then chroma
TABLES_T = np.stack([Y_TABLE.T, C_TABLE.T])


# csrc/diffjpeg.cu's routes (its ``Route``), the bytes route's unit width
# in macroblocks (``kUnitMB``) and its persistent CTAs an SM, forward and
# backward (``kCtasFwd``, ``kCtasBwd``: what shared memory allows)
ROUTES = {"bytes": 0, "latency": 1}
UNIT_MBS = 8
CTAS_PER_SM = (4, 2)
INT_MAX = 2 ** 31 - 1

# ``plan``'s crossover. Both routes timed on the whole card, forward +
# backward (NVIDIA H100 80GB HBM3, 132 SMs, 700 W;
# port_tools/ablate_diffjpeg.py --variants --shapes): the latency route
# takes about 24 ns a macroblock past a 4 µs floor, the bytes route about
# 24 µs until every backward CTA holds a unit and 73 ns a unit past it.
# The latency route won at 768 macroblocks (three 256² frames, 1.14×) and
# wherever units were 6 of 8 full or less (256 frames of 64 × 96, 1.10×;
# of 64², 1.9×; of 32², 3.2×); the bytes route at 1,024 (1.09×) and 2,048
# (1.7×) in full units, and at 64 frames of 64 × 1040 (7.2 of 8, 2.4×).
BYTES_MBS_PER_SM = 6


class Plan(NamedTuple):
    """How K24 covers an (N, H, W, 3) batch: ``route`` "bytes" (persistent
    CTAs, each a contiguous range of ``units``, a unit 16 rows × up to
    ``UNIT_MBS`` macroblocks of one frame) or "latency" (a CTA a macroblock,
    grid-stride); ``grid_fwd``, ``grid_bwd`` the CTAs of the forward and
    the backward."""
    route: str
    macroblocks: int
    units: int
    grid_fwd: int
    grid_bwd: int


def plan(n: int, h: int, w: int, sms: int,
         route: Optional[str] = None) -> Plan:
    """K24's route and grids for an (n, h, w, 3) batch on a card of ``sms``
    SMs. ``route`` None picks: the bytes route where there are at least
    ``BYTES_MBS_PER_SM`` macroblocks an SM and the units hold on average
    at least seven eighths of ``UNIT_MBS`` (a narrow unit costs the bytes
    route's backward more than a full one), else the latency route.
    "bytes" or "latency" takes that route (the tests and the measuring
    tools run every shape down both). The bytes route's grids are at most
    ``CTAS_PER_SM`` an SM and one CTA a unit; the latency route's a CTA a
    macroblock. Raises where the kernel refuses: H or W not a multiple of
    16, more than INT_MAX macroblocks."""
    if h % 16 or w % 16:
        raise ValueError(f"diffjpeg: H and W must be multiples of 16, got "
                         f"{h} x {w}")
    mbs = n * (h // 16) * (w // 16)
    if mbs > INT_MAX:
        raise ValueError(f"diffjpeg: {mbs} macroblocks, past INT_MAX")
    units = n * (h // 16) * -(-(w // 16) // UNIT_MBS)
    if route is None:
        route = "bytes" if (mbs >= BYTES_MBS_PER_SM * sms
                            and 8 * mbs >= 7 * UNIT_MBS * units) \
            else "latency"
    if route == "bytes":
        return Plan("bytes", mbs, units, min(units, sms * CTAS_PER_SM[0]),
                    min(units, sms * CTAS_PER_SM[1]))
    if route != "latency":
        raise ValueError(f"diffjpeg: route must be one of {sorted(ROUTES)},"
                         f" got {route!r}")
    return Plan("latency", mbs, units, mbs, mbs)


def _check(x: torch.Tensor, factor: torch.Tensor, dtypes) -> None:
    _lib.check_nhwc(x, "diffjpeg input")
    if x.dtype not in dtypes:
        raise TypeError(f"diffjpeg takes {dtypes}, got {x.dtype}")
    n, h, w, c = x.shape
    if c != 3 or h % 16 or w % 16:
        raise ValueError(f"diffjpeg: expected (N, H, W, 3) with H and W "
                         f"multiples of 16, got {tuple(x.shape)}")
    if tuple(factor.shape) != (n,) or factor.dtype != torch.float32 \
            or not factor.is_contiguous():
        raise ValueError(f"factor must be contiguous float32 ({n},), got "
                         f"{tuple(factor.shape)} {factor.dtype}")


def _plain_rgb(x: torch.Tensor, factor: torch.Tensor, coefs=None):
    """The plain version before its clip and /255, appending each plane's
    DCT coefficients c and divisors t (Y, Cb, Cr; (N, hb, wb, 8, 8) and
    (N, 1, 1, 8, 8)) to ``coefs`` where given."""
    n = x.shape[0]
    ycc = rgb_to_ycbcr_diffjpeg(x * 255.0)
    y = ycc[..., 0]
    cb = avg_pool_2x2(ycc[..., 1:2])[..., 0]
    cr = avg_pool_2x2(ycc[..., 2:3])[..., 0]
    tabs = torch.from_numpy(TABLES_T).to(x.device, x.dtype)
    f = factor.to(x.dtype).view(n, 1, 1, 1, 1)

    def comp(chan, tbl):
        c = dct_blocks(block_split(chan - 128.0))  # (N, hb, wb, 8, 8)
        t = tbl * f
        if coefs is not None:
            coefs.append((c, t))
        d = round_only_at_0(c / t) * t
        return block_merge(idct_blocks(d)) + 128.0

    y = comp(y, tabs[0])
    cb = comp(cb, tabs[1]).repeat_interleave(2, -2).repeat_interleave(2, -1)
    cr = comp(cr, tabs[1]).repeat_interleave(2, -2).repeat_interleave(2, -1)
    return ycbcr_to_rgb_diffjpeg(torch.stack([y, cb, cr], -1))


def diffjpeg_plain(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (gradients by autograd): the JAX package's
    ``diffjpeg`` op for op, each 8×8 block transformed on its own
    (``ops/dct.py``) where JAX contracts whole rows with ``I ⊗ C8``;
    float32, or float64 for a float64 parity test."""
    _check(x, factor.float() if x.dtype == torch.float64 else factor,
           (torch.float32, torch.float64))
    rgb = _plain_rgb(x, factor)
    return clip_ties_half(rgb, 0.0, 255.0) / torch.full(
        (), 255.0, dtype=x.dtype, device=x.device)


def tie_macroblocks(x: torch.Tensor, factor: torch.Tensor,
                    jump_tol: float = JUMP_TOL, clip_tol: float = CLIP_TOL):
    """The 16×16 macroblocks of ``x`` where the plain version sits within
    rounding of a step of DiffJPEG, as two (N, H/16, W/16) bool tensors:
    ``jump``, a coefficient with ||c| − t/2| ≤ ``jump_tol`` (r0's jump at
    |c/t| = ½: the forward and the gradient may part there), and ``grad``,
    ``jump`` or an RGB value before the clip within ``clip_tol`` of 0 or
    255 (the clip's derivative steps 1 → ½ → 0 there: the gradient may
    part). Every other macroblock of the kernel must match the plain
    version."""
    _check(x, factor, (torch.float32,))
    n, h, w, _ = x.shape
    coefs = []
    with torch.no_grad():
        rgb = _plain_rgb(x, factor, coefs)
    near = [((c.abs() - 0.5 * t).abs() <= jump_tol).flatten(-2).any(-1)
            for c, t in coefs]
    jump = near[0].reshape(n, h // 16, 2, w // 16, 2).any(4).any(2) \
        | near[1] | near[2]
    clip = ((rgb.abs() <= clip_tol) | ((rgb - 255.0).abs() <= clip_tol))
    clip = clip.reshape(n, h // 16, 16, w // 16, 16, 3).flatten(-1) \
        .any(-1).any(2).any(-1)
    return jump, jump | clip


class _DiffJpegKernel(torch.autograd.Function):
    """The kernels on ``p`` (``plan``'s pick, or a route a test or a
    measuring tool forces)."""

    @staticmethod
    def forward(ctx, x, factor, p):
        x = _lib.on_16(x)  # the bulk copies and 16-byte accesses
        n, h, w, _ = x.shape
        y = torch.empty_like(x)
        _lib.launch("vwfd_diffjpeg_fwd", x.device, x.data_ptr(),
                    y.data_ptr(), factor.data_ptr(), n, h, w,
                    ROUTES[p.route], p.grid_fwd)
        COUNT.n += 1
        ctx.save_for_backward(x, factor)
        ctx.plan = p
        return y

    @staticmethod
    def backward(ctx, g):
        x, factor = ctx.saved_tensors
        p = ctx.plan
        g = _lib.on_16(g.contiguous())
        n, h, w, _ = x.shape
        gx = torch.empty_like(x)
        _lib.launch("vwfd_diffjpeg_bwd", x.device, x.data_ptr(),
                    g.data_ptr(), gx.data_ptr(), factor.data_ptr(), n, h, w,
                    ROUTES[p.route], p.grid_bwd)
        COUNT.n += 1
        return gx, None, None


def diffjpeg(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """DiffJPEG of an NHWC float32 RGB batch in [0, 1], differentiable in x:
    the CUDA kernels (forward and backward) for CUDA tensors, the plain
    version for CPU tensors."""
    if not _lib.on_cuda(x, factor):
        return diffjpeg_plain(x, factor)
    _check(x, factor, (torch.float32,))
    n, h, w, _ = x.shape
    return _DiffJpegKernel.apply(x, factor.detach(),
                                 plan(n, h, w, _lib.sm_count(x.device)))
