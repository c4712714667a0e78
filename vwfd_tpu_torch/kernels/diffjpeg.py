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
way, nanoseconds of bytes: the launch's fixed cost is its time.

Design (``csrc/diffjpeg.cu``, a first version): a CTA of 256 threads takes
four 16×16 macroblocks; a thread per pixel maps to YCbCr in shared memory,
the chroma is pooled there, eight threads own each 8×8 block (one column
each, K5's separable passes and padded transposes), and a thread per pixel
maps back. The backward recomputes the forward from x (the clip's and the
soft round's derivatives need its values) and runs the transposed chain
in place. The colour maps, the means, c/t, the soft round and the clip are
rounded operation by operation in this plain version's order; the DCT sums
in another order than ``torch.matmul``, so a coefficient within rounding
of r0's jump at |c/t| = ½ may round the other way: kernel and plain then
part on that macroblock. ``tie_macroblocks`` names the macroblocks where
the plain version sits that close to a step; the checks of the kernel
(``chip_smoke.py``, tests/test_torch_gpu.py) excuse those and no others.
"""

import numpy as np
import torch

from . import _lib
from ..ops.color import rgb_to_ycbcr_diffjpeg, ycbcr_to_rgb_diffjpeg
from ..ops.dct import (C_TABLE, Y_TABLE, block_merge, block_split,
                       dct_blocks, idct_blocks)
from ..ops.filters import avg_pool_2x2
from ..ops.quantize import clip_ties_half, round_only_at_0

__all__ = ["diffjpeg", "diffjpeg_plain", "tie_macroblocks", "TABLES_T",
           "COUNT"]

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
    @staticmethod
    def forward(ctx, x, factor):
        n, h, w, _ = x.shape
        y = torch.empty_like(x)
        _lib.launch("vwfd_diffjpeg_fwd", x.device, x.data_ptr(),
                    y.data_ptr(), factor.data_ptr(), n, h, w)
        COUNT.n += 1
        ctx.save_for_backward(x, factor)
        return y

    @staticmethod
    def backward(ctx, g):
        x, factor = ctx.saved_tensors
        g = g.contiguous()
        n, h, w, _ = x.shape
        gx = torch.empty_like(x)
        _lib.launch("vwfd_diffjpeg_bwd", x.device, x.data_ptr(),
                    g.data_ptr(), gx.data_ptr(), factor.data_ptr(), n, h, w)
        COUNT.n += 1
        return gx, None


def diffjpeg(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """DiffJPEG of an NHWC float32 RGB batch in [0, 1], differentiable in x:
    the CUDA kernels (forward and backward) for CUDA tensors, the plain
    version for CPU tensors."""
    if not _lib.on_cuda(x, factor):
        return diffjpeg_plain(x, factor)
    _check(x, factor, (torch.float32,))
    return _DiffJpegKernel.apply(x, factor.detach())
