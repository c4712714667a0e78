"""K16 `zigzag_jpeg`: HiDDeN's JPEG-mask compression and its clip, forward
and backward with respect to the image.

Replaces ``vwfd_tpu/attacks/jpeg.py::hidden_jpeg_mask_compression``
(:249-258) with the clip of ``vwfd_tpu/models/hidden_model.py:40-42``, and
the ops under it: ``ops/color.py::rgb_to_yuv_analog`` /
``yuv_to_rgb_analog`` (:87-94) and ``ops/dct.py::dct8x8`` / ``idct8x8``
(:55-90). Per 8×8 block and channel::

    c = DCT8x8(YUV(x)) · keep,   z = RGB(IDCT8x8(c)),   y = clip01(z)

``keep`` is the zig-zag keep mask of each channel (``keep=(25, 9, 9)``
coefficients of Y, U, V), ``clip01`` ``jnp.clip(·, 0, 1)``, whose gradient
is ½ where z is exactly 0 or 1 (``torch.minimum(torch.maximum(·))`` has
the same). The plain version is the JAX package's form: the analog colour
matrix, the blockwise ``C·B·Cᵀ`` products, the mask, ``Cᵀ·B·C``, the
analog "inverse" (the reference's constants, not its inverse) and the clip,
its gradient by autograd.

Bound: bytes. At the HiDDeN path's (8, 3, 128, 128) f32 the forward reads
and writes 1.57 MB each, about 0.94 µs at 3.35 TB/s (H100 SXM data sheet,
700 W): below a launch's fixed cost. What it buys on the path is launches:
the plain version is about ten (colour, relayout, two products, the mask,
two products, relayout, colour, clip).

Design (``csrc/zigzag.cu``, K5 ``jpeg_pair``'s): a CTA owns a unit of 8
image rows × up to 8 blocks (256 CTAs at HiDDeN's shape), a thread per
block column and channel; one thread moves the unit's rows into shared
memory with 1-D bulk copies on an mbarrier and stores the result from the
same stage. The DCT passes are 8-term FMA chains on the immediate matrix
that K5 shares (``csrc/common.cuh``), in registers, turned through a padded
shared-memory tile. The masked coefficients are multiplied by
0, so a NaN or Inf pixel makes its 8×8 block NaN, as in the plain version
(F21: JAX's dense block-diagonal einsum spreads it over the image). The
backward runs the transposed chain (the transposed colour matrices around
the same DCT, mask and IDCT, the DCT being orthonormal) on ``g·clip'(z)``,
``clip'`` as the plain version's autograd gives it (½ at 0 and 1, 1 at NaN,
exactly 0 outside [0, 1]), which the forward writes as a byte per value for
it (recomputing z from x timed slower on the card, PERF.md §6). The kernel
sums the DCT in another order than ``torch.matmul``: within 2e-6 of the
plain version forward and 1e-6 of the plain gradient's max backward. The
bulk copies need the image (or the cotangent) on a 16-byte boundary; a view
off it is copied first.
"""

import functools

import numpy as np
import torch

from . import _lib
from ..ops.color import rgb_to_yuv_analog, yuv_to_rgb_analog
from ..ops.dct import (block_merge, block_split, dct_blocks, idct_blocks,
                       zigzag_keep_mask)

__all__ = ["zigzag_jpeg", "zigzag_jpeg_plain", "clip01", "keep_blocks",
           "keep_bits", "HIDDEN_KEEP", "COUNT"]

COUNT = _lib.LaunchCount("zigzag_jpeg")

HIDDEN_KEEP = (25, 9, 9)  # coefficients kept of Y, U, V


@functools.lru_cache(maxsize=None)
def keep_blocks(keep=HIDDEN_KEEP) -> np.ndarray:
    """(3, 8, 8) float32: each channel's zig-zag keep mask of one block."""
    return np.stack([zigzag_keep_mask(8, k, 8, 8) for k in keep])


@functools.lru_cache(maxsize=None)
def keep_bits(keep=HIDDEN_KEEP):
    """Each channel's mask as the kernel takes it: bit 8k + l set where
    coefficient (k, l) is kept."""
    return tuple(int(sum(1 << i for i, v in enumerate(m.reshape(-1)) if v))
                 for m in keep_blocks(keep))


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``: NaN passes, gradient ½ at 0 and 1."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _check(x: torch.Tensor, keep) -> None:
    _lib.check_nhwc(x, "zigzag_jpeg input")
    if not x.is_floating_point():
        raise TypeError(f"zigzag_jpeg takes a float tensor, got {x.dtype}")
    _, h, w, c = x.shape
    if c != 3 or h % 8 or w % 8:
        raise ValueError(f"zigzag_jpeg: expected (N, H, W, 3) with H and W "
                         f"multiples of 8, got {tuple(x.shape)}")
    if len(keep) != 3 or not all(0 <= k <= 64 for k in keep):
        raise ValueError(f"zigzag_jpeg: keep takes 3 counts in [0, 64], "
                         f"got {keep}")


def zigzag_jpeg_plain(x: torch.Tensor, keep=HIDDEN_KEEP, clip: bool = False
                      ) -> torch.Tensor:
    """Plain PyTorch version (gradients by autograd), in x's dtype."""
    keep = tuple(keep)
    _check(x, keep)
    yuv = rgb_to_yuv_analog(x)
    coeff = dct_blocks(block_split(yuv.movedim(-1, -3)))  # (N,3,hb,wb,8,8)
    m = torch.from_numpy(keep_blocks(keep)).to(x.device)[:, None, None]
    rgb = yuv_to_rgb_analog(
        block_merge(idct_blocks(coeff * m)).movedim(-3, -1))
    return clip01(rgb) if clip else rgb


def _launch(x, g, code, keep, clip):
    """One launch: the forward (``g`` None) of x, writing the clip's codes
    where ``code`` is given; the backward of g, reading them. ``x`` or ``g``
    is on a 16-byte boundary; ``out`` is new, so it is too."""
    src = x if g is None else g
    out = torch.empty_like(src)
    n, h, w, _ = src.shape
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    _lib.launch("vwfd_zigzag_jpeg", src.device, ptr(x), ptr(g), ptr(out),
                ptr(code), *keep_bits(keep), n, h, w, int(clip),
                int(g is not None))
    COUNT.n += 1
    return out


class _ZigzagFn(torch.autograd.Function):
    """K16 under autograd: the backward is K16's backward kernel, on the
    clip's derivative that the forward saved as a byte per value."""

    @staticmethod
    def forward(ctx, x, keep, clip):
        ctx.keep, ctx.clip = keep, clip
        code = (torch.empty(x.shape, device=x.device, dtype=torch.uint8)
                if clip and ctx.needs_input_grad[0] else None)
        ctx.save_for_backward(code)
        return _launch(_lib.on_16(x), None, code, keep, clip)

    @staticmethod
    def backward(ctx, g):
        code, = ctx.saved_tensors
        return _launch(None, _lib.on_16(g.contiguous()), code, ctx.keep,
                       ctx.clip), None, None


def zigzag_jpeg(x: torch.Tensor, keep=HIDDEN_KEEP, clip: bool = False
                ) -> torch.Tensor:
    """The zig-zag JPEG-mask compression of an NHWC float32 RGB batch (and
    with ``clip`` the clip to [0, 1]), differentiable in x: the CUDA
    kernels for a CUDA tensor, the plain version for a CPU tensor."""
    keep = tuple(keep)
    _check(x, keep)
    if not _lib.on_cuda(x):
        return zigzag_jpeg_plain(x, keep, clip)
    if x.dtype != torch.float32:
        raise TypeError(f"the zigzag_jpeg kernel takes float32, got {x.dtype}")
    return _ZigzagFn.apply(x, keep, bool(clip))
