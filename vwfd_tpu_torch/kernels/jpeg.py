"""K5 `jpeg_pair`: the attack pool's two fused JPEG draws, forward and
backward with respect to the image.

Replaces ``vwfd_tpu/attacks/jpeg.py::jpeg_pool_pair`` (:183-223) with
``ops/color.py::rgb_to_yuv_jpegbasic``/``yuv_to_rgb_jpegbasic`` (:61-75) and
``ops/dct.py::dct8x8``/``idct8x8`` (:55-86). Per frame::

    c   = DCT8x8(YUV(255·x))
    d_j = c·zonal (mode 2) | rint(c/q_j)·q_j (mode 0) | r0(c/q_j)·q_j (mode 1)
    y   = (w1+w2)·RGB(IDCT((w1·d_1 + w2·d_2)/(w1+w2))) / 255

with r0(v) = v³ where |v| < ½, else v, and the zonal mask keeping Y 5×5 and
chroma 3×3. ``qt`` holds each frame's quantisation tables, (N, 2 draws,
2 tables Y/C, 8, 8) float32, computed by ``attacks/jpeg.py::quant_tables``
with the plain version's own ops, so the kernel does no scale arithmetic
and ``rint`` sees the same tables; ``mode`` (N, 2) int32 and ``w`` (N, 2)
float32 are the per-frame draws and weights. The draws and weights take no
gradient. ``subsample=2`` is ``jpeg_basic(subsample=2)``'s 4:2:0 chroma
(``vwfd_tpu/attacks/jpeg.py:67-75``): before the DCT each 8×8 block's
chroma is taken from the even row and column of each 2×2; the backward
gathers the four copies' gradients into the source pixel. ``subsample=0``
launches the same code as before the option existed.

Bound: bytes. At the training shape (64 frames of 256²×3 f32) the forward
reads and writes 50.3 MB each, 0.030 ms at 3.35 TB/s; the backward reads x
and g and writes gx, 0.045 ms; the arithmetic, about 0.8 GFLOP a pass, takes
about 0.012 ms at the f32 FMA peak.

Design (``csrc/jpeg.cu``): the first design loaded both operands of every
DCT term from shared memory, so the rate of shared-memory loads, not
bytes, set its pace. Now persistent CTAs (two per SM) walk 8-row bands of up to 256
pixels; a producer warp moves each band with 1-D bulk copies through a
two-stage mbarrier ring (the next band loads while this one computes) and
copies a frame's quantisation tables once per stage and frame. Eight
threads own an 8×8 block, one column each: the separable passes are 8-term
FMA chains in registers whose matrix operand is an immediate (the DCT
matrix is compiled in; a CPU test checks the literals bit for bit), with
padded shared-memory tiles only for the two transposes. The backward
recomputes c from x rather than storing it. The colour maps, c/q (a
correctly rounded division), the rounding and the mix are rounded
operation by operation in the plain version's order, and the forward
coefficients sum as the first design's did (columns, then rows); they sum
in another order than ``torch.matmul``, so a coefficient that lies within
rounding of a .5 boundary may round the other way: kernel and plain agree
to 1e-4 except in such blocks (``chip_smoke.py`` counts them). What bounds
it now is the instruction rate (four divisions a value forward).
"""

import functools

import numpy as np
import torch

from . import _lib
from ..ops.color import rgb_to_yuv_jpegbasic, yuv_to_rgb_jpegbasic
from ..ops.dct import block_merge, block_split, dct_blocks, idct_blocks
from ..ops.quantize import round_only_at_0

__all__ = ["jpeg_pair", "jpeg_pool_pair_plain", "zonal_mask", "COUNT"]

COUNT = _lib.LaunchCount("jpeg_pair")


@functools.lru_cache(maxsize=None)
def _zonal_np() -> np.ndarray:
    m = np.zeros((3, 8, 8), np.float32)
    m[0, :5, :5] = 1.0
    m[1:, :3, :3] = 1.0
    return m


def zonal_mask(device) -> torch.Tensor:
    """(3, 8, 8): the JpegMask keep-mask per channel (Y 5×5, chroma 3×3)."""
    return torch.from_numpy(_zonal_np()).to(device)


_SUB_ROWS = (0, 0, 2, 2, 4, 4, 6, 6)  # 4:2:0: each 2×2 takes its even corner


def _check(x, qt, mode, w, dtypes=(torch.float32,), subsample=0) -> None:
    if subsample not in (0, 2):
        raise ValueError(f"subsample must be 0 or 2, got {subsample!r}")
    _lib.check_nhwc(x, "jpeg_pair input")
    if x.dtype not in dtypes:
        raise TypeError(f"jpeg_pair takes {dtypes}, got {x.dtype}")
    n, h, wd, c = x.shape
    if c != 3 or h % 8 or wd % 8:
        raise ValueError(f"jpeg_pair: expected (N, H, W, 3) with H and W "
                         f"multiples of 8, got {tuple(x.shape)}")
    if tuple(qt.shape) != (n, 2, 2, 8, 8) or qt.dtype != torch.float32 \
            or not qt.is_contiguous():
        raise ValueError(f"qt must be contiguous float32 ({n}, 2, 2, 8, 8), "
                         f"got {tuple(qt.shape)} {qt.dtype}")
    if tuple(mode.shape) != (n, 2) or mode.dtype != torch.int32 \
            or not mode.is_contiguous():
        raise ValueError(f"mode must be contiguous int32 ({n}, 2)")
    if tuple(w.shape) != (n, 2) or w.dtype != torch.float32 \
            or not w.is_contiguous():
        raise ValueError(f"w must be contiguous float32 ({n}, 2)")


def jpeg_pool_pair_plain(x: torch.Tensor, qt: torch.Tensor,
                         mode: torch.Tensor, w: torch.Tensor,
                         subsample: int = 0) -> torch.Tensor:
    """Plain PyTorch version (gradients by autograd through the torch ops):
    ``jpeg_pool_pair`` of the JAX package on explicit draws; float32, or
    float64 for the CPU parity tests' float64 steps."""
    _check(x, qt, mode, w, (torch.float32, torch.float64), subsample)
    n = x.shape[0]
    yuv = rgb_to_yuv_jpegbasic(x * 255.0)
    blocks = block_split(yuv.movedim(-1, -3))             # (N,3,hb,wb,8,8)
    if subsample:
        i = torch.tensor(_SUB_ROWS, device=x.device)
        chroma = blocks[:, 1:].index_select(-2, i).index_select(-1, i)
        blocks = torch.cat([blocks[:, :1], chroma], 1)
    coeff = dct_blocks(blocks)
    q = qt[:, :, [0, 1, 1]]                                # (N,2,3,8,8)
    zm = zonal_mask(x.device)[:, None, None]
    draws = []
    for j in range(2):
        qj = q[:, j, :, None, None]
        mj = mode[:, j].view(n, 1, 1, 1, 1, 1)
        scaled = coeff / qj
        quantized = torch.where(mj == 0, torch.round(scaled),
                                round_only_at_0(scaled)) * qj
        draws.append(torch.where(mj == 2, coeff * zm, quantized))
    w1, w2 = (w[:, j].view(n, 1, 1, 1, 1, 1) for j in range(2))
    ws = w1 + w2
    mixed = (w1 * draws[0] + w2 * draws[1]) / ws
    out = block_merge(idct_blocks(mixed)).movedim(-3, -1)
    rgb = yuv_to_rgb_jpegbasic(out)
    return ws.view(n, 1, 1, 1) * rgb / 255.0


class _JpegPairKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, qt, mode, w, subsample):
        n, h, wd, _ = x.shape
        y = torch.empty_like(x)
        _lib.launch("vwfd_jpeg_pair_fwd", x.device, x.data_ptr(),
                    y.data_ptr(), qt.data_ptr(), mode.data_ptr(),
                    w.data_ptr(), n, h, wd, int(bool(subsample)))
        COUNT.n += 1
        ctx.save_for_backward(x, qt, mode, w)
        ctx.subsample = subsample
        return y

    @staticmethod
    def backward(ctx, g):
        x, qt, mode, w = ctx.saved_tensors
        g = g.contiguous()
        n, h, wd, _ = x.shape
        gx = torch.empty_like(x)
        _lib.launch("vwfd_jpeg_pair_bwd", x.device, x.data_ptr(),
                    g.data_ptr(), gx.data_ptr(), qt.data_ptr(),
                    mode.data_ptr(), w.data_ptr(), n, h, wd,
                    int(bool(ctx.subsample)))
        COUNT.n += 1
        return gx, None, None, None, None


def jpeg_pair(x: torch.Tensor, qt: torch.Tensor, mode: torch.Tensor,
              w: torch.Tensor, subsample: int = 0) -> torch.Tensor:
    """The two-draw JPEG attack of an NHWC float32 RGB batch, differentiable
    in x: the CUDA kernels (forward and backward) for CUDA tensors, the
    plain version for CPU tensors; ``subsample=2`` takes 4:2:0 chroma."""
    if not _lib.on_cuda(x, qt, mode, w):
        return jpeg_pool_pair_plain(x, qt, mode, w, subsample)
    _check(x, qt, mode, w, subsample=subsample)
    _lib.check_aligned(x, "jpeg_pair input")
    return _JpegPairKernel.apply(x, qt, mode, w.detach(), subsample)
