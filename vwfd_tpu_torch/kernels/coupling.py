"""K2 `coupling_head`: one coupling half's head GEMM, bias and affine.

Replaces ``vwfd_tpu/nets/inn_packed.py::_st_packed`` / ``_st_unpacked``
from the concat on (:186-188, :195-198), and the affine lines of
``_coupling_fwd`` / ``_coupling_inv`` (:201-220) with
``vwfd_tpu/nets/inn.py::_e``::

    head = round_dt([xin | h] · Whᵀ)    (the 1×1 cat-skip head)
    s, t = split(head + bh)
    e    = exp(2·sigmoid(s) − 1) + 1e-4
    out  = e·x + t          (inverse: (x − t) / e)

``xin`` is the coupling's input half and ``h`` its trunk output; ``x`` and
``out`` are channel slices of the coupling's tensors (unit channel stride,
uniform row stride), so the result lands straight in the coupling's output.
``Wh`` (2C, K), the head transposed with K contiguous, and ``bh`` come from
``nets/inn_packed.py::pack_params`` with the head's outputs interleaved in
blocks of 8, ``[s c..c+7 | t c..c+7 | …]`` (``interleave_index``), so that
the kernel's accumulator fragments hold the s and t of the same channels.

Bound: at the flagship shapes (batch 16, 256², bf16) the level-48 coupling
(M = 65536, K = 224, N = 192) moves 54.6 MB for 5.6 GFLOP, bytes-bound at
about 16 µs; the 768-channel ones (M = 16384, K = 512, N = 768) move 42.7 MB
for 12.9 GFLOP, where bytes and tensor-core flops bind alike at about 13 µs
(3.35 TB/s and 989 TFLOP/s dense bf16, H100 SXM data sheet, 700 W).

Design (``csrc/coupling.cu``): a persistent tensor-core GEMM (``wgmma``,
f32 accumulators) whose blocks each keep one column slice of ``Wh`` in
shared memory and stream A in place from its two sources, ``xin`` then
``h``, through TMA tensor maps, so no concat and no head tensor touch device
memory; a producer warp feeds the rings of three or four consumer
warpgroups, which take 64-row tiles in turn so that one's epilogue overlaps
the others' products. The epilogue rounds the accumulator to the compute dtype,
adds the f32 bias and applies the affine with explicitly rounded
mul/add/div, following the plain version's order of operations. f32 takes
a CUDA-core tile (no TF32). The plain version is ``torch.cat`` +
``torch.matmul`` in the dtype, then ``coupling_affine_plain``.

Under autograd (a train step) the wrapper returns a fresh tensor through
``CouplingHeadFn``: the forward launches K2, the backward is
``coupling_head_backward`` in PyTorch — ∂/∂x = e(s) (1/e(s) inverse),
∂/∂t = 1 (−1/e(s)), ∂/∂s through e(s) = exp(2σ(s) − 1) + 1e-4, then the two
head products ``dHead·Wh`` and ``dHeadᵀ·[xin | h]`` with ``torch.matmul``,
as the JAX package leaves that GEMM to XLA.
"""

import functools
from typing import Dict, Optional

import numpy as np
import torch

from . import _lib

__all__ = ["coupling_head", "coupling_head_plain", "coupling_affine_plain",
           "coupling_head_backward", "CouplingHeadFn", "interleave_index",
           "deinterleave_index", "COUNT"]

COUNT = _lib.LaunchCount("coupling_head")
_EPS = 1e-4
_BLOCK = 8  # s/t interleave block (columns)


@functools.lru_cache(maxsize=None)
def interleave_index(n2c: int) -> np.ndarray:
    """Column order of the interleaved head: interleaved column j holds the
    (s ‖ t) column ``idx[j]``; blocks of 8 alternate s and t of the same 8
    channels."""
    c = n2c // 2
    if n2c % 2 or c % _BLOCK:
        raise ValueError(f"head width {n2c}: the s/t interleave needs a "
                         f"multiple of {2 * _BLOCK} columns")
    j = np.arange(n2c)
    blk, w = j // _BLOCK, j % _BLOCK
    return np.where(blk % 2 == 0, 0, c) + (blk // 2) * _BLOCK + w


@functools.lru_cache(maxsize=None)
def deinterleave_index(n2c: int) -> np.ndarray:
    """Inverse of ``interleave_index``: (s ‖ t) column i is interleaved
    column ``idx[i]``."""
    return np.argsort(interleave_index(n2c))


def _row_stride(t: torch.Tensor, name: str) -> int:
    """Row stride of an NHWC tensor seen as (N·H·W, C); raises unless the
    channel stride is 1 and rows are uniformly spaced (a channel slice of a
    contiguous tensor)."""
    if t.dim() != 4:
        raise ValueError(f"{name}: expected NHWC, got {tuple(t.shape)}")
    n, h, w, c = t.shape
    sn, sh, sw, sc = t.stride()
    ld = sw
    if sc != 1 or (h > 1 and sh != w * ld) or (n > 1 and sn != h * w * ld):
        raise ValueError(f"{name}: expected unit channel stride and uniform "
                         f"rows, got strides {t.stride()}")
    return ld


def _check_affine(head, bias, x, out):
    _lib.check_nhwc(head, "head")
    code = _lib.dtype_code(head)
    n, h, w, c2 = head.shape
    c = c2 // 2
    if c2 % 2 or tuple(x.shape) != (n, h, w, c):
        raise ValueError(f"head {tuple(head.shape)} and x {tuple(x.shape)} "
                         f"disagree (head holds s ‖ t for x's channels)")
    if out.shape != x.shape:
        raise ValueError(f"out {tuple(out.shape)} != x {tuple(x.shape)}")
    if x.dtype != head.dtype or out.dtype != head.dtype:
        raise TypeError("head, x and out must share one dtype")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (c2,) \
            or not bias.is_contiguous():
        raise ValueError(f"bias must be contiguous float32 ({c2},)")
    return code, _row_stride(x, "x"), _row_stride(out, "out")


def coupling_affine_plain(head: torch.Tensor, bias: torch.Tensor,
                          x: torch.Tensor, out: Optional[torch.Tensor] = None,
                          inverse: bool = False) -> torch.Tensor:
    """The affine alone, on a head in (s ‖ t) order: f32 arithmetic, one
    rounding to the dtype; writes into ``out`` and returns it."""
    out = torch.empty_like(x) if out is None else out
    _check_affine(head, bias, x, out)
    c = x.shape[-1]
    st = head.float() + bias
    s, t = st[..., :c], st[..., c:]
    e = torch.exp(2.0 * torch.sigmoid(s) - 1.0) + _EPS
    xf = x.float()
    out.copy_((xf - t) / e if inverse else e * xf + t)
    return out


def _check_head(xin, h, p, x, out):
    wh, bh = p["wh"], p["bh"]
    for t, name in ((xin, "xin"), (h, "h"), (x, "x"), (out, "out")):
        if t.dim() != 4:
            raise ValueError(f"{name}: expected NHWC, got {tuple(t.shape)}")
    code = _lib.dtype_code(x)
    if any(t.dtype != x.dtype for t in (xin, h, wh, out)):
        raise TypeError("xin, h, wh, x and out must share one dtype")
    n, hh, ww, c = x.shape
    if tuple(out.shape) != tuple(x.shape) or tuple(xin.shape[:3]) != \
            (n, hh, ww) or tuple(h.shape[:3]) != (n, hh, ww):
        raise ValueError(f"xin {tuple(xin.shape)}, h {tuple(h.shape)}, x "
                         f"{tuple(x.shape)} and out {tuple(out.shape)} must "
                         f"share N, H, W (and x, out their channels)")
    kx, f = xin.shape[-1], h.shape[-1]
    if c % _BLOCK or kx % _BLOCK or f % _BLOCK:
        raise ValueError(f"channels xin {kx}, h {f}, x {c}: each must be a "
                         f"multiple of {_BLOCK}")
    if tuple(wh.shape) != (2 * c, kx + f) or not wh.is_contiguous():
        raise ValueError(f"wh must be contiguous ({2 * c}, {kx + f}), got "
                         f"{tuple(wh.shape)}")
    if bh.dtype != torch.float32 or tuple(bh.shape) != (2 * c,) \
            or not bh.is_contiguous():
        raise ValueError(f"bh must be contiguous float32 ({2 * c},)")
    lds = [_row_stride(t, name) for t, name in
           ((xin, "xin"), (h, "h"), (x, "x"), (out, "out"))]
    return code, lds


def coupling_head_plain(xin: torch.Tensor, h: torch.Tensor,
                        p: Dict[str, torch.Tensor], x: torch.Tensor,
                        out: Optional[torch.Tensor] = None,
                        inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``torch.cat`` + ``torch.matmul`` in the dtype
    with the interleaved ``wh``, the head's columns put back in (s ‖ t)
    order, then ``coupling_affine_plain``."""
    out = torch.empty_like(x) if out is None else out
    _check_head(xin, h, p, x, out)
    z = torch.cat([xin, h], -1)
    n, hh, ww, k = z.shape
    head = torch.matmul(z.reshape(-1, k), p["wh"].t())
    back = torch.from_numpy(deinterleave_index(head.shape[-1])).to(
        head.device)
    head = head[:, back].reshape(n, hh, ww, -1)
    return coupling_affine_plain(head, p["bh"][back], x, out, inverse)


def coupling_head_backward(g, xin, h, wh, bh, x, inverse=False):
    """Gradients of ``coupling_head`` (in (s ‖ t) terms, then back to the
    interleaved head): ``(dxin, dh, dwh, dbh, dx)``, each in its input's
    dtype. The head is recomputed as the plain version computes it."""
    dt = x.dtype
    n, hh, ww, c = x.shape
    kx = xin.shape[-1]
    xin2, h2 = xin.reshape(-1, kx), h.reshape(-1, h.shape[-1])
    head = torch.matmul(torch.cat([xin2, h2], -1), wh.t())
    back = torch.from_numpy(deinterleave_index(2 * c)).to(x.device)
    st = head[:, back].float() + bh[back]
    sig = torch.sigmoid(st[:, :c])
    e0 = torch.exp(2.0 * sig - 1.0)
    e = e0 + _EPS
    gf = g.reshape(-1, c).float()
    xf = x.reshape(-1, c).float()
    if inverse:
        dx = gf / e
        dtt = -dx
        de = -dx * (xf - st[:, c:]) / e
    else:
        dx = gf * e
        dtt = gf
        de = gf * xf
    ds = de * e0 * 2.0 * sig * (1.0 - sig)
    dhead = torch.cat([ds, dtt], -1)[
        :, torch.from_numpy(interleave_index(2 * c)).to(x.device)]
    dbh = dhead.sum(0)
    dhead = dhead.to(dt)
    dz = torch.matmul(dhead, wh)
    dwh = torch.cat([torch.matmul(dhead.t(), xin2),
                     torch.matmul(dhead.t(), h2)], 1)
    return (dz[:, :kx].reshape(xin.shape), dz[:, kx:].reshape(h.shape), dwh,
            dbh, dx.to(dt).reshape(x.shape))


class CouplingHeadFn(torch.autograd.Function):
    """``coupling_head`` under autograd: ``launch`` computes the forward
    (K2, or the plain version in a test), ``coupling_head_backward`` the
    gradients."""

    @staticmethod
    def forward(ctx, xin, h, wh, bh, x, inverse, launch):
        ctx.inverse = inverse
        ctx.save_for_backward(xin, h, wh, bh, x)
        return launch(xin, h, {"wh": wh, "bh": bh}, x, None, inverse)

    @staticmethod
    def backward(ctx, g):
        grads = coupling_head_backward(g, *ctx.saved_tensors, ctx.inverse)
        return (*grads, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def coupling_head(xin: torch.Tensor, h: torch.Tensor,
                  p: Dict[str, torch.Tensor], x: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  inverse: bool = False) -> torch.Tensor:
    """``out = e(s)·x + t`` (or the inverse) with ``s ‖ t = [xin | h]·Whᵀ
    + bh``; ``p`` holds the interleaved ``wh`` / ``bh`` of ``pack_params``.
    Without autograd it writes into ``out`` (a channel slice is fine) and
    returns it; under autograd it returns a fresh tensor (``out`` must be
    None). The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if _needs_grad(xin, h, p["wh"], p["bh"], x):
        if out is not None:
            raise ValueError("coupling_head under autograd returns a fresh "
                             "tensor: pass out=None")
        if _lib.on_cuda(xin, h, p["wh"], p["bh"], x):
            return CouplingHeadFn.apply(xin, h, p["wh"], p["bh"], x, inverse,
                                        _launch)
        return coupling_head_plain(xin, h, p, x, None, inverse)
    return _launch(xin, h, p, x, out, inverse)


def _launch(xin, h, p, x, out, inverse):
    out = torch.empty_like(x) if out is None else out
    code, (ldxin, ldh, ldx, ldo) = _check_head(xin, h, p, x, out)
    if not _lib.on_cuda(xin, h, p["wh"], p["bh"], x, out):
        return coupling_head_plain(xin, h, p, x, out, inverse)
    wh = p["wh"]
    for t, ld, name in ((xin, ldxin, "xin"), (h, ldh, "h"), (x, ldx, "x"),
                        (out, ldo, "out"), (wh, wh.shape[1], "wh")):
        _lib.check_aligned(t, name, ld)
    n, hh, ww, c = x.shape
    _lib.launch("vwfd_coupling_head", x.device, xin.data_ptr(), ldxin,
                h.data_ptr(), ldh, xin.shape[-1], h.shape[-1],
                wh.data_ptr(), p["bh"].data_ptr(), x.data_ptr(), ldx,
                out.data_ptr(), ldo, n * hh * ww, c, int(inverse), code)
    COUNT.n += 1
    return out
