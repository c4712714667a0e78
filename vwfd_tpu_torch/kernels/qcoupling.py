"""K13 `qcoupling_head`: the int8 embed's split coupling head and the
RealNVP affine in one kernel.

Replaces ``vwfd_tpu/nets/inn_int8.py::forward_int8``'s split 1×1 head on the
quantized coupling half and the trunk output, with one weight-scale vector
shared by the two halves (:257-260), and the coupling's ``y = (e(s)·x +
t).astype(dtype)`` (:75-82) with ``vwfd_tpu/nets/inn.py::_e``::

    xi   = clip(round(xin / s_x), -127, 127)
    head = (float(xi·W2x)·m2x + float(h1i·W2h)·m2h) + b2     (float32)
    s, t = head[..., :C], head[..., C:]
    out  = dtype(e(s)·x + t),   e(s) = exp(2·sigmoid(s) − 1) + 1e-4

``xin`` (the coupling half the trunk read, float32 or bf16) and ``x`` / ``out``
(the half to transform, and where the result goes) are channel slices of
NHWC tensors; ``h1i`` is the trunk's int8 output. ``p`` is one subnet of the
port's int8 INN tree (``nets/inn_int8.py``): ``w2x`` (2C, 1, 1, Kx) and
``w2h`` (2C, 1, 1, F) int8, ``m2x``, ``m2h``, ``b2`` float32 (2C,) and the
0-dim ``s_x``, the head's columns in the packed executor's c-major order.

Bound: bytes at the flagship shapes, as K2's (the level-48 coupling reads a
bf16 half of 65,536 × 96 and an int8 trunk output of 65,536 × 128 and
writes 65,536 × 96 bf16; its 1.5 G int8 operations take 0.7 µs of the
tensor cores).

``xi`` (optional): the quantized half, int8 ``(N, H, W, Kx)``, as K11's
trunk conv writes it (``qconv(..., xi_out=)``): then nothing is quantized
here, as JAX's ``forward_int8`` computes ``xi`` once per subnet.

Design (``csrc/qcoupling.cu`` on ``csrc/qwgmma.cuh``): the persistent
``wgmma`` s8 core with two 1×1 operands, each with its own accumulators:
``xi`` (or ``xin``, quantized once per value and 64-channel slice by the
producer's threads, ``__fdiv_rn``) and ``h1i``, through TMA into a ring of
128-channel stages. A block's 128 weight rows are the s rows and then the t
rows of 64 channels, so that every thread holds the s and the t of the
same channels and applies the affine (K2's, ``common.cuh::rnvp_affine``)
from registers. Each float operation is one IEEE rounding in the plain
version's order, so the kernel equals the plain version.
"""

from typing import Dict, Optional

import torch

from . import _lib
from .coupling import _row_stride, affine_e
from .qconv import exact_conv, plan, quantize_input

__all__ = ["qcoupling_head", "qcoupling_head_plain", "plan_of", "COUNT"]

COUNT = _lib.LaunchCount("qcoupling_head")


def _check(xin, h1i, p, x, out, xi=None):
    w2x, w2h = p["w2x"], p["w2h"]
    for t, name in ((xin, "xin"), (h1i, "h1i"), (x, "x"), (out, "out")):
        if t.dim() != 4:
            raise ValueError(f"{name}: expected NHWC, got {tuple(t.shape)}")
    _lib.dtype_code(x)
    if xin.dtype != x.dtype or out.dtype != x.dtype or h1i.dtype != torch.int8:
        raise TypeError("xin, x and out share one float dtype; h1i is int8")
    n, hh, ww, c = x.shape
    kx, f = xin.shape[-1], h1i.shape[-1]
    if tuple(out.shape) != tuple(x.shape) or tuple(xin.shape[:3]) != \
            (n, hh, ww) or tuple(h1i.shape[:3]) != (n, hh, ww):
        raise ValueError(f"xin {tuple(xin.shape)}, h1i {tuple(h1i.shape)}, "
                         f"x {tuple(x.shape)} and out {tuple(out.shape)} must "
                         f"share N, H, W")
    if tuple(w2x.shape) != (2 * c, 1, 1, kx) \
            or tuple(w2h.shape) != (2 * c, 1, 1, f) \
            or w2x.dtype != torch.int8 or w2h.dtype != torch.int8 \
            or not (w2x.is_contiguous() and w2h.is_contiguous()):
        raise ValueError(f"w2x {tuple(w2x.shape)} / w2h {tuple(w2h.shape)}: "
                         f"expected contiguous int8 ({2 * c}, 1, 1, "
                         f"{kx} / {f})")
    for name in ("m2x", "m2h", "b2"):
        t = p[name]
        if t.dtype != torch.float32 or tuple(t.shape) != (2 * c,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 "
                             f"({2 * c},)")
    if p["s_x"].dim() != 0:
        raise ValueError("s_x: expected a 0-dim tensor")
    if xi is not None and (xi.dtype != torch.int8 or tuple(xi.shape) != tuple(
            xin.shape) or not xi.is_contiguous()):
        raise ValueError(f"xi: expected a contiguous int8 {tuple(xin.shape)}")


def qcoupling_head_plain(xin: torch.Tensor, h1i: torch.Tensor,
                         p: Dict[str, torch.Tensor], x: torch.Tensor,
                         out: Optional[torch.Tensor] = None,
                         xi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: exact sums in float64, the head and the affine
    in float32 torch ops in the JAX package's order; writes into ``out``
    and returns it."""
    out = torch.empty_like(x) if out is None else out
    _check(xin, h1i, p, x, out, xi)
    c = x.shape[-1]
    if xi is None:
        xi = quantize_input(xin, p["s_x"])
    acc_x = exact_conv(xi, p["w2x"])
    acc_h = exact_conv(h1i, p["w2h"])
    head = (acc_x.float() * p["m2x"] + acc_h.float() * p["m2h"]) + p["b2"]
    s, t = head[..., :c], head[..., c:]
    out.copy_(affine_e(s) * x.float() + t)
    return out


def plan_of(xin, h1i, p, x, xi=None):
    """The core's plan (``kernels/qconv.py::plan``) for the launch
    ``qcoupling_head`` makes on these CUDA tensors: 64-channel slices, each
    block the s and t rows of one."""
    n, hh, ww, c = x.shape
    kx = xin.shape[-1]
    src = xi if xi is not None else xin
    return plan(n, hh, ww, kx, 2 * c, 1,
                kind="int8" if xi is not None else str(xin.dtype)[6:],
                ld=kx if xi is not None else _row_stride(xin, "xin"),
                x_ptr=src.data_ptr(), w_ptr=p["w2x"].data_ptr(),
                cin2=h1i.shape[-1], x2_ptr=h1i.data_ptr(),
                w2_ptr=p["w2h"].data_ptr(), split=c,
                sms=_lib.sm_count(x.device))


def qcoupling_head(xin: torch.Tensor, h1i: torch.Tensor,
                   p: Dict[str, torch.Tensor], x: torch.Tensor,
                   out: Optional[torch.Tensor] = None,
                   xi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K13: ``out = e(s)·x + t`` from the split int8 head; writes into
    ``out`` (a channel slice is fine) and returns it. The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    out = torch.empty_like(x) if out is None else out
    _check(xin, h1i, p, x, out, xi)
    names = ("w2x", "w2h", "m2x", "m2h", "b2", "s_x")
    extra = [xi] if xi is not None else []
    if not _lib.on_cuda(xin, h1i, x, out, *extra, *(p[k] for k in names)):
        return qcoupling_head_plain(xin, h1i, p, x, out, xi)
    if not h1i.is_contiguous():
        raise ValueError("h1i: expected a contiguous tensor")
    n, hh, ww, c = x.shape
    kx, f = xin.shape[-1], h1i.shape[-1]
    if n * hh * ww * max(kx, f, c) >= 2 ** 31:
        raise ValueError("qcoupling_head: tensors of 2^31 elements or more")
    ldxin = _row_stride(xin, "xin")
    pl = plan_of(xin, h1i, p, x, xi)
    _lib.launch("vwfd_qcoupling_head", x.device, xin.data_ptr(), ldxin, kx,
                p["s_x"].data_ptr(), xi.data_ptr() if xi is not None else None,
                h1i.data_ptr(), f, p["w2x"].data_ptr(), p["w2h"].data_ptr(),
                p["m2x"].data_ptr(), p["m2h"].data_ptr(), p["b2"].data_ptr(),
                x.data_ptr(), _row_stride(x, "x"), out.data_ptr(),
                _row_stride(out, "out"), n, hh, ww, c, _lib.dtype_code(x),
                pl.stages, pl.groups, pl.tma, int(pl.b_resident))
    COUNT.n += 1
    return out
