"""K15 `coupling_affine`: the RealNVP affine of a coupling half on the INN
module path, forward and backward.

Replaces the affine lines of ``vwfd_tpu/nets/inn.py::RNVPCoupling.forward``
/ ``.inverse`` (:235-250) with ``_e`` (:176-179)::

    e   = exp(2·sigmoid(s) − 1) + 1e-4
    out = e·x + t          (inverse: (x − t) / e)

``st`` is the subnet's output: one head tensor whose two channel halves are
s and t (``fused_st``), or a pair ``(s, t)`` of tensors (the reference's
split subnets). ``x`` is a channel slice of the coupling's input and ``out``
one of its output: every operand needs unit channel stride and uniform rows
(K2's rule), so no slice is copied.

Arithmetic is float32, rounded once to the dtype, in K2's order of
operations (``vwfd::rnvp_affine``, ``kernels/coupling.py:119-138``): the
forward is within one ulp of its plain version (the ``exp`` of the two
libraries may differ in the last place).

Bound: bytes. The forward reads s, t and x and writes out, four tensors of
the half's size (at the refshape serving shapes the level-48 half moves
4 × 12.6 MB of bf16, about 15 µs at 3.35 TB/s, H100 SXM data sheet, 700 W);
about 20 operations a value.

Design (``csrc/affine.cu``): one thread per (row, 16 bytes of channels),
16-byte loads and stores; operands whose rows are not whole 16-byte words
take one value a thread.

Under autograd the wrapper returns a fresh tensor through ``_AffineFn``,
whose backward is a second kernel: from the gradient g it writes, in one
pass, ∂x = g·e, ∂t = g, ∂s = g·x·e₀·2σ(1 − σ) (e₀ = e − 1e-4), and the
inverse's ∂x = g/e, ∂t = −∂x, ∂s = −∂x·(x − t)/e·e₀·2σ(1 − σ); for a fused
head it writes ∂s and ∂t into the two halves of one tensor.
"""

from typing import Optional, Sequence, Tuple, Union

import torch

from . import _lib
from .coupling import _row_stride, affine_e

__all__ = ["coupling_affine", "coupling_affine_plain", "split_head",
           "COUNT"]

COUNT = _lib.LaunchCount("coupling_affine")

Head = Union[torch.Tensor, Sequence[torch.Tensor]]


def split_head(st: Head) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, t)``: the two channel halves of a head tensor, or the pair."""
    if isinstance(st, torch.Tensor):
        c = st.shape[-1] // 2
        return st[..., :c], st[..., c:]
    s, t = st
    return s, t


def _check(s, t, x, out) -> None:
    for v, name in ((s, "s"), (t, "t"), (x, "x"), (out, "out")):
        if v.dim() != 4:
            raise ValueError(f"{name}: expected NHWC, got {tuple(v.shape)}")
        if v.shape != x.shape:
            raise ValueError(f"{name} {tuple(v.shape)} != x "
                             f"{tuple(x.shape)}")
        if v.dtype != x.dtype:
            raise TypeError("s, t, x and out must share one dtype")
    _lib.dtype_code(x)


def coupling_affine_plain(st: Head, x: torch.Tensor,
                          out: Optional[torch.Tensor] = None,
                          inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version: float32 torch ops, one rounding to the dtype.
    Writes into ``out`` when given (no autograd), else returns a fresh
    tensor (differentiable)."""
    s, t = split_head(st)
    _check(s, t, x, x if out is None else out)
    e = affine_e(s.float())
    xf, tf = x.float(), t.float()
    res = (xf - tf) / e if inverse else e * xf + tf
    if out is None:
        return res.to(x.dtype)
    out.copy_(res)
    return out


def _vector_ok(*ts: torch.Tensor) -> bool:
    """16-byte accesses: every row and base address in whole 16-byte
    words (the channel count too)."""
    size = ts[0].element_size()
    return all(t.data_ptr() % 16 == 0 and (_row_stride(t, "t") * size) % 16
               == 0 and (t.shape[-1] * size) % 16 == 0 for t in ts)


def _launch(s, t, x, out, inverse):
    out = torch.empty_like(x) if out is None else out
    _check(s, t, x, out)
    lds = [_row_stride(v, name) for v, name in
           ((s, "s"), (t, "t"), (x, "x"), (out, "out"))]
    if not _lib.on_cuda(s, t, x, out):
        return coupling_affine_plain((s, t), x, out, inverse)
    n, h, w, c = x.shape
    _lib.launch("vwfd_coupling_affine", x.device, s.data_ptr(), lds[0],
                t.data_ptr(), lds[1], x.data_ptr(), lds[2], out.data_ptr(),
                lds[3], n * h * w, c, int(inverse), _lib.dtype_code(x),
                int(_vector_ok(s, t, x, out)))
    COUNT.n += 1
    return out


def _launch_backward(g, s, t, x, ds, dt, inverse):
    dx = torch.empty(x.shape, device=x.device, dtype=x.dtype)
    ops = ((g, "g"), (s, "s"), (t, "t"), (x, "x"), (dx, "dx"), (ds, "ds"),
           (dt, "dt"))
    lds = [_row_stride(v, name) for v, name in ops]
    n, h, w, c = x.shape
    _lib.launch("vwfd_coupling_affine_bwd", x.device, g.data_ptr(), lds[0],
                s.data_ptr(), lds[1], t.data_ptr(), lds[2], x.data_ptr(),
                lds[3], dx.data_ptr(), lds[4], ds.data_ptr(), lds[5],
                dt.data_ptr(), lds[6], n * h * w, c, int(inverse),
                _lib.dtype_code(x), int(_vector_ok(*(v for v, _ in ops))))
    COUNT.n += 1
    return dx


def _uniform_rows(g: torch.Tensor) -> torch.Tensor:
    try:
        _row_stride(g, "g")
        return g
    except ValueError:
        return g.contiguous()


class _AffineFn(torch.autograd.Function):
    """K15 under autograd. ``t`` None: ``head`` holds s ‖ t, and the
    backward writes ∂s ‖ ∂t into one tensor."""

    @staticmethod
    def forward(ctx, head, t, x, inverse):
        s, tt = split_head(head) if t is None else (head, t)
        ctx.inverse, ctx.fused = inverse, t is None
        ctx.save_for_backward(head, t, x)
        return _launch(s, tt, x, None, inverse)

    @staticmethod
    def backward(ctx, g):
        head, t, x = ctx.saved_tensors
        g = _uniform_rows(g)
        if ctx.fused:
            dhead = torch.empty(head.shape, device=x.device, dtype=x.dtype)
            s, tt = split_head(head)
            ds, dt = split_head(dhead)
            dx = _launch_backward(g, s, tt, x, ds, dt, ctx.inverse)
            return dhead, None, dx, None
        ds = torch.empty(head.shape, device=x.device, dtype=x.dtype)
        dt = torch.empty(t.shape, device=x.device, dtype=x.dtype)
        dx = _launch_backward(g, head, t, x, ds, dt, ctx.inverse)
        return ds, dt, dx, None


def coupling_affine(st: Head, x: torch.Tensor,
                    out: Optional[torch.Tensor] = None,
                    inverse: bool = False) -> torch.Tensor:
    """``out = e(s)·x + t`` (or the inverse) with ``st`` a head tensor (s ‖
    t) or a pair ``(s, t)``. Without autograd it writes into ``out`` (a
    channel slice is fine) and returns it; under autograd it returns a
    fresh tensor (``out`` must be None). The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    s, t = split_head(st)
    grad = torch.is_grad_enabled() and any(
        v.requires_grad for v in (s, t, x))
    if not grad:
        return _launch(s, t, x, out, inverse)
    if out is not None:
        raise ValueError("coupling_affine under autograd returns a fresh "
                         "tensor: pass out=None")
    _check(s, t, x, x)
    if not _lib.on_cuda(s, t, x):
        return coupling_affine_plain(st, x, None, inverse)
    if isinstance(st, torch.Tensor):
        return _AffineFn.apply(st, None, x, inverse)
    return _AffineFn.apply(s, t, x, inverse)
