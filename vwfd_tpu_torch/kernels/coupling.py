"""K2 `coupling_affine`: the RealNVP affine of one coupling half.

Replaces the affine lines of ``vwfd_tpu/nets/inn_packed.py::_coupling_fwd``
/ ``_coupling_inv`` (:201-220), ``vwfd_tpu/nets/inn.py::_e`` (:176-179) and
the head's bias add and (s ‖ t) split (inn_packed.py:186-188)::

    s, t = split(head + bias)
    e    = exp(2·sigmoid(s) − 1) + 1e-4
    out  = e·x + t          (inverse: (x − t) / e)

The 1×1 head GEMM that produces ``head`` stays a matmul outside the kernel,
as XLA computes it outside any kernel in the JAX package.

Bound: bytes. About 20 operations per output element against 2 + 2 + 2
bf16 bytes (head pair, x, out), far below the card's ~295 operations per
byte, so the least time is head + x read once and out written once over the
memory rate: at the flagship level-48 coupling (batch 16, 256², bf16)
25.2 + 12.6 + 12.6 MB, about 15 µs at 3.35 TB/s (H100 SXM data sheet,
700 W).

Design (``csrc/coupling.cu``): one thread per output element, f32 inside
with explicitly rounded mul/add/div so that it follows the plain version's
order of operations. ``x`` and ``out`` may be channel slices of NHWC tensors
(unit channel stride, uniform row stride): the kernel writes its half
straight into the coupling's output tensor, so no concat is needed.
"""

from typing import Optional

import torch

from . import _lib

__all__ = ["coupling_affine", "coupling_affine_plain", "COUNT"]

COUNT = _lib.LaunchCount("coupling_affine")
_EPS = 1e-4


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


def _check(head, bias, x, out):
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
    """Plain PyTorch version (f32 arithmetic, one rounding to the dtype)."""
    out = torch.empty_like(x) if out is None else out
    _check(head, bias, x, out)
    c = x.shape[-1]
    st = head.float() + bias
    s, t = st[..., :c], st[..., c:]
    e = torch.exp(2.0 * torch.sigmoid(s) - 1.0) + _EPS
    xf = x.float()
    out.copy_((xf - t) / e if inverse else e * xf + t)
    return out


def coupling_affine(head: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                    out: Optional[torch.Tensor] = None,
                    inverse: bool = False) -> torch.Tensor:
    """``out = e(s)·x + t`` (or the inverse) with ``s ‖ t = head + bias``;
    writes into ``out`` (a channel slice is fine) and returns it. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    out = torch.empty_like(x) if out is None else out
    code, ldx, ldo = _check(head, bias, x, out)
    if not _lib.on_cuda(head, bias, x, out):
        return coupling_affine_plain(head, bias, x, out, inverse)
    n, h, w, c = x.shape
    _lib.launch("vwfd_coupling_affine", x.device, head.data_ptr(),
                bias.data_ptr(), x.data_ptr(), ldx, out.data_ptr(), ldo,
                n * h * w, c, int(inverse), code)
    COUNT.n += 1
    return out
