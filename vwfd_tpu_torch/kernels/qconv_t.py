"""K12 `qconv_t`: the int8 UNet decoder's 2×2 / stride-2 transposed
convolution with its signed requant, stored depth-to-space.

Replaces ``vwfd_tpu/nets/unet_int8.py::apply_int8``'s ``lax.conv_transpose(zi,
up_w, (2, 2), "SAME", preferred_element_type=int32)`` and ``requant(u, up_m,
up_b, -127)`` (:257-260)::

    acc[n, i, j, (p, q, co)] = Σ_ci x[n, i, j, ci] · w[p, q, co, ci]
    out[n, 2i + p, 2j + q, co] = clip(round(float(acc)·m[co] + b[co]), -127, 127)

``w`` is the port's layout, ``(2, 2, Cout, Cin)`` int8, already flipped from
flax's HWIO kernel: flax's ``conv_transpose`` (``transpose_kernel=False``)
puts tap ``1 - p`` at sub-pixel ``p`` (F3), and
``convert.unet_int8_from_jax`` / ``nets/unet_int8.quantize`` apply that flip
once, as ``convert.py`` does for the float32 UNet.

Bound: operations at the flagship shapes (four launches, 0.134 G
multiply-adds a frame each, 64 frames; the int8 tensor cores' 1,979 TOP/s).
Design (``csrc/qconv_t.cu``): a stride-2 2×2 kernel touches each output
pixel once, so the op is one GEMM (N·h·w, Cin) × (Cin, 4·Cout) on the 1×1
core of ``csrc/qmma.cuh``, whose epilogue requantizes each column and
stores it to its sub-pixel. Equal to the plain version bit for bit; the
plain version sums exactly with ``F.conv_transpose2d`` in float64.
"""

import torch
import torch.nn.functional as F

from . import _lib
from .qconv import requant

__all__ = ["qconv_t", "qconv_t_plain", "COUNT"]

COUNT = _lib.LaunchCount("qconv_t")


def _check(x, w, m, b):
    _lib.check_nhwc(x, "x")
    _lib.check_nhwc(w, "w")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError("qconv_t takes int8 x and w")
    if w.shape[:2] != (2, 2) or w.shape[3] != x.shape[3]:
        raise ValueError(f"w {tuple(w.shape)} is not (2, 2, Cout, "
                         f"{x.shape[3]})")
    cout = w.shape[2]
    for t, name in ((m, "m"), (b, "b")):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 ({cout},)")


def qconv_t_plain(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: exact sums in float64, then the requant in
    float32 torch ops."""
    _check(x, w, m, b)
    acc = F.conv_transpose2d(x.permute(0, 3, 1, 2).double(),
                             w.permute(3, 2, 0, 1).double(), stride=2)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()
    return requant(acc.float() * m + b, -127)


def qconv_t(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """K12: (N, h, w, Cin) int8 → (N, 2h, 2w, Cout) int8; the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check(x, w, m, b)
    if not _lib.on_cuda(x, w, m, b):
        return qconv_t_plain(x, w, m, b)
    n, h, wd, cin = x.shape
    cout = w.shape[2]
    out = torch.empty((n, 2 * h, 2 * wd, cout), device=x.device,
                      dtype=torch.int8)
    if max(x.numel(), out.numel()) >= 2 ** 31:
        raise ValueError("qconv_t: tensors of 2^31 elements or more")
    _lib.launch("vwfd_qconv_t", x.device, x.data_ptr(), w.data_ptr(),
                m.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, wd, cin,
                cout)
    COUNT.n += 1
    return out
