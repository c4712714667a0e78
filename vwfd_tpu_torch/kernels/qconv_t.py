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

Bound, summed over the flagship's four launches (64 frames; 0.134 G
multiply-adds a frame each): operations at up4 and up3 (the int8 tensor
cores' 1,979 TOP/s), bytes at up2 and up1, whose int8 outputs dominate
(3.35 TB/s); 0.062 ms in all.

Design (``csrc/qconv_t.cu`` on ``csrc/qwgmma.cuh``): a stride-2 2×2 kernel
touches each output pixel once, so the op is one GEMM (N·h·w, Cin) × (Cin,
4·Cout) on the persistent ``wgmma`` s8 core's 1×1 path, with the batch
stacked as one tall image (1, N·h, w): a 1×1 product has no halo, so a
16 × 8 tile may span images. ``plan`` is ``qconv.plan`` of that GEMM; the
epilogue requantizes each column and writes the tile to ``out_index`` by
one TMA store a consumer (``store_route``), or in 16-byte runs.
Equal to the plain version bit for bit; the plain version sums exactly with
``F.conv_transpose2d`` in float64.
"""

import torch
import torch.nn.functional as F

from . import _lib, qconv
from .qconv import requant

__all__ = ["qconv_t", "qconv_t_plain", "plan", "plan_of", "out_index",
           "store_route", "launch_args", "COUNT"]

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


def out_index(r, j, n, w: int, cout: int):
    """The flat element of the (N, 2h, 2w, Cout) output that GEMM column
    ``n`` = (p, q, co) of input pixel (stacked row ``r`` = image·h + i,
    column ``j``) lands on: ``out[2r + p, 2j + q, co]`` of the stacked
    output, ``((2r + p)·w + j)·2·Cout + n − p·2·Cout`` with ``p = n //
    (2·Cout)`` (``csrc/qconv_t.cu::out_index``). Contiguous in ``n`` inside
    one sub-pixel row ``p``. Takes ints or integer tensors."""
    p = n // (2 * cout)
    return ((2 * r + p) * w + j) * (2 * cout) + n - p * (2 * cout)


def store_route(cout: int, bn: int) -> str:
    """How the epilogue writes a staged tile (``csrc/qconv_t.cu``; the
    wrapper passes the choice to the C launcher, which refuses a TMA route
    that does not hold): ``"tma"``, one TMA store of each consumer's 64
    pixels, where a column block of BN = 128 lies in one sub-pixel row
    (Cout % 64 == 0: 128 contiguous bytes a pixel, every stride a multiple
    of 16); ``"16-byte"`` runs where 16 columns do (Cout % 8 == 0); else
    ``"bytes"`` (the output is a fresh, 16-byte aligned tensor)."""
    if bn == 128 and cout % 64 == 0:
        return "tma"
    return "16-byte" if cout % 8 == 0 else "bytes"


def plan(n: int, h: int, w: int, cin: int, cout: int, *, x_ptr: int = 0,
         w_ptr: int = 0, sms: int = 132, stages=None,
         a_threads: bool = False) -> qconv.Plan:
    """The launch of an (n, h, w, cin) → (n, 2h, 2w, cout) transposed conv:
    ``qconv.plan`` of the 1×1 GEMM on the stacked (1, n·h, w) image with
    4·cout columns and an int8 output (``stages`` and ``a_threads``: its
    overrides)."""
    return qconv.plan(1, n * h, w, cin, 4 * cout, 1, x_ptr=x_ptr,
                      w_ptr=w_ptr, epilogue="signed", sms=sms, stages=stages,
                      a_threads=a_threads)


def plan_of(x, w, stages=None, a_threads=False) -> qconv.Plan:
    """``plan`` for the launch ``qconv_t`` makes on these CUDA tensors."""
    n, h, wd, cin = x.shape
    return plan(n, h, wd, cin, w.shape[2], x_ptr=x.data_ptr(),
                w_ptr=w.data_ptr(), sms=_lib.sm_count(x.device),
                stages=stages, a_threads=a_threads)


def qconv_t_plain(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: exact sums in float64, then the requant in
    float32 torch ops."""
    _check(x, w, m, b)
    acc = F.conv_transpose2d(x.permute(0, 3, 1, 2).double(),
                             w.permute(3, 2, 0, 1).double(), stride=2)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()
    return requant(acc.float() * m + b, -127)


def launch_args(x, w, m, b, stages=None, a_threads=False):
    """The output tensor and the arguments of the C launcher
    ``vwfd_qconv_t`` (all but the stream), for inputs ``_check`` passed,
    with ``plan``'s choice (``stages``, ``a_threads``: its overrides)."""
    n, h, wd, cin = x.shape
    cout = w.shape[2]
    out = torch.empty((n, 2 * h, 2 * wd, cout), device=x.device,
                      dtype=torch.int8)
    if max(x.numel(), out.numel()) >= 2 ** 31:
        raise ValueError("qconv_t: tensors of 2^31 elements or more")
    pl = plan_of(x, w, stages, a_threads)
    return out, (x.data_ptr(), w.data_ptr(), m.data_ptr(), b.data_ptr(),
                 out.data_ptr(), n, h, wd, cin, cout, pl.bn, pl.stages,
                 pl.groups, pl.tma, int(pl.b_resident),
                 int(store_route(cout, pl.bn) == "tma"))


def qconv_t(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """K12: (N, h, w, Cin) int8 → (N, 2h, 2w, Cout) int8; the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check(x, w, m, b)
    if not _lib.on_cuda(x, w, m, b):
        return qconv_t_plain(x, w, m, b)
    out, args = launch_args(x, w, m, b)
    _lib.launch("vwfd_qconv_t", x.device, *args)
    COUNT.n += 1
    return out
