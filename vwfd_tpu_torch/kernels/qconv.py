"""K11 `qconv`: an int8 3×3 SAME or 1×1 convolution with exact int32 sums
and its requant epilogue and input prologue fused.

Replaces the int8 convolutions of the JAX package's PTQ serving path:
``vwfd_tpu/nets/unet_int8.py::apply_int8``'s ``qconv`` + ``requant`` and the
int8 2×2 max-pool (:235-254), the split decoder conv (:261-265) and the head
(:268-270), and ``vwfd_tpu/nets/inn_int8.py::forward_int8``'s trunk convs
with their ELU requant (:241-256). With ``y = float(acc)·m + b`` per output
channel (``acc`` the exact int32 sum, ``float`` rounding to nearest even):

* ``"relu"``: ``clip(round(y), 0, 127)`` → int8;
* ``"signed"``: ``clip(round(y), -127, 127)`` → int8;
* ``"relu"`` with a second source ``x2``/``w2``/``m2`` (the split decoder):
  ``y = (float(acc)·m + float(acc2)·m2) + b``;
* ``"elu"``: ``clip(round(elu(y) / out_scale), -127, 127)`` → int8, the ELU
  through ``expm1`` as ``jax.nn.elu``;
* ``"f32"``: ``y`` → float32 (the head's logits).

Prologues: ``pool`` max-pools the int8 input 2×2 (floor) before the conv;
``x_scale`` (a 0-dim float32 tensor) quantizes a float32 or bf16 input on
load, ``clip(round(x / x_scale), -127, 127)`` (the INN trunk's first conv).
``round`` is half to even, as ``jnp.round``. The input may be a channel
slice (unit channel stride, uniform pixel stride).

Weights are the port's int8 layout, ``(Cout, k, k, Cin)`` (OHWI: K
contiguous in (tap, channel) order, as the tensor cores read B); ``m``, ``b``
and ``m2`` are float32 ``(Cout,)``.

Bound: operations at the flagship shapes, ``2·MAC`` over the int8 tensor
cores' 1,979 TOP/s (H100 SXM data sheet, 700 W): the UNet's twelve launches
of a detect are 7.9 G multiply-adds a frame, 64 frames, about 0.51 ms;
enc1's first conv (K = 108) and the head are bound by bytes.

Design (``csrc/qconv.cu`` on ``csrc/qmma.cuh``): an implicit GEMM, a block of
128 output pixels (8 × 16 for 3×3) × 64 output channels, shared-memory
stages of 32 input channels (the zero-padded halo of the pixel tile, and
the weights of all taps), ``mma.sync m16n8k32`` s8 → s32 from 8 warps. The
epilogue's arithmetic is one IEEE rounding per operation in the plain
version's order (no FMA), so the kernel equals the plain version bit for
bit. The plain version sums exactly in float64 (``F.conv2d`` on double:
|acc| ≤ 127²·9·Cin stays below 2⁵³, not below 2²⁴), then runs the epilogue
with float32 torch ops; its divisors are tensors (F14: a Python-scalar
divisor is a reciprocal multiply on the card).
"""

from typing import Optional

import torch
import torch.nn.functional as F

from . import _lib

__all__ = ["qconv", "qconv_plain", "launch_args", "exact_conv", "EPILOGUES",
           "COUNT"]

COUNT = _lib.LaunchCount("qconv")
EPILOGUES = {"relu": 0, "signed": 1, "elu": 2, "f32": 3}
# csrc/qmma.cuh Kind: what the loader applies to the input
_KINDS = {torch.int8: 0, "pool": 1, torch.float32: 2, torch.bfloat16: 3}


def exact_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of an int8 conv, ``w`` (Cout, k, k, Cin), SAME
    padding, computed in float64 (exact below 2⁵³)."""
    k = w.shape[1]
    y = F.conv2d(x.permute(0, 3, 1, 2).double(),
                 w.permute(0, 3, 1, 2).double(), padding=k // 2)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def quantize_input(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8 (``scale`` a 0-dim
    tensor: an IEEE division on every device)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 / stride-2 max-pool of NHWC (floor: a ragged last row or column
    is dropped, as ``reduce_window`` VALID)."""
    n, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def requant(y: torch.Tensor, lo: int) -> torch.Tensor:
    return torch.clamp(torch.round(y), lo, 127).to(torch.int8)


def _epilogue(acc, m, b, epilogue, acc2=None, m2=None, out_scale=None):
    y = acc.float() * m
    if acc2 is not None:
        y = y + acc2.float() * m2
    y = y + b
    if epilogue == "f32":
        return y
    if epilogue == "elu":
        e = torch.where(y > 0, y, torch.expm1(y))
        return requant(e / out_scale, -127)
    return requant(y, 0 if epilogue == "relu" else -127)


def _check(x, w, m, b, epilogue, pool, x_scale, x2, w2, m2, out_scale):
    _lib.check_nhwc(w, "w")
    cout, k, k2, cin = w.shape
    if w.dtype != torch.int8 or k != k2 or k not in (1, 3):
        raise ValueError(f"w: expected int8 (Cout, k, k, Cin) with k 1 or 3, "
                         f"got {w.dtype} {tuple(w.shape)}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {sorted(EPILOGUES)}")
    if x.dim() != 4 or x.shape[-1] != cin:
        raise ValueError(f"x {tuple(x.shape)} does not fit w "
                         f"{tuple(w.shape)}")
    if (x_scale is None) != (x.dtype == torch.int8):
        raise ValueError("x is int8, or float32/bf16 with an x_scale")
    if x_scale is not None and (x.dtype not in _KINDS or pool
                                or x_scale.dim() != 0):
        raise ValueError("x_scale quantizes a float32 or bf16 input (no "
                         "pool) by a 0-dim tensor")
    for t, name in ((m, "m"), (b, "b")) + (((m2, "m2"),) if x2 is not None
                                           else ()):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 "
                             f"({cout},)")
    if (epilogue == "elu") != (out_scale is not None):
        raise ValueError("out_scale goes with the elu epilogue")
    if x2 is not None:
        if epilogue != "relu" or x2.dtype != torch.int8 \
                or w2.dtype != torch.int8 or pool:
            raise ValueError("the dual epilogue: relu, int8 x2 and w2, no "
                             "pool")
        _lib.check_nhwc(x2, "x2")
        _lib.check_nhwc(w2, "w2")
        h, ww = ((x.shape[1] // 2, x.shape[2] // 2) if pool
                 else tuple(x.shape[1:3]))
        if tuple(x2.shape[:3]) != (x.shape[0], h, ww) \
                or tuple(w2.shape[:3]) != (cout, k, k) \
                or w2.shape[3] != x2.shape[3]:
            raise ValueError(f"x2 {tuple(x2.shape)} / w2 {tuple(w2.shape)} "
                             f"do not fit x {tuple(x.shape)} / w "
                             f"{tuple(w.shape)}")


def _pixel_stride(t: torch.Tensor, name: str) -> int:
    """Elements between pixels of an NHWC tensor with unit channel stride and
    uniformly spaced pixels (a channel slice of a contiguous tensor)."""
    n, h, w, c = t.shape
    sn, sh, sw, sc = t.stride()
    if (c > 1 and sc != 1) or (h > 1 and sh != w * sw) \
            or (n > 1 and sn != h * w * sw):
        raise ValueError(f"{name}: expected unit channel stride and uniform "
                         f"pixels, got strides {t.stride()}")
    return sw


def qconv_plain(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                b: torch.Tensor, epilogue: str = "relu", *, pool: bool = False,
                x_scale: Optional[torch.Tensor] = None,
                x2: Optional[torch.Tensor] = None,
                w2: Optional[torch.Tensor] = None,
                m2: Optional[torch.Tensor] = None,
                out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: exact sums in float64, the epilogue in float32
    torch ops in the JAX package's order."""
    _check(x, w, m, b, epilogue, pool, x_scale, x2, w2, m2, out_scale)
    if x_scale is not None:
        x = quantize_input(x, x_scale)
    if pool:
        x = max_pool2(x)
    acc2 = None if x2 is None else exact_conv(x2, w2)
    return _epilogue(exact_conv(x, w), m, b, epilogue, acc2, m2, out_scale)


def qconv(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
          epilogue: str = "relu", *, pool: bool = False,
          x_scale: Optional[torch.Tensor] = None,
          x2: Optional[torch.Tensor] = None,
          w2: Optional[torch.Tensor] = None,
          m2: Optional[torch.Tensor] = None,
          out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K11: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (N, H, W, Cout) int8 (float32 for ``"f32"``), H and W
    halved by ``pool``."""
    _check(x, w, m, b, epilogue, pool, x_scale, x2, w2, m2, out_scale)
    scalars = [t for t in (x_scale, out_scale) if t is not None]
    extra = [x2, w2, m2] if x2 is not None else []
    if not _lib.on_cuda(x, w, m, b, *scalars, *extra):
        return qconv_plain(x, w, m, b, epilogue, pool=pool, x_scale=x_scale,
                           x2=x2, w2=w2, m2=m2, out_scale=out_scale)
    out, args = launch_args(x, w, m, b, epilogue, pool=pool,
                            x_scale=x_scale, x2=x2, w2=w2, m2=m2,
                            out_scale=out_scale)
    _lib.launch("vwfd_qconv", x.device, *args)
    COUNT.n += 1
    return out


def launch_args(x, w, m, b, epilogue="relu", *, pool=False, x_scale=None,
                x2=None, w2=None, m2=None, out_scale=None):
    """The output tensor and the arguments of the C launcher ``vwfd_qconv``
    (all but the stream), for inputs ``_check`` passed."""
    n, hin, win, cin = x.shape
    h, wd = (hin // 2, win // 2) if pool else (hin, win)
    cout, k = w.shape[0], w.shape[1]
    ld = _pixel_stride(x, "x")
    if x2 is not None and not x2.is_contiguous():
        raise ValueError("x2: expected a contiguous tensor")
    out = torch.empty((n, h, wd, cout), device=x.device,
                      dtype=torch.float32 if epilogue == "f32"
                      else torch.int8)
    if max(x.numel(), out.numel(), x.storage_offset() + n * hin * win * ld
           ) >= 2 ** 31:
        raise ValueError("qconv: tensors of 2^31 elements or more")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    kind = _KINDS["pool"] if pool else _KINDS[x.dtype]
    dual = x2 is not None
    return out, (x.data_ptr(), kind, ld, hin, win, w.data_ptr(), cin,
                 ptr(x_scale), ptr(x2), x2.shape[-1] if dual else 0, ptr(w2),
                 w2.shape[-1] if dual else 0, m.data_ptr(), ptr(m2),
                 b.data_ptr(), ptr(out_scale), out.data_ptr(), n, h, wd,
                 cout, k, EPILOGUES[epilogue])
