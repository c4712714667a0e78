"""K3 `wire`: the serving path's uint8 wire format fused with its relayouts.

Replaces the uint8 decode/encode of ``vwfd_tpu/serving.py::_embed_u8`` /
``_detect_u8`` (:377-401), ``models/video_model.py::_to_channels`` /
``_to_frames`` (:43-52, :146-156), the clamp and 8-bit quantize of
``ops/quantize.py`` (:12-25) and the detect stem's space-to-depth
(``nets/unet.py:220-223``). Three entry points share one launch count:

* ``to_channels``: u8 (B,T,H,W,3) → ``/255`` → dtype, (B,H,W,3T);
* ``to_u8``: dtype (B,H,W,3T) → frames → f32 → clamp[0,1] → ``rint(x·255)``
  → u8 (B,T,H,W,3), rounding half to even as ``jnp.round``;
* ``to_s2d``: u8 (N,H,W,3) → ``/255`` → dtype, (N,H/s,W/s,s²·3) in the
  space-to-depth order of ``ops/squeeze.py``.

Bound: bytes, a handful of operations per element. At the flagship serving
shapes (batch 16, T=4, 256²) each entry point reads or writes 12.6 MB of
uint8 and 25.2 MB of bf16: 37.7 MB, about 11 µs at 3.35 TB/s (H100 SXM data
sheet, 700 W).

Design (``csrc/wire.cu``): one thread per output element, each reading its
one input element from the source layout; the division by 255 is an IEEE
division in both versions, so the outputs agree exactly.
"""

import torch

from ..ops.squeeze import space_to_depth
from . import _lib

__all__ = ["to_channels", "to_u8", "to_s2d", "to_channels_plain",
           "to_u8_plain", "to_s2d_plain", "COUNT"]

COUNT = _lib.LaunchCount("wire")


def _check_u8(x: torch.Tensor, ndim: int, name: str) -> None:
    _lib.check_nhwc(x, name, ndim)
    if x.dtype != torch.uint8 or x.shape[-1] != 3:
        raise ValueError(f"{name}: expected uint8 (..., 3), got {x.dtype} "
                         f"{tuple(x.shape)}")


def _div255(x: torch.Tensor) -> torch.Tensor:
    # a tensor divisor keeps this an IEEE division on every backend (a
    # Python-scalar divisor may be turned into a reciprocal multiply)
    return x.float() / x.new_tensor(255.0, dtype=torch.float32)


def to_channels_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    _check_u8(x, 5, "to_channels input")
    b, t, h, w, c = x.shape
    v = _div255(x).to(dtype)
    return v.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def to_u8_plain(x: torch.Tensor, frames: int) -> torch.Tensor:
    _check_frames(x, frames)
    b, h, w, tc = x.shape
    q = torch.round(x.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return q.reshape(b, h, w, frames, tc // frames).permute(
        0, 3, 1, 2, 4).contiguous()


def to_s2d_plain(x: torch.Tensor, s: int, dtype: torch.dtype
                 ) -> torch.Tensor:
    _check_s2d(x, s)
    return space_to_depth(_div255(x).to(dtype), s).contiguous()


def _check_frames(x: torch.Tensor, frames: int) -> None:
    _lib.check_nhwc(x, "to_u8 input")
    _lib.dtype_code(x)
    if x.shape[-1] != 3 * frames:
        raise ValueError(f"to_u8: {x.shape[-1]} channels != 3·{frames}")


def _check_s2d(x: torch.Tensor, s: int) -> None:
    _check_u8(x, 4, "to_s2d input")
    if s < 1 or x.shape[1] % s or x.shape[2] % s:
        raise ValueError(f"to_s2d: {tuple(x.shape)} not divisible by {s}")


def to_channels(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(a) u8 clip (B,T,H,W,3) → INN input (B,H,W,3T) in ``dtype``."""
    _check_u8(x, 5, "to_channels input")
    code = _lib.DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"to_channels: unsupported dtype {dtype}")
    if not _lib.on_cuda(x):
        return to_channels_plain(x, dtype)
    b, t, h, w, c = x.shape
    y = torch.empty((b, h, w, t * c), device=x.device, dtype=dtype)
    _lib.launch("vwfd_wire_to_channels", x.device, x.data_ptr(),
                y.data_ptr(), b, t, h, w, code)
    COUNT.n += 1
    return y


def to_u8(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(b) INN output (B,H,W,3T) → watermarked u8 clip (B,T,H,W,3)."""
    _check_frames(x, frames)
    if not _lib.on_cuda(x):
        return to_u8_plain(x, frames)
    b, h, w, _ = x.shape
    y = torch.empty((b, frames, h, w, 3), device=x.device, dtype=torch.uint8)
    _lib.launch("vwfd_wire_to_u8", x.device, x.data_ptr(), y.data_ptr(),
                b, frames, h, w, _lib.dtype_code(x))
    COUNT.n += 1
    return y


def to_s2d(x: torch.Tensor, s: int, dtype: torch.dtype) -> torch.Tensor:
    """(c) u8 frames (N,H,W,3) → detect stem input (N,H/s,W/s,s²·3)."""
    _check_s2d(x, s)
    code = _lib.DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"to_s2d: unsupported dtype {dtype}")
    if not _lib.on_cuda(x):
        return to_s2d_plain(x, s, dtype)
    n, h, w, _ = x.shape
    y = torch.empty((n, h // s, w // s, s * s * 3), device=x.device,
                    dtype=dtype)
    _lib.launch("vwfd_wire_to_s2d", x.device, x.data_ptr(), y.data_ptr(),
                n, h, w, s, code)
    COUNT.n += 1
    return y
