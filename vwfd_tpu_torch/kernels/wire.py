"""K3 `wire`: the serving path's uint8 wire format fused with its relayouts.

Replaces the uint8 decode/encode of ``vwfd_tpu/serving.py::_embed_u8`` /
``_detect_u8`` (:377-401), ``models/video_model.py::_to_channels`` /
``_to_frames`` (:43-52, :146-156), the clamp and 8-bit quantize of
``ops/quantize.py`` (:12-25) and the detect stem's space-to-depth
(``nets/unet.py:220-223``). Four entry points share one launch count:

* ``to_channels``: u8 (B,T,H,W,3) → ``/255`` → dtype, (B,H,W,3T);
* ``to_u8``: dtype (B,H,W,3T) → frames → f32 → clamp[0,1] → ``rint(x·255)``
  → u8 (B,T,H,W,3), rounding half to even as ``jnp.round``;
* ``to_s2d``: u8 (N,H,W,3) → ``/255`` → dtype, (N,H/s,W/s,s²·3) in the
  space-to-depth order of ``ops/squeeze.py``;
* ``to_u8_s2d``: ``to_u8`` and ``to_s2d`` of its output in one pass, the
  roundtrip's hand-over from embed to detect (``vwfd_tpu/serving.py:427-434``,
  one XLA program there): the watermarked u8 clip and the detect stem's
  input, decoded from the same bytes;
* ``to_s2d_i8`` and ``to_u8_s2d_i8``: the same with the int8 extractor's
  stem (``vwfd_tpu/serving.py:401`` then ``nets/unet_int8.py:244-245``),
  ``zi = clip(round(f32(u8 / 255) · 127), 0, 127)`` as int8 in s2d order.
  The quotient is float32, as the JAX int8 detect feeds ``apply_int8`` a
  float32 clip (a bf16 stem would be the wrong input). ``u·127/255`` is
  never closer than 1/510 to a half-integer, so the level is the same
  whether the quotient is the IEEE one or ``u·(1/255)``. The stem stays in
  K3 (its own launch, the roundtrip's in the one-pass encode) rather than
  in a K11 prologue, so the int8 UNet reads int8 from its first conv on.

Bound: bytes, a handful of operations per element. At the flagship serving
shapes (batch 16, T=4, 256²) each of the first three reads or writes 12.6 MB
of uint8 and 25.2 MB of bf16: 37.7 MB, about 11.3 µs at 3.35 TB/s (H100 SXM
data sheet, 700 W); ``to_u8_s2d`` moves 62.9 MB, about 18.8 µs.

Design (``csrc/wire.cu``): the tiled path runs one block per output row
(``to_u8_s2d``: per s input rows), stages the uint8 side of its rows in
shared memory with 1-D bulk copies and walks the dtype side in 16-byte
vectors, with 32-bit indices from a per-block offset table. ``tiled`` alone
picks it where the rows allow (16-byte rows, the staged rows within 48 KB);
other shapes take the general path, one thread per output element. The division
by 255 is an IEEE division everywhere (the tiled path reads a per-block
table of the 256 quotients), as in the plain version, so the outputs agree
exactly.
"""

from typing import Tuple

import torch

from ..ops.squeeze import space_to_depth
from . import _lib

__all__ = ["to_channels", "to_u8", "to_s2d", "to_u8_s2d", "to_s2d_i8",
           "to_u8_s2d_i8", "to_channels_plain", "to_u8_plain", "to_s2d_plain",
           "to_u8_s2d_plain", "to_s2d_i8_plain", "to_u8_s2d_i8_plain",
           "stem_levels", "tiled", "COUNT"]

COUNT = _lib.LaunchCount("wire")
# csrc/wire.cu: channels of one dtype-side pixel the offset table holds
# (kMaxK) and bytes between staged rows (kRowPad). The C launchers opt each
# launch in to the dynamic shared memory it asks for, so the staged rows may
# take all of _SMEM_MAX beside the kernels' static tables.
_MAX_K = 64
_ROW_PAD = 16
_SMEM_MAX = 48 * 1024


def tiled(x: torch.Tensor, width: int, rows: int, channels: int) -> bool:
    """Whether the row-tiled kernels take a map whose input is ``x``: image
    rows of ``width`` RGB pixels in whole 16-byte words, ``x`` 16-byte
    aligned, at most ``_MAX_K`` channels per dtype-side pixel, and ``rows``
    staged image rows within ``_SMEM_MAX``. The only place the path is
    chosen: the C launchers check just what the tiled kernels need."""
    return ((3 * width) % 16 == 0 and x.data_ptr() % 16 == 0
            and channels <= _MAX_K
            and rows * (3 * width + _ROW_PAD) <= _SMEM_MAX)


def _check_u8(x: torch.Tensor, ndim: int, name: str) -> None:
    _lib.check_nhwc(x, name, ndim)
    if x.dtype != torch.uint8 or x.shape[-1] != 3:
        raise ValueError(f"{name}: expected uint8 (..., 3), got {x.dtype} "
                         f"{tuple(x.shape)}")


def _check_frames(x: torch.Tensor, frames: int) -> None:
    _lib.check_nhwc(x, "to_u8 input")
    _lib.dtype_code(x)
    if x.shape[-1] != 3 * frames:
        raise ValueError(f"to_u8: {x.shape[-1]} channels != 3·{frames}")


def _check_s2d(x: torch.Tensor, s: int) -> None:
    if s < 1 or x.shape[-3] % s or x.shape[-2] % s:
        raise ValueError(f"s2d: {tuple(x.shape)} not divisible by {s}")


_I8 = 2  # csrc/common.cuh kI8: the int8 stem


def _code(dtype: torch.dtype, name: str) -> int:
    code = _lib.DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    return code


def _check_size(*ts: torch.Tensor) -> None:
    if any(t.numel() >= 2 ** 31 for t in ts):
        raise ValueError("wire: the kernels index in 32 bits (fewer than "
                         "2^31 elements a tensor)")


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
    _check_u8(x, 4, "to_s2d input")
    _check_s2d(x, s)
    return space_to_depth(_div255(x).to(dtype), s).contiguous()


def to_u8_s2d_plain(x: torch.Tensor, frames: int, s: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    u8 = to_u8_plain(x, frames)
    b, t, h, w, c = u8.shape
    return u8, to_s2d_plain(u8.reshape(b * t, h, w, c), s, x.dtype)


def stem_levels(x: torch.Tensor) -> torch.Tensor:
    """u8 → the int8 stem level ``clip(round((u8 / 255) · 127), 0, 127)``,
    the quotient in float32."""
    return torch.clamp(torch.round(_div255(x) * 127.0), 0, 127).to(
        torch.int8)


def to_s2d_i8_plain(x: torch.Tensor, s: int) -> torch.Tensor:
    _check_u8(x, 4, "to_s2d_i8 input")
    _check_s2d(x, s)
    return space_to_depth(stem_levels(x), s).contiguous()


def to_u8_s2d_i8_plain(x: torch.Tensor, frames: int, s: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    u8 = to_u8_plain(x, frames)
    b, t, h, w, c = u8.shape
    return u8, to_s2d_i8_plain(u8.reshape(b * t, h, w, c), s)


def to_channels(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(a) u8 clip (B,T,H,W,3) → INN input (B,H,W,3T) in ``dtype``."""
    _check_u8(x, 5, "to_channels input")
    code = _code(dtype, "to_channels")
    if not _lib.on_cuda(x):
        return to_channels_plain(x, dtype)
    b, t, h, w, c = x.shape
    y = torch.empty((b, h, w, t * c), device=x.device, dtype=dtype)
    _check_size(x, y)
    _lib.launch("vwfd_wire_to_channels", x.device, x.data_ptr(),
                y.data_ptr(), b, t, h, w, code, int(tiled(x, w, t, 3 * t)))
    COUNT.n += 1
    return y


def to_u8(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(b) INN output (B,H,W,3T) → watermarked u8 clip (B,T,H,W,3)."""
    _check_frames(x, frames)
    if not _lib.on_cuda(x):
        return to_u8_plain(x, frames)
    b, h, w, _ = x.shape
    y = torch.empty((b, frames, h, w, 3), device=x.device, dtype=torch.uint8)
    _check_size(x, y)
    _lib.launch("vwfd_wire_to_u8", x.device, x.data_ptr(), y.data_ptr(),
                b, frames, h, w, _lib.dtype_code(x),
                int(tiled(x, w, frames, 3 * frames)))
    COUNT.n += 1
    return y


def to_s2d(x: torch.Tensor, s: int, dtype: torch.dtype) -> torch.Tensor:
    """(c) u8 frames (N,H,W,3) → detect stem input (N,H/s,W/s,s²·3)."""
    _check_u8(x, 4, "to_s2d input")
    _check_s2d(x, s)
    code = _code(dtype, "to_s2d")
    if not _lib.on_cuda(x):
        return to_s2d_plain(x, s, dtype)
    return _to_s2d(x, s, dtype, code)


def _to_s2d(x: torch.Tensor, s: int, dtype: torch.dtype, code: int
            ) -> torch.Tensor:
    n, h, w, _ = x.shape
    y = torch.empty((n, h // s, w // s, s * s * 3), device=x.device,
                    dtype=dtype)
    _check_size(x, y)
    _lib.launch("vwfd_wire_to_s2d", x.device, x.data_ptr(), y.data_ptr(),
                n, h, w, s, code, int(tiled(x, w, s, 3 * s * s)))
    COUNT.n += 1
    return y


def to_u8_s2d(x: torch.Tensor, frames: int, s: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d) INN output (B,H,W,3T) → the watermarked u8 clip (B,T,H,W,3) and
    the detect stem input (B·T,H/s,W/s,s²·3), in ``x``'s dtype, decoded from
    its bytes: one launch on the tiled path; ``to_u8`` then ``to_s2d`` for
    other shapes."""
    _check_frames(x, frames)
    _check_s2d(x, s)
    if not _lib.on_cuda(x):
        return to_u8_s2d_plain(x, frames, s)
    b, h, w, _ = x.shape
    if not tiled(x, w, frames * s, 3 * max(frames, s * s)):
        u8 = to_u8(x, frames)
        return u8, to_s2d(u8.reshape(b * frames, h, w, 3), s, x.dtype)
    u8 = torch.empty((b, frames, h, w, 3), device=x.device, dtype=torch.uint8)
    y = torch.empty((b * frames, h // s, w // s, s * s * 3), device=x.device,
                    dtype=x.dtype)
    _check_size(x, u8, y)
    _lib.launch("vwfd_wire_to_u8_s2d", x.device, x.data_ptr(), u8.data_ptr(),
                y.data_ptr(), b, frames, h, w, s, _lib.dtype_code(x))
    COUNT.n += 1
    return u8, y


def to_s2d_i8(x: torch.Tensor, s: int) -> torch.Tensor:
    """(c) with the int8 stem: u8 frames (N,H,W,3) → int8
    (N,H/s,W/s,s²·3)."""
    _check_u8(x, 4, "to_s2d_i8 input")
    _check_s2d(x, s)
    if not _lib.on_cuda(x):
        return to_s2d_i8_plain(x, s)
    return _to_s2d(x, s, torch.int8, _I8)


def to_u8_s2d_i8(x: torch.Tensor, frames: int, s: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d) with the int8 stem: INN output (B,H,W,3T) → the watermarked u8
    clip and the int8 detect stem (B·T,H/s,W/s,s²·3) decoded from its
    bytes; one launch on the tiled path, ``to_u8`` then ``to_s2d_i8``
    otherwise."""
    _check_frames(x, frames)
    _check_s2d(x, s)
    if not _lib.on_cuda(x):
        return to_u8_s2d_i8_plain(x, frames, s)
    b, h, w, _ = x.shape
    if not tiled(x, w, frames * s, 3 * max(frames, s * s)):
        u8 = to_u8(x, frames)
        return u8, to_s2d_i8(u8.reshape(b * frames, h, w, 3), s)
    u8 = torch.empty((b, frames, h, w, 3), device=x.device, dtype=torch.uint8)
    y = torch.empty((b * frames, h // s, w // s, s * s * 3), device=x.device,
                    dtype=torch.int8)
    _check_size(x, u8, y)
    _lib.launch("vwfd_wire_to_u8_s2d_i8", x.device, x.data_ptr(),
                u8.data_ptr(), y.data_ptr(), b, frames, h, w, s,
                _lib.dtype_code(x))
    COUNT.n += 1
    return u8, y
