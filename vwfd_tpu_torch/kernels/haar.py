"""K14 `haar`: the INN module path's Haar squeeze and its inverse.

Replaces ``vwfd_tpu/ops/haar.py``'s ``haar_downsample`` / ``haar_upsample``
(:20-50) and the same linear map's conv forms ``haar_downsample_conv`` /
``haar_upsample_conv`` (:100-121): ``nets/inn.py``'s module path runs all
three ``haar`` settings (lift, conv, mixed) through it, and
``nets/inn_packed.py`` runs it at the unpacked levels past 768 channels
(``vwfd_tpu/nets/inn_packed.py:236-258``).

* down: NHWC (N,H,W,C) → (N,H/2,W/2,4C), output channel c·4+k =
  ½·(a ± b ± c ± d) with the reference's signs;
* up (``transpose=True``): (N,H/2,W/2,4C) → (N,H,W,C), the exact inverse.

The four-term sums run left to right in float32 and are rounded once, so
the kernel is ``torch.equal`` to its plain version,
``ops/haar.py::haar_downsample`` / ``haar_upsample``.

Bound: bytes. Five operations per output against four bytes (bf16) moved
for it: the input read once and the output written once, at the refshape
serving shapes (batch 16, 256², T = 4, bf16) 12.6 MB each way at the first
level, about 7.5 µs at 3.35 TB/s (H100 SXM data sheet, 700 W).

Design (``csrc/haar.cu``): one thread per (half-resolution position, 16
bytes of channels): four 16-byte loads of the 2×2 pixels' channels, the
butterflies, and the 4·V band values, contiguous in the c·4+k order, as
16-byte stores (the reverse for up). Channel rows of whole 8-byte words
only (the 12-channel clip in bf16) take 8-byte accesses, other rows one
value a thread.

Under autograd the map is symmetric and orthogonal (M·M = I, M = Mᵀ), so
the backward of down is K14 up of the gradient, and the reverse
(``_HaarFn``).
"""

import torch

from ..ops.haar import haar_downsample, haar_upsample
from . import _lib

__all__ = ["haar", "haar_plain", "out_shape", "COUNT"]

COUNT = _lib.LaunchCount("haar")


def out_shape(shape, transpose: bool = False):
    n, h, w, c = shape
    return (n, 2 * h, 2 * w, c // 4) if transpose else (n, h // 2, w // 2,
                                                        4 * c)


def _check(x: torch.Tensor, transpose: bool) -> None:
    _lib.check_nhwc(x, "haar input")
    _lib.dtype_code(x)
    _, h, w, c = x.shape
    if (c % 4 if transpose else h % 2 or w % 2):
        raise ValueError(f"haar{'ᵀ' if transpose else ''}: shape "
                         f"{tuple(x.shape)} does not fit the map")


def haar_plain(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the lifting form in float32, rounded once."""
    _check(x, transpose)
    return haar_upsample(x) if transpose else haar_downsample(x)


def access_width(row_bytes: int, *ts: torch.Tensor) -> int:
    """The widest access, 16 or 8 bytes, that divides ``row_bytes`` and
    every tensor's address; 0 for one value at a time."""
    for width in (16, 8):
        if row_bytes % width == 0 and all(t.data_ptr() % width == 0
                                          for t in ts):
            return width
    return 0


def _launch(x: torch.Tensor, transpose: bool) -> torch.Tensor:
    _check(x, transpose)
    y = torch.empty(out_shape(x.shape, transpose), device=x.device,
                    dtype=x.dtype)
    full = y if transpose else x
    n, h, w, c = full.shape
    _lib.launch("vwfd_haar", x.device, x.data_ptr(), y.data_ptr(), n, h, w,
                c, int(transpose), _lib.dtype_code(x),
                access_width(c * x.element_size(), x, y))
    COUNT.n += 1
    return y


class _HaarFn(torch.autograd.Function):
    """K14 under autograd: the backward is the other direction, also K14."""

    @staticmethod
    def forward(ctx, x, transpose):
        ctx.transpose = transpose
        return _launch(x, transpose)

    @staticmethod
    def backward(ctx, g):
        return _launch(g.contiguous(), not ctx.transpose), None


def haar(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Haar down (or up) on an NHWC f32/bf16 tensor, differentiable: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    _check(x, transpose)
    if not _lib.on_cuda(x):
        return haar_plain(x, transpose)
    return _HaarFn.apply(x, transpose)
