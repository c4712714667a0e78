"""Haar wavelet squeeze (port of vwfd_tpu/ops/haar.py).

Channel layout as the JAX package's: output channel ``c·4 + k`` holds band
``k ∈ (LL, LH, HL, HH)`` of input channel ``c``, scaled by ½ both ways, so
``haar_upsample(haar_downsample(x)) == x`` up to rounding. Layout NHWC, any
number of leading dims.

* ``haar_downsample`` / ``haar_upsample``: the lifting form (:20-50), the
  four-term sums in the reference's left-to-right order, in float32, rounded
  once to the input's dtype. This is K14's plain version
  (``kernels/haar.py``), and the CPU path of every ``haar`` setting: lift,
  conv and mixed are one linear map.
* ``haar_downsample_conv`` / ``haar_upsample_conv``: the same map as one
  grouped stride-2 (transposed) convolution with the fixed ±½ bank
  (:100-121), in the input's dtype: the library call K14 is timed beside.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["haar_downsample", "haar_upsample", "haar_downsample_conv",
           "haar_upsample_conv"]

# sign of band k ∈ (LL, LH, HL, HH) at sub-pixel (p=row, q=col)
_SIGNS = np.array(
    [
        [[1.0, 1.0], [1.0, 1.0]],      # LL =  a + b + c + d
        [[1.0, -1.0], [1.0, -1.0]],    # LH =  a − b + c − d
        [[1.0, 1.0], [-1.0, -1.0]],    # HL =  a + b − c − d
        [[1.0, -1.0], [-1.0, 1.0]],    # HH =  a − b − c + d
    ],
    np.float32,
)


def _bands(p0, p1, p2, p3):
    """½ × the four signed sums, left to right. The sign matrix is
    symmetric and its square is 4·I, so the same sums map pixels to bands
    and bands back to pixels."""
    return (0.5 * (p0 + p1 + p2 + p3), 0.5 * (p0 - p1 + p2 - p3),
            0.5 * (p0 + p1 - p2 - p3), 0.5 * (p0 - p1 - p2 + p3))


def haar_downsample(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) → (..., H/2, W/2, 4C)."""
    *lead, h, w, c = x.shape
    xf = x.float().reshape(*lead, h // 2, 2, w // 2, 2, c)
    a, b = xf[..., 0, :, 0, :], xf[..., 0, :, 1, :]
    cc, d = xf[..., 1, :, 0, :], xf[..., 1, :, 1, :]
    out = torch.stack(_bands(a, b, cc, d), -1)  # (..., H/2, W/2, C, 4)
    return out.reshape(*lead, h // 2, w // 2, 4 * c).to(x.dtype)


def haar_upsample(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 4C) → (..., 2H, 2W, C): the inverse of
    ``haar_downsample``."""
    *lead, h, w, c4 = x.shape
    c = c4 // 4
    xf = x.float().reshape(*lead, h, w, c, 4)
    a, b, cc, d = _bands(*xf.unbind(-1))
    row0 = torch.stack([a, b], -2)   # (..., h, w, 2, c)
    row1 = torch.stack([cc, d], -2)
    out = torch.stack([row0, row1], -4)  # (..., h, 2, w, 2, c)
    return out.reshape(*lead, 2 * h, 2 * w, c).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _bank(c: int) -> np.ndarray:
    """(4C, 1, 2, 2) grouped-conv bank: output channel c·4+k is band k of
    input channel c."""
    w = np.zeros((4 * c, 1, 2, 2), np.float32)
    for k in range(4):
        w[k::4, 0] = 0.5 * _SIGNS[k]
    return w


def _weight(c: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_bank(c)).to(device=like.device,
                                         dtype=like.dtype)


def _flat(x):
    *lead, h, w, c = x.shape
    return x.reshape(-1, h, w, c).permute(0, 3, 1, 2), lead


def haar_downsample_conv(x: torch.Tensor) -> torch.Tensor:
    """``haar_downsample`` as one grouped 2×2 stride-2 convolution."""
    xc, lead = _flat(x)
    c = xc.shape[1]
    y = F.conv2d(xc, _weight(c, x), stride=2, groups=c)
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], 4 * c)


def haar_upsample_conv(x: torch.Tensor) -> torch.Tensor:
    """``haar_upsample`` as one grouped 2×2 stride-2 transposed
    convolution."""
    xc, lead = _flat(x)
    c = xc.shape[1] // 4
    y = F.conv_transpose2d(xc, _weight(c, x), stride=2, groups=c)
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], c)
