"""Colour pairs (port of vwfd_tpu/ops/color.py:21-102).

The Jpeg/JpegSS/JpegMask coefficient set of the reference
(noise_layers/jpeg.py:147-163), and the analog BT.601 set of HiDDeN's
JpegCompression (noise_layers/jpeg_compression.py:52-63), whose two
matrices are the reference's constants and not each other's inverse. Each
output channel is the 3-term sum
``x0·m[o][0] + x1·m[o][1] + x2·m[o][2]`` in float32, left to right, one
rounding per operation: the JAX package's HIGHEST-precision 3×3
contraction, in an order that K5 (``csrc/jpeg.cu``) and K16
(``csrc/zigzag.cu``) repeat.

The DiffJPEG pair (utils/JPEG.py:115-135, 408-428) adds the chroma shift
(0, 128, 128) after the forward matrix and takes it off before the
inverse one, as ``color.py:77-85`` does; K24 (``csrc/diffjpeg.cu``)
repeats it. ``rgb_to_y_bt601`` is the video-range Y of the reference's
Y-channel PSNR (data/util.py:180-205), ``color.py:97-102``.
"""

import numpy as np
import torch

__all__ = ["rgb_to_yuv_jpegbasic", "yuv_to_rgb_jpegbasic",
           "rgb_to_yuv_analog", "yuv_to_rgb_analog", "rgb_to_ycbcr_diffjpeg",
           "ycbcr_to_rgb_diffjpeg", "rgb_to_y_bt601", "RGB2YUV_JPEGBASIC",
           "YUV2RGB_JPEGBASIC", "RGB2YUV_ANALOG", "YUV2RGB_ANALOG",
           "RGB2YCBCR_DIFFJPEG", "YCBCR2RGB_DIFFJPEG", "SHIFT_DIFFJPEG"]

RGB2YUV_JPEGBASIC = np.array([
    [0.299, 0.587, 0.114],
    [-0.1687, -0.3313, 0.5],
    [0.5, -0.4187, -0.0813],
], dtype=np.float32)

YUV2RGB_JPEGBASIC = np.array([
    [1.0, 0.0, 1.40198758],
    [1.0, -0.344113281, -0.714103821],
    [1.0, 1.77197812, 0.0],
], dtype=np.float32)

RGB2YUV_ANALOG = np.array([
    [0.299, 0.587, 0.114],
    [-0.14713, -0.28886, 0.436],
    [0.615, -0.51499, -0.10001],
], dtype=np.float32)

YUV2RGB_ANALOG = np.array([
    [1.0, 0.0, 1.13983],
    [1.0, -0.39465, -0.58060],
    [1.0, 2.03211, 0.0],
], dtype=np.float32)

RGB2YCBCR_DIFFJPEG = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], dtype=np.float32)

YCBCR2RGB_DIFFJPEG = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136, -0.714136],
    [1.0, 1.772, 0.0],
], dtype=np.float32)

SHIFT_DIFFJPEG = (0.0, 128.0, 128.0)


def _apply(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    x0, x1, x2 = x.unbind(-1)
    return torch.stack([x0 * float(r[0]) + x1 * float(r[1]) + x2 * float(r[2])
                        for r in m], -1)


def rgb_to_yuv_jpegbasic(x: torch.Tensor) -> torch.Tensor:
    """RGB → YUV, (..., 3) float32 (jpeg.py:147-155)."""
    return _apply(x, RGB2YUV_JPEGBASIC)


def yuv_to_rgb_jpegbasic(x: torch.Tensor) -> torch.Tensor:
    """YUV → RGB, (..., 3) float32 (jpeg.py:157-163)."""
    return _apply(x, YUV2RGB_JPEGBASIC)


def rgb_to_yuv_analog(x: torch.Tensor) -> torch.Tensor:
    """RGB → YUV, analog BT.601, (..., 3) float32
    (jpeg_compression.py:52-58)."""
    return _apply(x, RGB2YUV_ANALOG)


def yuv_to_rgb_analog(x: torch.Tensor) -> torch.Tensor:
    """YUV → RGB, the reference's analog BT.601 "inverse", (..., 3) float32
    (jpeg_compression.py:60-63)."""
    return _apply(x, YUV2RGB_ANALOG)


def _shift(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(SHIFT_DIFFJPEG, dtype=x.dtype, device=x.device)


def rgb_to_ycbcr_diffjpeg(x: torch.Tensor) -> torch.Tensor:
    """RGB → YCbCr with the +128 chroma shift, input in [0, 255]
    (utils/JPEG.py:115-135)."""
    return _apply(x, RGB2YCBCR_DIFFJPEG) + _shift(x)


def ycbcr_to_rgb_diffjpeg(x: torch.Tensor) -> torch.Tensor:
    """YCbCr → RGB, the shift taken off first (utils/JPEG.py:408-428)."""
    return _apply(x - _shift(x), YCBCR2RGB_DIFFJPEG)


def rgb_to_y_bt601(x01: torch.Tensor) -> torch.Tensor:
    """Video-range BT.601 Y of (..., 3) in [0, 1], back in [0, 1]:
    ``(16 + 65.481·R + 128.553·G + 24.966·B) / 255``."""
    r, g, b = x01.unbind(-1)
    return (16.0 + 65.481 * r + 128.553 * g + 24.966 * b) / 255.0
