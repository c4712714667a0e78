"""JPEG colour pair (port of vwfd_tpu/ops/color.py:21-31, 61-75).

The Jpeg/JpegSS/JpegMask coefficient set of the reference
(noise_layers/jpeg.py:147-163). Each output channel is the 3-term sum
``x0·m[o][0] + x1·m[o][1] + x2·m[o][2]`` in float32, left to right, one
rounding per operation: the JAX package's HIGHEST-precision 3×3
contraction, in an order that K5 (``csrc/jpeg.cu``) repeats.
"""

import numpy as np
import torch

__all__ = ["rgb_to_yuv_jpegbasic", "yuv_to_rgb_jpegbasic",
           "RGB2YUV_JPEGBASIC", "YUV2RGB_JPEGBASIC"]

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
