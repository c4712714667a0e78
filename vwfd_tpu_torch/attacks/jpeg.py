"""Differentiable JPEG pool (port of vwfd_tpu/attacks/jpeg.py:23-51,149-223).

``jpeg_pool`` is one draw from the reference's 15-member pool
``Combined([JpegMask(Q), Jpeg(Q), JpegSS(Q) for Q in 50..90])``
(models/IRNcrop_model.py:98-103); ``jpeg_pool_pair`` is
``w1·jpeg_pool(draw 1) + w2·jpeg_pool(draw 2)`` with the colour transform,
DCT and IDCT run once, through K5 (``kernels/jpeg.py``). The draws are
explicit tensors: the quality index into ``QUALITIES`` and the mode, 0 hard
round, 1 x³ soft round, 2 zonal 5×5/3×3 keep. Quality Q means the table
scale 2 − 0.02·Q (Q ≥ 50).
"""

import numpy as np
import torch

from ..ops.color import rgb_to_yuv_jpegbasic, yuv_to_rgb_jpegbasic
from ..ops.dct import block_merge, block_split, dct_blocks, idct_blocks
from ..ops.quantize import jpeg_scale_factor, round_only_at_0

__all__ = ["Y_TABLE", "C_TABLE", "QUALITIES", "quant_tables", "jpeg_pool",
           "jpeg_pool_pair"]

QUALITIES = (50, 60, 70, 80, 90)

# standard JPEG Annex-K quantisation tables (public ISO constants)
Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]],
    dtype=np.float32)


def quant_tables(q_idx: torch.Tensor) -> torch.Tensor:
    """Quality indices (...) into ``QUALITIES`` → tables (..., 2 (Y, C), 8,
    8) float32: ``max(round(T·scale), 1)`` with the JAX package's float32
    ops."""
    dev = q_idx.device
    q = torch.tensor(QUALITIES, dtype=torch.float32, device=dev)[q_idx]
    scale = jpeg_scale_factor(q)[..., None, None, None]
    tabs = torch.from_numpy(np.stack([Y_TABLE, C_TABLE])).to(dev)
    return torch.clamp(torch.round(tabs * scale), min=1.0)


def jpeg_pool(img: torch.Tensor, q_idx: torch.Tensor, mode: torch.Tensor
              ) -> torch.Tensor:
    """One pool draw per frame of (N, H, W, 3): quality index and mode
    (N,) each."""
    n = img.shape[0]
    yuv = rgb_to_yuv_jpegbasic(img * 255.0)
    coeff = dct_blocks(block_split(yuv.movedim(-1, -3)))
    q = quant_tables(q_idx)[:, [0, 1, 1], None, None]
    m = mode.view(n, 1, 1, 1, 1, 1)
    scaled = coeff / q
    quantized = torch.where(m == 0, torch.round(scaled),
                            round_only_at_0(scaled)) * q
    from ..kernels.jpeg import zonal_mask
    zm = zonal_mask(img.device)[:, None, None]
    out = torch.where(m == 2, coeff * zm, quantized)
    rgb = yuv_to_rgb_jpegbasic(block_merge(idct_blocks(out)).movedim(-3, -1))
    return rgb / 255.0


def jpeg_pool_pair(img: torch.Tensor, q_idx: torch.Tensor,
                   mode: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   kernels=None) -> torch.Tensor:
    """``w1·jpeg_pool(draw 1) + w2·jpeg_pool(draw 2)`` per frame of
    (N, H, W, 3), exactly, with one DCT and one IDCT: the dequantised
    coefficients are mixed, (w1·c1 + w2·c2)/(w1 + w2), and the RGB scaled
    by w1 + w2 (IDCT is linear, YUV→RGB affine). ``q_idx`` and ``mode`` are
    (N, 2); ``w1``, ``w2`` (N,). Runs ``kernels.jpeg_pair`` (K5; default
    ``kernels.KERNELS``)."""
    if kernels is None:
        from ..kernels import KERNELS as kernels
    qt = quant_tables(q_idx).contiguous()
    w = torch.stack([w1, w2], -1).float().contiguous()
    return kernels.jpeg_pair(img, qt, mode.to(torch.int32).contiguous(), w)
