"""8×8 blockwise DCT-II / IDCT (port of vwfd_tpu/ops/dct.py).

The JAX package contracts whole rows with the block-diagonal operator
``I ⊗ C8`` (a TPU choice, ``dct.py:30-38``); here each 8×8 block of a
``block_split`` view is transformed on its own, ``C @ B @ Cᵀ`` (columns,
then rows, the JAX package's order), with the same float32 orthonormal
matrix.
"""

import functools

import numpy as np
import torch

__all__ = ["dct_matrix", "block_split", "block_merge", "dct_blocks",
           "idct_blocks", "dct8x8", "idct8x8", "zigzag_keep_mask",
           "Y_TABLE", "C_TABLE"]

# standard JPEG Annex-K quantisation tables (public ISO constants), the
# attacks' (attacks/jpeg.py) and, transposed, DiffJPEG's (kernels/diffjpeg.py)
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


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(n: int = 8) -> np.ndarray:
    """Orthonormal DCT-II: C[0,:] = √(1/n); C[i,j] = √(2/n)·cos(πi(2j+1)/2n),
    built in float64 and rounded to float32 (dct.py:17-27)."""
    c = np.zeros((n, n), dtype=np.float64)
    c[0, :] = np.sqrt(1.0 / n)
    for i in range(1, n):
        for j in range(n):
            c[i, j] = np.cos(np.pi * i * (2 * j + 1) / (2 * n)) * np.sqrt(2.0 / n)
    return c.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_matrix_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dct_matrix_np(8)).to(device)


def dct_matrix(device) -> torch.Tensor:
    """The float32 8×8 DCT matrix on ``device`` (cached per device)."""
    return _dct_matrix_on(torch.device(device))


def block_split(x: torch.Tensor, k: int = 8) -> torch.Tensor:
    """(..., H, W) → (..., H/k, W/k, k, k), a view."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // k, k, w // k, k).transpose(-3, -2)


def block_merge(x: torch.Tensor) -> torch.Tensor:
    """(..., H/k, W/k, k, k) → (..., H, W)."""
    *lead, hb, wb, k, k2 = x.shape
    return x.transpose(-3, -2).reshape(*lead, hb * k, wb * k2)


def dct_blocks(b: torch.Tensor) -> torch.Tensor:
    """DCT of every 8×8 block of (..., 8, 8): ``C @ B @ Cᵀ``."""
    c = dct_matrix(b.device).to(b.dtype)
    return torch.matmul(torch.matmul(c, b), c.t())


def idct_blocks(b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``dct_blocks``: ``Cᵀ @ B @ C``."""
    c = dct_matrix(b.device).to(b.dtype)
    return torch.matmul(torch.matmul(c.t(), b), c)


def dct8x8(x: torch.Tensor, center: bool = False) -> torch.Tensor:
    """Blockwise 2-D DCT of (..., H, W), H and W multiples of 8.
    ``center=True`` subtracts 128 first (utils/JPEG.py:204)."""
    if center:
        x = x - 128.0
    return block_merge(dct_blocks(block_split(x)))


def idct8x8(x: torch.Tensor, center: bool = False) -> torch.Tensor:
    """Inverse blockwise 2-D DCT; ``center=True`` adds 128 back."""
    out = block_merge(idct_blocks(block_split(x)))
    return out + 128.0 if center else out


@functools.lru_cache(maxsize=None)
def zigzag_keep_mask(window: int, keep: int, h: int, w: int) -> np.ndarray:
    """(h, w) float32: 1 on the first ``keep`` coefficients of each
    ``window``² block in zig-zag order, tiled (vwfd_tpu/attacks/jpeg.py:
    236-246, the reference's noise_layers/jpeg_compression.py:30-43)."""
    mask = np.zeros((window, window), dtype=np.float32)
    order = sorted(((x, y) for x in range(window) for y in range(window)),
                   key=lambda p: (p[0] + p[1],
                                  -p[1] if (p[0] + p[1]) % 2 else p[1]))
    for i, j in order[:keep]:
        mask[i, j] = 1
    tiled = np.tile(mask, (int(np.ceil(h / window)),
                           int(np.ceil(w / window))))
    return tiled[:h, :w]
