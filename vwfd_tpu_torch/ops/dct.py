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
           "idct_blocks", "dct8x8", "idct8x8"]


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
    c = dct_matrix(b.device)
    return torch.matmul(torch.matmul(c, b), c.t())


def idct_blocks(b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``dct_blocks``: ``Cᵀ @ B @ C``."""
    c = dct_matrix(b.device)
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
