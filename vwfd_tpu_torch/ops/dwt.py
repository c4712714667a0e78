"""Block-layout Haar DWT / IWT (port of vwfd_tpu/ops/dwt.py; the
reference's network/common.py:32-66 ``dwt_init`` / ``iwt_init``).

NHWC. The bands are stacked [LL | HL | LH | HH] on the channel axis (each
band's channels together, not interleaved per input channel as
``ops/haar.py``'s), with the reference's signs; the same halvings and sums
in the same order as the JAX package.
"""

import torch

__all__ = ["dwt", "iwt"]


def dwt(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) → (..., H/2, W/2, 4C), bands [LL | HL | LH | HH]."""
    x1 = x[..., 0::2, 0::2, :] / 2  # even row, even col
    x2 = x[..., 1::2, 0::2, :] / 2  # odd row, even col
    x3 = x[..., 0::2, 1::2, :] / 2  # even row, odd col
    x4 = x[..., 1::2, 1::2, :] / 2  # odd row, odd col
    ll = x1 + x2 + x3 + x4
    hl = -x1 - x2 + x3 + x4
    lh = -x1 + x2 - x3 + x4
    hh = x1 - x2 - x3 + x4
    return torch.cat([ll, hl, lh, hh], -1)


def iwt(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``dwt``: (..., H, W, 4C) → (..., 2H, 2W, C)."""
    c = x.shape[-1] // 4
    x1 = x[..., 0 * c:1 * c] / 2
    x2 = x[..., 1 * c:2 * c] / 2
    x3 = x[..., 2 * c:3 * c] / 2
    x4 = x[..., 3 * c:4 * c] / 2
    ee = x1 - x2 - x3 + x4   # even row, even col
    oe = x1 - x2 + x3 - x4   # odd row, even col
    eo = x1 + x2 - x3 - x4   # even row, odd col
    oo = x1 + x2 + x3 + x4   # odd row, odd col
    *lead, h, w, _ = ee.shape
    row0 = torch.stack([ee, eo], -2)     # (..., h, w, 2, c)
    row1 = torch.stack([oe, oo], -2)
    out = torch.stack([row0, row1], -4)  # (..., h, 2, w, 2, c)
    return out.reshape(*lead, 2 * h, 2 * w, c)
