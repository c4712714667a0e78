"""Symmetric (half-sample) padding (port of vwfd_tpu/ops/pad.py:13-33).

``symm_pad`` repeats the edge pixel (index −1 reads 0, index H reads H − 1):
neither torch's ``reflect`` (which skips the edge) nor its ``replicate``
(which repeats it without end). As in the JAX package the index map is
built in numpy from the static pad amounts, and the pad is one gather.
"""

import numpy as np
import torch

__all__ = ["reflect_index", "symm_pad"]


def reflect_index(x: np.ndarray, minx: float, maxx: float) -> np.ndarray:
    """Triangular-wave reflection of the index array ``x`` into [minx, maxx]
    (models/networks.py:548-557)."""
    rng = maxx - minx
    double_rng = 2 * rng
    mod = np.fmod(x - minx, double_rng)
    normed_mod = np.where(mod < 0, mod + double_rng, mod)
    out = np.where(normed_mod >= rng, double_rng - normed_mod,
                   normed_mod) + minx
    return np.array(out, dtype=np.int64)


def symm_pad(im: torch.Tensor, padding) -> torch.Tensor:
    """Symmetric-pad (..., H, W, C) by (left, right, top, bottom)."""
    left, right, top, bottom = padding
    h, w = im.shape[-3], im.shape[-2]
    x_pad = reflect_index(np.arange(-left, w + right), -0.5, w - 0.5)
    y_pad = reflect_index(np.arange(-top, h + bottom), -0.5, h - 0.5)
    ys = torch.from_numpy(y_pad).to(im.device)
    xs = torch.from_numpy(x_pad).to(im.device)
    return im.index_select(-3, ys).index_select(-2, xs)
