"""Resize round trip (port of vwfd_tpu/attacks/spatial.py:22-50).

The reference picks a random ratio in [0.5, 1.5] and runs two
``F.interpolate`` calls (noise_layers/resize.py:15-55). As in the JAX
package, the pool of ratios is fixed and each ratio's down∘up resampling
is one (S, S) matrix per axis; the ratio index is an explicit tensor, and
the two products run as batched ``torch.matmul`` (the JAX package leaves
the same two einsums to XLA).
"""

import functools

import numpy as np
import torch

from ..ops.resize import resize_matrix

__all__ = ["DEFAULT_RATIOS", "make_resize_roundtrip_pool", "resize_roundtrip"]

DEFAULT_RATIOS = tuple(np.round(np.arange(0.5, 1.51, 0.05), 2))


@functools.lru_cache(maxsize=None)
def make_resize_roundtrip_pool(size: int, ratios=DEFAULT_RATIOS
                               ) -> np.ndarray:
    """(len(ratios), size, size) float32: the bicubic down→up matrix per
    ratio."""
    mats = []
    for r in ratios:
        s = max(8, int(r * size))
        mats.append(resize_matrix(s, size) @ resize_matrix(size, s))
    return np.stack(mats).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pool_on(size, ratios, device) -> torch.Tensor:
    return torch.from_numpy(make_resize_roundtrip_pool(size, ratios)).to(
        device)


def resize_roundtrip(img: torch.Tensor, ratio_idx: torch.Tensor,
                     ratios=DEFAULT_RATIOS) -> torch.Tensor:
    """Per-frame bicubic down/up round trip of (N, H, W, C) through ratio
    ``ratios[ratio_idx[n]]``, then clipped to [0, 1]."""
    n, h, w, c = img.shape
    ratios = tuple(ratios)
    a = _pool_on(h, ratios, img.device)[ratio_idx]                # (N, H, H)
    b = _pool_on(w, ratios, img.device)[ratio_idx]                # (N, W, W)
    out = torch.matmul(a, img.reshape(n, h, w * c))               # rows
    out = out.reshape(n, h, w, c).transpose(1, 2).reshape(n, w, h * c)
    out = torch.matmul(b, out)                                    # columns
    out = out.reshape(n, w, h, c).transpose(1, 2)
    return torch.minimum(torch.maximum(out, out.new_zeros(())),
                         out.new_ones(()))
