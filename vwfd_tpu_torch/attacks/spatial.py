"""Spatial attacks (port of vwfd_tpu/attacks/spatial.py:22-108).

HiDDeN's members take their draws as explicit tensors (the JAX package
draws them from a key inside the call): ``sample_crop_apex`` (:53-67) maps
four U[0, 1) draws to a crop window with the reference's coupled ratios,
``crop_attack`` (:70-77) crops and resamples it back through K17
(``kernels/crop_resize.py``) with the window on the device, ``cropout``
(:89-98) pastes a window of the image onto the cover, ``dropout_mix``
(:101-108) mixes image and cover pixels through one keep ratio and one
(H, W) mask shared by the batch; ``rect_mask`` (:80-86) is
``data/ondevice.py``'s.

Resize round trip (:22-50):
The reference picks a random ratio in [0.5, 1.5] and runs two
``F.interpolate`` calls (noise_layers/resize.py:15-55). As in the JAX
package, the pool of ratios is fixed and each ratio's down∘up resampling
is one (S, S) matrix per axis; the ratio index is an explicit tensor, and
the two products run as batched ``torch.matmul`` (the JAX package leaves
the same two einsums to XLA).

The image family's tamper (:111-146): ``shift_zero_pad`` moves (N, H, W,
C) by whole pixels with zero fill, ``copy_move_tamper`` pastes a shifted
copy of the image (detached, JAX's ``stop_gradient``) through the shifted
stroke mask, which becomes the new ground truth. The shift is an explicit
draw (``copy_move_shift`` maps the two U[0, 1) draws to it as JAX does).
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..data.ondevice import rect_mask
from ..ops.resize import resize_matrix

__all__ = ["DEFAULT_RATIOS", "make_resize_roundtrip_pool", "resize_roundtrip",
           "sample_crop_apex", "crop_attack", "rect_mask", "cropout",
           "cropout_apex", "dropout_mix", "shift_zero_pad",
           "copy_move_shift", "copy_move_tamper"]

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


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(key, minval=lo, maxval=hi)`` from its raw
    U[0, 1) draw ``u``, with its float32 operations."""
    lo_t = torch.full((), lo, dtype=torch.float32, device=u.device)
    span = torch.full((), hi, dtype=torch.float32, device=u.device) - lo_t
    return torch.maximum(lo_t, u * span + lo_t)


def sample_crop_apex(u: torch.Tensor, hw, min_rate: float = 0.5,
                     max_rate: float = 1.0) -> torch.Tensor:
    """Crop window (h0, h1, w0, w1), a (4,) float32 tensor of integer
    pixel bounds, from ``u`` (4,) U[0, 1) draws (the height ratio, the
    width ratio, the row and the column offset): each ratio is clipped to
    within 0.2 of the other (noise_layers/crop.py:32-44)."""
    h, w = hw
    hr = _uniform(u[0], min_rate, max_rate)
    wr = _uniform(u[1], min_rate, max_rate)
    hr = torch.minimum(hr, wr + 0.2)
    wr = torch.minimum(wr, hr + 0.2)
    ch = torch.floor(hr * h)
    cw = torch.floor(wr * w)
    h0 = torch.floor(u[2] * (h - ch + 1))
    w0 = torch.floor(u[3] * (w - cw + 1))
    return torch.stack([h0, h0 + ch, w0, w0 + cw])


def crop_attack(img: torch.Tensor, apex: torch.Tensor,
                kernels=None) -> torch.Tensor:
    """Crop ``apex`` of (N, H, W, 3) and resample it bilinearly back to
    (H, W) (noise_layers/crop.py:32-52), through ``kernels.crop_resize``
    (K17; default ``kernels.KERNELS``)."""
    if kernels is None:
        from ..kernels import KERNELS as kernels
    return kernels.crop_resize(img, apex)


def cropout_apex(u: torch.Tensor, hw, height_ratio: float = 0.5,
                 width_ratio: float = 0.5) -> torch.Tensor:
    """The cropout window from ``u`` (2,) U[0, 1) draws (the JAX package's
    ``key`` and ``fold_in(key, 1)``)."""
    h, w = hw
    h0 = torch.floor(u[0] * (h * (1 - height_ratio)))
    w0 = torch.floor(u[1] * (w * (1 - width_ratio)))
    return torch.stack([h0, h0 + h * height_ratio, w0, w0 + w * width_ratio])


def cropout(img: torch.Tensor, cover: torch.Tensor, u: torch.Tensor,
            height_ratio: float = 0.5, width_ratio: float = 0.5
            ) -> torch.Tensor:
    """Paste a window of ``img`` onto ``cover`` (noise_layers/crop.py
    Cropout:121-133); ``height_ratio = width_ratio = 0.5477`` keeps the
    paper's 30 % of the area."""
    apex = cropout_apex(u, img.shape[-3:-1], height_ratio, width_ratio)
    m = rect_mask(tuple(img.shape[-3:-1]), apex.unbind())[..., None]
    return img * m + cover * (1 - m)


def dropout_mix(img: torch.Tensor, cover: torch.Tensor, keep_u: torch.Tensor,
                mask_u: torch.Tensor, keep_min: float = 0.5,
                keep_max: float = 1.0) -> torch.Tensor:
    """Keep a pixel of ``img`` where the (H, W) draw ``mask_u`` lies below
    the keep ratio drawn from ``keep_u`` in [keep_min, keep_max), else the
    cover's (noise_layers/dropout.py:4-26)."""
    keep = _uniform(keep_u, keep_min, keep_max)
    mask = (mask_u < keep).to(img.dtype)[..., None]
    return img * mask + cover * (1 - mask)


def shift_zero_pad(x: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """``out[i, j] = x[i − dx, j − dy]`` on (N, H, W, C), zeros where the
    source falls outside the frame; |dx| ≤ H/2, |dy| ≤ W/2."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = h // 2, w // 2
    if abs(dx) > ph or abs(dy) > pw:
        raise ValueError(f"shift ({dx}, {dy}) beyond half the frame")
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    return xp[..., ph - dx:ph - dx + h, pw - dy:pw - dy + w, :]


def copy_move_shift(ux: float, uy: float, hw, max_shift_frac: float = 0.5):
    """The shift (dx, dy) from two U[0, 1) draws, JAX's float32
    ``floor(H·frac·(2u − 1))`` (``:127-130``)."""
    h, w = hw
    f32 = np.float32
    dx = math.floor(f32(h * max_shift_frac) * (f32(2.0) * f32(ux) - f32(1.0)))
    dy = math.floor(f32(w * max_shift_frac) * (f32(2.0) * f32(uy) - f32(1.0)))
    return int(dx), int(dy)


def copy_move_tamper(img: torch.Tensor, mask: torch.Tensor, shift):
    """Copy-move self-paste (models/IRNp_model.py:561-601): the detached
    image and its mask (B, H, W, 1) shifted by ``shift`` (dx, dy), the
    shifted content pasted through the shifted mask (clipped to [0, 1] as
    ``jnp.clip``). Returns ``(tampered, shifted_mask)``."""
    dx, dy = shift
    shifted = shift_zero_pad(img.detach(), dx, dy)
    m = shift_zero_pad(mask, dx, dy)
    m = torch.minimum(torch.maximum(m, m.new_zeros(())), m.new_ones(()))
    return img * (1.0 - m) + shifted * m, m
