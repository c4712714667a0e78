"""The flagship video attack pool (port of vwfd_tpu/attacks/combined.py:25-58).

Per frame: five attacked variants mixed by α = softmax(N(0,1)⁵) — the
*intended* semantics of models/IRNcrop_model.py:350-373 —
``α0·resize + jpeg_pair(α1, α2) + α3·median + α4·gauss``. The random draws
are an explicit ``AttackDraws``: ``sample_attack_draws`` makes them from a
``torch.Generator``; the tests derive them from a JAX key with the JAX
package's own split sequence, so both sides see the same draws. The resize
round trip is two batched ``torch.matmul``; the JPEG pair runs K5, the
median K6, and the gaussian blur, the mix and the epilogue the train and
eval steps put after the pool K9, through the kernel set.
"""

from typing import NamedTuple

import torch

from .blur import median_blur_attack
from .jpeg import QUALITIES, jpeg_pool_pair
from .spatial import DEFAULT_RATIOS, resize_roundtrip

__all__ = ["ATTACK_POOL_SIZE", "AttackDraws", "sample_attack_draws",
           "attack_pool_video", "combined_switch", "sample_switch_index"]

ATTACK_POOL_SIZE = 5  # resize, jpeg strong, jpeg weak, median, gaussian blur


class AttackDraws(NamedTuple):
    """Per-frame draws of the pool, frames in (B·T) order."""
    ratio_idx: torch.Tensor   # (B·T,) int64 index into the resize ratios
    quality_idx: torch.Tensor  # (B·T, 2) int64 index into jpeg.QUALITIES
    mode: torch.Tensor        # (B·T, 2) int64: 0 round, 1 soft, 2 zonal
    alpha: torch.Tensor       # (B·T, 5) float32 mixing weights

    def to(self, device) -> "AttackDraws":
        return AttackDraws(*(t.to(device) for t in self))


def sample_attack_draws(generator: torch.Generator, b: int, t: int,
                        n_ratios: int = len(DEFAULT_RATIOS)) -> AttackDraws:
    """Uniform ratio, quality and mode indices and α = softmax(N(0,1)⁵) per
    frame, from ``generator`` (on the generator's device)."""
    n = b * t
    dev = generator.device
    kw = {"generator": generator, "device": dev}
    return AttackDraws(
        torch.randint(0, n_ratios, (n,), **kw),
        torch.randint(0, len(QUALITIES), (n, 2), **kw),
        torch.randint(0, 3, (n, 2), **kw),
        torch.softmax(torch.randn(n, ATTACK_POOL_SIZE, **kw), -1))


def attack_pool_video(video: torch.Tensor, draws: AttackDraws,
                      ratios=None, kernels=None,
                      epilogue: str = "none") -> torch.Tensor:
    """(B, T, H, W, 3) in [0, 1] → the per-frame α-mix of the five attacks.
    ``ratios`` is the resize pool (None: the 21 ``DEFAULT_RATIOS``);
    ``kernels`` the kernel set (None: ``kernels.KERNELS``); ``epilogue``
    what follows the mix in the same pass (``kernels/mix.py``): ``"none"``
    (the JAX function), ``"clamp"`` (the eval step) or ``"quantize"`` (the
    train step's straight-through clamp and 8-bit quantizer)."""
    if kernels is None:
        from ..kernels import KERNELS as kernels
    b, t = video.shape[0], video.shape[1]
    flat = video.reshape((b * t,) + video.shape[2:]).contiguous()
    alpha = draws.alpha.to(flat.dtype).contiguous()
    a0 = resize_roundtrip(flat, draws.ratio_idx,
                          DEFAULT_RATIOS if ratios is None else ratios)
    a_jpeg = jpeg_pool_pair(flat, draws.quality_idx, draws.mode,
                            alpha[:, 1], alpha[:, 2], kernels=kernels)
    a3 = median_blur_attack(flat, kernels=kernels)
    out = kernels.attack_mix(flat, a0.contiguous(), a_jpeg, a3, alpha,
                             epilogue)
    return out.reshape(video.shape)


def sample_switch_index(generator: torch.Generator, n: int) -> int:
    """``combined_switch``'s draw: a uniform member index in [0, n)."""
    return int(torch.randint(0, n, (), generator=generator,
                             device=generator.device))


def combined_switch(img: torch.Tensor, attack_fns, idx) -> torch.Tensor:
    """Uniform random member selection (noise_layers/combined.py:15-20;
    ``vwfd_tpu/attacks/combined.py:13-22``): member ``idx`` (the explicit
    draw, ``sample_switch_index``) of ``attack_fns``, each a function of
    the image with its own draws bound."""
    return attack_fns[int(idx)](img)
