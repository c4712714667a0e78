"""Pixel-noise attacks (port of vwfd_tpu/attacks/noise.py:7-29): identity,
additive gaussian with its clip, salt and pepper, pixel dropout. Each takes
its noise as an explicit tensor of the image's shape (the JAX package draws
it from a key)."""

import torch

from ..kernels.zigzag import clip01

__all__ = ["identity", "gaussian_noise", "salt_pepper", "dropout_pixelwise"]


def identity(img: torch.Tensor) -> torch.Tensor:
    """Pass-through (noise_layers/identity.py)."""
    return img


def gaussian_noise(img: torch.Tensor, noise: torch.Tensor, mean: float = 0.0,
                   stddev: float = 0.05, clip: bool = True) -> torch.Tensor:
    """``img + mean + stddev·noise`` with ``noise`` N(0, 1), clipped to
    [0, 1] as ``jnp.clip`` (noise_layers/gaussian.py:4-17)."""
    out = img + mean + stddev * noise
    return clip01(out) if clip else out


def salt_pepper(img: torch.Tensor, rdn: torch.Tensor, prob: float = 0.01
                ) -> torch.Tensor:
    """0 where the U[0, 1) draw ``rdn`` exceeds 1 − prob/2, 1 where it lies
    below prob/2 (noise_layers/salt_pepper_noise.py)."""
    out = torch.where(rdn > 1.0 - prob / 2.0, torch.zeros_like(img), img)
    return torch.where(rdn < prob / 2.0, torch.ones_like(out), out)


def dropout_pixelwise(img: torch.Tensor, cover: torch.Tensor,
                      rdn: torch.Tensor, prob: float = 0.5) -> torch.Tensor:
    """The cover's value where the U[0, 1) draw ``rdn`` exceeds ``prob``
    (noise_layers/crop.py Dropout:136-147)."""
    return torch.where(rdn > prob, cover, img)
