"""Synthetic clips generated on the model's device (port of the generator of
``tools/run_convergence.py:123-140``, which ``tools/exp_int8_eval.py:78-89``
repeats), and ``rect_mask`` (port of vwfd_tpu/attacks/spatial.py:80-86).

A batch of the convergence runner's clip family: smooth "natural" content,
a coarse ``U(0, 1)`` grid of shape (B, 1, 16, 16, 3) upsampled bilinearly to
S², plus a per-frame drift ``0.05·N(0, 1)`` of shape (B, T, 1, 1, 3),
clipped to [0, 1]; and a tamper rectangle per clip, its corner ``U·0.7·S``
and its size ``0.15·S + U·0.25·S`` along each axis, the same in every
frame.

The draws and the batch are apart: ``sample_clip_draws`` draws them from an
explicit ``torch.Generator`` (on the device where the batch is made: no host
copies), ``clips_from_draws`` makes the batch from any draws, so a test can
feed it the JAX generator's. ``seeded_generator`` gives the generator of one
stream at one step, so that a stream is a function of ``(seed, step)`` and a
run resumed from a checkpoint draws what an unbroken run draws.
"""

from typing import NamedTuple, Tuple

import torch

from ..ops.resize import resize_bilinear

__all__ = ["ClipDraws", "rect_mask", "sample_clip_draws",
           "clips_from_draws", "seeded_generator", "synthetic_clips"]

COARSE = 16  # the coarse grid's side


class ClipDraws(NamedTuple):
    """The random draws of one batch, as the JAX generator draws them."""
    coarse: torch.Tensor  # (B, 1, 16, 16, 3) U(0, 1)
    noise: torch.Tensor   # (B, T, 1, 1, 3) N(0, 1); the drift is 0.05·noise
    corner: torch.Tensor  # (B, 2) U(0, 1); the corner is corner·0.7·S
    size: torch.Tensor    # (B, 2) U(0, 1); the size is 0.15·S + size·0.25·S


def rect_mask(hw: Tuple[int, int], apex) -> torch.Tensor:
    """Float mask, 1 inside ``apex = (h0, h1, w0, w1)`` (half-open, in
    pixel coordinates): (H, W) for scalar bounds, (..., H, W) for bounds of
    shape (...)."""
    h, w = hw
    h0, h1, w0, w1 = (torch.as_tensor(a, dtype=torch.float32)[..., None, None]
                      for a in apex)
    ys = torch.arange(h, dtype=torch.float32, device=h0.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=h0.device)[None, :]
    return ((ys >= h0) & (ys < h1) & (xs >= w0) & (xs < w1)).float()


def sample_clip_draws(gen: torch.Generator, b: int, t: int) -> ClipDraws:
    """One batch's draws from ``gen``, on the generator's device."""
    kw = {"generator": gen, "device": gen.device}
    return ClipDraws(torch.rand(b, 1, COARSE, COARSE, 3, **kw),
                     torch.randn(b, t, 1, 1, 3, **kw),
                     torch.rand(b, 2, **kw), torch.rand(b, 2, **kw))


def clips_from_draws(d: ClipDraws, size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch of ``d``: video (B, T, S, S, 3) and mask (B, T, S, S, 1),
    float32, contiguous, on the draws' device."""
    b, t = d.noise.shape[:2]
    s = size
    video = torch.clamp(resize_bilinear(d.coarse, (s, s)) + 0.05 * d.noise,
                        0.0, 1.0)
    h0 = d.corner * (0.7 * s)
    sz = 0.15 * s + d.size * (0.25 * s)
    m = rect_mask((s, s), (h0[:, 0], h0[:, 0] + sz[:, 0], h0[:, 1],
                           h0[:, 1] + sz[:, 1]))
    mask = m[:, None, :, :, None].expand(b, t, s, s, 1)
    return video.contiguous(), mask.contiguous()


def seeded_generator(device, seed: int, stream: int, step: int
                     ) -> torch.Generator:
    """A generator on ``device`` whose state is a function of ``(seed,
    stream, step)`` alone."""
    mixed = ((seed * 1_000_003 + stream) * 1_000_000_007 + step) % 2 ** 63
    return torch.Generator(device).manual_seed(mixed)


def synthetic_clips(device, seed: int, stream: int, step: int, b: int,
                    t: int, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch of stream ``stream`` at ``step``: ``clips_from_draws`` of
    draws from ``seeded_generator(device, seed, stream, step)``."""
    gen = seeded_generator(device, seed, stream, step)
    return clips_from_draws(sample_clip_draws(gen, b, t), size)
