"""Synthetic video clips (port of vwfd_tpu/data/synthetic.py:10-41): smooth
random frames with a per-clip tamper mask, the DVDataset batch contract
``(video (T,H,W,3), mask (T,H,W,1))`` in [0, 1], float32. The frames and the
rectangle masks equal the JAX package's for the same seed and index; the
stroke masks come from the port's numpy rasteriser (``masks.py``)."""

import numpy as np

from .masks import free_form_stroke_mask, random_rect_mask

__all__ = ["SyntheticVideoDataset"]


class SyntheticVideoDataset:
    def __init__(self, size=256, frames=4, length=1000, mask_kind="stroke",
                 mask_rate_max=0.2, seed=0):
        self.size = size
        self.frames = frames
        self.length = length
        self.mask_kind = mask_kind
        self.mask_rate_max = mask_rate_max
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h = w = self.size
        # low-frequency "natural" frames with slow temporal drift
        base = rng.random((h // 8, w // 8, 3)).astype(np.float32)
        frames = []
        for t in range(self.frames):
            drift = base + 0.02 * t * rng.standard_normal(base.shape).astype(
                np.float32)
            up = np.repeat(np.repeat(drift, 8, axis=0), 8, axis=1)
            up = up + 0.05 * rng.random((h, w, 3)).astype(np.float32)
            frames.append(np.clip(up, 0, 1))
        video = np.stack(frames)
        if self.mask_kind == "stroke":
            m = free_form_stroke_mask(rng, (h, w),
                                      percent_range=(0.05, self.mask_rate_max))
        else:
            m = random_rect_mask(rng, (h, w), 0.05, self.mask_rate_max)
        mask = np.repeat(m[None, :, :, None], self.frames, axis=0)
        return video.astype(np.float32), mask.astype(np.float32)
