"""Synthetic video clips and still images (port of
vwfd_tpu/data/synthetic.py:10-61). Video: smooth
random frames with a per-clip tamper mask, the DVDataset batch contract
``(video (T,H,W,3), mask (T,H,W,1))`` in [0, 1], float32. The frames and the
rectangle masks equal the JAX package's for the same seed and index; the
stroke masks come from the port's numpy rasteriser (``masks.py``). The
image family's items (``CannyImages``: an image and its host canny map)
and per-batch stroke masks (``stroke_masks``) sit beside them."""

import numpy as np

from .edges import canny_map
from .masks import free_form_stroke_mask, random_rect_mask

__all__ = ["SyntheticVideoDataset", "SyntheticImageDataset",
           "SpliceForgeryDataset", "CannyImages", "stroke_masks"]


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


class SyntheticImageDataset:
    """Blocky 8×8 random images plus 5 % fine noise (synthetic.py:44-61)."""

    def __init__(self, size=256, length=1000, seed=0):
        self.size = size
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 99991 + idx)
        h = w = self.size
        base = rng.random((h // 8, w // 8, 3)).astype(np.float32)
        img = np.repeat(np.repeat(base, 8, axis=0), 8, axis=1)
        img = np.clip(img + 0.05 * rng.random((h, w, 3)), 0,
                      1).astype(np.float32)
        return img


class SpliceForgeryDataset:
    """Composed splice forgeries of the Tianchi family: a one-frame
    ``SyntheticVideoDataset`` item with the content of the donor item
    ``(i·7919 + 1) mod length`` pasted through its mask, ``(image (H, W,
    3), mask (H, W, 1))`` float32 (the JAX ``train.py::_tianchi_loop`` and
    ``tools/run_family_convergence.py::_tianchi``'s ``_Img``; the
    reference's tianchi data are forged images and their masks,
    tianchi_dataset.py:16-77). The stroke masks are the port's rasteriser's
    (F11: each stroke within IoU 0.9 of cv2's pixels), so the images
    differ from the JAX runner's where the two masks differ."""

    def __init__(self, size=256, length=2000, seed=0):
        self.base = SyntheticVideoDataset(size=size, frames=1, length=length,
                                          seed=seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        video, mask = self.base[i]
        donor, _ = self.base[(i * 7919 + 1) % len(self.base)]
        img = video[0] * (1 - mask[0]) + donor[0] * mask[0]
        return img.astype(np.float32), mask[0]


class CannyImages:
    """The image family's items of a dataset of (H, W, 3) images (or of
    ``{"image": ...}`` items): ``(image, canny)`` with the host canny map
    (``edges.canny_map``, the JAX image loops' ``cv2.Canny``), or the image
    alone without ``with_canny`` (ImugeV2 embeds the previous batch, not
    the canny)."""

    def __init__(self, base, with_canny: bool = True):
        self.base, self.with_canny = base, with_canny

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        item = self.base[i]
        img = item["image"] if isinstance(item, dict) else item
        return (img, canny_map(img)) if self.with_canny else img


def stroke_masks(seed, n: int, size) -> np.ndarray:
    """(n, H, W, 1) free-form stroke masks from ``default_rng(seed)`` (a
    seed or a sequence, e.g. (data seed, batch index)): each batch's masks
    from a generator of its own, so a resumed run draws the same ones
    (the JAX loops draw them per item from one generator that the loader's
    threads share)."""
    rng = np.random.default_rng(seed)
    return np.stack([free_form_stroke_mask(rng, size)
                     for _ in range(n)])[..., None].astype(np.float32)
