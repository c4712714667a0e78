"""DAVIS video dataset (port of vwfd_tpu/data/davis.py; reference:
data/Dataloader.py ``DVDataset:59-99``): ``JPEGImages/480p/<video>/*.jpg``
frames paired with ``Annotations/480p/<video>/*.png`` masks at ``size²``.

The same selection as the JAX module, draw for draw from
``np.random.default_rng(seed)``: a random video per fetch (the index is
ignored, Dataloader.py:78), a random start, rejection of videos that are
too short, lack a mask, or whose mean mask rate is ≥ ``mask_rate_max`` or
0, and a persistent skip list of them (``:71,79-95``).

Decoding and resizing come from the caller: ``read_frame(path, size)`` →
float32 RGB (size, size, 3) in [0, 1] and ``read_mask(path, size)`` →
float32 (size, size) in {0, 1}; the port reads no image library.
``cv2_readers`` builds the JAX module's readers (``davis.py:34-43``) from
OpenCV where it imports.
"""

import os
from typing import Callable, Tuple

import numpy as np

__all__ = ["DavisVideoDataset", "cv2_readers"]

Reader = Callable[[str, int], np.ndarray]


def cv2_readers() -> Tuple[Reader, Reader]:
    """``(read_frame, read_mask)`` through OpenCV, as
    ``vwfd_tpu/data/davis.py:34-43``: BGR→RGB, bilinear resize, /255; masks
    gray, nearest resize, > 0. Raises ImportError without ``cv2``."""
    import cv2

    def read_frame(path, size):
        img = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]  # BGR→RGB
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        return img.astype(np.float32) / 255.0

    def read_mask(path, size):
        m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        m = cv2.resize(m, (size, size), interpolation=cv2.INTER_NEAREST)
        return (m > 0).astype(np.float32)

    return read_frame, read_mask


class DavisVideoDataset:
    def __init__(self, root, read_frame: Reader, read_mask: Reader,
                 size=256, frames=4, mask_rate_max=0.2, seed=0):
        self.image_root = os.path.join(root, "JPEGImages", "480p")
        self.mask_root = os.path.join(root, "Annotations", "480p")
        self.read_frame, self.read_mask = read_frame, read_mask
        self.size = size
        self.frames = frames
        self.mask_rate_max = mask_rate_max
        self.videos = sorted(os.listdir(self.image_root))
        self.skip_list = set()
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx):
        # rejection-sample a video with an acceptable tamper area
        for _ in range(10 * len(self.videos)):
            vid = self.videos[int(self.rng.integers(len(self.videos)))]
            if vid in self.skip_list:
                continue
            img_dir = os.path.join(self.image_root, vid)
            mask_dir = os.path.join(self.mask_root, vid)
            frame_files = sorted(os.listdir(img_dir))
            if len(frame_files) < self.frames:
                self.skip_list.add(vid)
                continue
            start = int(self.rng.integers(0, len(frame_files) - self.frames + 1))
            sel = frame_files[start:start + self.frames]
            masks = []
            for f in sel:
                mp = os.path.join(mask_dir, os.path.splitext(f)[0] + ".png")
                if not os.path.exists(mp):
                    break
                masks.append(self.read_mask(mp, self.size))
            if len(masks) < len(sel):
                self.skip_list.add(vid)
                continue
            rate = float(np.mean(masks))
            if rate >= self.mask_rate_max or rate == 0.0:
                self.skip_list.add(vid)
                continue
            video = np.stack([self.read_frame(os.path.join(img_dir, f),
                                              self.size)
                              for f in sel])             # (T, H, W, 3)
            mask = np.stack(masks)[..., None]            # (T, H, W, 1)
            return video, mask
        raise IOError("no DAVIS video satisfied the mask-rate bound")
