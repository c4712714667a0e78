"""Still-image folder dataset (port of vwfd_tpu/data/images.py; reference:
data/LQGT_dataset.py): every image under ``root`` (png, jpg, jpeg, bmp,
webp; sorted paths), read at ``size²`` by the caller's
``read_image(path, size)`` (float32 RGB in [0, 1]; ``data.cv2_readers``'s
``read_frame`` is the JAX module's reader), with the JAX module's
augmentation drawn from ``np.random.default_rng(seed)``: a horizontal flip
with probability ½, then ``k`` quarter turns, ``k`` uniform in 0..3. Items
are ``{"image": (size, size, 3)}``. The canny edge map (``with_canny``) and
masks serve the image families, which the port has not taken over: it
raises.
"""

import os
from typing import Callable

import numpy as np

__all__ = ["ImageFolderDataset"]

_IMG_EXT = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class ImageFolderDataset:
    def __init__(self, root: str, read_image: Callable[[str, int], np.ndarray],
                 size: int = 256, augment: bool = True,
                 with_canny: bool = False, seed: int = 0):
        if with_canny:
            raise NotImplementedError("with_canny serves the image families, "
                                      "which are not ported yet")
        self.paths = sorted(
            os.path.join(dp, f)
            for dp, _, fs in os.walk(root) for f in fs
            if f.lower().endswith(_IMG_EXT))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.read_image = read_image
        self.size = size
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        img = self.read_image(self.paths[idx % len(self.paths)], self.size)
        if self.augment:
            if self.rng.random() < 0.5:
                img = img[:, ::-1]
            img = np.rot90(img, int(self.rng.integers(0, 4)), axes=(0, 1))
        return {"image": np.ascontiguousarray(img, dtype=np.float32)}
