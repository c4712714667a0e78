"""Still-image folder dataset (port of vwfd_tpu/data/images.py; reference:
data/LQGT_dataset.py, data/tianchi_dataset.py): every image under ``root``
(png, jpg, jpeg, bmp, webp; sorted paths), read at ``size²`` by the
caller's ``read_image(path, size)`` (float32 RGB in [0, 1]; ``data.
cv2_readers``'s ``read_frame`` is the JAX module's reader), with the JAX
module's augmentation drawn from ``np.random.default_rng(seed)``: a
horizontal flip with probability ½, then ``k`` quarter turns, ``k``
uniform in 0..3. Items are ``{"image": (size, size, 3)}``.

With ``mask_root`` (Tianchi's forgery masks, ``images.py:50-55``) each item
also holds ``"mask"``: the file of the image's base name under
``mask_root``, read by the caller's ``read_mask(path, size)`` (float32
(size, size) in {0, 1}; ``cv2_mask_reader`` is the JAX module's: gray,
nearest resize, > 127), shaped (size, size, 1). As in the JAX module the
mask is not augmented. With ``with_canny`` (the image family's watermark
channel, ``images.py:46-48``) each item also holds ``"canny"``: the host
canny map of the augmented image (``data/edges.py::canny_map``, bit-equal
to ``cv2.Canny`` of its 8-bit gray image, 100, 200), (size, size, 1).
"""

import os
from typing import Callable, Optional

import numpy as np

from .edges import canny_map

__all__ = ["ImageFolderDataset", "cv2_mask_reader"]

_IMG_EXT = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


Reader = Callable[[str, int], np.ndarray]


def cv2_mask_reader() -> Reader:
    """``read_mask(path, size)`` through OpenCV, as ``vwfd_tpu/data/
    images.py:50-55``: gray, nearest resize to ``size²``, > 127, float32.
    OpenCV is imported here: without it this raises an ``ImportError``
    that names it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the mask reader needs OpenCV (cv2), and it does "
                          "not import here") from e

    def read_mask(path, size):
        m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        m = cv2.resize(m, (size, size), interpolation=cv2.INTER_NEAREST)
        return (m > 127).astype(np.float32)

    return read_mask


class ImageFolderDataset:
    def __init__(self, root: str, read_image: Reader, size: int = 256,
                 augment: bool = True, with_canny: bool = False,
                 mask_root: Optional[str] = None,
                 read_mask: Optional[Reader] = None, seed: int = 0):
        self.paths = sorted(
            os.path.join(dp, f)
            for dp, _, fs in os.walk(root) for f in fs
            if f.lower().endswith(_IMG_EXT))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        if mask_root is not None and read_mask is None:
            raise ValueError("mask_root needs read_mask")
        self.read_image = read_image
        self.mask_root, self.read_mask = mask_root, read_mask
        self.size = size
        self.augment = augment
        self.with_canny = with_canny
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        path = self.paths[idx % len(self.paths)]
        img = self.read_image(path, self.size)
        if self.augment:
            if self.rng.random() < 0.5:
                img = img[:, ::-1]
            img = np.rot90(img, int(self.rng.integers(0, 4)), axes=(0, 1))
        out = {"image": np.ascontiguousarray(img, dtype=np.float32)}
        if self.with_canny:
            out["canny"] = canny_map(out["image"])
        if self.mask_root is not None:
            m = self.read_mask(os.path.join(self.mask_root,
                                            os.path.basename(path)),
                               self.size)
            out["mask"] = np.asarray(m, np.float32)[..., None]
        return out
