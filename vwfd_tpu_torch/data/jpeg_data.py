"""JPEG-centric datasets (port of vwfd_tpu/data/jpeg_data.py): the KD-JPEG
family's data (``:54-85``; the reference's LQ dataset,
data/LQ_dataset.py:16-100) and the DCT-domain data (``:88-125``).

``LQJpegDataset``: each item is the clean image and its real JPEG at each
of ``qualities`` (10, 30, 50, 70, 90), stacked as (1 + Q, H, W, 3), with
labels 0..Q (class 0 the clean image). The images are the synthetic
family (``SyntheticImageDataset(size, synthetic_length or 1000, seed)``)
or an image folder (``root`` with the caller's ``read_image``, no
augmentation). The encoder is the JAX module's: ``(img·255).round()``
(numpy's half-to-even) to uint8 with no clip, PIL's JPEG at the quality
with PIL's default chroma subsampling (4:2:0), decoded back to [0, 1].
That is a different codec from ``attacks.jpeg_real`` (a clip, then 4:4:4),
which the image model's simulator pairs take; the two stay apart. PIL is
imported in ``_jpeg``, not with the module: without it ``_jpeg`` raises an
``ImportError`` that names it.

``DCTDomainDataset`` (the vendored datasets/dataset_imagenet_dct.py
pipeline): each image as normalised 8×8 DCT coefficients, Y at the full
block grid and Cb/Cr (2×2 means, 4:2:0) at half, each band standardised
over the image, ``{"dct_y", "dct_cb", "dct_cr"}`` of (H/8, W/8, 64) and
(H/16, W/16, 64) float32; the JAX module's numpy arithmetic, the DCT through
K25 (``native.blockwise_dct``, the host kernel: Y in one call, Cb and Cr
in another). ``blockwise_dct_np`` is K25 (the JAX module's name; it has no
numpy fallback, ``native.py``).
"""

import io
from typing import Callable, Optional

import numpy as np

from .images import ImageFolderDataset
from .synthetic import SyntheticImageDataset

__all__ = ["LQJpegDataset", "LQ_QUALITIES", "DCTDomainDataset",
           "blockwise_dct_np"]

LQ_QUALITIES = (10, 30, 50, 70, 90)


class LQJpegDataset:
    def __init__(self, root: Optional[str] = None, size: int = 256,
                 qualities=LQ_QUALITIES, synthetic_length: int = 0,
                 seed: int = 0,
                 read_image: Optional[Callable] = None):
        self.qualities = tuple(qualities)
        self.size = size
        self.seed = seed
        if root is not None:
            if read_image is None:
                raise ValueError("an image folder needs read_image "
                                 "(data.cv2_readers()[0])")
            self.base = ImageFolderDataset(root, read_image, size=size,
                                           augment=False)
            self.synthetic = False
        else:
            self.base = SyntheticImageDataset(
                size=size, length=synthetic_length or 1000, seed=seed)
            self.synthetic = True

    def __len__(self):
        return len(self.base)

    def _jpeg(self, img01: np.ndarray, q) -> np.ndarray:
        """PIL's JPEG of one (H, W, 3) image at quality ``q``, 4:2:0."""
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("LQJpegDataset needs PIL (Pillow) for libjpeg, "
                              "and it does not import here") from e
        u8 = (img01 * 255).round().astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(u8).save(buf, format="JPEG", quality=int(q))
        return np.asarray(Image.open(buf), np.float32) / 255.0

    def __getitem__(self, idx):
        item = self.base[idx]
        img = item["image"] if isinstance(item, dict) else item
        versions = [img] + [self._jpeg(img, q) for q in self.qualities]
        labels = np.arange(len(versions), dtype=np.int32)
        return np.stack(versions), labels  # (1+Q, H, W, 3), (1+Q,)


def blockwise_dct_np(plane: np.ndarray) -> np.ndarray:
    """(H, W) float32 → (H/8, W/8, 64) DCT coefficient blocks, through K25
    (``vwfd_tpu_torch.native.blockwise_dct``)."""
    from ..native import blockwise_dct  # native → kernels → attacks → data
    return blockwise_dct(plane)


def _band_norm(d: np.ndarray) -> np.ndarray:
    m = d.mean(axis=(0, 1), keepdims=True)
    s = d.std(axis=(0, 1), keepdims=True) + 1e-6
    return ((d - m) / s).astype(np.float32)


class DCTDomainDataset:
    """Images as normalised DCT-coefficient tensors (module docstring): the
    synthetic family (``SyntheticImageDataset(size, synthetic_length or
    1000, seed)``) or an image folder (``root`` with the caller's
    ``read_image``, no augmentation)."""

    def __init__(self, root: Optional[str] = None, size: int = 256,
                 synthetic_length: int = 0, seed: int = 0,
                 read_image: Optional[Callable] = None):
        if size % 16:
            raise ValueError(f"DCTDomainDataset takes a size that is a "
                             f"multiple of 16, got {size}")
        self.size = size
        if root is not None:
            if read_image is None:
                raise ValueError("an image folder needs read_image "
                                 "(data.cv2_readers()[0])")
            self.base = ImageFolderDataset(root, read_image, size=size,
                                           augment=False)
        else:
            self.base = SyntheticImageDataset(
                size=size, length=synthetic_length or 1000, seed=seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        from ..native import blockwise_dct
        item = self.base[idx]
        img = item["image"] if isinstance(item, dict) else item
        x = img * 255.0
        y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        cb = (-0.168736 * x[..., 0] - 0.331264 * x[..., 1]
              + 0.5 * x[..., 2] + 128)
        cr = (0.5 * x[..., 0] - 0.418688 * x[..., 1]
              - 0.081312 * x[..., 2] + 128)
        half = self.size // 2
        cb = cb.reshape(half, 2, half, 2).mean(axis=(1, 3))
        cr = cr.reshape(half, 2, half, 2).mean(axis=(1, 3))
        dy = blockwise_dct((y - 128).astype(np.float32))
        dc = blockwise_dct(np.stack([cb - 128, cr - 128]).astype(np.float32))
        return {"dct_y": _band_norm(dy), "dct_cb": _band_norm(dc[0]),
                "dct_cr": _band_norm(dc[1])}
