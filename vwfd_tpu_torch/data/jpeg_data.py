"""The KD-JPEG family's data (port of vwfd_tpu/data/jpeg_data.py:54-85;
the reference's LQ dataset, data/LQ_dataset.py:16-100).

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
"""

import io
from typing import Callable, Optional

import numpy as np

from .images import ImageFolderDataset
from .synthetic import SyntheticImageDataset

__all__ = ["LQJpegDataset", "LQ_QUALITIES"]

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
