"""Data pipeline of the port (counterparts of vwfd_tpu/data): the DAVIS and
synthetic video datasets, the synthetic images and the image folder of the
message and image families, KD-JPEG's clean + real-JPEG items
(``jpeg_data.py``), the host canny map without OpenCV
(``edges.py``), the tamper masks and the batching loader (numpy only;
DAVIS and the image folder take their image readers from the caller), and
the convergence runner's clip generator on the device (``ondevice.py``)."""

from .davis import DavisVideoDataset, cv2_readers
from .edges import canny_map, canny_u8, rgb_to_gray_u8
from .images import ImageFolderDataset, cv2_mask_reader
from .jpeg_data import LQJpegDataset
from .loader import Loader
from .masks import free_form_stroke_mask, random_rect_mask
from .ondevice import (ClipDraws, clips_from_draws, rect_mask,
                       sample_clip_draws, seeded_generator, synthetic_clips)
from .synthetic import (CannyImages, SpliceForgeryDataset,
                        SyntheticImageDataset, SyntheticVideoDataset,
                        stroke_masks)

__all__ = ["DavisVideoDataset", "cv2_readers", "canny_map", "canny_u8",
           "rgb_to_gray_u8", "ImageFolderDataset",
           "cv2_mask_reader", "SpliceForgeryDataset",
           "SyntheticImageDataset", "Loader",
           "free_form_stroke_mask", "random_rect_mask",
           "SyntheticVideoDataset", "ClipDraws", "clips_from_draws",
           "rect_mask", "sample_clip_draws", "seeded_generator",
           "synthetic_clips", "CannyImages", "stroke_masks",
           "LQJpegDataset"]
