"""Data pipeline of the port (counterparts of vwfd_tpu/data): the DAVIS and
synthetic video datasets, the tamper masks and the batching loader. Numpy
only (DAVIS takes its image readers from the caller)."""

from .davis import DavisVideoDataset, cv2_readers
from .loader import Loader
from .masks import free_form_stroke_mask, random_rect_mask
from .synthetic import SyntheticVideoDataset

__all__ = ["DavisVideoDataset", "cv2_readers", "Loader",
           "free_form_stroke_mask", "random_rect_mask",
           "SyntheticVideoDataset"]
