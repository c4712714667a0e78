"""Data pipeline of the port (counterparts of vwfd_tpu/data): the synthetic
video dataset, its tamper masks and the batching loader. Numpy only."""

from .loader import Loader
from .masks import free_form_stroke_mask, random_rect_mask
from .synthetic import SyntheticVideoDataset

__all__ = ["Loader", "free_form_stroke_mask", "random_rect_mask",
           "SyntheticVideoDataset"]
