"""Run-time utilities of the port (counterparts of vwfd_tpu/utils): the
logger, the progress bar, telemetry and the montage images. Standard
library and numpy only (``profile_trace`` uses ``torch.profiler``)."""

from .images import (crop_to_multiple, create_augmentations,
                     create_video_augmentations, read_png, save_image,
                     save_png, stitch_images, tensor_to_uint8)
from .logging import setup_logger
from .progbar import Progbar
from .telemetry import ScalarLogger, profile_trace, step_annotation

__all__ = ["crop_to_multiple", "create_augmentations",
           "create_video_augmentations", "read_png", "save_image",
           "save_png", "stitch_images", "tensor_to_uint8", "setup_logger",
           "Progbar", "ScalarLogger", "profile_trace", "step_annotation"]
