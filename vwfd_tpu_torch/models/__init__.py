"""Models of the port (counterparts of vwfd_tpu/models)."""

from .hidden_model import HiddenModel
from .image_model import ImageImmunizationModel
from .kdjpeg_model import KDJpegModel
from .mbrs_model import MBRSModel
from .tianchi_model import TianchiModel
from .video_model import VideoWatermarkModel

__all__ = ["HiddenModel", "ImageImmunizationModel", "KDJpegModel",
           "MBRSModel", "TianchiModel", "VideoWatermarkModel"]
