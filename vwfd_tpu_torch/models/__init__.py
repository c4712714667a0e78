"""Models of the port (counterparts of vwfd_tpu/models)."""

from .video_model import VideoWatermarkModel

__all__ = ["VideoWatermarkModel"]
