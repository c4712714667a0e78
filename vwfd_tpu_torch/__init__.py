"""vwfd_tpu_torch — the PyTorch/CUDA port of vwfd_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch``, numpy and yaml only: never JAX and never ``vwfd_tpu``. Public
functions keep the JAX package's NHWC layout. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``; without a card they raise.

This slice serves the flagship embed → detect roundtrip
(``serving.WatermarkServer``) through four hand-written CUDA kernels
(``kernels``). Training comes in a later slice.
"""

import os

from .config import Config, DataConfig, ModelConfig, TrainConfig, load_config

__all__ = ["Config", "DataConfig", "ModelConfig", "TrainConfig",
           "load_config", "FLAGSHIP_CONFIG"]

FLAGSHIP_CONFIG = os.path.join(os.path.dirname(__file__), "configs",
                               "video.yaml")
