"""vwfd_tpu_torch — the PyTorch/CUDA port of vwfd_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch``, numpy and yaml only: never JAX and never ``vwfd_tpu``. Public
functions keep the JAX package's NHWC layout. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``; without a card they raise.

It serves the embed → detect roundtrip (``serving.WatermarkServer``, in
bf16 or, for the flagship, int8), trains (``models.VideoWatermarkModel.
train_step`` / ``fit`` with its telemetry and montages, on DAVIS or
synthetic clips, ``python -m vwfd_tpu_torch.train``) and evaluates
(``eval_step``, ``extract_f1``, ``eval_real_jpeg``, ``python -m
vwfd_tpu_torch.train --val``) the flagship (``configs/video.yaml``: the
packed ``res_tpu2`` INN and ``UNetTPU``) and the reference-shaped model
(``configs/refshape.yaml``: the INN module path and the reference
``UNet``), with every subnet, Haar and extractor option of the JAX
package, through hand-written CUDA kernels (``kernels``); it
serves clips from media folders (``python -m vwfd_tpu_torch.serve
--root``); it trains the HiDDeN and MBRS message families
(``models.HiddenModel``, ``models.MBRSModel``) and the Tianchi
forgery-segmentation family (``models.TianchiModel``: SUNet, its
shifted-window attention in K18), the image family's PAMI, ImugeV2 and CLR
(``models.ImageImmunizationModel``: the 4-channel INN, the spectral-norm
localizer, the k-way attack fan-out, the soft canny of the reverse pass in
K19, CLR's crop, rectification and SSIM in K20-K22, and the options
``with_gan``, ``use_perceptual`` and ``with_jpeg_simulator``) and KD-JPEG
(``models.KDJpegModel``: FBCNN with its FiLM epilogue in K23, the QF
classifier, the discriminator), ``python -m vwfd_tpu_torch.train --task
hidden|mbrs|tianchi|pami|imuge|clr|kdjpeg``, ``run_family_convergence``;
and it loads
the JAX package's npz pretrain trees and (converted by
``tools/jax_checkpoint_to_torch.py``) its checkpoints.
"""

import os

from .config import Config, DataConfig, ModelConfig, TrainConfig, load_config

__all__ = ["Config", "DataConfig", "ModelConfig", "TrainConfig",
           "load_config", "FLAGSHIP_CONFIG", "REFSHAPE_CONFIG",
           "TIANCHI_CONFIG", "PAMI_CONFIG", "CLR_CONFIG", "KDJPEG_CONFIG"]

FLAGSHIP_CONFIG = os.path.join(os.path.dirname(__file__), "configs",
                               "video.yaml")
# ModelConfig()'s nets: the INN module path and the reference UNet
REFSHAPE_CONFIG = os.path.join(os.path.dirname(__file__), "configs",
                               "refshape.yaml")
# the Tianchi family's (SUNet; models/tianchi_model.py)
TIANCHI_CONFIG = os.path.join(os.path.dirname(__file__), "configs",
                              "tianchi.yaml")
# the image family's (PAMI and ImugeV2; models/image_model.py)
PAMI_CONFIG = os.path.join(os.path.dirname(__file__), "configs", "pami.yaml")
# the image family's CLR (the crop tamper and the apex regressor)
CLR_CONFIG = os.path.join(os.path.dirname(__file__), "configs", "clr.yaml")
# the KD-JPEG family's (FBCNN, the QF classifier, the discriminator)
KDJPEG_CONFIG = os.path.join(os.path.dirname(__file__), "configs",
                             "kdjpeg.yaml")
