"""Flagship video watermarking model (port of vwfd_tpu/models/video_model.py,
serving half): the INN that embeds the watermark and the UNet that predicts
the per-frame tamper mask, in eval mode.

Ported: ``_to_channels``, ``_to_frames``, ``__init__``, ``init_states``,
``embed`` and ``predict_mask(train=False)``. The train and eval steps, the
attack pool and the optimizer belong to the training slice.
"""

from typing import Dict, Optional

import torch

from ..config import Config
from ..device import compute_dtype, resolve_device
from ..kernels import KERNELS, KernelSet
from ..nets import InvertibleNet, UNetTPU
from ..ops.quantize import clamp_with_grad, ste_quantize_255

__all__ = ["VideoWatermarkModel", "_to_channels", "_to_frames"]


def _to_channels(video: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) → (B, H, W, T·C) — the 12-channel INN input layout."""
    b, t, h, w, c = video.shape
    return video.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def _to_frames(x: torch.Tensor, t: int) -> torch.Tensor:
    """(B, H, W, T·C) → (B, T, H, W, C)."""
    b, h, w, tc = x.shape
    return x.reshape(b, h, w, t, tc // t).permute(0, 3, 1, 2, 4)


def _check_supported(cfg: Config) -> None:
    mc = cfg.model
    if mc.inn_packed and not (mc.inn_subnet == "res_tpu2" and mc.fused_st):
        raise ValueError("inn_packed requires inn_subnet='res_tpu2' "
                         "with fused_st=True (nets/inn_packed.py)")
    unported = {
        "inn_packed": (mc.inn_packed, True),
        "extractor": (mc.extractor, "unet_tpu"),
        "extractor_head": (mc.extractor_head, "d2s"),
        "extractor_up": (mc.extractor_up, "convt"),
        "extractor_dec": (mc.extractor_dec, "concat"),
    }
    for key, (got, want) in unported.items():
        if got != want:
            raise NotImplementedError(
                f"ModelConfig.{key}={got!r} is not ported (the port runs "
                f"{want!r})")
    if mc.pretrain_path:
        raise NotImplementedError("pretrain_path is not ported; pass "
                                  "weights to WatermarkServer instead")


class VideoWatermarkModel:
    """Builds netG (``InvertibleNet``) and the ``generator`` extractor
    (``UNetTPU``) on ``device`` (``None`` → the CUDA card; raises without
    one unless ``device="cpu"``). ``kernels`` is the kernel set both nets
    call: ``kernels.KERNELS`` (the wrappers) or ``kernels.PLAIN``."""

    def __init__(self, cfg: Config, device=None,
                 kernels: KernelSet = KERNELS):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.frames = cfg.data.frames
        self.kernels = kernels
        mc = cfg.model
        self.compute_dtype = compute_dtype(cfg.train.dtype)
        dt = None if self.compute_dtype == torch.float32 else \
            self.compute_dtype
        self.inn = InvertibleNet(
            channels=3 * self.frames, down_num=mc.inn_down_num,
            block_num=mc.inn_block_num, subnet=mc.inn_subnet,
            fused_st=mc.fused_st, width=mc.inn_width, haar=mc.inn_haar,
            dtype=dt, kernels=kernels).to(self.device).eval()
        plan = (mc.extractor_enc_convs if mc.extractor_enc_convs is not None
                else 2)
        self.unet = UNetTPU(out_channels=1, init_features=mc.extractor_features,
                            s2d=mc.extractor_s2d, enc_convs=plan,
                            dtype=dt).to(self.device).eval()

    def init_states(self, seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fresh parameters from a seeded ``torch.Generator`` (zero-init
        coupling heads: the INN starts at the identity); returns the two
        nets' state dicts."""
        gen = torch.Generator().manual_seed(seed)
        for net in (self.inn, self.unet):
            net.to("cpu")
            net.init_params(gen)
            net.to(self.device)
        return self.states()

    def states(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"netG": self.inn.state_dict(),
                "generator": self.unet.state_dict()}

    def load_states(self, states: Dict[str, Dict[str, torch.Tensor]]) -> None:
        self.inn.load_state_dict(states["netG"])
        self.unet.load_state_dict(states["generator"])

    @torch.no_grad()
    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """Watermark-embed a clip (B,T,H,W,3) in [0,1]: INN forward, clamp,
        8-bit quantize; f32 out."""
        video = video.to(self.device, self.compute_dtype)
        x = _to_channels(video)
        fwd = self.inn(x, out_f32=self.compute_dtype == torch.float32)
        fwd = _to_frames(fwd, self.frames)
        return ste_quantize_255(clamp_with_grad(fwd.float()))

    @torch.no_grad()
    def predict_mask(self, video: torch.Tensor, train: bool = False
                     ) -> torch.Tensor:
        """Tamper probabilities per frame (B,T,H,W,1); frames folded into
        the batch."""
        b, t, h, w, c = video.shape
        out = self.unet(video.to(self.device).reshape(b * t, h, w, c),
                        train=train)
        return out.reshape(b, t, h, w, 1)
