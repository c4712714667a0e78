"""Flagship video watermarking model (port of vwfd_tpu/models/video_model.py):
the INN that embeds the watermark and the UNet that predicts the per-frame
tamper mask, served, trained and evaluated.

Train step (IRNcrop_model.py:325-451, ``video_model.py:174-253``):

1. the INN embeds (bf16 through K1/K2), then ``clamp_with_grad`` and the
   straight-through 8-bit quantizer;
2. splice tamper: ``fwd·(1 − mask) + previous_batch·mask``;
3. the 5-way per-frame attack pool (K5, K6), quantized again;
4. the UNet in train mode predicts the per-frame mask;
5. losses: the PSNR-gated forward fidelity (L1 by default) plus the mask
   BCE; one AdamW update per net (``models/state.py``, each clipped on its
   own);
6. the non-finite guard: on a non-finite loss, parameters, moments, step
   counts and BatchNorm running statistics keep their pre-step values, by
   ``torch.where`` on the device (no host sync).

Eval step (``video_model.py:257-275``): embed, splice, the attack pool on
its draws, ``clip(·, 0, 1)`` with no quantizer, the UNet in eval mode, then
the int-truncated PSNR, SSIM (K8) over the B·T frames and the F1 sweep (K7),
all as device tensors. ``extract_f1`` (``:277-283``) and ``eval_real_jpeg``
(``:285-305``, with the host JPEG codec an argument: the port reads no
image library).

Ported: ``_to_channels``, ``_to_frames``, ``__init__``, ``init_states``,
``embed``, ``predict_mask``, ``_loss``, ``train_step``, ``fit`` (with the
previous-batch buffer and checkpoints every ``save_interval`` steps),
``eval_step``, ``extract_f1`` and ``eval_real_jpeg``. Not yet: montages
(they need an image writer).
"""

import logging
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..attacks import AttackDraws, attack_pool_video, sample_attack_draws
from ..attacks.spatial import DEFAULT_RATIOS
from ..config import Config
from ..device import compute_dtype, resolve_device
from ..kernels import KERNELS, KernelSet
from ..metrics import bce_with_logits, f1_sweep, l1_loss, psnr255_int, ssim
from ..nets import InvertibleNet, UNetTPU
from ..ops.quantize import clamp_with_grad, ste_quantize_255
from .state import AdamW, make_optimizer, save_checkpoint

__all__ = ["VideoWatermarkModel", "_to_channels", "_to_frames", "NETS"]

NETS = ("netG", "generator")


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
        self.attack_ratios = (tuple(mc.attack_ratios) if mc.attack_ratios
                              else DEFAULT_RATIOS)
        self._opt: Optional[Dict[str, AdamW]] = None
        self._draw_gen: Optional[torch.Generator] = None
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
        coupling heads: the INN starts at the identity) and fresh optimizer
        states; returns the two nets' state dicts."""
        gen = torch.Generator().manual_seed(seed)
        for net in (self.inn, self.unet):
            net.to("cpu")
            net.init_params(gen)
            net.to(self.device)
        self._opt = None
        return self.states()

    def states(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"netG": self.inn.state_dict(),
                "generator": self.unet.state_dict()}

    def load_states(self, states: Dict[str, Dict[str, torch.Tensor]]) -> None:
        self.inn.load_state_dict(states["netG"])
        self.unet.load_state_dict(states["generator"])

    def nets(self):
        return {"netG": self.inn, "generator": self.unet}

    @property
    def optimizers(self) -> Dict[str, AdamW]:
        """One AdamW per net (built at first use: serving needs none)."""
        if self._opt is None:
            self._opt = {name: make_optimizer(list(net.parameters()),
                                              self.cfg.train)
                         for name, net in self.nets().items()}
        return self._opt

    def sample_draws(self, b: int, t: int) -> AttackDraws:
        """Attack draws for one step from the model's generator (seeded
        with ``TrainConfig.seed`` at first use)."""
        if self._draw_gen is None:
            self._draw_gen = torch.Generator(self.device).manual_seed(
                self.cfg.train.seed)
        return sample_attack_draws(self._draw_gen, b, t,
                                   len(self.attack_ratios))

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
    def predict_mask(self, video: torch.Tensor, train: bool = False):
        """Tamper probabilities per frame (B,T,H,W,1); frames folded into
        the batch. ``train=True`` also returns the new BatchNorm running
        statistics (``UNetTPU.forward``)."""
        b, t, h, w, c = video.shape
        out = self.unet(video.to(self.device).reshape(b * t, h, w, c),
                        train=train)
        if train:
            return out[0].reshape(b, t, h, w, 1), out[1]
        return out.reshape(b, t, h, w, 1)

    # -------------------------------------------------------------- train

    def _loss(self, video: torch.Tensor, mask: torch.Tensor,
              prev: torch.Tensor, draws: AttackDraws):
        """``vwfd_tpu/models/video_model.py:174-229``: (loss, {"lF", "lB",
        "PF"}, the UNet's new BatchNorm running statistics)."""
        tc = self.cfg.train
        b, t = video.shape[0], video.shape[1]
        x = _to_channels(video.to(self.compute_dtype))
        fwd = self.inn(x, out_f32=self.compute_dtype == torch.float32)
        fwd_video = ste_quantize_255(clamp_with_grad(
            _to_frames(fwd, t).float()))
        attacked_fwd = fwd_video * (1.0 - mask) + prev * mask
        attacked = attack_pool_video(attacked_fwd, draws, self.attack_ratios,
                                     self.kernels)
        attacked = ste_quantize_255(clamp_with_grad(attacked))
        pred, stats = self.unet(attacked.reshape(b * t, *attacked.shape[2:]),
                                train=True)
        pred_mask = pred.reshape(b, t, *pred.shape[1:])
        with torch.no_grad():
            psnr_forward = psnr255_int(video, fwd_video)
        w_fwd = torch.where(psnr_forward < tc.psnr_gate, tc.loss_weight_low,
                            tc.loss_weight_high)
        if tc.forward_criterion == "l1":
            l_fid = l1_loss(fwd_video, video)
        elif tc.forward_criterion == "l2":
            l_fid = torch.mean((fwd_video - video) ** 2)
        else:
            l_fid = bce_with_logits(fwd_video, video)
        l_forward = w_fwd * l_fid
        l_backward = bce_with_logits(pred_mask, mask)
        loss = l_forward + l_backward
        return loss, {"lF": l_forward, "lB": l_backward,
                      "PF": psnr_forward}, stats

    def to_device(self, *tensors):
        """Clips, masks or previous clips (numpy or tensors) → float32 on
        the model's device."""
        return [torch.as_tensor(t).to(self.device, torch.float32,
                                      non_blocking=True) for t in tensors]

    def loss_and_grads(self, video, mask, prev,
                       draws: Optional[AttackDraws] = None):
        """The loss, its terms, the gradients per net (lists in parameter
        order) and the new BatchNorm statistics, without any update."""
        video, mask, prev = self.to_device(video, mask, prev)
        if draws is None:
            draws = self.sample_draws(video.shape[0], video.shape[1])
        params = {k: list(net.parameters()) for k, net in self.nets().items()}
        flat = params["netG"] + params["generator"]
        with torch.enable_grad():
            loss, aux, stats = self._loss(video, mask, prev,
                                          draws.to(self.device))
            g = torch.autograd.grad(loss, flat, allow_unused=True)
        g = [torch.zeros_like(p) if d is None else d for p, d in zip(flat, g)]
        n = len(params["netG"])
        aux = {k: v.detach() for k, v in aux.items()}
        return loss.detach(), aux, {"netG": g[:n], "generator": g[n:]}, stats

    def train_step(self, video, mask, prev,
                   draws: Optional[AttackDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on a batch (video (B,T,H,W,3), mask (B,T,H,W,1)) with
        the previous batch ``prev`` spliced in. Returns the logs as 0-dim
        tensors on the device (no host sync)."""
        loss, aux, grads, stats = self.loss_and_grads(video, mask, prev,
                                                      draws)
        good = torch.isfinite(loss)
        for name, opt in self.optimizers.items():
            opt.step(grads[name], good)
        self.unet.load_stats(stats, good)
        return {"loss": loss, **aux}

    # --------------------------------------------------------------- eval

    @torch.no_grad()
    def eval_step(self, video, mask, prev,
                  draws: Optional[AttackDraws] = None
                  ) -> Dict[str, torch.Tensor]:
        """Embed → splice → attack → localize on a batch (video
        (B,T,H,W,3), mask (B,T,H,W,1)) with the previous batch ``prev``
        spliced in. Returns ``psnr_forward``, ``ssim_forward``, ``f1_best``
        (0-dim) and ``f1_sweep`` (9,) as float32 tensors on the device (no
        host sync)."""
        video, mask, prev = self.to_device(video, mask, prev)
        if draws is None:
            draws = self.sample_draws(video.shape[0], video.shape[1])
        fwd_video = self.embed(video)
        attacked_fwd = fwd_video * (1.0 - mask) + prev * mask
        attacked = attack_pool_video(attacked_fwd, draws.to(self.device),
                                     self.attack_ratios, self.kernels)
        attacked = torch.clamp(attacked, 0.0, 1.0)
        pred_mask = self.predict_mask(attacked)
        _, f1s = f1_sweep(pred_mask, mask, kernels=self.kernels)
        return {
            "psnr_forward": psnr255_int(video, fwd_video),
            "ssim_forward": ssim(fwd_video.reshape(-1, *fwd_video.shape[2:]),
                                 video.reshape(-1, *video.shape[2:]),
                                 kernels=self.kernels),
            "f1_best": torch.max(f1s),
            "f1_sweep": f1s,
        }

    @torch.no_grad()
    def extract_f1(self, attacked, mask) -> torch.Tensor:
        """Best-threshold F1 of the extractor on already attacked frames
        (B,T,H,W,3): the building block of host-side attack evals."""
        attacked, mask = self.to_device(attacked, mask)
        _, f1s = f1_sweep(self.predict_mask(attacked), mask,
                          kernels=self.kernels)
        return torch.max(f1s)

    @torch.no_grad()
    def eval_real_jpeg(self, video, mask, prev,
                       codec: Callable[[np.ndarray, int], np.ndarray],
                       qualities: Sequence[int] = (50, 70, 90)
                       ) -> Dict[str, float]:
        """Robustness to a real JPEG codec: embed, splice-tamper, clip, then
        ``codec(frames, quality)`` (float32 NHWC frames in [0, 1] → the
        decoded frames, on the host) at each quality before localization.
        Returns ``{"none": f1, "qf50": f1, ...}``. The card machine has no
        image library, so the codec is the caller's (the tests pass
        ``vwfd_tpu.attacks.jpeg.jpeg_real``, i.e. PIL's libjpeg)."""
        video, mask, prev = self.to_device(video, mask, prev)
        fwd = self.embed(video)
        tampered = torch.clamp(fwd * (1.0 - mask) + prev * mask, 0.0, 1.0)
        b, t, h, w, c = tampered.shape
        frames = tampered.reshape(b * t, h, w, c).cpu().numpy()
        out = {"none": float(self.extract_f1(tampered, mask))}
        for q in qualities:
            att = np.asarray(codec(frames, q), np.float32).reshape(
                b, t, h, w, c)
            out[f"qf{q}"] = float(self.extract_f1(att, mask))
        return out

    # --------------------------------------------------------------- loop

    def fit(self, loader, steps: int, ckpt_dir: Optional[str] = None):
        """Epoch loop (train.py:91-109) with the previous-batch buffer: the
        first batch only seeds it. With ``ckpt_dir``, a checkpoint is
        written every ``TrainConfig.save_interval`` steps
        (``video_model.py:356-357``). Returns ``(states, logs)`` with the
        last step's logs as floats."""
        log = logging.getLogger("base")
        interval = self.cfg.train.save_interval
        prev, step, logs_out = None, 0, {}
        while step < steps:
            seen = 0
            for video, mask in loader:
                seen += 1
                if step >= steps:
                    break
                video, mask = self.to_device(video, mask)
                if prev is None:
                    prev = video  # the first batch only seeds the buffer
                    continue
                logs = self.train_step(video, mask, prev)
                step += 1
                logs_out = {k: float(v) for k, v in logs.items()}
                if not math.isfinite(logs_out["loss"]):
                    log.warning("non-finite loss at step %d: update skipped "
                                "(the guard kept the pre-step state)", step)
                prev = video
                if ckpt_dir and step % interval == 0:
                    save_checkpoint(ckpt_dir, step, self)
            if not seen:
                raise ValueError("the loader yields no batches")
        return self.states(), logs_out
