"""Video watermarking model (port of vwfd_tpu/models/video_model.py): the
INN that embeds the watermark and the UNet that predicts the per-frame
tamper mask, served, trained and evaluated, for every configuration the
JAX package builds: the flagship (packed ``res_tpu2`` INN, ``UNetTPU``)
and the reference shapes (``ModelConfig()``'s defaults: the INN module
path with ``res`` subnets and the lifting Haar, the reference ``UNet``).

Train step (IRNcrop_model.py:325-451, ``video_model.py:174-253``):

1. the INN embeds (bf16; the packed executor through K1/K2, the module
   path through K14/K15), then ``clamp_with_grad`` and the
   straight-through 8-bit quantizer, and
2. the splice tamper ``fwd·(1 − mask) + previous_batch·mask``, both in K10;
3. the 5-way per-frame attack pool (K5, K6, and K9 for the blur, the mix
   and the second quantizer);
4. the UNet in train mode predicts the per-frame mask;
5. losses: the PSNR-gated forward fidelity (L1 by default) plus the mask
   BCE; one AdamW update per net (``models/state.py``, each clipped on its
   own);
6. the non-finite guard: on a non-finite loss, parameters, moments, step
   counts and BatchNorm running statistics keep their pre-step values, by
   ``torch.where`` on the device (no host sync).

Eval step (``video_model.py:257-275``): embed and splice (K10), the attack
pool on its draws with ``clip(·, 0, 1)`` and no quantizer (K9), the UNet in
eval mode, then
the int-truncated PSNR, SSIM (K8) over the B·T frames and the F1 sweep (K7),
all as device tensors. ``extract_f1`` (``:277-283``) and ``eval_real_jpeg``
(``:285-305``, with the host JPEG codec an argument: the port reads no
image library).

Data parallelism (``mesh=``, ``video_model.py:60-62,126-128``): each rank
holds its rows of the global batch, and the step is the one-process step
on the global batch (``parallel``): the draws are the global batch's, each
rank keeping its rows (F4); the fidelity and mask losses are global means
and the PSNR gate reads the global MSE; each net's gradients are
all-reduced before its clip (F2); the guard reads the global loss, so every
rank keeps or takes the step together (F6); BatchNorm takes the global
batch's moments (``nets/unet.py``); the eval step sums K7's counts over the
ranks in int64 (F12) and takes SSIM's and PSNR's global means. Without a
mesh every path is the single-process one.

Ported: ``_to_channels``, ``_to_frames``, ``__init__``, ``init_states``
(with ``model.pretrain_path``), ``embed``, ``predict_mask``, ``_loss``,
``train_step``, ``fit`` (the previous-batch buffer, checkpoints every
``save_interval`` steps, the progress bar, the scalar log and a montage
every ``montage_interval`` steps), ``_dump_montage``, ``eval_step``,
``extract_f1`` and ``eval_real_jpeg``.
"""

import logging
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..attacks import AttackDraws, attack_pool_video, sample_attack_draws
from ..attacks.spatial import DEFAULT_RATIOS
from ..config import Config
from ..device import compute_dtype, resolve_device
from ..kernels import KERNELS, KernelSet
from ..kernels.splice import to_frames as _to_frames
from ..metrics import (bce_with_logits, f1_sweep, l1_loss, postprocess_int,
                       psnr_from_mse, ssim)
from ..nets import InvertibleNet, UNet, UNetTPU
from ..parallel import (Mesh, all_reduce_grads, barrier, global_mean,
                        global_means, local_rows)
from ..utils.images import save_png, stitch_images
from .state import AdamW, apply_pretrain, make_optimizer, save_checkpoint

__all__ = ["VideoWatermarkModel", "_to_channels", "_to_frames", "NETS"]

NETS = ("netG", "generator")


def _to_channels(video: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) → (B, H, W, T·C) — the 12-channel INN input layout."""
    b, t, h, w, c = video.shape
    return video.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def _build_extractor(mc, dtype):
    """The extractor ``ModelConfig`` names (``video_model.py:84-103``):
    ``UNetTPU`` for ``unet_tpu``, ``unet_tpu_slim`` (1×1 skip projections)
    and ``unet_tpu2`` (single-conv encoder levels), the reference ``UNet``
    otherwise."""
    if mc.extractor in ("unet_tpu", "unet_tpu_slim", "unet_tpu2"):
        plan = (mc.extractor_enc_convs if mc.extractor_enc_convs is not None
                else 1 if mc.extractor == "unet_tpu2" else 2)
        return UNetTPU(out_channels=1, init_features=mc.extractor_features,
                       s2d=mc.extractor_s2d, enc_convs=plan, dtype=dtype,
                       slim_skip=mc.extractor == "unet_tpu_slim",
                       head_impl=mc.extractor_head, up_impl=mc.extractor_up,
                       dec_impl=mc.extractor_dec)
    return UNet(out_channels=1, init_features=mc.unet_features, dtype=dtype)


class VideoWatermarkModel:
    """Builds netG (``InvertibleNet``, on the packed executor or the module
    path as ``ModelConfig.inn_packed`` says, which needs ``res_tpu2`` with
    ``fused_st``: ``ValueError`` otherwise, as in the JAX package) and the
    ``generator`` extractor (``UNetTPU`` or ``UNet``) on ``device``
    (``None`` → the CUDA card; raises without one unless
    ``device="cpu"``). ``kernels`` is the kernel set both nets
    call: ``kernels.KERNELS`` (the wrappers) or ``kernels.PLAIN``.
    ``mesh`` (``parallel.make_mesh()``) makes the steps data-parallel:
    each rank passes its rows of the global batch."""

    def __init__(self, cfg: Config, device=None,
                 kernels: KernelSet = KERNELS, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
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
            dtype=dt, kernels=kernels,
            packed=mc.inn_packed).to(self.device).eval()
        self.unet = _build_extractor(mc, dt).to(self.device).eval()

    def init_states(self, seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fresh parameters from a seeded ``torch.Generator`` (zero-init
        coupling heads: the INN starts at the identity), then the npz
        pretrain trees of ``model.pretrain_path`` if set
        (``state.apply_pretrain``), and fresh optimizer states; returns the
        two nets' state dicts."""
        gen = torch.Generator().manual_seed(seed)
        for net in (self.inn, self.unet):
            net.to("cpu")
            net.init_params(gen)
            net.to(self.device)
        if self.cfg.model.pretrain_path:
            apply_pretrain(self, self.cfg.model.pretrain_path,
                           logging.getLogger("base"))
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
        """Attack draws for one step of ``b`` clips from the model's
        generator (seeded with ``TrainConfig.seed`` at first use). Under a
        mesh ``b`` is this rank's clips: every rank draws the global
        batch's draws and keeps its rows (F4)."""
        if self._draw_gen is None:
            self._draw_gen = torch.Generator(self.device).manual_seed(
                self.cfg.train.seed)
        world = 1 if self.mesh is None else self.mesh.size
        return local_rows(sample_attack_draws(
            self._draw_gen, b * world, t, len(self.attack_ratios)), self.mesh)

    @staticmethod
    def _mse255_int(a, b) -> torch.Tensor:
        """The MSE that ``psnr255_int`` takes (this process's rows)."""
        return torch.mean((postprocess_int(a) - postprocess_int(b)) ** 2)

    def _inn(self, video: torch.Tensor) -> torch.Tensor:
        """INN forward of a clip (B,T,H,W,3): (B,H,W,T·3) in the compute
        dtype."""
        x = _to_channels(video.to(self.device, self.compute_dtype))
        return self.inn(x, out_f32=self.compute_dtype == torch.float32)

    @torch.no_grad()
    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """Watermark-embed a clip (B,T,H,W,3) in [0,1]: INN forward, clamp,
        8-bit quantize (K10); f32 out."""
        return self.kernels.splice(self._inn(video), self.frames)

    @torch.no_grad()
    def _embed_splice(self, video, mask, prev):
        """``(embed(video), embed(video)·(1 − mask) + prev·mask)``, in one
        K10 launch after the INN."""
        return self.kernels.splice(self._inn(video), self.frames, mask, prev)

    @torch.no_grad()
    def predict_mask(self, video: torch.Tensor, train: bool = False):
        """Tamper probabilities per frame (B,T,H,W,1); frames folded into
        the batch. ``train=True`` also returns the new BatchNorm running
        statistics (the extractor's ``forward``)."""
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
        fwd_video, attacked_fwd = self.kernels.splice(self._inn(video), t,
                                                      mask, prev)
        attacked = attack_pool_video(attacked_fwd, draws, self.attack_ratios,
                                     self.kernels, epilogue="quantize")
        pred, stats = self.unet(attacked.reshape(b * t, *attacked.shape[2:]),
                                train=True, mesh=self.mesh)
        pred_mask = pred.reshape(b, t, *pred.shape[1:])
        with torch.no_grad():
            mse = self._mse255_int(video, fwd_video)
        if tc.forward_criterion == "l1":
            l_fid = l1_loss(fwd_video, video)
        elif tc.forward_criterion == "l2":
            l_fid = torch.mean((fwd_video - video) ** 2)
        else:
            l_fid = bce_with_logits(fwd_video, video)
        l_backward = bce_with_logits(pred_mask, mask)
        # the three global means in one all-reduce
        l_fid, l_backward, mse = global_means((l_fid, l_backward, mse),
                                              self.mesh)
        with torch.no_grad():
            psnr_forward = psnr_from_mse(mse)
        w_fwd = torch.where(psnr_forward < tc.psnr_gate, tc.loss_weight_low,
                            tc.loss_weight_high)
        l_forward = w_fwd * l_fid
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
        order) and the new BatchNorm statistics, without any update. Under
        a mesh the loss is the global batch's, every rank's the same, and
        the gradients this rank's: ``world`` times its share of the global
        gradient (``parallel``), which ``train_step`` all-reduces."""
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
                   draws: Optional[AttackDraws] = None,
                   grads_out: Optional[dict] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on a batch (video (B,T,H,W,3), mask (B,T,H,W,1)) with
        the previous batch ``prev`` spliced in. Returns the logs as 0-dim
        tensors on the device (no host sync). Under a mesh each net's
        gradients are all-reduced before its clip, and the guard reads the
        global loss, the same on every rank. ``grads_out``, if given,
        receives each net's gradients as the optimizer takes them."""
        loss, aux, grads, stats = self.loss_and_grads(video, mask, prev,
                                                      draws)
        good = torch.isfinite(loss)
        for name, opt in self.optimizers.items():
            g = all_reduce_grads(grads[name], self.mesh)
            if grads_out is not None:
                grads_out[name] = g
            opt.step(g, good)
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
        fwd_video, attacked_fwd = self._embed_splice(video, mask, prev)
        attacked = attack_pool_video(attacked_fwd, draws.to(self.device),
                                     self.attack_ratios, self.kernels,
                                     epilogue="clamp")
        pred_mask = self.predict_mask(attacked)
        _, f1s = f1_sweep(pred_mask, mask, kernels=self.kernels,
                          mesh=self.mesh)
        s = ssim(fwd_video.reshape(-1, *fwd_video.shape[2:]),
                 video.reshape(-1, *video.shape[2:]), kernels=self.kernels)
        if self.mesh is not None:  # equal image counts on every rank
            s = global_mean(s.double(), self.mesh).float()
        return {
            "psnr_forward": psnr_from_mse(global_mean(
                self._mse255_int(video, fwd_video), self.mesh)),
            "ssim_forward": s,
            "f1_best": torch.max(f1s),
            "f1_sweep": f1s,
        }

    @torch.no_grad()
    def extract_f1(self, attacked, mask) -> torch.Tensor:
        """Best-threshold F1 of the extractor on already attacked frames
        (B,T,H,W,3): the building block of host-side attack evals."""
        attacked, mask = self.to_device(attacked, mask)
        _, f1s = f1_sweep(self.predict_mask(attacked), mask,
                          kernels=self.kernels, mesh=self.mesh)
        return torch.max(f1s)

    @torch.no_grad()
    def eval_real_jpeg(self, video, mask, prev,
                       codec: Callable[[np.ndarray, int], np.ndarray],
                       qualities: Sequence[int] = (50, 70, 90)
                       ) -> Dict[str, float]:
        """Robustness to a real JPEG codec: embed, splice-tamper, clip, then
        ``codec(frames, quality)`` (float32 NHWC frames in [0, 1] → the
        decoded frames, on the host) at each quality before localization.
        Returns ``{"none": f1, "qf50": f1, ...}``. The port imports no
        image library with its modules, so the codec is the caller's
        (``attacks.jpeg_real``, PIL's libjpeg)."""
        video, mask, prev = self.to_device(video, mask, prev)
        tampered = torch.clamp(self._embed_splice(video, mask, prev)[1], 0.0,
                               1.0)
        b, t, h, w, c = tampered.shape
        frames = tampered.reshape(b * t, h, w, c).cpu().numpy()
        out = {"none": float(self.extract_f1(tampered, mask))}
        for q in qualities:
            att = np.asarray(codec(frames, q), np.float32).reshape(
                b, t, h, w, c)
            out[f"qf{q}"] = float(self.extract_f1(att, mask))
        return out

    # --------------------------------------------------------------- loop

    def fit(self, loader, steps: int, ckpt_dir: Optional[str] = None,
            progbar=None, scalar_logger=None,
            montage_dir: Optional[str] = None, start_step: int = 0,
            step_ms: Optional[List[float]] = None):
        """Epoch loop (train.py:91-109, ``video_model.py:309-358``) with the
        previous-batch buffer: the first batch only seeds it. Takes
        ``steps`` steps, numbered on from ``start_step``. After each step:
        ``progbar.add`` and ``scalar_logger.log`` of its logs; every
        ``TrainConfig.montage_interval`` steps a montage PNG in
        ``montage_dir`` (``_dump_montage``); with ``ckpt_dir``, a checkpoint
        every ``TrainConfig.save_interval`` steps. ``step_ms``, if given,
        receives each step's wall time (the step and its logs read back).
        Under a mesh the loader yields this rank's rows (the previous-batch
        splice is per clip, so no row crosses ranks), and only rank 0
        reports, logs, writes montages and checkpoints; every rank waits at
        a barrier after a checkpoint. Returns ``(states, logs)`` with the
        last step's logs as floats."""
        log = logging.getLogger("base")
        tc = self.cfg.train
        if self.mesh is not None and self.mesh.rank != 0:
            progbar = scalar_logger = montage_dir = None
        prev, step, logs_out = None, start_step, {}
        while step < start_step + steps:
            seen = 0
            for video, mask in loader:
                seen += 1
                if step >= start_step + steps:
                    break
                video, mask = self.to_device(video, mask)
                if prev is None:
                    prev = video  # the first batch only seeds the buffer
                    continue
                t0 = time.perf_counter()
                logs = self.train_step(video, mask, prev)
                logs_out = {k: float(v) for k, v in logs.items()}
                if step_ms is not None:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                step += 1
                if not math.isfinite(logs_out["loss"]):
                    log.warning("non-finite loss at step %d: update skipped "
                                "(the guard kept the pre-step state)", step)
                if progbar is not None:
                    progbar.add(1, values=list(logs_out.items()))
                if scalar_logger is not None:
                    scalar_logger.log(step, **logs_out)
                if montage_dir and step % tc.montage_interval == 0:
                    self._dump_montage(video, mask, prev, montage_dir, step)
                prev = video
                if ckpt_dir and step % tc.save_interval == 0:
                    if self.mesh is None or self.mesh.rank == 0:
                        save_checkpoint(ckpt_dir, step, self)
                    barrier(self.mesh)
            if not seen:
                raise ValueError("the loader yields no batches")
        return self.states(), logs_out

    @torch.no_grad()
    def _dump_montage(self, video, mask, prev, out_dir: str, step: int,
                      draws: Optional[AttackDraws] = None) -> str:
        """Qualitative dump (``video_model.py:360-381``,
        IRNcrop_model.py:421-437): input / embedded / 10×|diff| / attacked
        / predicted mask / ground-truth mask of frame 0 of each clip, one
        row a clip, written as ``<out_dir>/<step:05d>.png``. ``draws``
        default to draws from a generator of their own, seeded from
        ``TrainConfig.seed`` and the step, so that a run's training draws
        (``sample_draws``) do not depend on whether montages are on.
        Returns the file's path."""
        video, mask, prev = self.to_device(video, mask, prev)
        if draws is None:
            gen = torch.Generator(self.device).manual_seed(
                self.cfg.train.seed * 1_000_003 + step)
            draws = sample_attack_draws(gen, video.shape[0], video.shape[1],
                                        len(self.attack_ratios))
        fwd, tampered = self._embed_splice(video, mask, prev)
        attacked = attack_pool_video(tampered, draws.to(self.device),
                                     self.attack_ratios, self.kernels,
                                     epilogue="clamp")
        pred = self.predict_mask(attacked)
        frames = [video[:, 0], fwd[:, 0],
                  torch.clamp(10 * torch.abs(video[:, 0] - fwd[:, 0]), 0, 1),
                  attacked[:, 0], pred[:, 0], mask[:, 0]]
        canvas = stitch_images(*(f.cpu().numpy() for f in frames))
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{step:05d}.png")
        save_png(path, canvas)
        return path
