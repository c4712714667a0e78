"""The Tianchi forgery-segmentation trainer (port of
vwfd_tpu/models/tianchi_model.py; reference: models/tianchi_model.py:262-301).

One ``train_step`` makes two AdamW updates of the SUNet (``nets/sunet.py``,
sigmoid output; ``make_optimizer``: clip 1.0, weight decay 1e-5, the
config's rate and schedule):

1. BCE(SUNet(image), mask), the segmentation step;
2. the robustness step on the image pushed through one draw of the
   QF-banded JPEG pool (``QF_BANDS``; band 50 is Q ∈ {40, 45, 50, 55} ×
   {hard, soft, zonal}) and the 3×3 σ = 2 gaussian blur, clipped to
   [0, 1]: L1 of the prediction to a zero mask, taken on the parameters
   after the first update (``:56-84``). The processed image takes no
   gradient (JAX's ``stop_gradient``): it is computed under ``no_grad``,
   one K5 forward a step.

Where either loss is not finite, every parameter, Adam moment and the
count keep the values they had before the step: the step keeps them and
``torch.where``s them back on the device after both updates (F6; the
port's ``AdamW.step`` guards one update in place, JAX's step undoes both).
SUNet has no BatchNorm, so no statistics are carried.

The draws: JAX draws the band index and the mode from its key
(``jpeg_pool``: ``k1, k2 = split(key)``, ``randint(k1, (), 0, len(band))``,
``randint(k2, (), 0, 3)``) on the device; the port's ``TianchiSampler``
draws them on the host from a seeded numpy generator (F4: ``jax.random``
cannot be replayed) and the step runs the drawn pool member only.

``eval_step`` is the SUNet's prediction and the F1 sweep through K7
(``f1_best`` the best threshold's F1). The model runs in float32, on the
card with TF32 off (``device.full_f32``); every SwinBlock's attention runs
K18 (28 forward and 28 backward launches a train step, 14 an eval step).

Data parallelism (``mesh=``, JAX's ``_tianchi_loop`` over its ``"data"``
mesh): each rank passes its rows of the global batch and the whole
``TianchiDraws`` (one draw a batch); CE and CE1 are global means, each
update's gradients are all-reduced before it (the AdamW clip then reads
the global norm), the guard reads the global losses (F29) and
``eval_step``'s F1 counts are summed over the ranks (F30). The SUNet's
LayerNorms are per row: nothing else is global.
"""

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..attacks import gaussian_blur_attack, jpeg_pool_draw
from ..config import Config
from ..device import full_f32, resolve_device
from ..kernels import KERNELS, KernelSet
from ..metrics import bce_loss, f1_sweep, l1_loss
from ..nets.sunet import SUNet
from ..parallel import Mesh, all_reduce_grads, global_means
from .state import AdamW, make_optimizer

__all__ = ["QF_BANDS", "MODES", "TianchiDraws", "TianchiSampler",
           "TianchiModel"]

# QF bands of the tianchi pools (tianchi_model.py:112-135)
QF_BANDS = {
    90: (80, 85, 90, 95),
    70: (60, 65, 70, 75),
    50: (40, 45, 50, 55),
    30: (20, 25, 30, 35),
    10: (10,),
}
MODES = ("hard", "soft", "zonal")  # jpeg_pool's modes 0, 1, 2


class TianchiDraws(NamedTuple):
    """One batch's JPEG draw: ``q_idx`` indexes the model's band, ``mode``
    ``MODES``."""
    q_idx: int
    mode: int


class TianchiSampler:
    """Seeded draws on the host (numpy ``default_rng``): the band index,
    uniform over the band, then the mode, uniform over ``MODES``, one pair
    a batch, as the JAX step draws them from its key's two halves."""

    def __init__(self, seed: int, band_size: int = 4):
        self.rng = np.random.default_rng(seed)
        self.band_size = band_size

    def __call__(self) -> TianchiDraws:
        q = int(self.rng.integers(self.band_size))
        return TianchiDraws(q, int(self.rng.integers(len(MODES))))


class TianchiModel:
    def __init__(self, cfg: Config, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 8, robustness_band: int = 50,
                 device=None, kernels: KernelSet = KERNELS,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.kernels = kernels
        self.image_size = cfg.data.gt_size
        self.net = SUNet(out_channels=1, embed_dim=embed_dim, depths=depths,
                         num_heads=num_heads, window_size=window_size,
                         apply_sigmoid=True, image_size=self.image_size,
                         kernels=kernels).to(self.device)
        self.band = QF_BANDS[robustness_band]
        self.optimizers = self._adamw()

    def _adamw(self) -> Dict[str, AdamW]:
        return {"netG": make_optimizer(list(self.net.parameters()),
                                       self.cfg.train)}

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {"netG": self.net}

    def init_states(self, seed: int = 0) -> None:
        """Fresh parameters with flax's initialisers' distributions from a
        seeded ``torch.Generator``, fresh AdamW."""
        gen = torch.Generator().manual_seed(seed)
        self.net.to("cpu")
        self.net.init_params(gen)
        self.net.to(self.device)
        self.optimizers = self._adamw()

    def load_states(self, states: Dict[str, Dict[str, torch.Tensor]]
                    ) -> None:
        self.net.load_state_dict(states["netG"])

    def sampler(self, seed: int) -> TianchiSampler:
        return TianchiSampler(seed, len(self.band))

    def to_device(self, *tensors) -> List[torch.Tensor]:
        """Images or masks (numpy or tensors) → the net's dtype (float32)
        on the model's device."""
        dt = self.net.head.weight.dtype
        return [torch.as_tensor(t).to(self.device, dt, non_blocking=True)
                for t in tensors]

    def _tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state: parameters, Adam moments and count."""
        opt = self.optimizers["netG"]
        return [*opt.params, *opt.mu, *opt.nu, opt.count]

    def processed(self, images: torch.Tensor, draws: TianchiDraws
                  ) -> torch.Tensor:
        """The robustness step's input: ``clip(blur(jpeg_pool(images)), 0,
        1)`` at the drawn band member, without gradient."""
        with torch.no_grad():
            jp = jpeg_pool_draw(images, self.band[draws.q_idx], draws.mode,
                                self.kernels)
            return torch.clamp(gaussian_blur_attack(jp), 0.0, 1.0)

    def train_step(self, images, masks, draws: TianchiDraws,
                   grads_out: Optional[list] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on images (B, H, W, 3) in [0, 1] and their masks (B, H,
        W, 1) in {0, 1} with the JPEG ``draws``; returns ``CE`` and ``CE1``
        as 0-dim tensors (no host sync). ``grads_out``, a list, receives
        both updates' gradients (two lists in parameter order; under a mesh
        all-reduced). Under a mesh the batch is this rank's rows."""
        images, masks = self.to_device(images, masks)
        opt = self.optimizers["netG"]
        params = opt.params
        mesh = self.mesh
        with torch.no_grad():
            before = [t.clone() for t in self._tensors()]
        with torch.enable_grad(), full_f32():
            (ce,) = global_means((bce_loss(self.net(images), masks),), mesh)
            grads = all_reduce_grads(torch.autograd.grad(ce, params), mesh)
        opt.step(grads)
        with full_f32():
            processed = self.processed(images, draws)
        with torch.enable_grad(), full_f32():
            (ce1,) = global_means((l1_loss(self.net(processed),
                                           torch.zeros_like(masks)),), mesh)
            grads1 = all_reduce_grads(torch.autograd.grad(ce1, params), mesh)
        opt.step(grads1)
        with torch.no_grad():
            good = torch.isfinite(ce) & torch.isfinite(ce1)
            for t, old in zip(self._tensors(), before):
                t.copy_(torch.where(good, t, old))
        if grads_out is not None:
            grads_out.extend([list(grads), list(grads1)])
        return {"CE": ce.detach(), "CE1": ce1.detach()}

    @torch.no_grad()
    def eval_step(self, images, masks) -> Dict[str, torch.Tensor]:
        """``f1_best``, ``f1_sweep`` (K7) and ``predicted``, on the
        device. Under a mesh the F1 counts are the global batch's and
        ``predicted`` is this rank's rows."""
        images, masks = self.to_device(images, masks)
        with full_f32():
            pred = self.net(images)
        _, f1s = f1_sweep(pred, masks, kernels=self.kernels, mesh=self.mesh)
        return {"f1_best": torch.max(f1s), "f1_sweep": f1s,
                "predicted": pred}
