"""VGG19 feature loss (port of vwfd_tpu/metrics/perceptual.py:25-94; the
reference's loss.py:126-178).

``VGG19Features``: the VGG19 trunk (3×3 convs with bias, padding 1, ReLU;
a 2×2 max-pool after each of the five stages), returning every
``relu{s}_{r}`` activation. ``perceptual_loss`` is Σ wᵢ·mean|featᵢ(x) −
featᵢ(y)| over ``relu{1..5}_1``. NHWC in, NCHW inside; the convs carry
flax's names (``conv{s}_{r}``), so ``convert.py`` maps a flax tree.

No pretrained weights ship in the repository. ``load_vgg_npz`` reads the
npz that ``tools/convert_vgg19.py`` writes (keys ``conv{s}_{r}.kernel`` in
HWIO and ``.bias``; ``TrainConfig.vgg_weights``). Without one the trunk
takes its own seeded initialisation (``default_features``: flax's lecun
normal from a ``torch.Generator`` seeded 1234). The JAX package's fallback
draws from ``jax.random.PRNGKey(1234)``, which the port cannot replay, so
the two fallbacks are different random convnets; the parity tests carry
JAX's fallback weights into the port.
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .losses import absolute
from ..nets.unet import _trunc_normal_

__all__ = ["VGG19Features", "PERCEPTUAL_TAPS", "perceptual_loss",
           "load_vgg_npz", "default_features"]

# VGG19 conv plan: (channels, convs per stage)
_STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
PERCEPTUAL_TAPS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")


def _names():
    return [f"conv{s}_{r}" for s, (_, reps) in enumerate(_STAGES, start=1)
            for r in range(1, reps + 1)]


class VGG19Features(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for s, (ch, reps) in enumerate(_STAGES, start=1):
            for r in range(1, reps + 1):
                setattr(self, f"conv{s}_{r}", nn.Conv2d(cin, ch, 3,
                                                        padding=1))
                cin = ch

    def init_params(self, gen: torch.Generator) -> None:
        """flax's lecun normal kernels, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _trunc_normal_(m.weight, 1.0, m.weight[0].numel(), gen)
                with torch.no_grad():
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        feats = {}
        for s, (_, reps) in enumerate(_STAGES, start=1):
            for r in range(1, reps + 1):
                h = F.relu(getattr(self, f"conv{s}_{r}")(h))
                feats[f"relu{s}_{r}"] = h
            h = F.max_pool2d(h, 2, 2)
        return feats


def default_features(device=None) -> VGG19Features:
    """The seeded fallback trunk (no pretrained weights), frozen."""
    net = VGG19Features()
    net.init_params(torch.Generator().manual_seed(1234))
    return net.requires_grad_(False).to(device)


def load_vgg_npz(path, device=None) -> VGG19Features:
    """A frozen trunk from an npz of ``conv{s}_{r}.kernel`` (HWIO) and
    ``.bias`` arrays (``tools/convert_vgg19.py``'s layout)."""
    data = np.load(path)
    net = VGG19Features()
    sd = {}
    for name in _names():
        k = np.asarray(data[f"{name}.kernel"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(data[f"{name}.bias"], np.float32))
    net.load_state_dict(sd)
    return net.requires_grad_(False).to(device)


def perceptual_loss(x: torch.Tensor, y: torch.Tensor,
                    net: Optional[VGG19Features] = None,
                    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0)
                    ) -> torch.Tensor:
    """Σ wᵢ·L1(featᵢ(x), featᵢ(y)) over relu{1..5}_1 (loss.py:126-151),
    through ``net`` (default the seeded fallback on x's device)."""
    if net is None:
        net = default_features(x.device)
    fx, fy = net(x), net(y)
    loss = 0.0
    for w, tap in zip(weights, PERCEPTUAL_TAPS):
        loss = loss + w * torch.mean(absolute(fx[tap] - fy[tap]))
    return loss
