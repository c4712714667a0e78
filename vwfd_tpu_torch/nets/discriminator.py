"""The patch discriminator of the image family's ``with_gan`` option (port
of vwfd_tpu/nets/discriminator.py:9-37; the reference's ``Discriminator``,
models/networks.py:631-749).

Five pairs of spectral-norm convs (a 4×4 stride-2 conv, then a 3×3 conv,
each padding 1 and followed by flax's tanh GELU; no biases under spectral
norm), doubling ``dim`` from pair ``conv1`` on, then a 1×1 ``conv5``
without bias and a sigmoid (``use_sigmoid``). NHWC in and out, NCHW inside;
the ``SNConv`` vectors follow ``nets/blocks.py`` (a forward given ``sn``
puts the new vectors in it; ``load_u`` stores them).
"""

from typing import Optional

import torch
from torch import nn

from .blocks import SNConv, gelu
from .localizer import _conv_init

__all__ = ["Discriminator"]

_PAIRS = ("init", "conv1", "conv2", "conv3", "conv4")


class Discriminator(nn.Module):
    def __init__(self, dim: int = 32, use_sigmoid: bool = True,
                 use_spectral_norm: bool = True, in_channels: int = 3):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        sn = use_spectral_norm
        cin = in_channels
        for i, name in enumerate(_PAIRS):
            feats = dim * 2 ** i
            setattr(self, f"{name}_a", SNConv(cin, feats, 4, stride=2,
                                              padding=1, use_bias=not sn,
                                              use_spectral_norm=sn))
            setattr(self, f"{name}_b", SNConv(feats, feats, 3, padding=1,
                                              use_bias=not sn,
                                              use_spectral_norm=sn))
            cin = feats
        self.conv5 = nn.Conv2d(cin, 1, 1, bias=False)

    def init_params(self, gen: torch.Generator) -> None:
        """flax's initialisers: kaiming normal for each ``SNConv``, lecun
        normal for ``conv5``, ``u`` at ``ones/√n``."""
        for m in self.modules():
            if isinstance(m, SNConv):
                m.init_params(gen)
        _conv_init(self.conv5, gen, 1.0)

    def sn_convs(self):
        return [m for m in self.modules()
                if isinstance(m, SNConv) and m.use_spectral_norm]

    @torch.no_grad()
    def load_u(self, sn: dict, good: Optional[torch.Tensor] = None,
               old: Optional[dict] = None) -> None:
        """Store the vectors of a forward's ``sn``; where ``good`` (a 0-dim
        bool tensor) is False, keep ``old[conv]`` (default the stored
        ones)."""
        for conv, u in sn.items():
            keep = conv.u if old is None else old[conv]
            conv.u.copy_(u if good is None else torch.where(good, u, keep))

    def forward(self, x: torch.Tensor, sn: Optional[dict] = None
                ) -> torch.Tensor:
        """(N, H, W, C) → (N, H/32, W/32, 1) probabilities (or logits)."""
        h = x.permute(0, 3, 1, 2)
        for name in _PAIRS:
            h = gelu(getattr(self, f"{name}_a")(h, sn))
            h = gelu(getattr(self, f"{name}_b")(h, sn))
        out = self.conv5(h)
        if self.use_sigmoid:
            out = torch.sigmoid(out)
        return out.permute(0, 2, 3, 1)
