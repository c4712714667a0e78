"""The tamper localizer (port of vwfd_tpu/nets/localizer.py:23-118; the
reference's UNetDiscriminator, models/networks.py:896-1113).

A forensic front end (``use_srm``: the input symm-padded by 2, then a
learned 5×5 conv of ``dim − 12`` features, the fixed SRM bank's 9
residuals and a Bayar-constrained 5×5 conv of 3, concatenated in that
order; else two 3×3 ``SNConv``), a spectral-norm U-Net (two strided
encoder stages, ``residual_blocks`` dilated ``ResnetBlock``, two
transposed-conv decoder stages on the skips), optional QF-FiLM attention
(``with_qf_attn``: three Dense 512 + ReLU on the quality factor, a sigmoid
γ and tanh β per stage on a reflect-padded 7×7 conv), a 1×1 head on
``[e0, d1]`` and a sigmoid (``use_sigmoid``). GELU is flax's tanh form.

NHWC in and out (the JAX layout), NCHW inside. The Bayar kernel is kept in
flax's (5, 5, Cin, 3) layout as the parameter ``bayar_kernel`` and
constrained on every call (``ops/filters.py``); every other conv holds a
PyTorch weight that ``convert.py`` maps from flax's kernel. With ``sn`` (a
dict) the spectral-norm convs put their new power-iteration vectors in it
(flax's ``update_sn=True``); ``load_u`` stores them.

The port computes in float32 (on the card with TF32 off, the image model's
``device.full_f32``), as the JAX model does.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.filters import bayar_constrain, srm_conv
from ..ops.pad import symm_pad
from .blocks import ResnetBlock, SNConv, gelu, reflect_pad
from .unet import _trunc_normal_

__all__ = ["UNetDiscriminator"]


def _conv_init(m: nn.Module, gen: torch.Generator, scale: float) -> None:
    """flax's variance scaling (fan-in) on a Conv2d or Linear, zero bias."""
    fan_in = m.weight[0].numel()
    _trunc_normal_(m.weight, scale, fan_in, gen)
    if m.bias is not None:
        with torch.no_grad():
            m.bias.zero_()


class UNetDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 residual_blocks: int = 2, dim: int = 16,
                 use_spectral_norm: bool = True, use_srm: bool = True,
                 use_sigmoid: bool = True, with_qf_attn: bool = False,
                 qf_dim: int = 1):
        super().__init__()
        d, sn = dim, use_spectral_norm
        self.use_srm, self.use_sigmoid = use_srm, use_sigmoid
        self.with_qf_attn = with_qf_attn
        if use_srm:
            self.init_conv = nn.Conv2d(in_channels, d - 12, 5, bias=False)
            self.bayar_kernel = nn.Parameter(torch.zeros(5, 5, in_channels,
                                                         3))
        else:
            self.init_a = SNConv(in_channels, d, 3, use_spectral_norm=sn)
            self.init_b = SNConv(d, d, 3, use_spectral_norm=sn)
        for name, cin, feats in (("enc1", d, 2 * d), ("enc2", 2 * d, 4 * d)):
            setattr(self, f"{name}_down", SNConv(cin, feats, 4, stride=2,
                                                 padding=1,
                                                 use_spectral_norm=sn))
            setattr(self, f"{name}_conv", SNConv(feats, feats, 3,
                                                 use_spectral_norm=sn))
        self.res = [ResnetBlock(4 * d, 2, sn) for _ in range(residual_blocks)]
        for i, blk in enumerate(self.res):
            setattr(self, f"res{i}", blk)
        if with_qf_attn:
            for i in range(3):
                setattr(self, f"qf_embed{i}",
                        nn.Linear(qf_dim if i == 0 else 512, 512))
            for name, feats in (("3", 4 * d), ("2", 2 * d), ("1", d)):
                setattr(self, f"film{name}_g", nn.Linear(512, feats))
                setattr(self, f"film{name}_b", nn.Linear(512, feats))
                setattr(self, f"attn{name}", nn.Conv2d(feats, feats, 7))
        for name, cin, feats in (("dec2", 8 * d, 2 * d), ("dec1", 4 * d, d)):
            setattr(self, f"{name}_up", SNConv(cin, feats, 4, stride=2,
                                               transpose=True,
                                               use_spectral_norm=sn))
            setattr(self, f"{name}_conv", SNConv(feats, feats, 3,
                                                 use_spectral_norm=sn))
        self.head = nn.Conv2d(2 * d, out_channels, 1)

    def init_params(self, gen: torch.Generator) -> None:
        """flax's initialisers: kaiming normal for the front end's learned
        convs and every ``SNConv``, lecun normal for the head, the Dense
        layers and the attention convs, zero biases, ``u`` at ``ones/√n``."""
        for name, m in self.named_modules():
            if isinstance(m, SNConv):
                m.init_params(gen)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                _conv_init(m, gen, 2.0 if name == "init_conv" else 1.0)
        if self.use_srm:
            k = self.bayar_kernel
            _trunc_normal_(k, 2.0, k[..., 0].numel(), gen)

    def sn_convs(self):
        return [m for m in self.modules()
                if isinstance(m, SNConv) and m.use_spectral_norm]

    @torch.no_grad()
    def load_u(self, sn: dict, good: Optional[torch.Tensor] = None) -> None:
        """Store the vectors of a forward's ``sn``; where ``good`` (a 0-dim
        bool tensor) is False, keep the old ones."""
        for conv, u in sn.items():
            conv.u.copy_(u if good is None else torch.where(good, u, conv.u))

    def _stage(self, z, name, sn):
        z = gelu(getattr(self, f"{name}_down")(z, sn))
        return gelu(getattr(self, f"{name}_conv")(z, sn))

    def _up(self, z, skip, name, sn):
        z = gelu(getattr(self, f"{name}_up")(torch.cat([skip, z], 1), sn))
        return gelu(getattr(self, f"{name}_conv")(z, sn))

    def _film(self, z, q, name):
        gamma = torch.sigmoid(getattr(self, f"film{name}_g")(q))
        beta = torch.tanh(getattr(self, f"film{name}_b")(q))
        a = getattr(self, f"attn{name}")(reflect_pad(z, 3))
        return gamma[:, :, None, None] * a + beta[:, :, None, None]

    def forward(self, x: torch.Tensor, qf: Optional[torch.Tensor] = None,
                sn: Optional[dict] = None) -> torch.Tensor:
        """(N, H, W, C) → (N, H, W, out_channels): the mask probabilities
        (``use_sigmoid``) or logits; ``qf`` (N, qf_dim) with
        ``with_qf_attn``."""
        if self.use_srm:
            xp = symm_pad(x, (2, 2, 2, 2))
            bk = bayar_constrain(self.bayar_kernel).permute(3, 2, 0, 1)
            xc = xp.permute(0, 3, 1, 2)
            e0 = gelu(torch.cat([self.init_conv(xc),
                                 srm_conv(xp).permute(0, 3, 1, 2),
                                 F.conv2d(xc, bk)], 1))
        else:
            h = gelu(self.init_a(x.permute(0, 3, 1, 2), sn))
            e0 = gelu(self.init_b(h, sn))
        e1 = self._stage(e0, "enc1", sn)
        e2 = self._stage(e1, "enc2", sn)
        m = e2
        for blk in self.res:
            m = blk(m, sn)
        q = None
        if self.with_qf_attn:
            q = qf
            for i in range(3):
                q = F.relu(getattr(self, f"qf_embed{i}")(q))
            m = self._film(m, q, "3")
        d2 = self._up(m, e2, "dec2", sn)
        if self.with_qf_attn:
            d2 = self._film(d2, q, "2")
        d1 = self._up(d2, e1, "dec1", sn)
        if self.with_qf_attn:
            d1 = self._film(d1, q, "1")
        out = self.head(torch.cat([e0, d1], 1))
        if self.use_sigmoid:
            out = torch.sigmoid(out)
        return out.permute(0, 2, 3, 1)
