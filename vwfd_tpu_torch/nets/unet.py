"""Tamper-mask extractor (port of vwfd_tpu/nets/unet.py::UNetTPU, eval mode).

Same parameter names as the flax tree (``enc1.Conv_0``, ``enc1.BatchNorm_0``,
``up4``, ``dec4_conv``, ``dec4_bn``, ``head`` ...), so that a flax tree and its
batch stats convert one to one (``convert.py``). Tensors stay NHWC; every
conv hands cuDNN the ``permute(0, 3, 1, 2)`` view, which is channels_last,
so no copy is made.

Ported lowerings: space-to-depth stem, ``up_impl='convt'``,
``dec_impl='concat'``, ``head_impl='d2s'``; BatchNorm in eval mode (running
statistics). Train-mode BatchNorm belongs to the training slice.
"""

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.squeeze import depth_to_space, space_to_depth

__all__ = ["UNetTPU"]


def _trunc_normal_(w: torch.Tensor, scale: float, fan_in: int,
                   gen: torch.Generator) -> None:
    """flax ``variance_scaling(scale, 'fan_in', 'truncated_normal')``."""
    std = math.sqrt(scale / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(x, conv: nn.Conv2d, dt, padding):
    b = None if conv.bias is None else conv.bias.to(dt)
    return _nhwc(F.conv2d(_nchw(x), conv.weight.to(dt), b, padding=padding))


def _bn_relu(x, bn: nn.BatchNorm2d):
    """Eval BatchNorm (flax computes it in f32 and casts to the compute
    dtype; PyTorch does the same for a bf16 input with f32 statistics)."""
    y = F.batch_norm(_nchw(x), bn.running_mean, bn.running_var, bn.weight,
                     bn.bias, False, 0.0, bn.eps)
    return F.relu(_nhwc(y))


class _DoubleConv(nn.Module):
    """``convs`` × (3×3 conv without bias, BatchNorm, ReLU)."""

    def __init__(self, cin: int, features: int, convs: int = 2):
        super().__init__()
        self.convs = convs
        for i in range(convs):
            setattr(self, f"Conv_{i}",
                    nn.Conv2d(cin if i == 0 else features, features, 3,
                              padding=1, bias=False))
            setattr(self, f"BatchNorm_{i}", nn.BatchNorm2d(features, eps=1e-5))

    def forward(self, x, dt):
        for i in range(self.convs):
            x = _conv(x, getattr(self, f"Conv_{i}"), dt, 1)
            x = _bn_relu(x, getattr(self, f"BatchNorm_{i}"))
        return x


class UNetTPU(nn.Module):
    """The flagship extractor: s2d stem, encoder f·(1,2,4,8) + f·16
    bottleneck, ConvTranspose up + concat single-conv decoder, s2d-packed
    1×1 head. ``forward`` returns sigmoid probabilities (N,H,W,out) in f32;
    ``body`` returns the packed head logits (N,H/s,W/s,s²·out) in the
    compute dtype, which the serving path hands to K4 (kernels/mask.py)."""

    def __init__(self, out_channels: int = 1, init_features: int = 64,
                 s2d: int = 2, enc_convs: Union[int, Sequence[int]] = 2,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3):
        super().__init__()
        f, s = init_features, s2d
        ec = ((enc_convs,) * 5 if isinstance(enc_convs, int)
              else tuple(enc_convs))
        if len(ec) != 5:
            raise ValueError("enc_convs plan is (enc1..enc4, bottleneck)")
        self.s2d, self.out_channels, self.dtype = s, out_channels, dtype
        chans = [in_channels * s * s, f, 2 * f, 4 * f, 8 * f, 16 * f]
        for i, name in enumerate(("enc1", "enc2", "enc3", "enc4",
                                  "bottleneck")):
            setattr(self, name, _DoubleConv(chans[i], chans[i + 1], ec[i]))
        for lvl, feats in ((4, 8 * f), (3, 4 * f), (2, 2 * f), (1, f)):
            setattr(self, f"up{lvl}",
                    nn.ConvTranspose2d(2 * feats, feats, 2, stride=2))
            setattr(self, f"dec{lvl}_conv",
                    nn.Conv2d(2 * feats, feats, 3, padding=1, bias=False))
            setattr(self, f"dec{lvl}_bn", nn.BatchNorm2d(feats, eps=1e-5))
        self.head = nn.Conv2d(f, out_channels * s * s, 1)

    def init_params(self, gen: torch.Generator) -> None:
        """flax's initialisers: kaiming-normal convs, lecun-normal
        transposed convs and head, zero biases, identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                _trunc_normal_(m.weight, 1.0, m.weight[:, 0].numel(), gen)
            elif isinstance(m, nn.Conv2d):
                scale = 1.0 if m is self.head else 2.0
                _trunc_normal_(m.weight, scale, m.weight[0].numel(), gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            if getattr(m, "bias", None) is not None \
                    and not isinstance(m, nn.BatchNorm2d):
                with torch.no_grad():
                    m.bias.zero_()

    def _up(self, z, lvl, dt):
        up = getattr(self, f"up{lvl}")
        return _nhwc(F.conv_transpose2d(_nchw(z), up.weight.to(dt),
                                        up.bias.to(dt), stride=2))

    def _dec(self, z, skip, lvl, dt):
        z = torch.cat([z, skip], -1)
        z = _conv(z, getattr(self, f"dec{lvl}_conv"), dt, 1)
        return _bn_relu(z, getattr(self, f"dec{lvl}_bn"))

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """Space-to-depth input (N,H/s,W/s,s²·C) → packed head logits."""
        dt = self.dtype or torch.float32
        x = x.to(dt)

        def pool(z):
            return _nhwc(F.max_pool2d(_nchw(z), 2, 2))

        enc1 = self.enc1(x, dt)
        enc2 = self.enc2(pool(enc1), dt)
        enc3 = self.enc3(pool(enc2), dt)
        enc4 = self.enc4(pool(enc3), dt)
        bott = self.bottleneck(pool(enc4), dt)
        d4 = self._dec(self._up(bott, 4, dt), enc4, 4, dt)
        d3 = self._dec(self._up(d4, 3, dt), enc3, 3, dt)
        d2 = self._dec(self._up(d3, 2, dt), enc2, 2, dt)
        d1 = self._dec(self._up(d2, 1, dt), enc1, 1, dt)
        return _conv(d1, self.head, dt, 0).contiguous()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(N,H,W,C) in [0,1] → sigmoid probabilities (N,H,W,out), f32."""
        if train:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet (training slice)")
        dt = self.dtype or torch.float32
        logits = self.body(space_to_depth(x.to(dt), self.s2d))
        return torch.sigmoid(depth_to_space(logits, self.s2d).float())
