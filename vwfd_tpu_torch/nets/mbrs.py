"""The MBRS family (port of vwfd_tpu/nets/mbrs.py:19-208): the SE-block
encoder and message-diffusion decoder of the reference's mbrs_models/, the
plain conv decoder and the Baluja prep / hide / reveal trio, NHWC float32.

* ``SEBottleneck`` (blocks/SENet.py:52-91): 1×1 (strided) → BN → ReLU →
  3×3 → BN → ReLU → 1×1 → BN, squeeze-excitation (spatial mean, 1×1 to
  C/8, ReLU, 1×1 back, sigmoid, product), plus the identity or a strided
  1×1 + BN where the shape changes, ReLU;
* ``SENet`` (``blocks`` bottlenecks), ``SENetDecoder`` (a bottleneck, then
  per stage a bottleneck and a stride-2 one doubling the channels) and
  ``ExpandNet`` (2×2 stride-2 transposed conv → BN → ReLU per stage);
* ``MBRSEncoder`` (Encoder_MP_Diffusion, Encoder_MP.py:64-115): the image
  through ConvBNRelu and an SE trunk; the message through Dense(diffusion
  length), a (√D, √D, 1) map, ConvBNRelu, ExpandNet up to the image size
  and two SE trunks; both concatenated, ConvBNRelu, then a 1×1 conv to 3
  over ``[h, image]``;
* ``MBRSDecoder`` (Decoder_Diffusion, Decoder.py:88-118): ConvBNRelu, the
  strided SE trunk down to the diffusion map, ConvBNRelu, an SE block,
  ConvBNRelu to 1 channel, flattened, Dense(message length);
* ``MBRSPlainDecoder`` (Decoder.py:56-85) and ``BalujaPrep`` /
  ``BalujaHiding`` / ``BalujaReveal`` (baluja_networks.py:5-176), which
  the JAX package reaches only through its registry.

Module names are the flax tree's (``image_first.block0.Conv_1``,
``message_expand.up0``, ``down.down0.downsample_bn``, ...), so a tree
converts one to one (``convert.py``; ``message_expand.up{i}`` are
transposed convs, whose kernels flax applies flipped, F3). Flax pads a 1×1
strided conv by 0 ('SAME') and a 4×4 'SAME' conv by 1 before and 2 after.
``forward(..., train=True)`` returns ``(out, stats)``: BatchNorm on the
batch statistics and the updated running statistics of each (flax's
``mutable=["batch_stats"]``, F1), applied with ``load_stats``; with
``mesh`` (a ``parallel.Mesh`` of more than one rank) the batch statistics
are the global batch's (``nets/unet.py``'s ``BatchStats``). The SE
blocks' third BatchNorm and ``downsample_bn`` have no ReLU.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ConvBNRelu, FlaxNet, conv_nhwc
from .unet import BatchStats, _bn

__all__ = ["SEBottleneck", "SENet", "SENetDecoder", "ExpandNet",
           "MBRSEncoder", "MBRSDecoder", "MBRSPlainDecoder", "BalujaPrep",
           "BalujaHiding", "BalujaReveal"]


class SEBottleneck(nn.Module):
    def __init__(self, cin: int, features: int, r: int = 8,
                 stride: int = 1):
        super().__init__()
        f = features
        self.Conv_0 = nn.Conv2d(cin, f, 1, stride=stride, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(f)
        self.Conv_1 = nn.Conv2d(f, f, 3, padding=1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm2d(f)
        self.Conv_2 = nn.Conv2d(f, f, 1, bias=False)
        self.BatchNorm_2 = nn.BatchNorm2d(f)
        self.Conv_3 = nn.Conv2d(f, f // r, 1, bias=False)
        self.Conv_4 = nn.Conv2d(f // r, f, 1, bias=False)
        self.downsample = self.downsample_bn = None
        if cin != f or stride != 1:
            self.downsample = nn.Conv2d(cin, f, 1, stride=stride, bias=False)
            self.downsample_bn = nn.BatchNorm2d(f)

    def forward(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        h = F.relu(_bn(conv_nhwc(x, self.Conv_0), self.BatchNorm_0, stats))
        h = F.relu(_bn(conv_nhwc(h, self.Conv_1), self.BatchNorm_1, stats))
        h = _bn(conv_nhwc(h, self.Conv_2), self.BatchNorm_2, stats)
        s = F.relu(conv_nhwc(h.mean(dim=(1, 2), keepdim=True), self.Conv_3))
        h = h * torch.sigmoid(conv_nhwc(s, self.Conv_4))
        if self.downsample is not None:
            x = _bn(conv_nhwc(x, self.downsample), self.downsample_bn, stats)
        return F.relu(h + x)


class SENet(nn.Module):
    def __init__(self, cin: int, features: int, blocks: int = 4):
        super().__init__()
        self.n = blocks
        for i in range(blocks):
            setattr(self, f"block{i}",
                    SEBottleneck(cin if i == 0 else features, features))

    def forward(self, x, stats=None):
        for i in range(self.n):
            x = getattr(self, f"block{i}")(x, stats)
        return x


class SENetDecoder(nn.Module):
    def __init__(self, cin: int, features: int, blocks: int = 4):
        super().__init__()
        self.n = blocks - 1
        f = features
        self.block0 = SEBottleneck(cin, f)
        for i in range(self.n):
            setattr(self, f"keep{i}", SEBottleneck(f, f))
            setattr(self, f"down{i}", SEBottleneck(f, 2 * f, stride=2))
            f *= 2
        self.out_channels = f

    def forward(self, x, stats=None):
        x = self.block0(x, stats)
        for i in range(self.n):
            x = getattr(self, f"keep{i}")(x, stats)
            x = getattr(self, f"down{i}")(x, stats)
        return x


class ExpandNet(nn.Module):
    def __init__(self, cin: int, features: int, blocks: int = 3):
        super().__init__()
        self.n = blocks
        for i in range(blocks):
            setattr(self, f"up{i}", nn.ConvTranspose2d(
                cin if i == 0 else features, features, 2, stride=2))
            setattr(self, f"bn{i}", nn.BatchNorm2d(features))

    def forward(self, x, stats=None):
        for i in range(self.n):
            x = F.relu(_bn(conv_nhwc(x, getattr(self, f"up{i}")),
                           getattr(self, f"bn{i}"), stats))
        return x


class MBRSEncoder(FlaxNet):
    def __init__(self, height: int = 128, message_length: int = 30,
                 channels: int = 64, blocks: int = 4,
                 diffusion_length: int = 256):
        super().__init__()
        c = channels
        self.dsize = int(diffusion_length ** 0.5)
        self.image_pre = ConvBNRelu(3, c)
        self.image_first = SENet(c, c, blocks)
        self.message_duplicate = nn.Linear(message_length, diffusion_length)
        self.message_pre0 = ConvBNRelu(1, c)
        self.message_expand = ExpandNet(
            c, c, int(math.log2(height // self.dsize)))
        self.message_pre2 = SENet(c, c, 1)
        self.message_first = SENet(c, c, blocks)
        self.after_concat = ConvBNRelu(2 * c, c)
        self.final = nn.Conv2d(c + 3, 3, 1)

    def forward(self, image: torch.Tensor, message: torch.Tensor,
                train: bool = False, mesh=None):
        """(B, H, W, 3) image, (B, L) message → (B, H, W, 3) encoded."""
        stats = BatchStats(mesh) if train else None
        img = self.image_first(self.image_pre(image, stats), stats)
        m = self.message_duplicate(message).reshape(-1, self.dsize,
                                                    self.dsize, 1)
        m = self.message_expand(self.message_pre0(m, stats), stats)
        m = self.message_first(self.message_pre2(m, stats), stats)
        h = self.after_concat(torch.cat([img, m], -1), stats)
        out = conv_nhwc(torch.cat([h, image], -1), self.final)
        return (out, stats) if train else out


class MBRSDecoder(FlaxNet):
    def __init__(self, height: int = 128, message_length: int = 30,
                 channels: int = 64, diffusion_length: int = 256):
        super().__init__()
        c = channels
        dsize = int(diffusion_length ** 0.5)
        self.pre = ConvBNRelu(3, c)
        self.down = SENetDecoder(c, c, int(math.log2(height // dsize)) + 1)
        self.mid = ConvBNRelu(self.down.out_channels, c)
        self.keep = SENet(c, c, 1)
        self.final = ConvBNRelu(c, 1)
        self.message = nn.Linear(diffusion_length, message_length)

    def forward(self, image: torch.Tensor, train: bool = False, mesh=None):
        """(B, H, W, 3) → (B, L) message logits."""
        stats = BatchStats(mesh) if train else None
        h = self.down(self.pre(image, stats), stats)
        h = self.final(self.keep(self.mid(h, stats), stats), stats)
        out = self.message(h.reshape(h.shape[0], -1))
        return (out, stats) if train else out


class MBRSPlainDecoder(FlaxNet):
    """9 ConvBNRelu + a ConvBNRelu to ``out_num``, the mean, Dense,
    (tanh + 1)/2."""

    def __init__(self, out_num: int = 4, channels: int = 64):
        super().__init__()
        for i in range(9):
            setattr(self, f"conv{i}", ConvBNRelu(3 if i == 0 else channels,
                                                 channels))
        self.head = ConvBNRelu(channels, out_num)
        self.linear = nn.Linear(out_num, out_num)

    def forward(self, image: torch.Tensor, train: bool = False, mesh=None):
        stats = BatchStats(mesh) if train else None
        h = image
        for i in range(9):
            h = getattr(self, f"conv{i}")(h, stats)
        h = self.head(h, stats).mean(dim=(1, 2))
        out = (torch.tanh(self.linear(h)) + 1.0) / 2.0
        return (out, stats) if train else out


_BALUJA_K = (3, 4, 5)


def _same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """flax's 'SAME' stride-1 conv of NHWC ``x``: k − 1 pixels of padding,
    the smaller half before."""
    k = conv.kernel_size[0]
    lo, hi = (k - 1) // 2, k // 2
    return conv_nhwc(F.pad(x, (0, 0, lo, hi, lo, hi)), conv)


class _Baluja(FlaxNet):
    """Stages of three parallel ReLU convs (3×3, 4×4, 5×5, 'SAME'),
    concatenated."""

    def _stages(self, h, names):
        for s in names:
            h = torch.cat([F.relu(_same(h, getattr(self, f"{s}_k{k}")))
                           for k in _BALUJA_K], -1)
        return h

    def _add_stages(self, cin, features, names):
        for i, s in enumerate(names):
            for k in _BALUJA_K:
                setattr(self, f"{s}_k{k}", nn.Conv2d(
                    cin if i == 0 else 3 * features, features, k))


class BalujaPrep(_Baluja):
    def __init__(self, cin: int = 3, features: int = 50):
        super().__init__()
        self._add_stages(cin, features, ("s1", "s2"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._stages(x, ("s1", "s2"))


class BalujaHiding(_Baluja):
    """Five stages, then a 1×1 conv to 3; ``cin`` is the prepared secret's
    channels plus the cover's."""

    def __init__(self, cin: int = 153, features: int = 50):
        super().__init__()
        self.names = tuple(f"s{s}" for s in range(5))
        self._add_stages(cin, features, self.names)
        self.final = nn.Conv2d(3 * features, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self._stages(x, self.names), self.final)


class BalujaReveal(BalujaHiding):
    """The hiding trunk on the container: reveals the secret image."""

    def __init__(self, cin: int = 3, features: int = 50):
        super().__init__(cin, features)
