"""The HiDDeN family (port of vwfd_tpu/nets/hidden.py:18-84): encoder,
decoder and discriminator of the reference's hidden_models/, NHWC float32.

* ``HiddenEncoder``: ``blocks`` × ConvBNRelu(channels) on the image, the
  message broadcast over (H, W) and concatenated as ``[message, h, image]``
  on channels, ConvBNRelu(channels), a 1×1 conv to 3 (encoder.py:8-43);
* ``HiddenDecoder``: ``blocks`` × ConvBNRelu(channels), ConvBNRelu(message
  length), the global mean, Dense(message length) (decoder.py:8-36);
* ``HiddenDiscriminator``: ``blocks`` × ConvBNRelu(channels), the mean,
  Dense(1) (discriminator.py:6-27);
* ``HiddenEncoderDecoder``: encode → noise → decode (encoder_decoder.py:
  8-29).

The defaults are the published widths (message 30, 64 channels, 4 / 7 / 3
blocks). Module names are the flax tree's (``conv0.Conv_0``,
``conv0.BatchNorm_0``, ``after_concat``, ``final``, ``msg_conv``,
``linear``), so a tree converts one to one (``convert.py``). ``forward(...,
train=True)`` returns ``(out, stats)``: BatchNorm on batch statistics and
the updated running statistics of each (flax's ``mutable=["batch_stats"]``),
applied with ``load_stats``; with ``mesh`` (a ``parallel.Mesh`` of more than
one rank) the batch statistics are the global batch's (``nets/unet.py``'s
``BatchStats``).
"""

from typing import Callable, Optional

import torch
from torch import nn

from .blocks import ConvBNRelu, FlaxNet
from .unet import BatchStats, _conv

__all__ = ["HiddenEncoder", "HiddenDecoder", "HiddenDiscriminator",
           "HiddenEncoderDecoder"]


class _HiddenNet(FlaxNet):
    """The HiDDeN nets' stack of ConvBNRelu blocks."""

    def _blocks(self, h, n, stats):
        for i in range(n):
            h = getattr(self, f"conv{i}")(h, stats)
        return h


class HiddenEncoder(_HiddenNet):
    def __init__(self, message_length: int = 30, channels: int = 64,
                 blocks: int = 4):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"conv{i}", ConvBNRelu(3 if i == 0 else channels,
                                                 channels))
        self.after_concat = ConvBNRelu(message_length + channels + 3,
                                       channels)
        self.final = nn.Conv2d(channels, 3, 1)

    def forward(self, image: torch.Tensor, message: torch.Tensor,
                train: bool = False, mesh=None):
        """(B, H, W, 3) image, (B, L) message → (B, H, W, 3) encoded."""
        stats = BatchStats(mesh) if train else None
        h = self._blocks(image, self.blocks, stats)
        b, ih, iw, _ = image.shape
        expanded = message[:, None, None, :].expand(b, ih, iw,
                                                    message.shape[-1])
        h = self.after_concat(torch.cat([expanded, h, image], -1), stats)
        out = _conv(h, self.final, h.dtype, 0)
        return (out, stats) if train else out


class HiddenDecoder(_HiddenNet):
    def __init__(self, message_length: int = 30, channels: int = 64,
                 blocks: int = 7):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"conv{i}", ConvBNRelu(3 if i == 0 else channels,
                                                 channels))
        self.msg_conv = ConvBNRelu(channels, message_length)
        self.linear = nn.Linear(message_length, message_length)

    def forward(self, image_wm: torch.Tensor, train: bool = False,
                mesh=None):
        """(B, H, W, 3) → (B, L) message logits (AdaptiveAvgPool2d(1))."""
        stats = BatchStats(mesh) if train else None
        h = self.msg_conv(self._blocks(image_wm, self.blocks, stats), stats)
        out = self.linear(h.mean(dim=(1, 2)))
        return (out, stats) if train else out


class HiddenDiscriminator(_HiddenNet):
    def __init__(self, channels: int = 64, blocks: int = 3):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"conv{i}", ConvBNRelu(3 if i == 0 else channels,
                                                 channels))
        self.linear = nn.Linear(channels, 1)

    def forward(self, image: torch.Tensor, train: bool = False, mesh=None):
        """(B, H, W, 3) → (B, 1) logits."""
        stats = BatchStats(mesh) if train else None
        h = self._blocks(image, self.blocks, stats)
        out = self.linear(h.mean(dim=(1, 2)))
        return (out, stats) if train else out


class HiddenEncoderDecoder(nn.Module):
    """encode → noise → decode (hidden_models/encoder_decoder.py:8-29);
    ``noiser(encoded, cover) -> noised`` is any attack callable with its
    draws bound."""

    def __init__(self, message_length: int = 30, encoder_channels: int = 64,
                 encoder_blocks: int = 4, decoder_channels: int = 64,
                 decoder_blocks: int = 7):
        super().__init__()
        self.encoder = HiddenEncoder(message_length, encoder_channels,
                                     encoder_blocks)
        self.decoder = HiddenDecoder(message_length, decoder_channels,
                                     decoder_blocks)

    def forward(self, image, message, noiser: Optional[Callable] = None,
                train: bool = False, mesh=None):
        """``(encoded, noised, decoded)``; with ``train`` also the two nets'
        BatchNorm statistics, ``(…, enc_stats, dec_stats)``."""
        if train:
            encoded, es = self.encoder(image, message, train=True, mesh=mesh)
            noised = encoded if noiser is None else noiser(encoded, image)
            decoded, ds = self.decoder(noised, train=True, mesh=mesh)
            return encoded, noised, decoded, es, ds
        encoded = self.encoder(image, message)
        noised = encoded if noiser is None else noiser(encoded, image)
        return encoded, noised, self.decoder(noised)
