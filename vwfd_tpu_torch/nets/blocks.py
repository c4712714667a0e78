"""Conv → BatchNorm → ReLU (port of vwfd_tpu/nets/blocks.py:111-121, the
reference's hidden_models/conv_bn_relu.py:4-18), the block of the HiDDeN
and MBRS nets, and ``FlaxNet``, their shared base.

A 3×3 convolution with bias, padding 1, then flax's BatchNorm (momentum
0.9, ε 1e-5) and ReLU, NHWC. The BatchNorm is ``nets/unet.py``'s: eval mode
on the running statistics; train mode on the batch statistics, returning
the running statistics flax would store (``0.9·ra + 0.1·batch`` with the
BIASED batch variance, F1) in ``stats`` without writing them.

``FlaxNet`` draws flax's initialisers (``init_params``) and writes a
train-mode forward's statistics (``load_stats``).
"""

import torch
from torch import nn

from .unet import _bn_relu, _conv, _nchw, _nhwc, _trunc_normal_

__all__ = ["ConvBNRelu", "FlaxNet", "conv_nhwc"]


def conv_nhwc(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """``conv`` (its own stride, padding and bias) on NHWC ``x``."""
    return _nhwc(conv(_nchw(x)))


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, padding=1)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        """``stats`` None: eval mode; a dict: train mode, the updated
        running (mean, var) of the BatchNorm land in it."""
        return _bn_relu(_conv(x, self.Conv_0, x.dtype, 1), self.BatchNorm_0,
                        stats)


class FlaxNet(nn.Module):
    """flax's initialisers and the BatchNorm statistics, shared."""

    def init_params(self, gen: torch.Generator) -> None:
        """kaiming-normal (truncated, fan-in) ConvBNRelu convs, lecun-normal
        every other conv, transposed conv and Dense layer, zero biases,
        identity BatchNorm."""
        kaiming = {id(b.Conv_0) for b in self.modules()
                   if isinstance(b, ConvBNRelu)}
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                # fan-in: (Cout, Cin, k, k), (Cin, Cout, k, k), (out, in)
                fan_in = (m.weight[:, 0] if isinstance(m, nn.ConvTranspose2d)
                          else m.weight[0]).numel()
                _trunc_normal_(m.weight, 2.0 if id(m) in kaiming else 1.0,
                               fan_in, gen)
                if m.bias is not None:
                    with torch.no_grad():
                        m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def load_stats(self, stats, good=None) -> None:
        """Write the running statistics of a train-mode forward; where
        ``good`` (a 0-dim bool tensor) is False, keep the old ones."""
        for bn, (mean, var) in stats.items():
            for buf, new in ((bn.running_mean, mean), (bn.running_var, var)):
                buf.copy_(new if good is None else torch.where(good, new, buf))
