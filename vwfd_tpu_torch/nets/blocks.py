"""Conv → BatchNorm → ReLU (port of vwfd_tpu/nets/blocks.py:111-121, the
reference's hidden_models/conv_bn_relu.py:4-18), the block of the HiDDeN
nets.

A 3×3 convolution with bias, padding 1, then flax's BatchNorm (momentum
0.9, ε 1e-5) and ReLU, NHWC. The BatchNorm is ``nets/unet.py``'s: eval mode
on the running statistics; train mode on the batch statistics, returning
the running statistics flax would store (``0.9·ra + 0.1·batch`` with the
BIASED batch variance, F1) in ``stats`` without writing them.
"""

import torch
from torch import nn

from .unet import _bn_relu, _conv

__all__ = ["ConvBNRelu"]


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
