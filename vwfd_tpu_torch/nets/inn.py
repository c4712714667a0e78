"""Invertible watermark-embedding network (port of vwfd_tpu/nets/inn.py).

The modules hold the JAX package's parameters under the same names and
shapes (``down_blocks_{i}_{b}.st{1,2}.Conv_{0,1,2}``), so that a flax tree
converts one to one (``convert.py``). Their computation is the packed-space
executor of ``nets/inn_packed.py``: ``InvertibleNet.forward`` / ``inverse``
ARE that executor, with the permuted weights it needs computed once per
weight version and device.

Ported: ``subnet='res_tpu2'`` with ``fused_st=True`` and conv Haar (the
flagship). Other subnets, ``fused_st=False`` and the lift/mixed Haar raise
``NotImplementedError``.
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels import KERNELS, KernelSet
from . import inn_packed

__all__ = ["ResSubnetTPU", "ResSubnetTPUS2", "RNVPCoupling", "InvertibleNet",
           "glorot_normal_"]


def glorot_normal_(w: torch.Tensor, scale: float, gen: torch.Generator
                   ) -> None:
    """flax ``glorot_normal`` (truncated at ±2σ, fan_avg) times ``scale``,
    drawn from ``gen``; ``w`` is OIHW."""
    fan_in = w.shape[1] * w[0, 0].numel()
    fan_out = w.shape[0] * w[0, 0].numel()
    std = scale * math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class ResSubnetTPU(nn.Module):
    """Parameters of the MXU-shaped coupling trunk (inn.py:79-113): two
    3×3 convs at ``feature`` width and a zero-init 1×1 cat-skip head."""

    def __init__(self, in_channels: int, out_channels: int,
                 feature: int = 128):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, feature, 3, padding=1)
        self.Conv_1 = nn.Conv2d(feature, feature, 3, padding=1)
        self.Conv_2 = nn.Conv2d(in_channels + feature, out_channels, 1)

    def init_params(self, gen: torch.Generator) -> None:
        for conv in (self.Conv_0, self.Conv_1):
            glorot_normal_(conv.weight, 0.1, gen)
        with torch.no_grad():
            for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
                conv.bias.zero_()
            self.Conv_2.weight.zero_()  # couplings start at identity


class ResSubnetTPUS2(ResSubnetTPU):
    """``ResSubnetTPU`` at half spatial resolution (inn.py:116-169): the
    trunk sees the 2× space-to-depth of its input and the head emits
    d2s-packed ``4·out_channels``."""

    def __init__(self, in_channels: int, out_channels: int,
                 feature: int = 128):
        super().__init__(4 * in_channels, 4 * out_channels, feature)


class RNVPCoupling(nn.Module):
    """RealNVP affine coupling (inn.py:182-252) with fused (s, t) trunks:
    ``st2`` reads x2 and gives (s2, t2) for x1, ``st1`` reads y1 and gives
    (s1, t1) for x2. ≥256-channel couplings keep the full-res ``res_tpu``
    trunk, as in the JAX package."""

    def __init__(self, channels: int, subnet: str = "res_tpu2",
                 fused_st: bool = True, width: int = 0):
        super().__init__()
        if subnet != "res_tpu2" or not fused_st:
            raise NotImplementedError(
                f"RNVPCoupling(subnet={subnet!r}, fused_st={fused_st}) is not "
                "ported; the port runs res_tpu2 with fused_st=True")
        split1 = channels // 2
        split2 = channels - split1
        sub = ResSubnetTPU if channels >= 256 else ResSubnetTPUS2
        kw = {"feature": width} if width else {}
        self.st1 = sub(split1, 2 * split2, **kw)
        self.st2 = sub(split2, 2 * split1, **kw)
        self.channels = channels

    @property
    def packed(self) -> bool:
        return isinstance(self.st1, ResSubnetTPUS2)


class InvertibleNet(nn.Module):
    """U-shaped invertible chain (inn.py:255-353): (Haar↓ + couplings)×N then
    (Haar↑ + couplings)×N, the up phase with the reference's
    reversed-truncated schedule ``block_num[:-1][::-1] + [0]``.

    ``dtype`` is the compute dtype (``torch.bfloat16`` or None for float32);
    parameters stay float32. ``kernels`` picks the kernel set the executor
    calls (``kernels.KERNELS`` or ``kernels.PLAIN``).
    """

    def __init__(self, channels: int = 12, down_num: int = 3,
                 block_num: Sequence[int] = (1, 1, 1),
                 subnet: str = "res_tpu2", fused_st: bool = True,
                 width: int = 0, haar: str = "conv",
                 dtype: Optional[torch.dtype] = None,
                 kernels: KernelSet = KERNELS):
        super().__init__()
        if haar != "conv":
            raise NotImplementedError(
                f"InvertibleNet(haar={haar!r}) is not ported; the packed "
                "executor runs the conv Haar")
        self.channels, self.down_num = channels, down_num
        self.dtype = dtype
        self.kernels = kernels
        ch = channels
        for i in range(down_num):
            ch *= 4
            for b in range(block_num[i]):
                setattr(self, f"down_blocks_{i}_{b}",
                        RNVPCoupling(ch, subnet, fused_st, width))
        up_sched = list(block_num[:-1])[::-1] + [0]
        for i in range(down_num):
            ch //= 4
            for b in range(up_sched[i]):
                setattr(self, f"up_blocks_{i}_{b}",
                        RNVPCoupling(ch, subnet, fused_st, width))
        self._packed = None
        self._packed_key = None

    def init_params(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, ResSubnetTPU):
                m.init_params(gen)

    def packed_params(self):
        """The executor's weights (permuted, cast to the compute dtype),
        computed once per parameter version, device and dtype. The state
        dict keeps the JAX tree's own unpermuted layout."""
        params = list(self.parameters())
        key = (tuple(p._version for p in params), params[0].device,
               self.dtype)
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = inn_packed.pack_params(self, self.dtype)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor, out_f32: bool = True) -> torch.Tensor:
        return inn_packed.forward(
            self.packed_params(), x, channels=self.channels,
            down_num=self.down_num, dtype=self.dtype, out_f32=out_f32,
            kernels=self.kernels)

    def inverse(self, y: torch.Tensor, return_middle: bool = True):
        return inn_packed.inverse(
            self.packed_params(), y, channels=self.channels,
            down_num=self.down_num, dtype=self.dtype,
            return_middle=return_middle, kernels=self.kernels)
