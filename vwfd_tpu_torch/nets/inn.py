"""Invertible watermark-embedding network (port of vwfd_tpu/nets/inn.py).

The modules hold the JAX package's parameters under the same names and
shapes (``down_blocks_{i}_{b}.st{1,2}.Conv_{k}``, or ``s1, t1, s2, t2`` for
the split couplings), so that a flax tree converts one to one
(``convert.py``). Two executors run them, picked as
``vwfd_tpu/models/video_model.py::_inn_forward`` picks
(``ModelConfig.inn_packed``):

* ``packed=True``: the packed-space executor of ``nets/inn_packed.py`` (K1
  transitions, K2 coupling heads), for ``subnet='res_tpu2'`` with
  ``fused_st=True`` only, as in the JAX package; the permuted weights it
  needs are computed once per weight version and device. It ignores
  ``haar``: every setting is the same linear map.
* ``packed=False``: the module path of ``inn.py:28-353``. Each subnet runs
  its convolutions through cuDNN (NHWC tensors, ``channels_last`` views);
  every Haar squeeze, lift, conv or mixed alike, is K14 (``kernels/haar.py``)
  and every coupling affine K15 (``kernels/affine.py``), with s and t the
  halves of one head (``fused_st``) or the outputs of two subnets.

Both are differentiable in the parameters (training) and run the forward
and the inverse.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import KERNELS, KernelSet
from ..ops.squeeze import depth_to_space, space_to_depth
from . import inn_packed

__all__ = ["DenseSubnet", "ResSubnet", "ResSubnetTPU", "ResSubnetTPUS2",
           "RNVPCoupling", "InvertibleNet", "glorot_normal_", "HAARS"]

HAARS = ("lift", "conv", "mixed")


def glorot_normal_(w: torch.Tensor, scale: float, gen: torch.Generator
                   ) -> None:
    """flax ``glorot_normal`` (truncated at ±2σ, fan_avg) times ``scale``,
    drawn from ``gen``; ``w`` is OIHW."""
    fan_in = w.shape[1] * w[0, 0].numel()
    fan_out = w.shape[0] * w[0, 0].numel()
    std = scale * math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dt) -> torch.Tensor:
    """NHWC conv in the compute dtype (SAME padding): cuDNN sees the
    channels_last NCHW view."""
    pad = conv.kernel_size[0] // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt),
                 conv.bias.to(dt), padding=pad)
    return y.permute(0, 2, 3, 1)


class _Subnet(nn.Module):
    """Convs ``Conv_0`` … ``Conv_{n-1}``; the last one zero-initialised
    (couplings start at the identity), the others ``scaled_glorot(0.1)``,
    biases zero (``vwfd_tpu/nets/blocks.py::scaled_glorot``)."""

    def convs(self):
        return [getattr(self, f"Conv_{i}") for i in range(self.n_convs)]

    def init_params(self, gen: torch.Generator) -> None:
        *inner, last = self.convs()
        for conv in inner:
            glorot_normal_(conv.weight, 0.1, gen)
        with torch.no_grad():
            for conv in (*inner, last):
                conv.bias.zero_()
            last.weight.zero_()


class DenseSubnet(_Subnet):
    """5-conv dense block with ELU (inn.py:28-50): each conv reads the
    concat ``[x, x1, …]`` of the input and every earlier output, in that
    order, which fixes each conv's input-channel order."""

    n_convs = 5

    def __init__(self, in_channels: int, out_channels: int, gc: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"Conv_{i}",
                    nn.Conv2d(in_channels + i * gc, gc, 3, padding=1))
        self.Conv_4 = nn.Conv2d(in_channels + 4 * gc, out_channels, 3,
                                padding=1)

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        feats = [x.to(dt)]
        for conv in self.convs()[:4]:
            feats.append(F.elu(_conv(torch.cat(feats, -1), conv, dt)))
        return _conv(torch.cat(feats, -1), self.Conv_4, dt)


class ResSubnet(_Subnet):
    """4 × (3×3 conv + ELU) at ``feature`` width, then a zero-init 3×3
    conv on the cat-skip ``[x, h]`` (inn.py:53-76)."""

    n_convs = 5

    def __init__(self, in_channels: int, out_channels: int,
                 feature: int = 64):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, feature, 3, padding=1)
        for i in range(1, 4):
            setattr(self, f"Conv_{i}", nn.Conv2d(feature, feature, 3,
                                                 padding=1))
        self.Conv_4 = nn.Conv2d(in_channels + feature, out_channels, 3,
                                padding=1)

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        x = x.to(dt)
        h = x
        for conv in self.convs()[:4]:
            h = F.elu(_conv(h, conv, dt))
        return _conv(torch.cat([x, h], -1), self.Conv_4, dt)


class ResSubnetTPU(_Subnet):
    """The MXU-shaped coupling trunk (inn.py:79-113): two 3×3 convs at
    ``feature`` width and a zero-init 1×1 cat-skip head."""

    n_convs = 3

    def __init__(self, in_channels: int, out_channels: int,
                 feature: int = 128):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, feature, 3, padding=1)
        self.Conv_1 = nn.Conv2d(feature, feature, 3, padding=1)
        self.Conv_2 = nn.Conv2d(in_channels + feature, out_channels, 1)

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        x = x.to(dt)
        h = F.elu(_conv(x, self.Conv_0, dt))
        h = F.elu(_conv(h, self.Conv_1, dt))
        return _conv(torch.cat([x, h], -1), self.Conv_2, dt)


class ResSubnetTPUS2(ResSubnetTPU):
    """``ResSubnetTPU`` at half spatial resolution (inn.py:116-169): the
    trunk sees the 2× space-to-depth of its input and the head emits
    d2s-packed ``4·out_channels``."""

    def __init__(self, in_channels: int, out_channels: int,
                 feature: int = 128):
        super().__init__(4 * in_channels, 4 * out_channels, feature)

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        return depth_to_space(super().forward(space_to_depth(x, 2), dt), 2)


_SUBNETS = {"res": ResSubnet, "dense": DenseSubnet, "res_tpu": ResSubnetTPU,
            "res_tpu2": ResSubnetTPUS2}


class RNVPCoupling(nn.Module):
    """RealNVP affine coupling (inn.py:182-252). ``fused_st``: ``st2``
    reads x2 and gives (s2 ‖ t2) for x1, ``st1`` reads y1 and gives (s1 ‖
    t1) for x2, each from one double-width head; otherwise the reference's
    four subnets ``s1, t1, s2, t2``. ≥256-channel couplings of ``res_tpu2``
    keep the full-res ``res_tpu`` trunk; ``width`` overrides the subnet
    width (``feature`` of the res subnets, ``gc`` of the dense one)."""

    def __init__(self, channels: int, subnet: str = "res_tpu2",
                 fused_st: bool = True, width: int = 0):
        super().__init__()
        if subnet not in _SUBNETS:
            raise ValueError(f"unknown subnet {subnet!r} (one of "
                             f"{sorted(_SUBNETS)})")
        split1 = channels // 2
        split2 = channels - split1
        name = "res_tpu" if subnet == "res_tpu2" and channels >= 256 \
            else subnet
        sub = _SUBNETS[name]
        kw = ({"feature": width} if subnet.startswith("res")
              else {"gc": width}) if width else {}
        self.fused_st = fused_st
        if fused_st:
            self.st1 = sub(split1, 2 * split2, **kw)
            self.st2 = sub(split2, 2 * split1, **kw)
        else:
            self.s1 = sub(split1, split2, **kw)
            self.t1 = sub(split1, split2, **kw)
            self.s2 = sub(split2, split1, **kw)
            self.t2 = sub(split2, split1, **kw)
        self.channels, self.split1 = channels, split1

    @property
    def packed(self) -> bool:
        return isinstance(self.st1, ResSubnetTPUS2)

    def _st(self, i: int, z: torch.Tensor, dt):
        """The head of ``st{i}`` (s ‖ t), or the pair ``(s{i}, t{i})``."""
        if self.fused_st:
            return getattr(self, f"st{i}")(z, dt)
        return getattr(self, f"s{i}")(z, dt), getattr(self, f"t{i}")(z, dt)

    def forward(self, z: torch.Tensor, dt, k: KernelSet) -> torch.Tensor:
        c = self.split1
        x1, x2 = z[..., :c], z[..., c:]
        if torch.is_grad_enabled():
            y1 = k.coupling_affine(self._st(2, x2, dt), x1)
            y2 = k.coupling_affine(self._st(1, y1, dt), x2)
            return torch.cat([y1, y2], -1)
        out = torch.empty_like(z)
        y1, y2 = out[..., :c], out[..., c:]
        k.coupling_affine(self._st(2, x2, dt), x1, out=y1)
        k.coupling_affine(self._st(1, y1, dt), x2, out=y2)
        return out

    def inverse(self, z: torch.Tensor, dt, k: KernelSet) -> torch.Tensor:
        c = self.split1
        y1, y2 = z[..., :c], z[..., c:]
        if torch.is_grad_enabled():
            x2 = k.coupling_affine(self._st(1, y1, dt), y2, inverse=True)
            x1 = k.coupling_affine(self._st(2, x2, dt), y1, inverse=True)
            return torch.cat([x1, x2], -1)
        out = torch.empty_like(z)
        x1, x2 = out[..., :c], out[..., c:]
        k.coupling_affine(self._st(1, y1, dt), y2, out=x2, inverse=True)
        k.coupling_affine(self._st(2, x2, dt), y1, out=x1, inverse=True)
        return out


class InvertibleNet(nn.Module):
    """U-shaped invertible chain (inn.py:255-353): (Haar↓ + couplings)×N then
    (Haar↑ + couplings)×N, the up phase with the reference's
    reversed-truncated schedule ``block_num[:-1][::-1] + [0]``.

    ``dtype`` is the compute dtype (``torch.bfloat16`` or None for float32);
    parameters stay float32. ``kernels`` picks the kernel set both
    executors call (``kernels.KERNELS`` or ``kernels.PLAIN``); ``packed``
    picks the executor (module docstring).
    """

    def __init__(self, channels: int = 12, down_num: int = 3,
                 block_num: Sequence[int] = (1, 1, 1),
                 subnet: str = "res_tpu2", fused_st: bool = True,
                 width: int = 0, haar: str = "conv",
                 dtype: Optional[torch.dtype] = None,
                 kernels: KernelSet = KERNELS, packed: bool = True):
        super().__init__()
        if packed and not (subnet == "res_tpu2" and fused_st):
            raise ValueError("inn_packed requires inn_subnet='res_tpu2' "
                             "with fused_st=True (nets/inn_packed.py)")
        if haar not in HAARS:
            raise ValueError(f"unknown haar {haar!r} (one of {HAARS})")
        self.channels, self.down_num = channels, down_num
        self.dtype, self.kernels, self.packed = dtype, kernels, packed
        ch = channels
        self.down_blocks, self.up_blocks = [], []
        for i in range(down_num):
            ch *= 4
            self.down_blocks.append(self._add("down_blocks", i, block_num[i],
                                              ch, subnet, fused_st, width))
        up_sched = list(block_num[:-1])[::-1] + [0]
        for i in range(down_num):
            ch //= 4
            self.up_blocks.append(self._add("up_blocks", i, up_sched[i], ch,
                                            subnet, fused_st, width))
        self._packed = None
        self._packed_key = None

    def _add(self, phase, i, n, ch, subnet, fused_st, width):
        blocks = [RNVPCoupling(ch, subnet, fused_st, width) for _ in range(n)]
        for b, blk in enumerate(blocks):
            setattr(self, f"{phase}_{i}_{b}", blk)
        return blocks

    def init_params(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, _Subnet):
                m.init_params(gen)

    def packed_params(self):
        """The packed executor's weights (permuted, cast to the compute
        dtype). With grad enabled they are computed afresh on every call,
        keeping the graph to the parameters; without, once per parameter
        version, device and dtype. The state dict keeps the JAX tree's own
        unpermuted layout."""
        params = list(self.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return inn_packed.pack_params(self, self.dtype)
        key = (tuple(p._version for p in params), params[0].device,
               self.dtype)
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = inn_packed.pack_params(self, self.dtype)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor, out_f32: bool = True) -> torch.Tensor:
        if self.packed:
            return inn_packed.forward(
                self.packed_params(), x, channels=self.channels,
                down_num=self.down_num, dtype=self.dtype, out_f32=out_f32,
                kernels=self.kernels)
        k, dt = self.kernels, self.dtype or torch.float32
        x = x.to(dt).contiguous()
        for blocks in self.down_blocks:
            x = k.haar(x)
            for b in blocks:
                x = b(x, dt, k)
        for blocks in self.up_blocks:
            x = k.haar(x, transpose=True)
            for b in blocks:
                x = b(x, dt, k)
        return x.float() if out_f32 else x

    def inverse(self, y: torch.Tensor, return_middle: bool = True):
        if self.packed:
            return inn_packed.inverse(
                self.packed_params(), y, channels=self.channels,
                down_num=self.down_num, dtype=self.dtype,
                return_middle=return_middle, kernels=self.kernels)
        k, dt = self.kernels, self.dtype or torch.float32
        y = y.to(dt).contiguous()
        for blocks in reversed(self.up_blocks):
            for b in reversed(blocks):
                y = b.inverse(y, dt, k)
            y = k.haar(y)
        middle = y.float()
        for blocks in reversed(self.down_blocks):
            for b in reversed(blocks):
                y = b.inverse(y, dt, k)
            y = k.haar(y, transpose=True)
        y = y.float()
        return (y, middle) if return_middle else y
