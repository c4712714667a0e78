"""SUNet, the Swin U-Net of the tianchi forgery-segmentation family (port of
vwfd_tpu/nets/sunet.py:19-212), NHWC float32.

* ``WindowAttention`` (:32-71) on the map: the ``qkv`` Dense, K18
  ``window_attention`` (``kernels/window_attention.py``: each window's
  tokens read from and written to their places in the map rolled by
  −shift, the relative-position bias from the ``rel_pos_bias`` table
  ((2·ws − 1)², heads), the shift mask, softmax) and the ``proj`` Dense;
* ``SwinBlock`` (:74-114): LayerNorm, window attention, the residual;
  LayerNorm, Dense(4C), GELU, Dense(C), the residual. JAX's roll by
  −shift, ``window_partition``, ``window_reverse`` and roll back around the
  attention are K18's addressing: the Dense layers work token by token,
  so they commute with those moves. The window is min(ws, H, W) and the
  shift 0 where that window covers the map (:84-85);
* ``pixel_shuffle`` (:117-124): torch's channel order, in NHWC;
* ``DualUpSample`` (:127-160): the pixel-shuffle and the bilinear branch
  (``ops/resize.py::resize_bilinear``), each between 1×1 convs with a
  PReLU, fused by a 1×1 conv;
* ``SUNet`` (:163-212): a stride-4 conv patch embed, Swin stages joined by
  PatchMerging (2×2 space-to-depth, LayerNorm, Dense to 2C), dual
  up-samples with skip concatenation and a Dense back to the stage's width,
  a ×4 dual up-sample and a 3×3 conv head, optionally a sigmoid.

flax's defaults, kept: ``nn.LayerNorm``'s epsilon is 1e-6 (torch's 1e-5);
``nn.gelu`` is the tanh form (``approximate=True``); ``nn.PReLU`` is one
scalar ``negative_slope`` initialised to 0.01 (``where(x ≥ 0, x, a·x)``).
Module and parameter names are the flax tree's (``enc0_blk1.attn.qkv``,
``enc0_blk1.attn.rel_pos_bias``, ``up0.PReLU_0.negative_slope``,
``merge_norm0``, ...), so ``convert.py`` carries a tree one to one.

The relative-position table's size follows the window each block sees,
min(ws, H, W), so the net is built for one input size (``image_size``, as
flax's ``init`` shapes it); another size with the same windows runs too.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import KERNELS, KernelSet
from ..ops.resize import resize_bilinear
from .unet import _trunc_normal_

__all__ = ["pixel_shuffle", "PReLU", "WindowAttention", "SwinBlock", "DualUpSample", "SUNet",
           "LN_EPS"]

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch.nn.PixelShuffle in NHWC: (B, H, W, C·r²) → (B, H·r, W·r, C),
    channel k = c·r² + i·r + j."""
    b, h, w, cr2 = x.shape
    c = cr2 // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def _linear(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1×1 conv of NHWC ``x`` as a product over channels."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class PReLU(nn.Module):
    """flax ``nn.PReLU``: one scalar slope, ``where(x ≥ 0, x, a·x)``."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor, ws: int, shift: int,
                kernels: KernelSet = KERNELS) -> torch.Tensor:
        """``x`` (B, H, W, C) on the map → (B, H, W, C); windows of ``ws``
        on the map rolled by −``shift`` (0: no roll, no mask)."""
        b, hh, ww, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, hh, ww, 3, h, c // h)
        out = kernels.window_attention(qkv, self.rel_pos_bias, ws, shift)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, hw: Tuple[int, int], mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift
        ws = min(window_size, *hw)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, kernels: KernelSet = KERNELS
                ) -> torch.Tensor:
        """x: (B, H, W, C)."""
        _, h, w, _ = x.shape
        ws = min(self.window_size, h, w)
        shift = self.shift_size if ws < min(h, w) else 0
        x = x + self.attn(self.norm1(x), ws, shift, kernels)
        z = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        return x + z


class DualUpSample(nn.Module):
    """The dual up-sample of SUNet_detail.py:334-390: a pixel-shuffle branch
    (1×1 conv to r²·C_out, PReLU, shuffle, 1×1 conv) and a bilinear one
    (1×1 conv with bias, PReLU, bilinear ×r, 1×1 conv), concatenated and
    fused by a 1×1 conv; C_out = C/2 for ×2, C for ×4."""

    def __init__(self, c: int, factor: int = 2):
        super().__init__()
        self.factor = r = factor
        c_out = c // 2 if r == 2 else c
        lift = 2 * c if r == 2 else 16 * c
        self.up_p_conv1 = nn.Conv2d(c, lift, 1, bias=False)
        self.PReLU_0 = PReLU()
        self.up_p_conv2 = nn.Conv2d(c_out, c_out, 1, bias=False)
        self.up_b_conv1 = nn.Conv2d(c, c, 1)
        self.PReLU_1 = PReLU()
        self.up_b_conv2 = nn.Conv2d(c, c_out, 1, bias=False)
        self.fuse = nn.Conv2d(2 * c_out, c_out, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.factor
        p = pixel_shuffle(self.PReLU_0(_linear(x, self.up_p_conv1)), r)
        p = _linear(p, self.up_p_conv2)
        b_ = self.PReLU_1(_linear(x, self.up_b_conv1))
        hh, ww = b_.shape[-3], b_.shape[-2]
        b_ = _linear(resize_bilinear(b_, (hh * r, ww * r)), self.up_b_conv2)
        return _linear(torch.cat([p, b_], -1), self.fuse)


class SUNet(nn.Module):
    def __init__(self, out_channels: int = 1, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 8, apply_sigmoid: bool = False,
                 image_size: int = 256, kernels: KernelSet = KERNELS):
        super().__init__()
        self.depths, self.apply_sigmoid = tuple(depths), apply_sigmoid
        self.kernels = kernels
        c0 = embed_dim
        dims = [c0 * 2 ** i for i in range(len(depths))]
        sides = [image_size // 4 // 2 ** i for i in range(len(depths))]
        self.patch_embed = nn.Conv2d(3, c0, 4, stride=4)
        self.embed_norm = nn.LayerNorm(c0, eps=LN_EPS)

        def stage(prefix, i):
            for d in range(depths[i]):
                setattr(self, f"{prefix}{i}_blk{d}", SwinBlock(
                    dims[i], num_heads[i], window_size,
                    0 if d % 2 == 0 else window_size // 2,
                    (sides[i], sides[i])))
        for i in range(len(depths)):
            stage("enc", i)
            if i < len(depths) - 1:
                setattr(self, f"merge_norm{i}",
                        nn.LayerNorm(4 * dims[i], eps=LN_EPS))
                setattr(self, f"merge{i}",
                        nn.Linear(4 * dims[i], 2 * dims[i], bias=False))
        for i in reversed(range(len(depths) - 1)):
            setattr(self, f"up{i}", DualUpSample(dims[i + 1], 2))
            setattr(self, f"fuse{i}", nn.Linear(2 * dims[i], dims[i]))
            stage("dec", i)
        self.norm_up = nn.LayerNorm(dims[0], eps=LN_EPS)
        self.up_final = DualUpSample(dims[0], 4)
        self.head = nn.Conv2d(dims[0], out_channels, 3, padding=1,
                              bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, H, W, out_channels)."""
        k = self.kernels
        h = self.patch_embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h = self.embed_norm(h)
        n = len(self.depths)
        skips = []
        for i in range(n):
            for d in range(self.depths[i]):
                h = getattr(self, f"enc{i}_blk{d}")(h, k)
            if i < n - 1:
                skips.append(h)
                b, hh, ww, cc = h.shape
                h = h.reshape(b, hh // 2, 2, ww // 2, 2, cc)
                h = h.permute(0, 1, 3, 2, 4, 5).reshape(b, hh // 2, ww // 2,
                                                        4 * cc)
                h = getattr(self, f"merge{i}")(
                    getattr(self, f"merge_norm{i}")(h))
        for i in reversed(range(n - 1)):
            h = getattr(self, f"up{i}")(h)
            h = getattr(self, f"fuse{i}")(torch.cat([h, skips[i]], -1))
            for d in range(self.depths[i]):
                h = getattr(self, f"dec{i}_blk{d}")(h, k)
        h = self.up_final(self.norm_up(h))
        out = self.head(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.sigmoid(out) if self.apply_sigmoid else out

    def init_params(self, gen: torch.Generator) -> None:
        """flax's initialisers: lecun-normal (truncated, fan-in) Dense and
        conv kernels, zero biases, LayerNorm scale 1 and bias 0, PReLU
        slopes 0.01, relative-position tables ``0.02·N(0, 1)`` truncated to
        ±2 (``initializers.truncated_normal(0.02)``)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    _trunc_normal_(m.weight, 1.0, m.weight[0].numel(), gen)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
                elif isinstance(m, PReLU):
                    m.negative_slope.fill_(0.01)
                elif isinstance(m, WindowAttention):
                    nn.init.trunc_normal_(m.rel_pos_bias, 0.0, 1.0, -2.0, 2.0,
                                          generator=gen)
                    m.rel_pos_bias.mul_(0.02)
