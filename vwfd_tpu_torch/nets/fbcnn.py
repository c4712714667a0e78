"""FBCNN and the Bayar-front QF classifier / crop-apex regressor (port of
vwfd_tpu/nets/fbcnn.py; the reference's FBCNN and QF_predictor,
models/conditional_jpeg_generator.py:202-375, 697-827).

``FBCNN`` (``:44-99``), the QF-conditioned U-shaped JPEG simulator of the
KD-JPEG family and of the image model's ``with_jpeg_simulator``: the
conditioning ``qf`` (N, 1) through three ``Dense(512)`` + GELU
(``qf_embed0``-``2``) gives per level a sigmoid ``to_gamma_{3,2,1}`` and a
tanh ``to_beta_{3,2,1}`` of ``nc[2]``, ``nc[1]``, ``nc[0]`` features; the
image goes through a 3×3 ``head`` to ``nc[0]``, three ``down`` stages (a
2×2 stride-2 conv, flax's "SAME", to ``nc[1]``, ``nc[2]``, ``nc[2]``, then
``nb`` residual blocks ``*_res{i}``), ``nb`` ``body`` blocks with ``h =
m1 + x4``, three ``up`` stages (a 2×2 stride-2 ``ConvTranspose``
``up{3,2,1}_up`` to ``nc[2]``, ``nc[1]``, ``nc[0]``, then ``nb``
QF-attention blocks ``*_attn{i}``: conv-ReLU-conv ``h`` and the FiLM
epilogue ``x + (γ·h + β)``, K23 ``film_residual`` through the
``KernelSet``), each added to its skip, and a 3×3 ``tail`` to
``out_channels``. It returns ``(out, (m1, m2, m3, m4))``, all NHWC; the
input is made contiguous NCHW once, so every conv and K23 see contiguous
planes. ``nc[3]`` is never read, as in JAX. The ConvTranspose weights are
PyTorch's layout of flax's kernel (``convert.py`` flips it, F3).

``QFPredictor``: the input symm-padded by 2 (``ops/pad.py``) through a
Bayar-constrained 5×5 conv of 3 features (no bias; the kernel kept as the
parameter ``bayar_kernel`` in flax's (5, 5, Cin, 3) layout, constrained on
every call), a 3×3 ``head`` conv, three stages of ``nb`` conv-ReLU-conv
residual blocks (``_ResBlockCRC``) each ending in a 2×2 stride-2 conv
(flax's "SAME": a zero row and column at the end of an odd side), ``nb``
blocks of 192 and then

* ``crop_pred=True``: a 1×1 ``to_img`` conv to one channel resized
  bicubically to ``out_size`` (``ops/resize.py::resize_bicubic``), and the
  spatial mean through Dense 192 + GELU, 192 + GELU, ``classes``: returns
  ``(mask_logits (N, out_size, out_size, 1), q (N, classes))`` — CLR's
  apex regressor (``classes`` 4, the window's fractions);
* ``crop_pred=False``: ``nb`` more blocks, the mean and the same Dense
  head: returns ``(bayar_features (N, H, W, 3), q)``.

GELU is flax's tanh form. NHWC in and out, NCHW inside; every conv and
Dense has the name of its flax module, so ``convert.py`` maps the tree.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.filters import bayar_constrain
from ..ops.pad import symm_pad
from ..ops.resize import resize_bicubic
from ..kernels import KERNELS, KernelSet
from .blocks import gelu
from .unet import _trunc_normal_

__all__ = ["FBCNN", "QFPredictor"]


class _ResBlockCRC(nn.Module):
    """conv-ReLU-conv residual block (3×3, padding 1, biases)."""

    def __init__(self, features: int):
        super().__init__()
        self.c1 = nn.Conv2d(features, features, 3, padding=1)
        self.c2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(F.relu(self.c1(x)))


def _down(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """flax's 2×2 stride-2 conv with "SAME" padding: odd sides get a zero
    row or column at the end."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    return conv(x)


def _lecun_init(net: nn.Module, gen: torch.Generator) -> None:
    """flax's lecun normal for every conv, transposed conv and Dense layer
    (fan-in: input channels × kernel taps), zero biases."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = (m.weight[:, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            _trunc_normal_(m.weight, 1.0, fan_in, gen)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()


class _QFAttention(nn.Module):
    """FiLM-modulated residual block (``fbcnn.py:31-41``): ``x + (γ·h +
    β)`` with ``h`` conv-ReLU-conv of ``x``, the epilogue K23."""

    def __init__(self, features: int):
        super().__init__()
        self.c1 = nn.Conv2d(features, features, 3, padding=1)
        self.c2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x, gamma, beta, kernels: KernelSet):
        return kernels.film_residual(x, self.c2(F.relu(self.c1(x))), gamma,
                                     beta)


class FBCNN(nn.Module):
    def __init__(self, nc: Sequence[int] = (32, 64, 128, 256), nb: int = 4,
                 out_channels: int = 3, in_channels: int = 3,
                 kernels: KernelSet = KERNELS):
        super().__init__()
        self.nb, self.kernels = nb, kernels
        self.qf_embed0 = nn.Linear(1, 512)
        self.qf_embed1 = nn.Linear(512, 512)
        self.qf_embed2 = nn.Linear(512, 512)
        for lvl, feats in ((3, nc[2]), (2, nc[1]), (1, nc[0])):
            setattr(self, f"to_gamma_{lvl}", nn.Linear(512, feats))
            setattr(self, f"to_beta_{lvl}", nn.Linear(512, feats))
        self.head = nn.Conv2d(in_channels, nc[0], 3, padding=1)
        for name, fin, fout in (("down1", nc[0], nc[1]),
                                ("down2", nc[1], nc[2]),
                                ("down3", nc[2], nc[2])):
            setattr(self, f"{name}_down", nn.Conv2d(fin, fout, 2, stride=2))
            for i in range(nb):
                setattr(self, f"{name}_res{i}", _ResBlockCRC(fout))
        for i in range(nb):
            setattr(self, f"body{i}", _ResBlockCRC(nc[2]))
        for name, fin, fout in (("up3", nc[2], nc[2]), ("up2", nc[2], nc[1]),
                                ("up1", nc[1], nc[0])):
            setattr(self, f"{name}_up", nn.ConvTranspose2d(fin, fout, 2,
                                                           stride=2))
            for i in range(nb):
                setattr(self, f"{name}_attn{i}", _QFAttention(fout))
        self.tail = nn.Conv2d(nc[0], out_channels, 3, padding=1)

    def init_params(self, gen: torch.Generator) -> None:
        """flax's initialisers: lecun normal everywhere, zero biases."""
        _lecun_init(self, gen)

    def _stage(self, z, prefix: str, *film):
        for i in range(self.nb):
            block = getattr(self, f"{prefix}{i}")
            z = block(z, *film, self.kernels) if film else block(z)
        return z

    def forward(self, x: torch.Tensor, qf: torch.Tensor):
        """(N, H, W, C) images and (N, 1) conditioning → ``(out (N, H, W,
        out_channels), (m1, m2, m3, m4))``, NHWC."""
        q = qf
        for i in range(3):
            q = gelu(getattr(self, f"qf_embed{i}")(q))
        film = {lvl: (torch.sigmoid(getattr(self, f"to_gamma_{lvl}")(q)),
                      torch.tanh(getattr(self, f"to_beta_{lvl}")(q)))
                for lvl in (3, 2, 1)}
        x1 = self.head(x.permute(0, 3, 1, 2).contiguous())
        x2 = self._stage(_down(x1, self.down1_down), "down1_res")
        x3 = self._stage(_down(x2, self.down2_down), "down2_res")
        x4 = self._stage(_down(x3, self.down3_down), "down3_res")
        m1 = self._stage(x4, "body")
        m2 = self._stage(self.up3_up(m1 + x4), "up3_attn", *film[3])
        m3 = self._stage(self.up2_up(m2 + x3), "up2_attn", *film[2])
        m4 = self._stage(self.up1_up(m3 + x2), "up1_attn", *film[1])
        out = self.tail(m4 + x1)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)
        return nhwc(out), tuple(nhwc(m) for m in (m1, m2, m3, m4))


class QFPredictor(nn.Module):
    def __init__(self, nc: Sequence[int] = (32, 64, 128, 256), nb: int = 4,
                 classes: int = 5, crop_pred: bool = False,
                 out_size: int = 512, in_channels: int = 3):
        super().__init__()
        self.nb, self.crop_pred, self.out_size = nb, crop_pred, out_size
        self.bayar_kernel = nn.Parameter(torch.zeros(5, 5, in_channels, 3))
        self.head = nn.Conv2d(3, nc[0], 3, padding=1)
        for name, fin, fout in (("down1", nc[0], nc[1]),
                                ("down2", nc[1], nc[2]),
                                ("down3", nc[2], 192)):
            for i in range(nb):
                setattr(self, f"{name}_res{i}", _ResBlockCRC(fin))
            setattr(self, f"{name}_down", nn.Conv2d(fin, fout, 2, stride=2))
        for i in range(nb):
            setattr(self, f"body{i}", _ResBlockCRC(192))
        if crop_pred:
            self.to_img = nn.Conv2d(192, 1, 1, bias=False)
        else:
            for i in range(nb):
                setattr(self, f"qf_res{i}", _ResBlockCRC(192))
        self.qf0 = nn.Linear(192, 192)
        self.qf1 = nn.Linear(192, 192)
        self.qf2 = nn.Linear(192, classes)

    def init_params(self, gen: torch.Generator) -> None:
        """flax's initialisers: kaiming normal for the Bayar kernel, lecun
        normal for every conv and Dense layer, zero biases."""
        _lecun_init(self, gen)
        k = self.bayar_kernel
        _trunc_normal_(k, 2.0, k[..., 0].numel(), gen)

    def _blocks(self, h: torch.Tensor, name: str) -> torch.Tensor:
        for i in range(self.nb):
            h = getattr(self, f"{name}{i}")(h)
        return h

    def _q(self, h: torch.Tensor) -> torch.Tensor:
        q = torch.mean(h, dim=(2, 3))
        q = gelu(self.qf0(q))
        q = gelu(self.qf1(q))
        return self.qf2(q)

    def forward(self, x: torch.Tensor):
        bk = bayar_constrain(self.bayar_kernel).permute(3, 2, 0, 1)
        e0 = F.conv2d(symm_pad(x, (2, 2, 2, 2)).permute(0, 3, 1, 2), bk)
        h = self.head(e0)
        for name in ("down1", "down2", "down3"):
            h = _down(self._blocks(h, f"{name}_res"),
                      getattr(self, f"{name}_down"))
        h = self._blocks(h, "body")
        if self.crop_pred:
            img = self.to_img(h).permute(0, 2, 3, 1)
            return (resize_bicubic(img, (self.out_size, self.out_size)),
                    self._q(h))
        return e0.permute(0, 2, 3, 1), self._q(self._blocks(h, "qf_res"))
