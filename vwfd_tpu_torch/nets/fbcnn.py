"""The Bayar-front QF classifier / crop-apex regressor (port of
vwfd_tpu/nets/fbcnn.py:18-28, 105-154; the reference's QF_predictor,
models/conditional_jpeg_generator.py:697-827). KD-JPEG's ``FBCNN`` is not
ported here.

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
from .blocks import gelu
from .unet import _trunc_normal_

__all__ = ["QFPredictor"]


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
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _trunc_normal_(m.weight, 1.0, m.weight[0].numel(), gen)
                if m.bias is not None:
                    with torch.no_grad():
                        m.bias.zero_()
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
