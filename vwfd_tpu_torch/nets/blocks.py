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

``SNConv`` and ``ResnetBlock`` (``vwfd_tpu/nets/blocks.py:31-108``) are the
localizer's blocks, NCHW inside the port's nets:

* ``SNConv`` is a convolution (strided, dilated or transposed) whose
  kernel is divided by its spectral norm σ, written here as flax's module
  computes it (not ``torch.nn.utils.spectral_norm``): one power iteration
  on every call from the stored vector ``u``, which starts at
  ``ones/√n`` and has flax's row order (kh, kw, cin) of the kernel matrix
  (``kernel.reshape(-1, features)``), so a JAX tree's ``u`` converts as it
  is; the kernel is divided by ``σ + 1e-12`` with σ taken as a constant
  (JAX's ``stop_gradient``; torch's own spectral norm differentiates σ).
  A caller that passes a dict receives the new ``u`` in it (flax's
  ``update_sn=True``) and stores it itself (the image model's guard).
  The transposed form is ``jax.lax.conv_transpose`` with ``"SAME"``
  padding and no ``transpose_kernel``, which at k 4, stride 2 is
  ``conv_transpose2d(k=4, s=2, p=1)`` on the spatially flipped kernel with
  its in and out axes swapped: the port keeps ``ConvTranspose2d``'s
  (Cin, Cout, 4, 4) layout (``convert.py``'s flip, F3) and its σ reads the
  kernel back in flax's layout.
* ``ResnetBlock`` reflect-pads by the dilation 2, a dilated 3×3 ``SNConv``
  (no bias under spectral norm), GELU (flax's tanh form), a reflect pad of
  1 and a 3×3 ``SNConv``, added to its input.

``reflect_pad`` is ``F.pad(mode="reflect")`` made of slices, flips and
concatenations: the same values, and a backward that adds each pixel's
mirrored cotangents two at a time, rows then columns, where PyTorch's CUDA
reflection-pad backward accumulates up to four with ``atomicAdd`` and its
last bits vary from call to call. The localizer's gradients then repeat
bit for bit, and a step over a world-1 group equals the step without one.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .unet import _bn_relu, _conv, _nchw, _nhwc, _trunc_normal_

__all__ = ["ConvBNRelu", "FlaxNet", "conv_nhwc", "SNConv", "ResnetBlock",
           "gelu", "reflect_pad"]


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


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """``F.pad(x, (p, p, p, p), mode="reflect")`` of NCHW ``x`` (module
    docstring)."""
    x = torch.cat([x[..., 1:p + 1].flip(-1), x,
                   x[..., -p - 1:-1].flip(-1)], -1)
    return torch.cat([x[..., 1:p + 1, :].flip(-2), x,
                      x[..., -p - 1:-1, :].flip(-2)], -2)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class SNConv(nn.Module):
    """``vwfd_tpu/nets/blocks.py::SNConv`` on NCHW tensors (module
    docstring). ``padding``: an int, ``"SAME"`` (stride 1, odd kernel) or
    ``"VALID"``; the transposed form takes k 4, stride 2, ``"SAME"``."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding="SAME", dilation: int = 1,
                 use_bias: bool = True, use_spectral_norm: bool = True,
                 transpose: bool = False):
        super().__init__()
        k = kernel_size
        if transpose:
            if (k, stride, padding, dilation) != (4, 2, "SAME", 1):
                raise NotImplementedError(
                    "transposed SNConv: only k 4, stride 2, 'SAME' (the "
                    "localizer's decoder)")
            self.padding = 1
            shape = (cin, features, k, k)
        else:
            if padding == "SAME":
                if stride != 1 or k % 2 == 0:
                    raise NotImplementedError(
                        "SNConv 'SAME': stride 1 and an odd kernel only")
                padding = dilation * (k - 1) // 2
            elif padding == "VALID":
                padding = 0
            self.padding = int(padding)
            shape = (features, cin, k, k)
        self.cin, self.features, self.k = cin, features, k
        self.stride, self.dilation, self.transpose = stride, dilation, \
            transpose
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.use_spectral_norm = use_spectral_norm
        if use_spectral_norm:
            n = k * k * cin
            self.register_buffer("u", torch.full((n,), 1.0 / math.sqrt(n)))

    def init_params(self, gen: torch.Generator) -> None:
        """flax's kaiming normal (fan-in k·k·cin), zero bias, ``u`` at
        ``ones/√n``."""
        _trunc_normal_(self.weight, 2.0, self.k * self.k * self.cin, gen)
        with torch.no_grad():
            if self.bias is not None:
                self.bias.zero_()
            if self.use_spectral_norm:
                self.u.fill_(1.0 / math.sqrt(self.u.numel()))

    def kernel_matrix(self) -> torch.Tensor:
        """The kernel in flax's (kh, kw, cin, features) layout, as the
        (kh·kw·cin, features) matrix of its spectral norm."""
        w = self.weight
        hwio = (w.permute(2, 3, 0, 1).flip(0, 1) if self.transpose
                else w.permute(2, 3, 1, 0))
        return hwio.reshape(-1, self.features)

    @torch.no_grad()
    def sigma(self):
        """(σ, the new u) from one power iteration on the stored u."""
        mat = self.kernel_matrix().detach()
        v = mat.T @ self.u
        v = v / (torch.linalg.norm(v) + 1e-12)
        u = mat @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
        return u @ mat @ v, u

    def forward(self, x: torch.Tensor, sn: Optional[dict] = None
                ) -> torch.Tensor:
        """NCHW in and out; with ``sn`` (a dict) the new ``u`` lands in
        ``sn[self]``."""
        w = self.weight
        if self.use_spectral_norm:
            sigma, u = self.sigma()
            if sn is not None:
                sn[self] = u
            w = w / (sigma + 1e-12)
        if self.transpose:
            return F.conv_transpose2d(x, w, self.bias, stride=2, padding=1)
        return F.conv2d(x, w, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation)


class ResnetBlock(nn.Module):
    """Dilated residual block (``vwfd_tpu/nets/blocks.py:90-108``,
    models/networks.py:1387-1419) on NCHW tensors."""

    def __init__(self, dim: int, dilation: int = 2,
                 use_spectral_norm: bool = True):
        super().__init__()
        self.d = dilation
        kw = dict(padding="VALID", use_bias=not use_spectral_norm,
                  use_spectral_norm=use_spectral_norm)
        self.conv1 = SNConv(dim, dim, 3, dilation=dilation, **kw)
        self.conv2 = SNConv(dim, dim, 3, **kw)

    def forward(self, x: torch.Tensor, sn: Optional[dict] = None
                ) -> torch.Tensor:
        d = self.d
        h = self.conv1(reflect_pad(x, d), sn)
        h = gelu(h)
        h = self.conv2(reflect_pad(h, 1), sn)
        return x + h
