"""Tamper-mask extractors (port of vwfd_tpu/nets/unet.py): the reference
``UNet`` and the MXU-shaped ``UNetTPU``.

Same parameter names as the flax trees (``enc1.Conv_0``, ``enc1.BatchNorm_0``,
``up4``, ``dec4_conv``, ``dec4_bn``, ``dec4_skipproj``, ``dec4.Conv_1``,
``head`` ...), so that a flax tree and its batch stats convert one to one
(``convert.py``). Tensors stay NHWC; every conv hands cuDNN the
``permute(0, 3, 1, 2)`` view, which is channels_last, so no copy is made.

Every lowering of the JAX package is here, each the same map on the same
parameters: ``UNet``'s ConvTranspose up and its ``fast_upsample`` GEMM
(o-major columns + depth-to-space); ``UNetTPU``'s space-to-depth stem,
``enc_convs`` as an int or a per-level plan, ``slim_skip`` (a 1×1
projection of each skip to half its channels), ``up_impl`` ``convt`` or
``gemm`` (sub-pixel-major columns + depth-to-space), ``dec_impl``
``concat`` or ``split`` (the decoder conv as two convs on the two halves of
its kernel, no concat) and ``head_impl`` ``d2s`` or ``convt`` (the head
and depth-to-space composed into one s×s stride-s transposed conv, with
the per-sub-pixel bias tile). The flax ConvTranspose kernel flip (F3) is
taken in ``convert.py``: every ``up*`` weight here is PyTorch's
``ConvTranspose2d`` layout, ``W[ci, o, p, q] = K[1−p, 1−q, ci, o]``.

``body`` returns the head's logits at ``head_s2d``: packed (N,H/s,W/s,s²)
for the ``d2s`` head, full resolution (s = 1) for ``UNet`` and the
``convt`` head; the server hands them to K4 with that s.

BatchNorm in eval mode (running statistics) and in train mode. Train mode
normalises with the batch
statistics (biased variance, float32 for a bf16 input, as flax) and
returns the running statistics flax would store, ``0.9·ra + 0.1·batch``
with the BIASED batch variance (``F.batch_norm`` alone would blend in the
unbiased one), without writing them: the train step applies them with
``load_stats`` after its non-finite guard. Under data parallelism
(``forward(..., mesh=)``, more than one rank) train mode takes the
moments over the global batch, as flax's BatchNorm does under ``jit`` on a
sharded batch: each rank's float32 means of x and x² are all-reduced
differentiably, the variance is flax's ``max(0, E[x²] − E[x]²)``, and the
running statistics take those global moments.
"""

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.squeeze import depth_to_space, space_to_depth
from ..parallel import global_mean

__all__ = ["UNet", "UNetTPU", "BatchStats"]


def _trunc_normal_(w: torch.Tensor, scale: float, fan_in: int,
                   gen: torch.Generator) -> None:
    """flax ``variance_scaling(scale, 'fan_in', 'truncated_normal')``."""
    std = math.sqrt(scale / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(x, conv: nn.Conv2d, dt, padding):
    b = None if conv.bias is None else conv.bias.to(dt)
    return _nhwc(F.conv2d(_nchw(x), conv.weight.to(dt), b, padding=padding))


_MOMENTUM = 0.9  # flax BatchNorm(momentum=0.9): ra ← 0.9·ra + 0.1·batch


class BatchStats(dict):
    """The running statistics of a train-mode forward, ``{bn: (mean,
    var)}``; ``mesh``: the data group whose global batch the moments are
    taken over (None: this process's rows)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh


def _bn_global(x, bn: nn.BatchNorm2d, stats: BatchStats):
    """Train-mode BatchNorm over the global batch of ``stats.mesh``
    (flax's ``_compute_stats`` and ``_normalize`` in float32, float64 for a
    float64 input: one all-reduce of the stacked local means of x and x²,
    equal row counts on every rank)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(x.dim() - 1))
    mu, mu2 = global_mean(torch.stack([xf.mean(dims), (xf * xf).mean(dims)]),
                          stats.mesh).unbind()
    var = torch.clamp_min(mu2 - mu * mu, 0.0)
    y = (xf - mu) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    with torch.no_grad():
        stats[bn] = (_MOMENTUM * bn.running_mean + (1 - _MOMENTUM) * mu,
                     _MOMENTUM * bn.running_var + (1 - _MOMENTUM) * var)
    return y.to(x.dtype)


def _bn(x, bn: nn.BatchNorm2d, stats=None):
    """BatchNorm of NHWC ``x`` (flax computes it in f32 and casts to the
    compute dtype; PyTorch does the same for a bf16 input with f32
    statistics). ``stats`` None: eval mode, running statistics. Otherwise
    train mode: batch statistics, and ``stats[bn]`` receives the updated
    running (mean, var); over the global batch when ``stats`` is a
    ``BatchStats`` whose mesh has more than one rank (with one, its rows
    are the global batch, and ``F.batch_norm`` normalises as without a
    mesh)."""
    if stats is None:
        y = F.batch_norm(_nchw(x), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps)
        return _nhwc(y)
    mesh = getattr(stats, "mesh", None)
    if mesh is not None and mesh.size > 1:
        return _bn_global(x, bn, stats)
    c = x.shape[-1]
    mean = torch.zeros(c, device=x.device)
    var = torch.ones(c, device=x.device)
    # momentum 1: the buffers receive the batch mean and unbiased variance
    y = F.batch_norm(_nchw(x), mean, var, bn.weight, bn.bias, True, 1.0,
                     bn.eps)
    n = x.numel() // c
    with torch.no_grad():
        biased = var * ((n - 1) / n)
        stats[bn] = (_MOMENTUM * bn.running_mean + (1 - _MOMENTUM) * mean,
                     _MOMENTUM * bn.running_var + (1 - _MOMENTUM) * biased)
    return _nhwc(y)


def _bn_relu(x, bn: nn.BatchNorm2d, stats=None):
    """``_bn`` then ReLU."""
    return F.relu(_bn(x, bn, stats))


class _DoubleConv(nn.Module):
    """``convs`` × (3×3 conv without bias, BatchNorm, ReLU)."""

    def __init__(self, cin: int, features: int, convs: int = 2):
        super().__init__()
        self.convs = convs
        for i in range(convs):
            setattr(self, f"Conv_{i}",
                    nn.Conv2d(cin if i == 0 else features, features, 3,
                              padding=1, bias=False))
            setattr(self, f"BatchNorm_{i}", nn.BatchNorm2d(features, eps=1e-5))

    def forward(self, x, dt, stats=None):
        for i in range(self.convs):
            x = _conv(x, getattr(self, f"Conv_{i}"), dt, 1)
            x = _bn_relu(x, getattr(self, f"BatchNorm_{i}"), stats)
        return x


class _Extractor(nn.Module):
    """What both extractors share: flax's initialisers, the forward around
    ``body`` and the BatchNorm statistics."""

    s2d = 1       # the stem's space-to-depth factor
    head_s2d = 1  # the packing of ``body``'s logits

    def _lecun(self):
        """Convs that flax initialises lecun-normal (no kernel_init given):
        the head and the skip projections."""
        return {self.head}

    def init_params(self, gen: torch.Generator) -> None:
        """flax's initialisers: kaiming-normal convs, lecun-normal
        transposed convs, head and skip projections, zero biases, identity
        BatchNorm."""
        lecun = self._lecun()
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                _trunc_normal_(m.weight, 1.0, m.weight[:, 0].numel(), gen)
            elif isinstance(m, nn.Conv2d):
                scale = 1.0 if m in lecun else 2.0
                _trunc_normal_(m.weight, scale, m.weight[0].numel(), gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            if getattr(m, "bias", None) is not None \
                    and not isinstance(m, nn.BatchNorm2d):
                with torch.no_grad():
                    m.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None):
        """(N,H,W,C) in [0,1] → sigmoid probabilities (N,H,W,out), f32.
        ``train=True`` returns ``(probs, stats)``: BatchNorm on batch
        statistics, and the updated running (mean, var) of every BatchNorm
        for ``load_stats`` (flax's ``mutable=["batch_stats"]``); with a
        ``parallel.Mesh`` of more than one rank, on the global batch's."""
        dt = self.dtype or torch.float32
        stats = BatchStats(mesh) if train else None
        logits = self.body(space_to_depth(x.to(dt), self.s2d), stats)
        probs = torch.sigmoid(depth_to_space(logits, self.head_s2d).float())
        return (probs, stats) if train else probs

    @torch.no_grad()
    def load_stats(self, stats, good=None) -> None:
        """Write the running statistics of a train-mode forward; where
        ``good`` (a 0-dim bool tensor) is False, keep the old ones."""
        for bn, (mean, var) in stats.items():
            for buf, new in ((bn.running_mean, mean), (bn.running_var, var)):
                buf.copy_(new if good is None else torch.where(good, new, buf))


def _pool(z):
    return _nhwc(F.max_pool2d(_nchw(z), 2, 2))


def _up_convt(z, up: nn.ConvTranspose2d, dt):
    return _nhwc(F.conv_transpose2d(_nchw(z), up.weight.to(dt),
                                    up.bias.to(dt), stride=2))


def _gemm_up(z, up: nn.ConvTranspose2d, dt, subpixel_major: bool):
    """The 2×2/s2 transposed conv as one (Cin → 4·Cout) GEMM +
    depth-to-space, then the bias. Columns sub-pixel-major ((p·2+q)·Cout
    + o, ``UNetTPU``'s ``gemm``) or o-major (o·4 + p·2 + q, ``UNet``'s
    ``fast_upsample``)."""
    w = up.weight  # (Cin, Cout, 2, 2): W[ci, o, p, q]
    cin, cout = w.shape[:2]
    if subpixel_major:
        w2 = w.permute(0, 2, 3, 1).reshape(cin, 4 * cout)
        h = depth_to_space(torch.matmul(z, w2.to(dt)), 2)
    else:
        h = torch.matmul(z, w.reshape(cin, 4 * cout).to(dt))
        n, hh, ww, _ = h.shape
        h = h.reshape(n, hh, ww, cout, 2, 2).permute(0, 1, 4, 2, 5, 3)
        h = h.reshape(n, 2 * hh, 2 * ww, cout)
    return h + up.bias.to(dt)


class UNetTPU(_Extractor):
    """The MXU-shaped extractor: s2d stem, encoder f·(1,2,4,8) + f·16
    bottleneck, upsample + single-conv decoder, s2d-packed 1×1 head.
    ``forward`` returns sigmoid probabilities (N,H,W,out) in f32; ``body``
    returns the head's logits in the compute dtype at ``head_s2d`` (s for
    the ``d2s`` head, 1 for ``convt``), which the serving path hands to K4
    (kernels/mask.py)."""

    def __init__(self, out_channels: int = 1, init_features: int = 64,
                 s2d: int = 2, enc_convs: Union[int, Sequence[int]] = 2,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3,
                 slim_skip: bool = False, head_impl: str = "d2s",
                 up_impl: str = "convt", dec_impl: str = "concat"):
        super().__init__()
        f, s = init_features, s2d
        ec = ((enc_convs,) * 5 if isinstance(enc_convs, int)
              else tuple(enc_convs))
        if len(ec) != 5:
            raise ValueError("enc_convs plan is (enc1..enc4, bottleneck)")
        for key, got, ok in (("head_impl", head_impl, ("d2s", "convt")),
                             ("up_impl", up_impl, ("convt", "gemm")),
                             ("dec_impl", dec_impl, ("concat", "split"))):
            if got not in ok:
                raise ValueError(f"{key}={got!r}: one of {ok}")
        self.s2d, self.out_channels, self.dtype = s, out_channels, dtype
        self.head_s2d = s if head_impl == "d2s" else 1
        self.slim_skip, self.head_impl = slim_skip, head_impl
        self.up_impl, self.dec_impl = up_impl, dec_impl
        chans = [in_channels * s * s, f, 2 * f, 4 * f, 8 * f, 16 * f]
        for i, name in enumerate(("enc1", "enc2", "enc3", "enc4",
                                  "bottleneck")):
            setattr(self, name, _DoubleConv(chans[i], chans[i + 1], ec[i]))
        for lvl, feats in ((4, 8 * f), (3, 4 * f), (2, 2 * f), (1, f)):
            skip = feats // 2 if slim_skip else feats
            setattr(self, f"up{lvl}",
                    nn.ConvTranspose2d(2 * feats, feats, 2, stride=2))
            if slim_skip:
                setattr(self, f"dec{lvl}_skipproj",
                        nn.Conv2d(feats, skip, 1, bias=False))
            setattr(self, f"dec{lvl}_conv",
                    nn.Conv2d(feats + skip, feats, 3, padding=1, bias=False))
            setattr(self, f"dec{lvl}_bn", nn.BatchNorm2d(feats, eps=1e-5))
        self.head = nn.Conv2d(f, out_channels * s * s, 1)

    def _lecun(self):
        return {self.head} | {m for n, m in self.named_modules()
                              if n.endswith("_skipproj")}

    def _up(self, z, lvl, dt):
        up = getattr(self, f"up{lvl}")
        if self.up_impl == "gemm":
            return _gemm_up(z, up, dt, subpixel_major=True)
        return _up_convt(z, up, dt)

    def _dec(self, z, skip, lvl, dt, stats=None):
        if self.slim_skip:
            skip = _conv(skip, getattr(self, f"dec{lvl}_skipproj"), dt, 0)
        conv = getattr(self, f"dec{lvl}_conv")
        if self.dec_impl == "split":
            w, cu = conv.weight.to(dt), z.shape[-1]
            z = (_nhwc(F.conv2d(_nchw(z), w[:, :cu], padding=1))
                 + _nhwc(F.conv2d(_nchw(skip), w[:, cu:], padding=1)))
        else:
            z = _conv(torch.cat([z, skip], -1), conv, dt, 1)
        return _bn_relu(z, getattr(self, f"dec{lvl}_bn"), stats)

    def _head(self, d1, dt):
        if self.head_impl == "d2s":
            return _conv(d1, self.head, dt, 0)
        # head ∘ d2s as one s×s stride-s transposed conv (unet.py:279-299):
        # out[s·i+p, s·j+q, c] = d1[i, j] · K[(p·s+q)·C + c] + b[(p·s+q)·C+c]
        s, c = self.s2d, self.out_channels
        w = self.head.weight[:, :, 0, 0]                 # ((p·s+q)·C+c, f)
        wt = w.reshape(s, s, c, -1).permute(3, 2, 0, 1)  # (f, C, p, q)
        out = _nhwc(F.conv_transpose2d(_nchw(d1), wt.to(dt), stride=s))
        bgrid = self.head.bias.reshape(s, s, c).to(dt)
        return out + bgrid.repeat(out.shape[1] // s, out.shape[2] // s, 1)

    def body(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        """Space-to-depth input (N,H/s,W/s,s²·C) → the head's logits at
        ``head_s2d``. ``stats`` (a dict) selects train-mode BatchNorm and
        receives the updated running statistics."""
        dt = self.dtype or torch.float32
        x = x.to(dt)
        enc1 = self.enc1(x, dt, stats)
        enc2 = self.enc2(_pool(enc1), dt, stats)
        enc3 = self.enc3(_pool(enc2), dt, stats)
        enc4 = self.enc4(_pool(enc3), dt, stats)
        bott = self.bottleneck(_pool(enc4), dt, stats)
        d4 = self._dec(self._up(bott, 4, dt), enc4, 4, dt, stats)
        d3 = self._dec(self._up(d4, 3, dt), enc3, 3, dt, stats)
        d2 = self._dec(self._up(d3, 2, dt), enc2, 2, dt, stats)
        d1 = self._dec(self._up(d2, 1, dt), enc1, 1, dt, stats)
        return self._head(d1, dt).contiguous()


class UNet(_Extractor):
    """The reference U-Net (unet.py:87-144, network/UNet.py:7-98): four
    double-conv encoder levels and a bottleneck at f·(1,2,4,8,16), each
    decoder level a 2×2/s2 ConvTranspose (``fast_upsample``: the same map
    as one GEMM + depth-to-space) then a double conv on ``[up, skip]``, and
    a 1×1 head at full resolution. ``body`` takes the frames themselves (s
    = 1) and returns full-resolution logits."""

    def __init__(self, out_channels: int = 1, init_features: int = 32,
                 fast_upsample: bool = False,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3):
        super().__init__()
        f = init_features
        self.out_channels, self.dtype = out_channels, dtype
        self.fast_upsample = fast_upsample
        chans = [in_channels, f, 2 * f, 4 * f, 8 * f, 16 * f]
        for i, name in enumerate(("enc1", "enc2", "enc3", "enc4",
                                  "bottleneck")):
            setattr(self, name, _DoubleConv(chans[i], chans[i + 1]))
        for lvl, feats in ((4, 8 * f), (3, 4 * f), (2, 2 * f), (1, f)):
            setattr(self, f"up{lvl}",
                    nn.ConvTranspose2d(2 * feats, feats, 2, stride=2))
            setattr(self, f"dec{lvl}", _DoubleConv(2 * feats, feats))
        self.head = nn.Conv2d(f, out_channels, 1)

    def body(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        """Frames (N,H,W,C) → full-resolution logits (N,H,W,out) in the
        compute dtype; ``stats`` as ``UNetTPU.body``."""
        dt = self.dtype or torch.float32
        x = x.to(dt)
        enc1 = self.enc1(x, dt, stats)
        enc2 = self.enc2(_pool(enc1), dt, stats)
        enc3 = self.enc3(_pool(enc2), dt, stats)
        enc4 = self.enc4(_pool(enc3), dt, stats)
        z = self.bottleneck(_pool(enc4), dt, stats)
        for lvl, skip in ((4, enc4), (3, enc3), (2, enc2), (1, enc1)):
            up = getattr(self, f"up{lvl}")
            u = (_gemm_up(z, up, dt, subpixel_major=False)
                 if self.fast_upsample else _up_convt(z, up, dt))
            z = getattr(self, f"dec{lvl}")(torch.cat([u, skip], -1), dt,
                                           stats)
        return _conv(z, self.head, dt, 0).contiguous()
