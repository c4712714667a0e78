"""Int8 post-training-quantized embed of the packed flagship INN (port of
vwfd_tpu/nets/inn_int8.py).

Only the learned convs quantize: the fixed orthogonal Haar transitions (K1)
and the RealNVP affine stay in the compute dtype / float32, so the
invertibility structure is untouched.

* ``collect_amax``: the packed executor's walk (``nets/inn_packed.py``: its
  ``_levels`` and K1 transitions) in float32, recording each subnet's three
  quant points (its input and the two ELU trunk outputs);
* ``calibrate``: per-tensor scales ``max(amax, 1e-6)·margin/127`` (Python
  floats), the walk run in full float32 (TF32 off);
* ``quantize``: the subnet kernels with the packed executor's c-major
  permutations applied first (``_cmajor_to_gmajor``, ``_head_colperm``), then
  per-output-channel symmetric int8 weights; the fused head split into its
  ``xin`` and ``h`` operands with one shared weight-scale vector; built on
  the CPU in float32 in the JAX package's order, so the tree equals its;
* ``forward_int8``: the int8 walk through a ``KernelSet``: per subnet
  evaluation two K11 ``qconv`` (the first quantizes the coupling half on
  load and writes it, JAX's ``xi``, as a side output; both apply the ELU
  requant) and one K13 ``qcoupling_head`` (the split head on ``xi`` and
  the trunk output, and the affine), the transitions in K1.

The tree mirrors the parameter tree one level down: block → ``st1`` /
``st2`` → ``{s_x, s_h0, s_h1, w0, m0, b0, w1, m1, b1, w2x, w2h, m2x, m2h,
b2}``, the JAX package's keys; the int8 weights in the port's kernel layout
``(Cout, k, k, Cin)`` (``convert.inn_int8_from_jax`` maps a JAX tree), the
scales 0-dim float32 tensors.
"""

from typing import Dict, Iterable

import torch
import torch.nn.functional as F

from ..device import full_f32
from ..kernels import KERNELS, KernelSet
from ..kernels.coupling import affine_e
from .inn import InvertibleNet
from .inn_packed import (_cmajor_to_gmajor, _down_transition, _head_colperm,
                         _levels, _up_transition)
from .unet_int8 import ohwi, quant_w, tree_map

__all__ = ["collect_amax", "calibrate", "quantize", "forward_int8"]


def _block_keys(tree, name, i):
    out, b = [], 0
    while f"{name}_{i}_{b}" in tree:
        out.append(f"{name}_{i}_{b}")
        b += 1
    return out


def _walk(tree, x, coupling, channels, down_num, dtype, kernels):
    """The packed executor's forward walk with the coupling abstracted:
    ``coupling(block_key, tree[block_key], z) -> z'``. Transitions run in
    ``dtype`` (None: float32)."""
    x = x.to(dtype or torch.float32).contiguous()
    packed, c = False, channels
    for i, (lc, lp) in enumerate(_levels(channels, down_num)):
        x = _down_transition(x, packed, lp, kernels)
        packed, c = lp, lc
        for k in _block_keys(tree, "down_blocks", i):
            x = coupling(k, tree[k], x)
    for i in range(down_num):
        dst_c = c // 4
        dst_packed = (dst_c < 256) and (i < down_num - 1)
        x = _up_transition(x, packed, dst_packed, kernels)
        packed, c = dst_packed, dst_c
        for k in _block_keys(tree, "up_blocks", i):
            x = coupling(k, tree[k], x)
    return x


def _elu(y):
    return torch.where(y > 0, y, torch.expm1(y))


def _conv(x, w, pad):
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad).permute(0, 2, 3, 1)


def _prep(sub, packed: bool):
    """The subnet's float32 kernels (OIHW) with the packed executor's
    permutations applied and the fused head split into its operands:
    ``(w0, b0, w1, b1, w2x, w2h, b2)``."""
    w0, b0 = sub.Conv_0.weight.detach().float(), sub.Conv_0.bias.detach()
    w1, b1 = sub.Conv_1.weight.detach().float(), sub.Conv_1.bias.detach()
    wh, bh = sub.Conv_2.weight.detach().float(), sub.Conv_2.bias.detach()
    ci = w0.shape[1]
    if packed:
        perm = torch.from_numpy(_cmajor_to_gmajor(ci)).to(w0.device)
        w0 = w0[:, perm]
        wh = torch.cat([wh[:, perm], wh[:, ci:]], 1)
        colperm = torch.from_numpy(_head_colperm(wh.shape[0])).to(w0.device)
        wh, bh = wh[colperm], bh[colperm]
    return (w0, b0.float(), w1, b1.float(), wh[:, :ci], wh[:, ci:],
            bh.float())


def _preps(net: InvertibleNet):
    return {name: {st: _prep(getattr(blk, st), blk.packed)
                   for st in ("st1", "st2")}
            for name, blk in net.named_children()}


@torch.no_grad()
def collect_amax(net: InvertibleNet, x: torch.Tensor,
                 kernels: KernelSet = KERNELS):
    """Float32 packed-walk forward recording each subnet's three quant-point
    absolute maxima: ``(y, {block: {st: [a_x, a_h0, a_h1]}})``, the maxima
    0-dim tensors."""
    amax: Dict[str, Dict] = {}

    def st(key, stn, w, xin):
        w0, b0, w1, b1, w2x, w2h, b2 = w
        xf = xin.float()
        h0 = _elu(_conv(xf, w0, 1) + b0)
        h1 = _elu(_conv(h0, w1, 1) + b1)
        out = _conv(xf, w2x, 0) + _conv(h1, w2h, 0) + b2
        amax.setdefault(key, {})[stn] = [xf.abs().max(), h0.abs().max(),
                                         h1.abs().max()]
        half = out.shape[-1] // 2
        return out[..., :half], out[..., half:]

    def coupling(key, p, z):
        half = z.shape[-1] // 2
        x1, x2 = z[..., :half], z[..., half:]
        s2, t2 = st(key, "st2", p["st2"], x2)
        y1 = (affine_e(s2) * x1.float() + t2).to(z.dtype)
        s1, t1 = st(key, "st1", p["st1"], y1)
        y2 = (affine_e(s1) * x2.float() + t1).to(z.dtype)
        return torch.cat([y1, y2], -1)

    y = _walk(_preps(net), x, coupling, net.channels, net.down_num, None,
              kernels)
    return y.float(), amax


@torch.no_grad()
def calibrate(net: InvertibleNet, batches: Iterable, margin: float = 1.0,
              kernels: KernelSet = KERNELS) -> Dict:
    """Per-tensor activation scales from representative embed inputs:
    ``batches`` iterates (N, H, W, channels) arrays or tensors, what the
    embed feeds the INN (frame→channel-transposed clips in [0, 1]). Scales
    are ``margin · max-over-batches(amax) / 127``, Python floats."""
    dev = next(net.parameters()).device
    agg = None
    with full_f32():
        for v in batches:
            v = torch.as_tensor(v, dtype=torch.float32).to(dev)
            a = tree_map(float, collect_amax(net, v, kernels)[1])
            agg = a if agg is None else tree_map(max, agg, a)
    if agg is None:
        raise ValueError("calibration needs at least one batch")
    return tree_map(lambda a: max(a, 1e-6) * margin / 127.0, agg)


@torch.no_grad()
def quantize(net: InvertibleNet, scales: Dict, device=None) -> Dict:
    """The int8 inference tree of ``net`` on ``scales`` (``calibrate``'s),
    built on the CPU, then moved to ``device`` (default: the CPU)."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    q: Dict[str, Dict] = {}
    for name, blk in net.named_children():
        q[name] = {}
        for stn in ("st1", "st2"):
            w0, b0, w1, b1, w2x, w2h, b2 = (
                t.cpu() for t in _prep(getattr(blk, stn), blk.packed))
            s_x, s_h0, s_h1 = scales[name][stn]
            w0i, sw0 = quant_w(w0, (1, 2, 3))
            w1i, sw1 = quant_w(w1, (1, 2, 3))
            # one weight-scale vector across the full fused head
            w2i, sw2 = quant_w(torch.cat([w2x, w2h], 1), (1, 2, 3))
            cx = w2x.shape[1]
            q[name][stn] = {
                "s_x": f32(s_x), "s_h0": f32(s_h0), "s_h1": f32(s_h1),
                "w0": ohwi(w0i), "m0": f32(s_x) * sw0, "b0": b0,
                "w1": ohwi(w1i), "m1": f32(s_h0) * sw1, "b1": b1,
                "w2x": ohwi(w2i[:, :cx]), "w2h": ohwi(w2i[:, cx:]),
                "m2x": f32(s_x) * sw2, "m2h": f32(s_h1) * sw2, "b2": b2,
            }
    return tree_map(lambda t: t.to(device or "cpu"), q)


@torch.no_grad()
def forward_int8(q: Dict, x: torch.Tensor, *, channels: int = 12,
                 down_num: int = 3, dtype=torch.bfloat16,
                 out_f32: bool = True,
                 kernels: KernelSet = KERNELS) -> torch.Tensor:
    """Int8 packed-space embed forward, NHWC (N, H, W, channels) → the same
    shape, float32 (or ``dtype`` when ``out_f32`` is False). Learned convs
    sum int8×int8 → int32; transitions and affines run in ``dtype`` (None:
    float32) as the executor's."""
    def trunk(p, xin, xi):
        h0 = kernels.qconv(xin, p["w0"], p["m0"], p["b0"], "elu",
                           x_scale=p["s_x"], out_scale=p["s_h0"], xi_out=xi)
        return kernels.qconv(h0, p["w1"], p["m1"], p["b1"], "elu",
                             out_scale=p["s_h1"])

    def coupling(key, p, z):
        half = z.shape[-1] // 2
        out = torch.empty_like(z)
        x1, x2 = z[..., :half], z[..., half:]
        y1, y2 = out[..., :half], out[..., half:]
        # xi: the quantized coupling half, written by the trunk's first
        # conv and read by the head (JAX's xi, computed once)
        xi = torch.empty(x2.shape, dtype=torch.int8, device=z.device)
        kernels.qcoupling_head(x2, trunk(p["st2"], x2, xi), p["st2"], x1,
                               out=y1, xi=xi)
        kernels.qcoupling_head(y1, trunk(p["st1"], y1, xi), p["st1"], x2,
                               out=y2, xi=xi)
        return out

    y = _walk(q, x, coupling, channels, down_num, dtype, kernels)
    return y.float() if out_f32 else y
