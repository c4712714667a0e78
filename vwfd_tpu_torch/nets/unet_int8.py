"""Int8 post-training-quantized serving path of ``UNetTPU`` (port of
vwfd_tpu/nets/unet_int8.py).

* ``fold_unet_tpu``: eval-mode BatchNorm folded into each conv (w' = w·γ/√(σ²+ε),
  b' = β − μ·γ/√(σ²+ε)), float32, the same operations in the same order as
  the JAX package's, so the folded tree equals its;
* ``apply_folded``: the eval-mode forward on the folded tree, optionally
  collecting each quant point's absolute maximum (the calibration
  observable);
* ``calibrate``: per-tensor activation scales ``max(amax, 1e-6)·margin/127``
  (Python floats, computed in double as the JAX package's), the folded net
  run in full float32 (TF32 off: TF32 moves every amax by about 1e-3);
* ``quantize``: per-output-channel symmetric int8 weights and the fused
  requant constants ``m = s_in·s_w/s_out``, ``b = bias/s_out`` (the head keeps
  float32 logits), built on the CPU in float32 in the JAX package's order
  (each Python scale rounded to float32 where it meets a tensor, as JAX's
  weak types), so that the tree equals the JAX package's on the same
  scales;
* ``apply_int8`` / ``body_int8``: the int8 forward through a ``KernelSet``:
  K11 ``qconv`` for every conv (the max-pool fused into each level's first
  conv, the split decoder conv as K11's dual epilogue, the head as its f32
  epilogue) and K12 ``qconv_t`` for the transposed convs.

Trees are nested dicts of tensors with the JAX package's keys. The int8
weights take the port's kernel layout: convs ``(Cout, k, k, Cin)`` (OHWI),
the transposed convs ``(2, 2, Cout, Cin)`` already flipped from flax's HWIO
kernel (F3); ``convert.unet_int8_from_jax`` maps a JAX tree to this one.
Scope as the JAX package's: head ``d2s``, upsample ``convt``, any
``enc_convs`` plan, ``s2d`` and width.
"""

from typing import Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from ..device import full_f32
from ..kernels import KERNELS, KernelSet
from ..ops.squeeze import depth_to_space, space_to_depth
from .unet import UNetTPU

__all__ = ["fold_unet_tpu", "apply_folded", "calibrate", "quantize",
           "apply_int8", "body_int8", "quant_w", "ohwi", "tree_map"]

_EPS = 1e-5  # flax BatchNorm default epsilon
_ENC_NAMES = ("enc1", "enc2", "enc3", "enc4", "bottleneck")
_DEC_LEVELS = (4, 3, 2, 1)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts / lists / tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _cpu(t):
    return t.detach().float().cpu()


def _fold_bn(conv, bn):
    w, gamma, beta, mean, var = map(_cpu, (conv.weight, bn.weight, bn.bias,
                                           bn.running_mean, bn.running_var))
    # torch's vectorized float32 CPU sqrt is not correctly rounded (one ulp
    # off on some of a 128-channel vector); the float64 root rounded to
    # float32 is, as XLA's (F16)
    g = gamma / torch.sqrt((var + _EPS).double()).float()
    return w * g[:, None, None, None], beta - mean * g


@torch.no_grad()
def fold_unet_tpu(net: UNetTPU) -> Dict:
    """The BN-folded float32 tree of a ``UNetTPU``, on the CPU:
    ``{"enc": [[(w, b), ...] ×5], "up": [(k, b) ×4], "dec": [(w, b) ×4],
    "head": (k, b)}`` with the module's own layouts (conv weights OIHW, the
    transposed convs' ``(Cin, Cout, 2, 2)``)."""
    enc = []
    for name in _ENC_NAMES:
        blk = getattr(net, name)
        enc.append([_fold_bn(getattr(blk, f"Conv_{i}"),
                             getattr(blk, f"BatchNorm_{i}"))
                    for i in range(blk.convs)])
    ups = [(_cpu(getattr(net, f"up{lv}").weight),
            _cpu(getattr(net, f"up{lv}").bias)) for lv in _DEC_LEVELS]
    dec = [_fold_bn(getattr(net, f"dec{lv}_conv"), getattr(net, f"dec{lv}_bn"))
           for lv in _DEC_LEVELS]
    head = (_cpu(net.head.weight), _cpu(net.head.bias))
    return {"enc": enc, "up": ups, "dec": dec, "head": head}


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(z, w):
    return _nhwc(F.conv2d(_nchw(z), w, padding=w.shape[-1] // 2))


def apply_folded(folded: Dict, x: torch.Tensor, s2d: int = 2,
                 apply_sigmoid: bool = True, collect_amax: bool = False):
    """Eval-mode ``UNetTPU`` forward on the folded tree (its tensors on
    ``x``'s device). With ``collect_amax`` also returns the quant points'
    absolute maxima as 0-dim tensors, ``{"enc": [[a]×convs]×5, "up": [a]×4,
    "dec": [a]×4}``; the input point is not calibrated (serving inputs are
    [0, 1]: scale 1/127). The head's width fixes the output channels."""
    amax = {"enc": [], "up": [], "dec": []}
    z = space_to_depth(x.float(), s2d)
    skips = []
    for j, level in enumerate(folded["enc"]):
        if j > 0:
            z = _nhwc(F.max_pool2d(_nchw(z), 2, 2))
        lv = []
        for w, b in level:
            z = F.relu(_conv(z, w) + b)
            lv.append(z.abs().max())
        amax["enc"].append(lv)
        if j < 4:
            skips.append(z)
    for i, ((uk, ub), (dw, db)) in enumerate(zip(folded["up"],
                                                  folded["dec"])):
        u = _nhwc(F.conv_transpose2d(_nchw(z), uk, stride=2)) + ub
        amax["up"].append(u.abs().max())
        cu = u.shape[-1]
        z = F.relu(_conv(u, dw[:, :cu]) + _conv(skips[3 - i], dw[:, cu:])
                   + db)
        amax["dec"].append(z.abs().max())
    hk, hb = folded["head"]
    o = depth_to_space(_conv(z, hk) + hb, s2d)
    out = torch.sigmoid(o) if apply_sigmoid else o
    return (out, amax) if collect_amax else out


@torch.no_grad()
def calibrate(net: UNetTPU, batches: Iterable, margin: float = 1.0) -> Dict:
    """Per-tensor activation scales from representative inputs: ``batches``
    iterates (N, H, W, 3) arrays or tensors in [0, 1]. Scales are ``margin ·
    max-over-batches(amax) / 127``, Python floats."""
    dev = net.head.weight.device
    folded = tree_map(lambda t: t.to(dev), fold_unet_tpu(net))
    agg = None
    with full_f32():
        for v in batches:
            v = torch.as_tensor(v, dtype=torch.float32).to(dev)
            a = tree_map(float, apply_folded(folded, v, net.s2d,
                                             collect_amax=True)[1])
            agg = a if agg is None else tree_map(max, agg, a)
    if agg is None:
        raise ValueError("calibration needs at least one batch")
    return tree_map(lambda a: max(a, 1e-6) * margin / 127.0, agg)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def quant_w(w: torch.Tensor, dims):
    """Per-output-channel symmetric int8 weights: ``(w_i8, scale)``, the
    scale ``max(amax, 1e-8)/127`` over ``dims``."""
    sw = torch.clamp(w.abs().amax(dim=dims), min=1e-8) / _f32(127.0)
    shape = [1] * w.dim()
    keep = [d for d in range(w.dim()) if d not in dims][0]
    shape[keep] = -1
    wi = torch.clamp(torch.round(w / sw.reshape(shape)), -127, 127)
    return wi.to(torch.int8), sw.float()


def ohwi(w: torch.Tensor) -> torch.Tensor:
    """OIHW → the int8 kernels' (Cout, k, k, Cin)."""
    return w.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def quantize(net: UNetTPU, scales: Dict, device=None) -> Dict:
    """The int8 inference tree of ``net`` on ``scales`` (``calibrate``'s):
    each conv carries ``m = s_in·s_w/s_out`` per channel and ``b =
    bias/s_out``; the head keeps float32 logits (``s_out = 1``). Built on the
    CPU, then moved to ``device`` (default: the CPU)."""
    folded = fold_unet_tpu(net)
    qp: Dict = {"enc": [], "dec": []}
    sz = 1.0 / 127.0  # serving contract: input in [0, 1]
    for j, level in enumerate(folded["enc"]):
        lv = []
        for i, (w, b) in enumerate(level):
            wi, sw = quant_w(w, (1, 2, 3))
            s_out = scales["enc"][j][i]
            lv.append({"w": ohwi(wi), "m": _f32(sz) * sw / _f32(s_out),
                       "b": b / _f32(s_out)})
            sz = s_out
        qp["enc"].append(lv)
        # maxpool commutes with the (monotone, positive-scale) quant
    enc_out_scale = [scales["enc"][j][-1] for j in range(5)]
    sz = enc_out_scale[4]
    for i, ((uk, ub), (dw, db)) in enumerate(zip(folded["up"],
                                                  folded["dec"])):
        uwi, usw = quant_w(uk, (0, 2, 3))
        s_up = scales["up"][i]
        cu = uk.shape[1]
        cwi, csw = quant_w(dw, (1, 2, 3))  # one scale vector for the kernel
        s_skip = enc_out_scale[3 - i]
        s_out = scales["dec"][i]
        qp["dec"].append({
            "up_w": uwi.permute(2, 3, 1, 0).contiguous(),
            "up_m": _f32(sz) * usw / _f32(s_up), "up_b": ub / _f32(s_up),
            "w_up": ohwi(cwi[:, :cu]), "w_skip": ohwi(cwi[:, cu:]),
            "m_up": _f32(s_up) * csw / _f32(s_out),
            "m_skip": _f32(s_skip) * csw / _f32(s_out),
            "b": db / _f32(s_out),
        })
        sz = s_out
    hk, hb = folded["head"]
    hwi, hsw = quant_w(hk, (1, 2, 3))
    qp["head"] = {"w": ohwi(hwi), "m": _f32(sz) * hsw, "b": hb}
    return tree_map(lambda t: t.to(device or "cpu"), qp)


def body_int8(qp: Dict, zi: torch.Tensor, kernels: KernelSet = KERNELS,
              acts: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Int8 stem (N, H/s, W/s, s²·3) → the head's packed float32 logits (N,
    H/s, W/s, s²·out). ``acts`` (a list) receives every int8 activation, in
    the order the JAX package computes them."""
    def keep(z):
        if acts is not None:
            acts.append(z)
        return z

    skips = []
    for j, level in enumerate(qp["enc"]):
        for i, c in enumerate(level):
            zi = keep(kernels.qconv(zi, c["w"], c["m"], c["b"], "relu",
                                    pool=j > 0 and i == 0))
        if j < 4:
            skips.append(zi)
    for i, d in enumerate(qp["dec"]):
        ui = keep(kernels.qconv_t(zi, d["up_w"], d["up_m"], d["up_b"]))
        zi = keep(kernels.qconv(ui, d["w_up"], d["m_up"], d["b"], "relu",
                                x2=skips[3 - i], w2=d["w_skip"],
                                m2=d["m_skip"]))
    h = qp["head"]
    return kernels.qconv(zi, h["w"], h["m"], h["b"], "f32")


def apply_int8(qp: Dict, x: torch.Tensor, s2d: int = 2,
               apply_sigmoid: bool = True, kernels: KernelSet = KERNELS,
               acts: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Int8 eval-mode ``UNetTPU`` forward: ``x`` float32 (N, H, W, 3) in
    [0, 1] → probabilities (or logits) (N, H, W, out), float32. The stem
    ``clip(round(x·127), 0, 127)`` runs in torch; the server instead hands
    ``body_int8`` K3's int8 stem of the uint8 clip."""
    zi = torch.clamp(torch.round(x.float() * 127.0), 0, 127).to(torch.int8)
    zi = space_to_depth(zi, s2d).contiguous()
    o = depth_to_space(body_int8(qp, zi, kernels, acts), s2d)
    return torch.sigmoid(o) if apply_sigmoid else o
