"""Packed-space executor for the flagship INN (port of
vwfd_tpu/nets/inn_packed.py).

Runs ``InvertibleNet(subnet='res_tpu2', fused_st=True)`` with every
<256-channel level held space-to-depth-packed at its coupling-trunk
resolution, in the JAX package's "c-major" channel order (packed channel
c·4 + g, g = 2p + q the sub-pixel):

* ``Conv_0`` and the head's first input rows are indexed with a fixed
  permutation and the head's output columns re-ordered (``pack_params``,
  once per weight version), so the parameters are the module tree's own;
* the Haar levels are fixed orthogonal transitions (K1, ``kernels/
  transition.py``): entry 4×4/s4, packed→packed 2×2/s2, packed→unpacked
  1×1, and their exact transposes on the way up; the unpacked→unpacked
  levels past 768 channels (``down_num`` ≥ 4) are the plain Haar squeeze,
  K14 (``kernels/haar.py``), as the JAX package calls
  ``haar_downsample_conv`` / ``haar_upsample_conv`` there;
* each coupling half's 1×1 head GEMM, bias and affine run in K2
  (``kernels/coupling.py``), which reads the input half and the trunk output
  in place (no concat) and writes its half straight into the coupling's
  output; ``pack_params`` interleaves the head's s and t columns in blocks
  of 8 for it.

At the flagship shapes (12 channels, down_num 3, block_num (1,1,1)) the walk
is: entry (→ H/4 × 192), coupling 48; p2p (→ H/8 × 768), coupling 192; p2u
(→ unpacked 768), coupling 768; then p2uᵀ, coupling 192; p2pᵀ, coupling 48;
entryᵀ. Six transitions, five couplings, two affines each.

The executor is differentiable: with grad enabled ``pack_params`` keeps the
graph (gather, then cast) so that gradients reach the float32 module
parameters, each coupling half is a fresh tensor (K2 under autograd), and
K1's backward is K1 with ``transpose`` flipped. Without grad (serving) the
couplings write their halves in place, as before.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import KERNELS, KernelSet
from ..kernels.coupling import interleave_index

# sign of Haar band k ∈ (LL, LH, HL, HH) at sub-pixel (p=row, q=col) —
# vwfd_tpu/nets/inn_packed.py::_SIGNS
_SIGNS = np.array(
    [
        [[1.0, 1.0], [1.0, 1.0]],
        [[1.0, -1.0], [1.0, -1.0]],
        [[1.0, 1.0], [-1.0, -1.0]],
        [[1.0, -1.0], [-1.0, 1.0]],
    ],
    np.float32,
)


def _g(p, q):
    return 2 * p + q


# ------------------------------------------------------------ fixed kernels
# HWIO numpy kernels, exactly as the JAX package builds them. The plain
# version of K1 (kernels/transition.py) convolves with them; the CUDA kernel
# gathers the same taps.


def _t(w):
    return np.ascontiguousarray(w.transpose(0, 1, 3, 2)[::-1, ::-1])


@functools.lru_cache(maxsize=None)
def _entry_kernel(cin: int, transpose: bool):
    """(4,4,C,16C): unpacked (H,W,C) → packed level (H/4,W/4,16C)."""
    w = np.zeros((4, 4, cin, 16 * cin), np.float32)
    for ci in range(cin):
        for k in range(4):
            for p in range(2):
                for q in range(2):
                    for u in range(2):
                        for v in range(2):
                            w[p * 2 + u, q * 2 + v, ci,
                              (ci * 4 + k) * 4 + _g(p, q)] = \
                                0.5 * _SIGNS[k][u, v]
    return w if not transpose else _t(w)


@functools.lru_cache(maxsize=None)
def _p2p_kernel(c: int, transpose: bool):
    """(2,2,4C,16C): packed level C (res r) → packed level 4C (res r/2)."""
    w = np.zeros((2, 2, 4 * c, 16 * c), np.float32)
    for ci in range(c):
        for k in range(4):
            for g1 in range(4):
                for g2 in range(4):
                    w[g2 // 2, g2 % 2, ci * 4 + g1,
                      ((ci * 4 + k) * 4 + g2)] = \
                        0.5 * _SIGNS[k][g1 // 2, g1 % 2]
    return w if not transpose else _t(w)


@functools.lru_cache(maxsize=None)
def _p2u_kernel(c: int, transpose: bool):
    """(1,1,4C,4C): packed level C (res r) → UNPACKED level 4C (res r)."""
    w = np.zeros((1, 1, 4 * c, 4 * c), np.float32)
    for ci in range(c):
        for k in range(4):
            for g in range(4):
                w[0, 0, ci * 4 + g, ci * 4 + k] = \
                    0.5 * _SIGNS[k][g // 2, g % 2]
    return w if not transpose else _t(w)


# ------------------------------------------------------- packed parameters


@functools.lru_cache(maxsize=None)
def _cmajor_to_gmajor(ci4: int):
    """π[j] = (j%4)·Ci + j//4: c-major packed channel j = c·4+g holds what
    the s2d order (g·Ci + c) puts at π[j]."""
    ci = ci4 // 4
    return np.array([(j % 4) * ci + j // 4 for j in range(ci4)], np.int64)


@functools.lru_cache(maxsize=None)
def _head_colperm(c4: int):
    """Columns: head emits d2s order (g·C + c); we want c-major (c·4 + g)."""
    c = c4 // 4
    return np.array([(j % 4) * c + j // 4 for j in range(c4)], np.int64)


def _pack_subnet(sub, packed: bool, dt):
    """One subnet's executor weights: trunk convs in ``dt`` (OIHW), the head
    as a (2C, K) matrix in ``dt`` (transposed, K contiguous, as K2's tensor
    cores read it) and its bias in f32 (rounded through ``dt`` first, as
    flax casts the bias to the compute dtype), both with the (s ‖ t)
    outputs interleaved in blocks of 8 for K2."""
    w0 = sub.Conv_0.weight
    wh = sub.Conv_2.weight[:, :, 0, 0].t()           # (ci4 + F, out)
    bh = sub.Conv_2.bias
    if packed:
        ci4 = w0.shape[1]
        perm = torch.from_numpy(_cmajor_to_gmajor(ci4)).to(w0.device)
        w0 = w0[:, perm]
        # rows: the z-part of the concat is our c-major slice; the trunk
        # part is order-neutral
        wh = torch.cat([wh[perm], wh[ci4:]], 0)
        colperm = torch.from_numpy(_head_colperm(wh.shape[1])).to(w0.device)
        wh, bh = wh[:, colperm], bh[colperm]
    st = torch.from_numpy(interleave_index(wh.shape[1])).to(w0.device)
    wh, bh = wh[:, st], bh[st]
    out = {"w0": w0.to(dt).contiguous(), "b0": sub.Conv_0.bias.to(dt),
           "w1": sub.Conv_1.weight.to(dt), "b1": sub.Conv_1.bias.to(dt),
           "wh": wh.t().to(dt).contiguous(), "bh": bh.to(dt).float()}
    return out


def pack_params(net, dtype=None):
    """``InvertibleNet`` parameters → the executor's tree: for every
    coupling name, ``{"st1": ..., "st2": ...}``. Differentiable in the
    parameters when grad is enabled."""
    dt = dtype or torch.float32
    return {name: {st: _pack_subnet(getattr(blk, st), blk.packed, dt)
                   for st in ("st1", "st2")}
            for name, blk in net.named_children()}


# ------------------------------------------------------------ subnet / st


def _conv3x3(x, w, b):
    """NHWC 3×3 conv: cuDNN sees the channels_last NCHW view, no copy."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1)
    return y.permute(0, 2, 3, 1)


def _st(p, xin):
    """The subnet's trunk (two 3×3 convs + ELU); returns ``h``. The 1×1
    cat-skip head on ``[xin | h]`` runs in K2. Same code for the packed
    subnet (its weights are permuted in ``pack_params``) and the unpacked
    ≥256-channel one."""
    h = F.elu(_conv3x3(xin, p["w0"], p["b0"]))
    return F.elu(_conv3x3(h, p["w1"], p["b1"]))


def _coupling_fwd(p, z, k: KernelSet):
    half = z.shape[-1] // 2
    if torch.is_grad_enabled():
        # autograd: fresh halves (K2 through its autograd function)
        x1, x2 = z[..., :half], z[..., half:]
        y1 = k.coupling_head(x2, _st(p["st2"], x2), p["st2"], x1)
        y2 = k.coupling_head(y1, _st(p["st1"], y1), p["st1"], x2)
        return torch.cat([y1, y2], -1)
    out = torch.empty_like(z)
    x1, x2 = z[..., :half], z[..., half:]
    y1, y2 = out[..., :half], out[..., half:]
    k.coupling_head(x2, _st(p["st2"], x2), p["st2"], x1, out=y1)
    k.coupling_head(y1, _st(p["st1"], y1), p["st1"], x2, out=y2)
    return out


def _coupling_inv(p, z, k: KernelSet):
    half = z.shape[-1] // 2
    out = torch.empty_like(z)
    y1, y2 = z[..., :half], z[..., half:]
    x1, x2 = out[..., :half], out[..., half:]
    k.coupling_head(y1, _st(p["st1"], y1), p["st1"], y2, out=x2,
                    inverse=True)
    k.coupling_head(x2, _st(p["st2"], x2), p["st2"], y1, out=x1,
                    inverse=True)
    return out


# ------------------------------------------------------------------- walks


def _levels(channels, down_num):
    """Per down level: (channels after Haar, packed?). Packed mirrors
    RNVPCoupling's subnet rule: res_tpu2 (⇒ packed) below 256 channels."""
    out, ch = [], channels
    for _ in range(down_num):
        ch *= 4
        out.append((ch, ch < 256))
    return out


def _down_transition(z, src_packed, dst_packed, k: KernelSet):
    if not src_packed and not dst_packed:
        return k.haar(z)  # levels past 768 channels: the plain Haar (K14)
    if not src_packed:
        return k.transition(z, "entry")
    if dst_packed:
        return k.transition(z, "p2p")
    return k.transition(z, "p2u")


def _up_transition(z, src_packed, dst_packed, k: KernelSet):
    """Exact inverse of ``_down_transition(·, dst_packed, src_packed)``."""
    if not dst_packed and not src_packed:
        return k.haar(z, transpose=True)
    if not dst_packed:
        return k.transition(z, "entry", transpose=True)
    if src_packed:
        return k.transition(z, "p2p", transpose=True)
    return k.transition(z, "p2u", transpose=True)


def _blocks(params, name, i):
    out, b = [], 0
    while f"{name}_{i}_{b}" in params:
        out.append(params[f"{name}_{i}_{b}"])
        b += 1
    return out


def forward(params, x, *, channels=12, down_num=3, dtype=torch.bfloat16,
            out_f32=True, kernels: KernelSet = KERNELS):
    """Packed-space ``InvertibleNet.forward``; ``params`` from
    ``pack_params``. NHWC in, NHWC out (f32, or the compute dtype when
    ``out_f32`` is False)."""
    x = x.to(dtype or torch.float32).contiguous()
    packed, c = False, channels
    for i, (lc, lp) in enumerate(_levels(channels, down_num)):
        x = _down_transition(x, packed, lp, kernels)
        packed, c = lp, lc
        for p in _blocks(params, "down_blocks", i):
            x = _coupling_fwd(p, x, kernels)
    for i in range(down_num):
        dst_c = c // 4
        dst_packed = (dst_c < 256) and (i < down_num - 1)
        x = _up_transition(x, packed, dst_packed, kernels)
        packed, c = dst_packed, dst_c
        for p in _blocks(params, "up_blocks", i):
            x = _coupling_fwd(p, x, kernels)
    return x.float() if out_f32 else x


def inverse(params, y, *, channels=12, down_num=3, dtype=torch.bfloat16,
            return_middle=True, kernels: KernelSet = KERNELS):
    """Packed-space ``InvertibleNet.inverse``; ``middle`` is the unpacked
    bottleneck tensor (f32)."""
    y = y.to(dtype or torch.float32).contiguous()
    levels = _levels(channels, down_num)
    packed, c = False, channels
    for j in range(down_num - 1, -1, -1):
        for p in reversed(_blocks(params, "up_blocks", j)):
            y = _coupling_inv(p, y, kernels)
        dst_c = c * 4
        dst_packed = (dst_c < 256) and (j > 0)
        y = _down_transition(y, packed, dst_packed, kernels)
        packed, c = dst_packed, dst_c
    middle = y.float()
    for j in range(down_num - 1, -1, -1):
        for p in reversed(_blocks(params, "down_blocks", j)):
            y = _coupling_inv(p, y, kernels)
        dst_c = c // 4
        dst_packed = (dst_c < 256) and (j > 0) and levels[j - 1][1]
        y = _up_transition(y, packed, dst_packed, kernels)
        packed, c = dst_packed, dst_c
    y = y.float()
    return (y, middle) if return_middle else y
