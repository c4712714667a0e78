"""K11 `qconv`: an int8 3×3 SAME or 1×1 convolution with exact int32 sums
and its requant epilogue and input prologue fused.

Replaces the int8 convolutions of the JAX package's PTQ serving path:
``vwfd_tpu/nets/unet_int8.py::apply_int8``'s ``qconv`` + ``requant`` and the
int8 2×2 max-pool (:235-254), the split decoder conv (:261-265) and the head
(:268-270), and ``vwfd_tpu/nets/inn_int8.py::forward_int8``'s trunk convs
with their ELU requant (:241-256). With ``y = float(acc)·m + b`` per output
channel (``acc`` the exact int32 sum, ``float`` rounding to nearest even):

* ``"relu"``: ``clip(round(y), 0, 127)`` → int8;
* ``"signed"``: ``clip(round(y), -127, 127)`` → int8;
* ``"relu"`` with a second source ``x2``/``w2``/``m2`` (the split decoder):
  ``y = (float(acc)·m + float(acc2)·m2) + b``;
* ``"elu"``: ``clip(round(elu(y) / out_scale), -127, 127)`` → int8, the ELU
  through ``expm1`` as ``jax.nn.elu``;
* ``"f32"``: ``y`` → float32 (the head's logits).

Prologues: ``pool`` max-pools the int8 input 2×2 (floor) before the conv;
``x_scale`` (a 0-dim float32 tensor) quantizes a float32 or bf16 input on
load, ``clip(round(x / x_scale), -127, 127)`` (the INN trunk's first conv).
``round`` is half to even, as ``jnp.round``. The input may be a channel
slice (unit channel stride, uniform pixel stride).

Weights are the port's int8 layout, ``(Cout, k, k, Cin)`` (OHWI: K
contiguous in (tap, channel) order, as the tensor cores read B); ``m``, ``b``
and ``m2`` are float32 ``(Cout,)``.

Bound: operations at the flagship shapes, ``2·MAC`` over the int8 tensor
cores' 1,979 TOP/s (H100 SXM data sheet, 700 W): the UNet's twelve launches
of a detect are 7.9 G multiply-adds a frame, 64 frames, about 0.51 ms;
enc1's first conv (K = 108) and the head are bound by bytes.

Design (``csrc/qconv.cu`` on ``csrc/qwgmma.cuh``): a persistent implicit
GEMM, 16 × 8-pixel output tiles × BN (64 or 128) output channels,
``wgmma`` m64nBNk32 s8 → s32 from two consumer warpgroups, fed through a
ring of shared-memory stages (32 input channels for 3×3: the tile's halo,
whose nine taps are descriptor offsets, and the weights of all taps; 128
for 1×1) by TMA, or, for what TMA cannot describe (a pixel stride or Cin
off the 16-byte grid, the pool and quantize prologues), by the producer
warpgroup's threads (``cp.async`` for int8 copies). ``plan`` picks the
loaders, BN, the stage count and the grid; the wrapper passes its choice
to the C entry point. The epilogue's arithmetic is one IEEE rounding per
operation in the plain version's order (no FMA), so the kernel equals the
plain version bit for bit. The plain version sums exactly in float64
(``F.conv2d`` on double: |acc| ≤ 127²·9·Cin stays below 2⁵³, not below
2²⁴), then runs the epilogue with float32 torch ops; its divisors are
tensors (F14: a Python-scalar divisor is a reciprocal multiply on the
card).

``xi_out`` (with ``x_scale``): an int8 ``(N, H, W, Cin)`` tensor that
receives the quantized input, JAX's ``xi`` (``vwfd_tpu/nets/inn_int8.py``
:248-250), computed once for the trunk's first conv and K13's head.
"""

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _lib

__all__ = ["qconv", "qconv_plain", "launch_args", "exact_conv", "EPILOGUES",
           "COUNT", "plan", "plan_of", "Plan", "SMEM_LIMIT"]

COUNT = _lib.LaunchCount("qconv")
EPILOGUES = {"relu": 0, "signed": 1, "elu": 2, "f32": 3}
# csrc/qwgmma.cuh Kind: what the loader applies to the input
_KINDS = {torch.int8: 0, "pool": 1, torch.float32: 2, torch.bfloat16: 3}

# csrc/qwgmma.cuh: the tile, the ring's limits and a block's shared memory
TILE = (16, 8)          # output rows x columns of a tile
CONSUMERS = 2           # consumer warpgroups, 64 pixels each
MAX_STAGES = 6
SMEM_LIMIT = 232_448    # bytes of shared memory a block can use (H100)
_STATIC_SMEM, _ALIGN, _PARAMS = 256, 1024, 2048
_UNIT = {"int8": 1, "pool": 1, "float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the int8 wgmma core (K11, K12 through
    ``qconv_t.plan``, and K13 with ``split``).

    ``loaders``: per operand (activation, weights), each ``"tma"``,
    ``"cp.async"`` (int8 copies of 16 or 4 bytes by the producer's
    threads), ``"bytes"`` (byte copies), ``"pool"`` or ``"quant"`` (the
    prologues, by the producer's threads). ``maps``: the TMA operands'
    tensor maps as ``(name, base, dims, byte strides, box)``, innermost
    first. ``smem``: dynamic shared memory of a block."""
    ks: int
    bn: int
    kc: int
    stages: int
    groups: int
    grid: int
    loaders: Tuple[Tuple[str, str], ...]
    tma: int
    smem: int
    maps: Tuple[tuple, ...]
    b_resident: bool = False


def _unit(ptr: int, cin: int, ld: int, elem: int) -> int:
    """csrc/qwgmma.cuh::unit_bytes: the load unit of the producer's
    threads."""
    if elem > 1:
        return 4 if cin % 4 == 0 and ld % 4 == 0 else 1
    for v in (16, 4):
        if cin % v == 0 and ld % v == 0 and ptr % v == 0:
            return v
    return 1


def plan(n: int, h: int, w: int, cin: int, cout: int, k: int, *,
         kind: str = "int8", ld: Optional[int] = None, x_ptr: int = 0,
         w_ptr: int = 0, cin2: int = 0, ld2: Optional[int] = None,
         x2_ptr: int = 0, w2_ptr: int = 0, epilogue: str = "relu",
         split: int = 0, sms: int = 132, stages: Optional[int] = None,
         a_threads: bool = False) -> Plan:
    """The launch of an (n, h, w) output with ``cout`` columns from a
    ``cin``-channel source (``kind``: int8, pool, float32 or bfloat16; pixel
    stride ``ld`` elements, default cin) and ``k`` × ``k`` weights, and the
    optional second int8 operand (``cin2``: the dual conv, or K13's trunk
    output). ``split`` > 0 is K13: ``cout`` = 2·split rows, each block the s
    and t rows of BN/2 channels. The pointers decide TMA's 16-byte rule;
    ``stages`` overrides the ring depth and ``a_threads`` sends int8
    activations TMA could load through ``cp.async`` (``ablate_qconv``)."""
    ld = cin if ld is None else ld
    bn = 128 if split or cout > 64 else 64
    kc = 32 if k == 3 else 128
    hh, hw = TILE[0] + k - 1, TILE[1] + k - 1
    taps = k * k
    if k == 3:  # 16-byte planes of the halo; 32-byte weight rows a tap
        plane = (hh * hw * 16 + 127) // 128 * 128
        slot = (kc // 16 * plane + 1023) // 1024 * 1024 + taps * bn * kc
    else:       # 128-byte swizzled rows: the tile's pixels, the weight rows
        slot = hh * hw * kc + bn * kc
    int8_out = epilogue != "f32" and not split
    # the epilogue's staging, and its per-column parameters
    staging = (CONSUMERS * 64 * (bn + 16) if int8_out else 0) + _PARAMS
    room = SMEM_LIMIT - _STATIC_SMEM - _ALIGN - staging
    ops = [(kind, ld, x_ptr, w_ptr, cin)]
    if cin2:
        ops.append(("int8", cin2 if ld2 is None else ld2, x2_ptr, w2_ptr,
                    cin2))
    loaders, maps, tma = [], [], 0
    for o, (knd, ldo, xp, wp, ci) in enumerate(ops):
        # bytes of a TMA row: the halo's 16, weight rows 32 (3x3) or 128
        if knd == "int8" and ldo % 16 == 0 and xp % 16 == 0 \
                and not a_threads:
            a = "tma"
            maps.append((f"a{o}", xp, (ci, w, h, n),
                         (ldo, ldo * w, ldo * w * h),
                         (16 if k == 3 else kc, hw, hh, 1)))
        elif knd == "int8":
            a = "cp.async" if _unit(xp, ci, ldo, 1) >= 4 else "bytes"
        else:
            a = "pool" if knd == "pool" else "quant"
        if ci % 16 == 0 and wp % 16 == 0:
            b = "tma"
            maps.append((f"b{o}", wp, (taps * ci, cout), (taps * ci,),
                         (kc, bn // 2 if split else bn)))
        else:
            b = "cp.async" if _unit(wp, ci, ci, 1) >= 4 else "bytes"
        tma |= ((a == "tma") | (b == "tma") << 1) << (2 * o)
        loaders.append((a, b))
    # thread loads arrive a stage late and consumers release a stage late,
    # so the producer's threads need 3 slots
    least = 2 if tma == (15 if cin2 else 3) else 3
    fit = min(MAX_STAGES, room // slot)
    # stages a tile walks; when they divide the ring, every slot keeps one
    # stage of the block's weights and B is loaded once (resident)
    per_tile = -(-cin // kc) + -(-cin2 // kc)
    if stages is None:
        stages = per_tile * (fit // per_tile) if per_tile <= fit else fit
        stages = stages if stages >= least else fit
    if not least <= stages <= MAX_STAGES or stages * slot > room:
        raise ValueError(f"qconv plan: {stages} stages of {slot} bytes "
                         f"(at least {least}) do not fit")
    resident = stages % per_tile == 0
    nblk = -(-(split or cout) // (bn // 2 if split else bn))
    tiles = n * -(-h // TILE[0]) * -(-w // TILE[1])
    groups = max(1, min(tiles, sms // nblk))
    return Plan(k, bn, kc, stages, groups, groups * nblk, tuple(loaders),
                tma, _ALIGN + stages * slot + staging, tuple(maps), resident)


def exact_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of an int8 conv, ``w`` (Cout, k, k, Cin), SAME
    padding, computed in float64 (exact below 2⁵³)."""
    k = w.shape[1]
    y = F.conv2d(x.permute(0, 3, 1, 2).double(),
                 w.permute(0, 3, 1, 2).double(), padding=k // 2)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def quantize_input(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8 (``scale`` a 0-dim
    tensor: an IEEE division on every device)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 / stride-2 max-pool of NHWC (floor: a ragged last row or column
    is dropped, as ``reduce_window`` VALID)."""
    n, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def requant(y: torch.Tensor, lo: int) -> torch.Tensor:
    return torch.clamp(torch.round(y), lo, 127).to(torch.int8)


def _epilogue(acc, m, b, epilogue, acc2=None, m2=None, out_scale=None):
    y = acc.float() * m
    if acc2 is not None:
        y = y + acc2.float() * m2
    y = y + b
    if epilogue == "f32":
        return y
    if epilogue == "elu":
        e = torch.where(y > 0, y, torch.expm1(y))
        return requant(e / out_scale, -127)
    return requant(y, 0 if epilogue == "relu" else -127)


def _check(x, w, m, b, epilogue, pool, x_scale, x2, w2, m2, out_scale,
           xi_out=None):
    _lib.check_nhwc(w, "w")
    cout, k, k2, cin = w.shape
    if w.dtype != torch.int8 or k != k2 or k not in (1, 3):
        raise ValueError(f"w: expected int8 (Cout, k, k, Cin) with k 1 or 3, "
                         f"got {w.dtype} {tuple(w.shape)}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {sorted(EPILOGUES)}")
    if x.dim() != 4 or x.shape[-1] != cin:
        raise ValueError(f"x {tuple(x.shape)} does not fit w "
                         f"{tuple(w.shape)}")
    if (x_scale is None) != (x.dtype == torch.int8):
        raise ValueError("x is int8, or float32/bf16 with an x_scale")
    if x_scale is not None and (x.dtype not in _KINDS or pool
                                or x_scale.dim() != 0):
        raise ValueError("x_scale quantizes a float32 or bf16 input (no "
                         "pool) by a 0-dim tensor")
    for t, name in ((m, "m"), (b, "b")) + (((m2, "m2"),) if x2 is not None
                                           else ()):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 "
                             f"({cout},)")
    if (epilogue == "elu") != (out_scale is not None):
        raise ValueError("out_scale goes with the elu epilogue")
    if xi_out is not None:
        if x_scale is None or xi_out.dtype != torch.int8 \
                or tuple(xi_out.shape) != tuple(x.shape) \
                or not xi_out.is_contiguous():
            raise ValueError(f"xi_out: a contiguous int8 {tuple(x.shape)} "
                             f"tensor, with x_scale")
    if x2 is not None:
        if epilogue != "relu" or x2.dtype != torch.int8 \
                or w2.dtype != torch.int8 or pool:
            raise ValueError("the dual epilogue: relu, int8 x2 and w2, no "
                             "pool")
        _lib.check_nhwc(x2, "x2")
        _lib.check_nhwc(w2, "w2")
        h, ww = ((x.shape[1] // 2, x.shape[2] // 2) if pool
                 else tuple(x.shape[1:3]))
        if tuple(x2.shape[:3]) != (x.shape[0], h, ww) \
                or tuple(w2.shape[:3]) != (cout, k, k) \
                or w2.shape[3] != x2.shape[3]:
            raise ValueError(f"x2 {tuple(x2.shape)} / w2 {tuple(w2.shape)} "
                             f"do not fit x {tuple(x.shape)} / w "
                             f"{tuple(w.shape)}")


def _pixel_stride(t: torch.Tensor, name: str) -> int:
    """Elements between pixels of an NHWC tensor with unit channel stride and
    uniformly spaced pixels (a channel slice of a contiguous tensor)."""
    n, h, w, c = t.shape
    sn, sh, sw, sc = t.stride()
    if (c > 1 and sc != 1) or (h > 1 and sh != w * sw) \
            or (n > 1 and sn != h * w * sw):
        raise ValueError(f"{name}: expected unit channel stride and uniform "
                         f"pixels, got strides {t.stride()}")
    return sw


def qconv_plain(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                b: torch.Tensor, epilogue: str = "relu", *, pool: bool = False,
                x_scale: Optional[torch.Tensor] = None,
                x2: Optional[torch.Tensor] = None,
                w2: Optional[torch.Tensor] = None,
                m2: Optional[torch.Tensor] = None,
                out_scale: Optional[torch.Tensor] = None,
                xi_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: exact sums in float64, the epilogue in float32
    torch ops in the JAX package's order."""
    _check(x, w, m, b, epilogue, pool, x_scale, x2, w2, m2, out_scale,
           xi_out)
    if x_scale is not None:
        x = quantize_input(x, x_scale)
        if xi_out is not None:
            xi_out.copy_(x)
    if pool:
        x = max_pool2(x)
    acc2 = None if x2 is None else exact_conv(x2, w2)
    return _epilogue(exact_conv(x, w), m, b, epilogue, acc2, m2, out_scale)


def qconv(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
          epilogue: str = "relu", *, pool: bool = False,
          x_scale: Optional[torch.Tensor] = None,
          x2: Optional[torch.Tensor] = None,
          w2: Optional[torch.Tensor] = None,
          m2: Optional[torch.Tensor] = None,
          out_scale: Optional[torch.Tensor] = None,
          xi_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K11: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (N, H, W, Cout) int8 (float32 for ``"f32"``), H and W
    halved by ``pool``; with ``xi_out`` also writes the quantized input
    there."""
    _check(x, w, m, b, epilogue, pool, x_scale, x2, w2, m2, out_scale,
           xi_out)
    scalars = [t for t in (x_scale, out_scale, xi_out) if t is not None]
    extra = [x2, w2, m2] if x2 is not None else []
    if not _lib.on_cuda(x, w, m, b, *scalars, *extra):
        return qconv_plain(x, w, m, b, epilogue, pool=pool, x_scale=x_scale,
                           x2=x2, w2=w2, m2=m2, out_scale=out_scale,
                           xi_out=xi_out)
    out, args = launch_args(x, w, m, b, epilogue, pool=pool,
                            x_scale=x_scale, x2=x2, w2=w2, m2=m2,
                            out_scale=out_scale, xi_out=xi_out)
    _lib.launch("vwfd_qconv", x.device, *args)
    COUNT.n += 1
    return out


def plan_of(x, w, epilogue="relu", *, pool=False, x2=None, w2=None,
            stages=None, a_threads=False) -> Plan:
    """``plan`` for the launch ``qconv`` makes on these CUDA tensors."""
    n, hin, win, cin = x.shape
    h, wd = (hin // 2, win // 2) if pool else (hin, win)
    dual = x2 is not None
    return plan(n, h, wd, cin, w.shape[0], w.shape[1],
                kind="pool" if pool else str(x.dtype)[6:],
                ld=_pixel_stride(x, "x"), x_ptr=x.data_ptr(),
                w_ptr=w.data_ptr(), cin2=x2.shape[-1] if dual else 0,
                x2_ptr=x2.data_ptr() if dual else 0,
                w2_ptr=w2.data_ptr() if dual else 0, epilogue=epilogue,
                sms=_lib.sm_count(x.device), stages=stages,
                a_threads=a_threads)


def launch_args(x, w, m, b, epilogue="relu", *, pool=False, x_scale=None,
                x2=None, w2=None, m2=None, out_scale=None, xi_out=None,
                stages=None, a_threads=False):
    """The output tensor and the arguments of the C launcher ``vwfd_qconv``
    (all but the stream), for inputs ``_check`` passed, with ``plan``'s
    choice (``stages`` and ``a_threads``: its overrides)."""
    n, hin, win, cin = x.shape
    h, wd = (hin // 2, win // 2) if pool else (hin, win)
    cout, k = w.shape[0], w.shape[1]
    ld = _pixel_stride(x, "x")
    dual = x2 is not None
    if dual and (not x2.is_contiguous() or k != 3):
        raise ValueError("x2: a contiguous tensor, with 3x3 weights")
    out = torch.empty((n, h, wd, cout), device=x.device,
                      dtype=torch.float32 if epilogue == "f32"
                      else torch.int8)
    if max(x.numel(), out.numel(), x.storage_offset() + n * hin * win * ld
           ) >= 2 ** 31:
        raise ValueError("qconv: tensors of 2^31 elements or more")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    pl = plan_of(x, w, epilogue, pool=pool, x2=x2, w2=w2, stages=stages,
                 a_threads=a_threads)
    return out, (x.data_ptr(), _KINDS["pool" if pool else x.dtype], ld, hin,
                 win, w.data_ptr(), cin, ptr(x_scale), ptr(x2),
                 x2.shape[-1] if dual else 0, ptr(w2),
                 w2.shape[-1] if dual else 0, m.data_ptr(), ptr(m2),
                 b.data_ptr(), ptr(out_scale), out.data_ptr(), n, h, wd,
                 cout, k, EPILOGUES[epilogue], ptr(xi_out), pl.bn, pl.stages,
                 pl.groups, pl.tma, int(pl.b_resident))
