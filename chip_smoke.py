#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``vwfd_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, ``sm_90a``) and ``nvcc``; exits non-zero, with
no result line, on any failure or without a card. Drives the port only: it
imports nothing of JAX and nothing of ``vwfd_tpu``. Phases:

1. the card: name and power limit as ``nvidia-smi`` reports them;
2. build: one ``nvcc`` call compiles every ``vwfd_tpu_torch/csrc/*.cu``;
3. per-kernel checks at the flagship serving shapes (batch 16, T=4, 256²),
   in bf16 and f32, each kernel against its plain PyTorch version on the
   card, with the tolerances stated in ``TOL`` below; each kernel is timed
   beside its plain version with CUDA events: K1 per map beside the single
   ``F.conv2d`` / ``F.conv_transpose2d`` call that computes the same map, K2
   ``coupling_head`` at both coupling levels, forward and inverse, f32 and
   bf16, beside ``torch.cat`` + ``torch.matmul`` of the same shapes (the
   unfused path's yardstick; no single call computes the fused function);
   K3's four maps exact on the tiled and the general path, each timed warm
   and with a cold L2, (a)-(c) beside a one-call ``Tensor.copy_`` between
   the same layouts (a yardstick: no single call computes them); K4 warm
   and cold; then the training kernels at the training shape (64 frames of
   256²×3 f32): K5 ``jpeg_pair`` with draws covering all 5 qualities × 3
   modes and K6 ``median3`` on 8-bit inputs full of ties, each forward and
   input gradient against its plain version (K6 exact; K5 to 1e-4 except in
   8×8 blocks where a coefficient's rounding flipped, counted), K6 also on
   a small input with NaN pixels (NaN outputs at the same places), each
   timed forward + backward, warm and with a cold L2, beside its plain
   version; then the eval kernels at the eval shape: K7 ``f1_sweep``
   (64 frames of 256² f32, every k/255 boundary and NaN pixels) with counts
   EQUAL to the plain version's, and K8 ``ssim`` (64 frames of 256²×3 f32,
   with a flat patch) within ``ssim.ATOL`` on every per-image mean and the
   mean, each timed warm and with a cold L2 beside its plain version, K8
   also beside a depthwise 11×11 ``F.conv2d`` yardstick;
4. the slice: ``WatermarkServer`` from the port's ``configs/video.yaml`` (bf16,
   random weights from a seed with the zero-init heads perturbed) serves one
   roundtrip with the launch counts at 0 just before and read just after
   (K1 ×6, K2 ``coupling_head`` ×10, K3 ×2: ``to_channels`` and the
   one-pass ``to_u8_s2d``, K4 ×1), then embed, detect and roundtrip requests
   compared with the same server running the plain versions, and a small
   f32 clip compared with the CPU plain path;
5. roundtrip latency (p50 ms) and streaming throughput (frames/s);
6. training at full width: the same model with a synthetic loader takes one
   ``train_step`` through ``KERNELS`` with the launch counts at 0 just
   before and read just after (K1 ×11: six maps forward, five backward,
   the clip taking no gradient; K2 ×10; K5 ×2; K6 ×2), after the loss and
   gradients of one step through ``KERNELS`` and through ``PLAIN`` from the
   same weights, batch, previous batch and draws are compared (loss terms
   within 1e-2 relative, each net's gradient with cosine ≥ 0.999); then 2
   warm-up and 10 timed steps (p50 ms, frames/s), the finiteness of every
   loss, a batch with a NaN pixel that must leave every parameter, moment,
   step count and running statistic as it was, and the peak memory;
7. evaluation at full width: the same model takes one ``eval_step``
   through ``KERNELS`` with the launch counts at 0 just before and read
   just after (K1 ×6, K2 ×10, K5 ×1, K6 ×1, K7 ×1, K8 ×1), compared with
   ``PLAIN`` on the same batch, previous batch and draws (PSNR and SSIM
   within ``EVAL_PSNR_ATOL`` / ``EVAL_SSIM_ATOL``, each F1 within the
   bound its pixels that cross a level between the two paths allow); then
   2 warm-up and 10 timed eval steps (p50 ms, frames/s) and the peak memory.

TF32 is off for cuDNN and cuBLAS throughout (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32``), so that the float32 checks
compare full-float32 paths.

The line before the last is a JSON object with one entry per kernel (its
launches on its main path and on each path, its error against the plain
version, its time warm and with a cold L2, the plain time, the bound, the
library time and a yardstick's: per roundtrip for K1-K4, per train step for
K5 and K6, per eval step for K7 and K8); the last line is ``{"ok": true,
"device": {...}}``.
"""

import collections
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config
from vwfd_tpu_torch.attacks import quant_tables
from vwfd_tpu_torch.data import Loader, SyntheticVideoDataset
from vwfd_tpu_torch.attacks import attack_pool_video
from vwfd_tpu_torch.kernels import (PLAIN, _lib, coupling, f1, jpeg,
                                    launch_counts, mask, median,
                                    reset_launch_counts, ssim, transition,
                                    wire)
from vwfd_tpu_torch.metrics import DEFAULT_THRESHOLDS, threshold_level
from vwfd_tpu_torch.models.video_model import VideoWatermarkModel
from vwfd_tpu_torch.ops.squeeze import depth_to_space
from vwfd_tpu_torch.serving import WatermarkServer, unpack_mask_bits

# H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # non-tensor-core f32: the kernels' arithmetic
BF16_TC_OPS_PER_S = 989e12  # bf16 tensor-core flops: coupling_head's GEMM

# kernel vs plain tolerances, |kernel − plain| ≤ rtol·|plain| + atol·max|plain|
TOL = {torch.bfloat16: (2.0 ** -7, 1e-6),   # one bf16 ulp relative
       torch.float32: (1e-5, 1e-6)}
MASK_NEAR = 1e-6         # mask bits may differ only where |p − thr| < this
MEAN_ATOL = 1e-5         # tamper fraction
# slice vs the plain server (bf16, full width). Observed on an H100 SXM at
# 700 W: at most 1 level, 1 − 8e-8 of pixels equal, 2.6e-6 of mask bits
# differing (bf16 rounding differences amplified through the nets).
EMBED_MAX_LEVELS = 1     # watermarked uint8 within 1 level ...
EMBED_FRAC_EXACT = 0.9999  # ... and equal on ≥ 99.99% of pixels
MASK_DISAGREE = 1e-4     # mask bits disagreeing on < 0.01%

B, T, S = 16, 4, 256
COLD_BYTES = 100e6       # cold-L2 timing: working set of twice the L2
ROUNDTRIP_WIRE = ("to_channels", "to_u8_s2d")  # K3's launches per roundtrip
KERNEL_SOURCES = {
    "transition": ("vwfd_tpu_torch/csrc/transition.cu",
                   "vwfd_tpu/nets/inn_packed.py:75"),
    "coupling_head": ("vwfd_tpu_torch/csrc/coupling.cu",
                      "vwfd_tpu/nets/inn_packed.py:186"),
    "wire": ("vwfd_tpu_torch/csrc/wire.cu", "vwfd_tpu/serving.py:377"),
    "mask_pack": ("vwfd_tpu_torch/csrc/mask.cu", "vwfd_tpu/serving.py:82"),
    "jpeg_pair": ("vwfd_tpu_torch/csrc/jpeg.cu",
                  "vwfd_tpu/attacks/jpeg.py:183"),
    "median3": ("vwfd_tpu_torch/csrc/median.cu",
                "vwfd_tpu/ops/filters.py:76"),
    "f1_sweep": ("vwfd_tpu_torch/csrc/f1.cu",
                 "vwfd_tpu/metrics/metrics.py:96"),
    "ssim": ("vwfd_tpu_torch/csrc/ssim.cu", "vwfd_tpu/metrics/metrics.py:65"),
}
# one PyTorch call beside a kernel that computes a related, not the same,
# function (no single call computes the kernel's)
YARDSTICKS = {"coupling_head": "torch.cat + torch.matmul (the unfused head)",
              "wire": "Tensor.copy_ between the layouts of to_channels, "
                      "to_u8 and to_s2d",
              "ssim": "one depthwise 11x11 F.conv2d over the five stacked "
                      "windowed quantities"}
ROUNDTRIP_LAUNCHES = {"transition": 6, "coupling_head": 10, "wire": 2,
                      "mask_pack": 1, "jpeg_pair": 0, "median3": 0,
                      "f1_sweep": 0, "ssim": 0}
# K1: six maps forward and five backward (the entry map's input, the clip,
# takes no gradient)
TRAIN_LAUNCHES = {"transition": 11, "coupling_head": 10, "wire": 0,
                  "mask_pack": 0, "jpeg_pair": 2, "median3": 2,
                  "f1_sweep": 0, "ssim": 0}
# the eval step: the embed's six maps, the attack pool's forward only
EVAL_LAUNCHES = {"transition": 6, "coupling_head": 10, "wire": 0,
                 "mask_pack": 0, "jpeg_pair": 1, "median3": 1,
                 "f1_sweep": 1, "ssim": 1}
# the rows' main paths: each row is timed per launch of its path
ROW_PATH = {"jpeg_pair": "train_step", "median3": "train_step",
            "f1_sweep": "eval_step", "ssim": "eval_step"}
SSIM_FLOPS = 243  # per value: 2 passes x 5 sums x 11 FMA, products, map
# eval step, KERNELS vs PLAIN (bf16, full width): PSNR and SSIM within these
# (the embed differs by one level on < 0.01 % of pixels, F7; K8 sums the
# windows in another order); each F1 within 4·n/(2·tp + fp + fn), n the
# pixels whose prediction lies on the other side of that level's boundary
# on the two paths (each such pixel moves tp, fp or fn by one)
EVAL_PSNR_ATOL = 0.01
EVAL_SSIM_ATOL = 1e-4
JPEG_FLIP_ATOL = 1e-4    # K5 vs plain, outside flipped blocks ...
JPEG_FLIP_SHARE = 1e-4   # ... which are at most this share of all blocks
JPEG_FLIP_BOUND = 1.0    # and differ by at most this anywhere
TRAIN_LOSS_RTOL = 1e-2   # train step, KERNELS vs PLAIN, bf16
TRAIN_GRAD_COS = 0.999


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call: CUDA events around ``iters`` calls
    queued behind a ~50 ms device sleep, so that the host has enqueued them
    all before the first starts and a short kernel is not timed at the
    host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved, ops, ops_per_s=F32_OPS_PER_S):
    """Least time (ms) for the work: bytes over the memory rate vs
    operations over their type's peak rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want, dtype):
    """Max abs error and whether every element is within TOL[dtype]."""
    rtol, atol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max()) or 1.0
    ok = not bool((err > rtol * want.abs() + atol * scale).any())
    return float(err.max()), ok


class Row:
    """Per-kernel totals over one roundtrip's launches."""

    def __init__(self, name):
        self.name = name
        self.err = 0.0
        self.ms = self.plain_ms = 0.0
        self.library_ms = self.yardstick_ms = None
        self.cold_ms = None
        self.t_bytes = self.t_ops = 0.0  # ms at the memory / ops rate

    def add(self, ms, plain_ms, bytes_moved, ops, library_ms=None,
            ops_per_s=F32_OPS_PER_S, yardstick_ms=None, cold_ms=None):
        self.ms += ms
        self.plain_ms += plain_ms
        self.t_bytes += bound(bytes_moved, 0)[0]
        self.t_ops += ops / ops_per_s * 1e3
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms
        if yardstick_ms is not None:
            self.yardstick_ms = (self.yardstick_ms or 0.0) + yardstick_ms
        if cold_ms is not None:
            self.cold_ms = (self.cold_ms or 0.0) + cold_ms

    def json(self, by_path):
        b = max(self.t_bytes, self.t_ops)
        by = "bytes" if self.t_bytes >= self.t_ops else "operations"
        src, rep = KERNEL_SOURCES[self.name]
        path = ROW_PATH.get(self.name, "roundtrip")
        return {"name": self.name, "route": "cuda", "source": src,
                "replaces": rep, "launches": by_path[path][self.name],
                "launches_by_path": {k: v[self.name]
                                     for k, v in by_path.items()},
                "timed_per": path,
                "max_abs_err": self.err, "ms": self.ms,
                "cold_ms": self.cold_ms,
                "plain_ms": self.plain_ms, "bound_ms": b, "bound_by": by,
                "library_ms": self.library_ms,
                "yardstick_ms": self.yardstick_ms,
                "yardstick": YARDSTICKS.get(self.name)}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 3


def check_transition(rows, card):
    row = rows["transition"]
    dev = torch.device("cuda")
    g = torch.Generator("cuda").manual_seed(0)
    # the six maps of one flagship embed: entry, p2p, p2u and transposes
    walk = [("entry", (B, S, S, 3 * T)), ("p2p", (B, S // 4, S // 4, 192)),
            ("p2u", (B, S // 8, S // 8, 768))]
    for kind, shape in walk:
        for transpose in (False, True):
            src = transition.out_shape(shape, kind) if transpose else shape
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(src, device=dev, generator=g).to(dt)
                y = transition.transition(x, kind, transpose)
                ref = transition.transition_plain(x, kind, transpose)
                torch.cuda.synchronize()
                err, ok = rel_err(y, ref, dt)
                check(ok, f"transition {kind} T={transpose} {dt}: {err}")
                back = transition.transition(y, kind, not transpose)
                inv_err, inv_ok = rel_err(back, x, dt)
                check(inv_ok or (dt == torch.bfloat16
                                 and inv_err <= 2.0 ** -6 * float(x.abs().max())),
                      f"transition {kind} T={transpose} {dt} does not invert: "
                      f"{inv_err}")
                if dt != torch.bfloat16:
                    print(f"check transition {kind}{'T' if transpose else ''} "
                          f"f32 max_abs_err={err} inverse_err={inv_err}")
                    continue
                row.err = max(row.err, err)
                w = transition._fixed_weight(kind, x, transpose)
                s = transition._STRIDE[kind]
                xc = x.permute(0, 3, 1, 2)
                lib = (lambda: F.conv_transpose2d(xc, w, stride=s)) \
                    if transpose else (lambda: F.conv2d(xc, w, stride=s))
                ms = time_ms(lambda: transition.transition(x, kind, transpose))
                pms = time_ms(
                    lambda: transition.transition_plain(x, kind, transpose))
                lms = time_ms(lib)
                row.add(ms, pms, nbytes(x, y), 3 * y.numel(), lms)
                bms = bound(nbytes(x, y), 3 * y.numel())[0]
                print(f"check transition {kind}{'T' if transpose else ''} "
                      f"bf16 {tuple(x.shape)}->{tuple(y.shape)} "
                      f"max_abs_err={err} inverse_err={inv_err} ms={ms:.4f} "
                      f"plain_ms={pms:.4f} library_ms={lms:.4f} "
                      f"bound_ms={bms:.4f} share_of_bound={bms / ms:.3f} "
                      f"[{card}]")


def check_coupling(rows, card):
    row = rows["coupling_head"]
    dev = torch.device("cuda")
    g = torch.Generator("cuda").manual_seed(1)
    # (spatial, channels of z, launches per roundtrip): level 48 packed
    # (2 couplings), levels 192 packed and 768 unpacked (3 couplings); the
    # trunk width is 128
    levels = [((S // 4), 192, 4), ((S // 8), 768, 6)]
    for hw, cz, launches in levels:
        c = cz // 2
        k = c + 128
        for dt in (torch.float32, torch.bfloat16):
            z = torch.randn(B, hw, hw, cz, device=dev, generator=g).to(dt)
            h = torch.randn(B, hw, hw, 128, device=dev, generator=g).to(dt)
            p = {"wh": (torch.randn(cz, k, device=dev, generator=g)
                        / k ** 0.5).to(dt),
                 "bh": 0.1 * torch.randn(cz, device=dev, generator=g)}
            xin, x = z[..., c:], z[..., :c]
            for inverse in (False, True):
                out = torch.empty_like(z)
                ref = torch.empty_like(z)
                coupling.coupling_head(xin, h, p, x, out=out[..., :c],
                                       inverse=inverse)
                coupling.coupling_head_plain(xin, h, p, x, out=ref[..., :c],
                                             inverse=inverse)
                torch.cuda.synchronize()
                err, ok = rel_err(out[..., :c], ref[..., :c], dt)
                check(ok, f"coupling_head z={cz} inverse={inverse} {dt}: "
                      f"{err}")
                print(f"check coupling_head z={cz} inverse={inverse} {dt} "
                      f"max_abs_err={err}")
                if dt != torch.bfloat16:
                    continue
                row.err = max(row.err, err)
                if inverse:  # serving runs the forward only
                    continue
                o = out[..., :c]
                ms = time_ms(lambda: coupling.coupling_head(xin, h, p, x,
                                                            out=o))
                pms = time_ms(lambda: coupling.coupling_head_plain(
                    xin, h, p, x, out=o))
                cat_mm = time_ms(lambda: torch.matmul(
                    torch.cat([xin, h], -1).reshape(-1, k), p["wh"].t()))
                m = B * hw * hw
                moved = nbytes(xin, h, x, o, p["wh"], p["bh"])
                flops = 2 * m * k * cz
                row.add(launches * ms, launches * pms, launches * moved,
                        launches * flops, ops_per_s=BF16_TC_OPS_PER_S,
                        yardstick_ms=launches * cat_mm)
                bms, by = bound(moved, flops, BF16_TC_OPS_PER_S)
                print(f"check coupling_head z={cz} bf16 M={m} K={k} N={cz} "
                      f"ms={ms:.4f} plain_ms={pms:.4f} cat_matmul_ms="
                      f"{cat_mm:.4f} bound_ms={bms:.4f} ({by}) "
                      f"share_of_bound={bms / ms:.3f} (x{launches} per "
                      f"roundtrip) [{card}]")


def time_cold_ms(fn, input_sets, iters=None):
    """Mean device time of one call with a cold L2: the calls rotate over
    ``input_sets`` (together at least ``COLD_BYTES``, twice the H100's
    50 MB L2) and each call's outputs stay alive until its set comes round
    again, so no call finds its inputs or its output memory in L2."""
    n = len(input_sets)
    keep = collections.deque(maxlen=n - 1)
    iters = iters or max(20, 4 * n)

    def step(k):
        keep.append(fn(*input_sets[k % n]))
    for k in range(n):
        step(k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for k in range(iters):
        step(k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_sets(make, bytes_per_call):
    """Enough input sets from ``make(i)`` for ``time_cold_ms``."""
    return [make(i) for i in range(max(2, math.ceil(COLD_BYTES
                                                     / bytes_per_call)))]


def wire_inputs(b, h, w, dt, g):
    """A u8 clip and an INN output (b,h,w,3T) in [-0.2, 1.2] whose first
    quarter holds exact .5 ties x = fl((k + .5)/255) (their product with
    255 often rounds to k + .5 exactly in f32)."""
    clip = torch.randint(0, 256, (b, T, h, w, 3), device="cuda", generator=g,
                         dtype=torch.uint8)
    x = torch.rand(b, h, w, 3 * T, device="cuda", generator=g) * 1.4 - 0.2
    k = torch.arange(x.numel() // 4, device="cuda") % 255
    x.view(-1)[: k.numel()] = (k + 0.5) / 255.0
    return clip, x.to(dt)


def check_wire(rows, card):
    """K3: every map exact against its plain version, in f32 and bf16, on
    the tiled path (the flagship) and the general path (rows of 300 bytes);
    then each map timed at the flagship in bf16, warm and with a cold L2,
    beside its plain version and, for (a)-(c), a one-call copy yardstick."""
    row = rows["wire"]
    g = torch.Generator("cuda").manual_seed(2)
    for b, h, w in ((B, S, S), (2, 100, 100)):
        path = "tiled" if (3 * w) % 16 == 0 else "general"
        for dt in (torch.float32, torch.bfloat16):
            clip, x = wire_inputs(b, h, w, dt, g)
            flat = clip.reshape(b * T, h, w, 3)
            check(torch.equal(wire.to_channels(clip, dt),
                              wire.to_channels_plain(clip, dt)),
                  f"wire to_channels {path} {dt} differs")
            check(torch.equal(wire.to_s2d(flat, 2, dt),
                              wire.to_s2d_plain(flat, 2, dt)),
                  f"wire to_s2d {path} {dt} differs")
            check(torch.equal(wire.to_u8(x, T), wire.to_u8_plain(x, T)),
                  f"wire to_u8 {path} {dt} differs")
            u8, xs = wire.to_u8_s2d(x, T, 2)
            u8_ref, xs_ref = wire.to_u8_s2d_plain(x, T, 2)
            check(torch.equal(u8, u8_ref) and torch.equal(xs, xs_ref),
                  f"wire to_u8_s2d {path} {dt} differs")
            ties = int(((x.float().clamp(0, 1) * 255.0) % 1 == 0.5).sum())
            check(ties > 0, "no exact ties in the to_u8 input")
            print(f"check wire {path} {(b, T, h, w)} {dt} exact: to_channels "
                  f"to_u8 to_s2d to_u8_s2d (to_u8 inputs with {ties} exact "
                  f".5 ties)")

    dt = torch.bfloat16
    clip, x = wire_inputs(B, S, S, dt, g)
    flat = clip.reshape(B * T, S, S, 3)
    a = torch.empty(B, S, S, 3 * T, device="cuda", dtype=dt)
    u8 = torch.empty(B, T, S, S, 3, device="cuda", dtype=torch.uint8)
    c = torch.empty(B * T, S // 2, S // 2, 12, device="cuda", dtype=dt)
    maps = [
        ("to_channels", wire.to_channels, wire.to_channels_plain, (clip, dt),
         lambda: a.view(B, S, S, T, 3).copy_(clip.permute(0, 2, 3, 1, 4)),
         nbytes(clip, a), lambda i: wire_inputs(B, S, S, dt, g)[:1] + (dt,)),
        ("to_u8", wire.to_u8, wire.to_u8_plain, (x, T),
         lambda: u8.permute(0, 2, 3, 1, 4).copy_(x.view(B, S, S, T, 3)),
         nbytes(x, u8), lambda i: (wire_inputs(B, S, S, dt, g)[1], T)),
        ("to_s2d", wire.to_s2d, wire.to_s2d_plain, (flat, 2, dt),
         lambda: c.view(B * T, S // 2, S // 2, 2, 2, 3).copy_(
             flat.view(B * T, S // 2, 2, S // 2, 2, 3).permute(
                 0, 1, 3, 2, 4, 5)),
         nbytes(flat, c), lambda i: (wire_inputs(B, S, S, dt, g)[0].reshape(
             B * T, S, S, 3), 2, dt)),
        ("to_u8_s2d", wire.to_u8_s2d, wire.to_u8_s2d_plain, (x, T, 2),
         None, nbytes(x, u8, c),
         lambda i: (wire_inputs(B, S, S, dt, g)[1], T, 2)),
    ]
    for name, fn, plain, args, copy, moved, make in maps:
        ms = time_ms(lambda: fn(*args))
        cold = time_cold_ms(fn, cold_sets(make, moved))
        pms = time_ms(lambda: plain(*args))
        bms = bound(moved, 0)[0]
        copy_ms = time_ms(copy) if copy else None
        if name in ROUNDTRIP_WIRE:
            row.add(ms, pms, moved, 3 * x.numel(), cold_ms=cold)
        if copy_ms is not None:
            row.yardstick_ms = (row.yardstick_ms or 0.0) + copy_ms
        yard = (f" copy_yardstick_ms={copy_ms:.4f}" if copy else "")
        print(f"check wire {name} bf16 ms={ms:.4f} cold_ms={cold:.4f} "
              f"plain_ms={pms:.4f}{yard} bound_ms={bms:.4f} "
              f"share_of_bound={bms / ms:.3f} cold_share={bms / cold:.3f} "
              f"({'roundtrip' if name in ROUNDTRIP_WIRE else 'embed/detect-only'}"
              f" path) [{card}]")


def check_mask(rows, card):
    row = rows["mask_pack"]
    g = torch.Generator("cuda").manual_seed(3)

    def make_logits(dt):
        z = torch.randn(B * T, S // 2, S // 2, 4, device="cuda", generator=g)
        z.view(-1)[::97] = 0.0  # p == threshold exactly
        return z.to(dt)

    for dt in (torch.float32, torch.bfloat16):
        logits = make_logits(dt)
        m, frac = mask.mask_pack(logits, T, 2, 0.5)
        m_ref, frac_ref = mask.mask_pack_plain(logits, T, 2, 0.5)
        torch.cuda.synchronize()
        p = torch.sigmoid(depth_to_space(logits.float(), 2)).reshape(
            B, T, S, S, 1)
        near = ((p - 0.5).abs() < MASK_NEAR).cpu().numpy()
        differ = (unpack_mask_bits(m.cpu().numpy())
                  != unpack_mask_bits(m_ref.cpu().numpy()))
        check(not (differ & ~near).any(),
              f"mask_pack {dt}: bits differ away from the threshold")
        mean_err = float((frac - frac_ref).abs().max())
        check(mean_err <= MEAN_ATOL, f"mask_pack {dt}: mean err {mean_err}")
        again = mask.mask_pack(logits, T, 2, 0.5)[1]
        check(torch.equal(again, frac), f"mask_pack {dt}: tamper fraction "
              f"not repeatable")
        print(f"check mask_pack {dt} bits_differ={int(differ.sum())} "
              f"near_threshold={int(near.sum())} mean_err={mean_err} "
              f"(fraction bit-identical over repeated calls)")
        if dt == torch.bfloat16:
            row.err = mean_err
            moved = nbytes(logits, m, frac)
            ms = time_ms(lambda: mask.mask_pack(logits, T, 2, 0.5))
            cold = time_cold_ms(
                lambda z: mask.mask_pack(z, T, 2, 0.5),
                cold_sets(lambda i: (make_logits(dt),), moved))
            pms = time_ms(lambda: mask.mask_pack_plain(logits, T, 2, 0.5))
            row.add(ms, pms, moved, 6 * 4 * logits.numel(), cold_ms=cold)
            bms = bound(moved, 0)[0]
            print(f"check mask_pack bf16 ms={ms:.4f} cold_ms={cold:.4f} "
                  f"plain_ms={pms:.4f} bound_ms={bms:.4f} "
                  f"share_of_bound={bms / ms:.3f} cold_share={bms / cold:.3f}"
                  f" [{card}]")


def train_shape_input(g, levels=256):
    """64 frames of 256²×3 f32 on the 8-bit grid (``levels`` levels: few
    levels make ties common), as the attack pool sees them."""
    return torch.randint(0, levels, (B * T, S, S, 3), device="cuda",
                         generator=g).float() / 255.0


def fwd_bwd_ms(fn, x, cot):
    """Device ms of one forward and of one backward of ``fn`` at x."""
    xg = x.clone().requires_grad_(True)
    fwd = time_ms(lambda: fn(xg))
    y = fn(xg)
    bwd = time_ms(lambda: torch.autograd.grad(y, xg, cot,
                                              retain_graph=True))
    return fwd, bwd


def fwd_bwd_cold_ms(fn, make):
    """Device ms of one forward and of one backward of ``fn`` with a cold
    L2 (``time_cold_ms``), on fresh inputs ``make(i)`` -> (x, cotangent)."""
    xs = [make(i) for i in range(2)]  # each call moves ≥ 100 MB
    fwd = time_cold_ms(lambda v, c: fn(v), xs)
    graphs = []
    for v, c in xs:
        vg = v.clone().requires_grad_(True)
        graphs.append((fn(vg), vg, c))
    bwd = time_cold_ms(lambda y, vg, c: torch.autograd.grad(
        y, vg, c, retain_graph=True)[0], graphs)
    return fwd, bwd


def flipped_blocks(got, want, atol):
    """8×8 blocks (all channels) of NHWC frames where |got − want| > atol."""
    n, h, w, c = got.shape
    d = (got - want).abs().reshape(n, h // 8, 8, w // 8, 8, c)
    return int((d.amax(dim=(2, 4, 5)) > atol).sum()), n * (h // 8) * (w // 8)


def check_jpeg(rows, card):
    """K5 at the training shape: forward and input gradient against the
    plain version (autograd through the torch ops); every quality × mode
    pair among the 128 draws."""
    row = rows["jpeg_pair"]
    g = torch.Generator("cuda").manual_seed(4)
    n = B * T
    pairs = torch.arange(2 * n, device="cuda") % 15
    qt = quant_tables((pairs % 5).view(n, 2)).contiguous()
    mode = (pairs // 5).view(n, 2).to(torch.int32).contiguous()
    w = torch.softmax(torch.randn(n, 5, device="cuda", generator=g),
                      -1)[:, 1:3].contiguous()
    x = train_shape_input(g)
    cot = torch.randn(x.shape, device="cuda", generator=g)
    outs = []
    for fn in (jpeg.jpeg_pair, jpeg.jpeg_pool_pair_plain):
        xg = x.clone().requires_grad_(True)
        y = fn(xg, qt, mode, w)
        outs.append((y.detach(), torch.autograd.grad(y, xg, cot)[0]))
    torch.cuda.synchronize()
    (yk, gk), (yp, gp) = outs
    gscale = float(gp.abs().max())
    fb, blocks = flipped_blocks(yk, yp, JPEG_FLIP_ATOL)
    gfb, _ = flipped_blocks(gk, gp, JPEG_FLIP_ATOL * gscale)
    ok_y = (yk - yp).abs()
    err = float(ok_y.max())
    check(fb <= JPEG_FLIP_SHARE * blocks and gfb <= JPEG_FLIP_SHARE * blocks,
          f"jpeg_pair: {fb} / {gfb} of {blocks} blocks differ (forward / "
          f"gradient)")
    check(err <= JPEG_FLIP_BOUND, f"jpeg_pair: max err {err}")
    d = ok_y.reshape(n, S // 8, 8, S // 8, 8, 3).amax(dim=(2, 4, 5))
    calm = float(d[d <= JPEG_FLIP_ATOL].max()) if fb < blocks else 0.0
    row.err = err
    fn = lambda v: jpeg.jpeg_pair(v, qt, mode, w)  # noqa: E731
    pfn = lambda v: jpeg.jpeg_pool_pair_plain(v, qt, mode, w)  # noqa: E731
    kf, kb = fwd_bwd_ms(fn, x, cot)
    cf, cb = fwd_bwd_cold_ms(fn, lambda i: (
        train_shape_input(g), torch.randn(x.shape, device="cuda",
                                          generator=g)))
    pf, pb = fwd_bwd_ms(pfn, x, cot)
    fwd_bytes = nbytes(x, yk, qt, mode, w)
    bwd_bytes = nbytes(x, cot, gk, qt, mode, w)
    vals = x.numel()
    # per value: forward 2 transforms × 2 passes × 8 FMA + ~20 for colour,
    # quantisation and mix; backward 3 transforms + ~30
    fwd_ops, bwd_ops = vals * (64 + 20), vals * (96 + 30)
    row.add(kf + kb, pf + pb, fwd_bytes + bwd_bytes, fwd_ops + bwd_ops,
            cold_ms=cf + cb)
    bms = bound(fwd_bytes + bwd_bytes, fwd_ops + bwd_ops)[0]
    print(f"check jpeg_pair {tuple(x.shape)} f32 modes 0/1/2 x qualities "
          f"50..90: forward flipped_blocks={fb} gradient flipped_blocks="
          f"{gfb} of {blocks} (tol {JPEG_FLIP_ATOL}, share "
          f"{JPEG_FLIP_SHARE}); max_abs_err={err} (outside flipped blocks "
          f"{calm}); gradient max_abs_err={float((gk - gp).abs().max())} of "
          f"max {gscale}")
    print(f"check jpeg_pair ms fwd={kf:.4f} bwd={kb:.4f} cold fwd={cf:.4f} "
          f"bwd={cb:.4f} plain fwd={pf:.4f} bwd={pb:.4f} bound_ms={bms:.4f} "
          f"(fwd {bound(fwd_bytes, 0)[0]:.4f} + bwd "
          f"{bound(bwd_bytes, 0)[0]:.4f}) share_of_bound={bms / (kf + kb):.3f}"
          f" cold_share={bms / (cf + cb):.3f} [{card}]")


def median_both(x, cot):
    """(output, input gradient) of K6 and of its plain version at x."""
    outs = []
    for fn in (median.median3, median.median3_plain):
        xg = x.clone().requires_grad_(True)
        y = fn(xg)
        outs.append((y.detach(), torch.autograd.grad(y, xg, cot)[0]))
    torch.cuda.synchronize()
    return outs


def check_median(rows, card):
    """K6 at the training shape on inputs of 4 levels (ties everywhere):
    forward and input gradient EQUAL to the plain version's; then a small
    input with NaN pixels: NaN outputs at the same places, every other
    value and the whole gradient equal."""
    row = rows["median3"]
    g = torch.Generator("cuda").manual_seed(5)
    x = train_shape_input(g, levels=4)
    cot = torch.randn(x.shape, device="cuda", generator=g)
    (yk, gk), (yp, gp) = median_both(x, cot)
    check(torch.equal(yk, yp), "median3 forward differs from plain")
    check(torch.equal(gk, gp), "median3 gradient differs from plain")
    routed = float((gk != cot).float().mean())

    xn = torch.randint(0, 8, (2, 64, 64, 3), device="cuda",
                       generator=g).float() / 255.0
    xn.view(-1)[torch.randperm(xn.numel(), device="cuda",
                               generator=g)[:5]] = float("nan")
    cn = torch.randn(xn.shape, device="cuda", generator=g)
    (ynk, gnk), (ynp, gnp) = median_both(xn, cn)
    nan = torch.isnan(ynp)
    check(bool(nan.any()) and torch.equal(torch.isnan(ynk), nan)
          and torch.equal(ynk[~nan], ynp[~nan]),
          "median3 forward on NaN input differs from plain")
    check(torch.equal(gnk, gnp),
          "median3 gradient on NaN input differs from plain")
    print(f"check median3 {tuple(xn.shape)} f32 with 5 NaN values: "
          f"{int(nan.sum())} NaN outputs at the plain version's places, "
          f"other values and the gradient equal")

    kf, kb = fwd_bwd_ms(median.median3, x, cot)
    cf, cb = fwd_bwd_cold_ms(median.median3, lambda i: (
        train_shape_input(g, levels=4), torch.randn(x.shape, device="cuda",
                                                    generator=g)))
    pf, pb = fwd_bwd_ms(median.median3_plain, x, cot)
    fwd_bytes, bwd_bytes = nbytes(x, yk), nbytes(x, cot, gk)
    # 19 min/max pairs per value forward; recomputed + 9 compares and
    # up to 9 adds backward
    fwd_ops, bwd_ops = x.numel() * 38, x.numel() * (38 + 27)
    row.add(kf + kb, pf + pb, fwd_bytes + bwd_bytes, fwd_ops + bwd_ops,
            cold_ms=cf + cb)
    bms = bound(fwd_bytes + bwd_bytes, fwd_ops + bwd_ops)[0]
    print(f"check median3 {tuple(x.shape)} f32 4-level input: forward and "
          f"gradient equal to plain (gradient routed off the pixel itself "
          f"for {routed:.3f} of values); ms fwd={kf:.4f} bwd={kb:.4f} cold "
          f"fwd={cf:.4f} bwd={cb:.4f} plain fwd={pf:.4f} bwd={pb:.4f} "
          f"bound_ms={bms:.4f} share_of_bound={bms / (kf + kb):.3f} "
          f"cold_share={bms / (cf + cb):.3f} [{card}]")


LEVELS = [threshold_level(t) for t in np.float32(DEFAULT_THRESHOLDS)]


def eval_pred(g):
    """A prediction at the eval shape (64 frames of 256², f32) holding every
    k/255, its float32 neighbours and NaN pixels; the rest uniform."""
    p = torch.rand(B * T, S, S, 1, device="cuda", generator=g)
    k = torch.arange(256, device="cuda", dtype=torch.float32) / 255.0
    special = torch.cat([k, torch.nextafter(k, torch.full_like(k, 2.0)),
                         torch.nextafter(k, torch.full_like(k, -1.0)),
                         torch.full((64,), float("nan"), device="cuda")])
    idx = torch.randperm(p.numel(), device="cuda", generator=g)
    p.view(-1)[idx[:special.numel()]] = special
    return p


def eval_mask(g):
    return (torch.rand(B * T, S, S, 1, device="cuda", generator=g)
            < 0.3).float()


def check_f1(rows, card):
    """K7 at the eval shape: the counts EQUAL the plain version's (every
    k/255 boundary and NaN pixels), repeated calls equal; timed warm and
    with a cold L2 beside the plain version."""
    row = rows["f1_sweep"]
    g = torch.Generator("cuda").manual_seed(6)
    pred, gt = eval_pred(g), eval_mask(g)
    counts = f1.f1_sweep(pred, gt, LEVELS)
    ref = f1.f1_sweep_plain(pred, gt, LEVELS)
    torch.cuda.synchronize()
    check(torch.equal(counts, ref), f"f1_sweep counts {counts} plain {ref}")
    check(torch.equal(f1.f1_sweep(pred, gt, LEVELS), counts),
          "f1_sweep counts not repeatable")
    # an odd size off the 16-byte grid takes the scalar path
    odd_p, odd_g = pred.view(-1)[1:1 + 100_003], gt.view(-1)[1:1 + 100_003]
    check(torch.equal(f1.f1_sweep(odd_p, odd_g, LEVELS),
                      f1.f1_sweep_plain(odd_p, odd_g, LEVELS)),
          "f1_sweep counts differ on the scalar path")
    row.err = 0.0
    moved = nbytes(pred, gt, counts)
    ms = time_ms(lambda: f1.f1_sweep(pred, gt, LEVELS))
    cold = time_cold_ms(lambda p, m: f1.f1_sweep(p, m, LEVELS),
                        cold_sets(lambda i: (eval_pred(g), eval_mask(g)),
                                  moved))
    pms = time_ms(lambda: f1.f1_sweep_plain(pred, gt, LEVELS))
    ops = pred.numel() * (4 + 2 * len(LEVELS))  # 2 mul, 2 trunc, compares
    row.add(ms, pms, moved, ops, cold_ms=cold)
    bms, by = bound(moved, ops)
    print(f"check f1_sweep {tuple(pred.shape)} f32 x{len(LEVELS)} levels: "
          f"counts equal to plain (tp of the 0.5 level {int(counts[4, 0])}, "
          f"{int(torch.isnan(pred).sum())} NaN pixels); ms={ms:.4f} "
          f"cold_ms={cold:.4f} plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) "
          f"share_of_bound={bms / ms:.3f} cold_share={bms / cold:.3f} "
          f"[{card}]")


def ssim_pair(g):
    x = torch.rand(B * T, S, S, 3, device="cuda", generator=g)
    y = (x + 0.05 * torch.randn(x.shape, device="cuda", generator=g)).clamp(
        0, 1)
    y[:, :40, :40] = x[:, :40, :40] = 0.25  # flat: σ² cancels to ~0
    return x, y


def check_ssim(rows, card):
    """K8 at the eval shape: per-image means and the mean within
    ``ssim.ATOL`` of the plain version's, bit-identical over repeated calls;
    a ragged shape off the 16-byte grid on the scalar staging path; timed
    warm and with a cold L2 beside the plain version and the depthwise
    ``F.conv2d`` yardstick."""
    row = rows["ssim"]
    g = torch.Generator("cuda").manual_seed(7)
    x, y = ssim_pair(g)
    means, mean = ssim.ssim(x, y)
    pmeans, pmean = ssim.ssim_plain(x, y)
    torch.cuda.synchronize()
    err = max(float((means - pmeans).abs().max()), abs(float(mean - pmean)))
    check(err <= ssim.ATOL, f"ssim: err {err} > {ssim.ATOL}")
    again = ssim.ssim(x, y)
    check(torch.equal(again[0], means) and torch.equal(again[1], mean),
          "ssim not repeatable")
    xr, yr = x[:3, :37, :45].contiguous(), y[:3, :37, :45].contiguous()
    rerr = float((ssim.ssim(xr, yr)[0] - ssim.ssim_plain(xr, yr)[0]).abs()
                 .max())
    check(rerr <= ssim.ATOL, f"ssim ragged: err {rerr}")
    row.err = err
    moved = nbytes(x, y, means, mean)
    ms = time_ms(lambda: ssim.ssim(x, y))
    cold = time_cold_ms(ssim.ssim, cold_sets(lambda i: ssim_pair(g), moved))
    pms = time_ms(lambda: ssim.ssim_plain(x, y), iters=3, warmup=1)
    stacked = torch.cat([x, y, x * x, y * y, x * y], -1).permute(
        0, 3, 1, 2).contiguous()
    w = ssim.window_2d().to("cuda").expand(15, 1, 11, 11).contiguous()
    yard = time_ms(lambda: F.conv2d(stacked, w, padding=5, groups=15))
    ops = x.numel() * SSIM_FLOPS
    row.add(ms, pms, moved, ops, yardstick_ms=yard, cold_ms=cold)
    bms, by = bound(moved, ops)
    print(f"check ssim {tuple(x.shape)} f32: mean {float(mean):.6f}, max "
          f"abs err vs plain {err:.3g} (ragged 3x37x45: {rerr:.3g}; tol "
          f"{ssim.ATOL}), bit-identical over repeated calls; ms={ms:.4f} "
          f"cold_ms={cold:.4f} plain_ms={pms:.4f} conv2d_yardstick_ms="
          f"{yard:.4f} bound_ms={bms:.4f} ({by}) share_of_bound="
          f"{bms / ms:.3f} cold_share={bms / cold:.3f} [{card}]")


# ------------------------------------------------------------ phase 4


HEAD_PERTURB = 5e-4  # moves pixels by about 2 levels: a faint watermark


def perturbed_states(cfg, seed):
    """Random weights from ``seed`` with the zero-init coupling heads
    perturbed (``HEAD_PERTURB``·N(0,1)), so that the INN is not the
    identity. Larger heads saturate the random INN and turn the output
    into noise."""
    model = VideoWatermarkModel(cfg)
    states = model.init_states(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    netG = {}
    for k, v in states["netG"].items():
        if ".Conv_2." in k:
            v = v + HEAD_PERTURB * torch.randn(v.shape, generator=gen).to(
                v.device)
        netG[k] = v
    return {"netG": netG, "generator": states["generator"]}


def compare(got, want, what):
    """Kernel-served vs plain-served outputs of one request."""
    out = {}
    if "watermarked" in got.keys():
        d = np.abs(got.watermarked.astype(int) - want.watermarked.astype(int))
        exact = float((d == 0).mean())
        check(d.max() <= EMBED_MAX_LEVELS and exact >= EMBED_FRAC_EXACT,
              f"{what}: watermark differs by up to {d.max()} levels, "
              f"{exact:.6f} exact")
        out.update(embed_max_levels=int(d.max()), embed_exact=exact)
    if "mask_bits" in got.keys():
        dis = float((got.mask != want.mask).mean())
        check(dis < MASK_DISAGREE, f"{what}: mask bits disagree on {dis}")
        ferr = float(np.abs(got.tamper_fraction
                            - want.tamper_fraction).max())
        out.update(mask_disagree=dis, tamper_fraction_err=ferr)
    return out


def run_slice(card):
    cfg = load_config(FLAGSHIP_CONFIG)
    check((cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size,
           cfg.train.dtype) == (B, T, S, "bfloat16"), "flagship config")
    modes = ("embed", "detect", "roundtrip")
    states = perturbed_states(cfg, seed=7)
    server = WatermarkServer(cfg, weights=states, modes=modes)
    plain = WatermarkServer(cfg, weights=states, modes=modes, kernels=PLAIN)
    rng = np.random.default_rng(0)
    clips = [rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
             for _ in range(3)]
    server.serve(clips[0], "roundtrip").prefetch()  # warm up cuDNN/cuBLAS
    torch.cuda.synchronize()

    # the main path, with the launch counts at 0 just before
    reset_launch_counts()
    res = server.serve(clips[0], "roundtrip")
    res.prefetch()
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path launches per roundtrip: {json.dumps(launches)}")
    check(launches == ROUNDTRIP_LAUNCHES, f"launch counts {launches}")

    wm = res.watermarked
    check(wm.shape == (B, T, S, S, 3) and wm.dtype == np.uint8, "wm shape")
    check(res.mask_bits.shape == (B, T, S, S // 8), "mask shape")
    frac = res.tamper_fraction
    check(frac.shape == (B,) and np.isfinite(frac).all()
          and ((frac >= 0) & (frac <= 1)).all(), f"tamper_fraction {frac}")
    moved = np.abs(wm.astype(int) - clips[0].astype(int))
    print(f"slice roundtrip: watermark moves pixels by mean "
          f"{moved.mean():.4f} max {moved.max()} levels; tamper_fraction "
          f"{np.round(frac, 4).tolist()}")
    check(moved.max() > 0, "the perturbed INN left the clip unchanged")

    stats = {
        "roundtrip": compare(res, plain.serve(clips[0], "roundtrip"),
                             "roundtrip"),
        "roundtrip_2": compare(server.serve(clips[1], "roundtrip"),
                               plain.serve(clips[1], "roundtrip"),
                               "roundtrip 2"),
        "embed": compare(server.serve(clips[2], "embed"),
                         plain.serve(clips[2], "embed"), "embed"),
    }
    det = server.serve(wm, "detect")
    stats["detect"] = compare(det, plain.serve(wm, "detect"), "detect")
    check(np.array_equal(det.mask_bits, res.mask_bits),
          "detect(watermarked) differs from the roundtrip's mask")
    print(f"slice vs plain server: {json.dumps(stats)}")

    # a small f32 clip against the CPU plain path (the CPU tests' reference)
    small = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, gt_size=64),
        train=dataclasses.replace(cfg.train, dtype="float32"))
    w_small = perturbed_states(small, seed=11)
    clip = rng.integers(0, 256, (2, T, 64, 64, 3), dtype=np.uint8)
    gpu = WatermarkServer(small, weights=w_small, modes=("roundtrip",))
    cpu = WatermarkServer(small, device="cpu", weights=w_small,
                          modes=("roundtrip",))
    small_stats = compare(gpu.serve(clip, "roundtrip"),
                          cpu.serve(clip, "roundtrip"), "f32 card vs CPU")
    print(f"slice f32 64² card vs CPU plain path: {json.dumps(small_stats)}")
    return server, plain, clips, launches


# ------------------------------------------------------------ phase 5


def run_timing(server, plain, clips, card):
    def one(srv):
        r = srv.serve(clips[0], "roundtrip")
        return r.watermarked, r.mask_bits, r.tamper_fraction

    p50 = {}
    for name, srv in (("kernels", server), ("plain", plain)):
        for _ in range(3):
            one(srv)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            one(srv)
            times.append((time.perf_counter() - t0) * 1e3)
        p50[name] = float(np.percentile(times, 50))
    n = 24
    t0 = time.perf_counter()
    for r in server.serve_stream((clips[i % 3] for i in range(n)),
                                 "roundtrip", window=2):
        r.watermarked, r.mask_bits, r.tamper_fraction
    wall = time.perf_counter() - t0
    fps = n * B * T / wall
    print(f"roundtrip latency p50_ms={p50['kernels']:.3f} (plain versions "
          f"p50_ms={p50['plain']:.3f}); stream window=2 frames_per_s="
          f"{fps:.1f} over {n} requests of {B}x{T}x{S}x{S} [{card}]")
    print(json.dumps({"serving": {
        "roundtrip_p50_ms": p50["kernels"], "plain_roundtrip_p50_ms":
        p50["plain"], "stream_frames_per_s": fps, "batch": B, "frames": T,
        "size": S, "card": card}}))


# ------------------------------------------------------------ phase 6


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def snapshot(model):
    out = [t.clone() for net in model.nets().values()
           for t in list(net.parameters()) + list(net.buffers())]
    for opt in model.optimizers.values():
        out += [t.clone() for t in opt.mu + opt.nu + [opt.count]]
    return out


def run_train(card):
    cfg = load_config(FLAGSHIP_CONFIG)
    gc.collect()  # the peak counts this phase, not what earlier ones left
    torch.cuda.reset_peak_memory_stats()
    states = perturbed_states(cfg, seed=7)
    model = VideoWatermarkModel(cfg)
    model.load_states(states)
    plain = VideoWatermarkModel(cfg, kernels=PLAIN)
    plain.load_states(states)
    loader = Loader(SyntheticVideoDataset(size=S, frames=T, length=16 * B,
                                          seed=cfg.train.seed), B,
                    seed=cfg.train.seed)
    batches = [model.to_device(v, m) for v, m in loader]  # 16 batches
    prev, (video, mask_) = batches[0][0], batches[1]
    draws = model.sample_draws(B, T)

    # KERNELS vs PLAIN: loss terms and gradients from the same state
    res = {}
    for name, m in (("kernels", model), ("plain", plain)):
        loss, aux, grads, _ = m.loss_and_grads(video, mask_, prev, draws)
        res[name] = ({"loss": float(loss), "lF": float(aux["lF"]),
                      "lB": float(aux["lB"]), "PF": float(aux["PF"])}, grads)
    (lk, gk), (lp, gp) = res["kernels"], res["plain"]
    for k in ("loss", "lF", "lB"):
        check(abs(lk[k] - lp[k]) <= TRAIN_LOSS_RTOL * abs(lp[k]),
              f"train {k}: kernels {lk[k]} plain {lp[k]}")
    grad_stats = {}
    for net in gk:
        cos = cosine(torch.cat([t.flatten() for t in gk[net]]),
                     torch.cat([t.flatten() for t in gp[net]]))
        rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(gk[net], gp[net]))
        grad_stats[net] = {"cosine": cos, "max_rel_err_per_tensor": rel}
        check(cos >= TRAIN_GRAD_COS, f"train {net} gradient cosine {cos}")
    print(f"train step bf16 {B}x{T}x{S}x{S}: kernels {json.dumps(lk)} plain "
          f"{json.dumps(lp)}; gradients kernels vs plain "
          f"{json.dumps(grad_stats)}")

    # the main path, with the launch counts at 0 just before
    torch.cuda.synchronize()
    reset_launch_counts()
    logs = model.train_step(video, mask_, prev, draws)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path launches per train step: {json.dumps(launches)}")
    check(launches == TRAIN_LAUNCHES, f"train launch counts {launches}")
    first = {k: float(v) for k, v in logs.items()}
    check(all(math.isfinite(v) for v in first.values()), f"train {first}")
    check(first["PF"] > 30.0, f"train PF {first['PF']}")

    # 2 warm-up and 10 timed steps, each on the batch after its prev
    times, all_logs = [], [first]
    for i in range(2, 14):
        p, (v, m) = batches[i - 1][0], batches[i]
        t0 = time.perf_counter()
        out = model.train_step(v, m, p)
        torch.cuda.synchronize()
        if i >= 4:
            times.append((time.perf_counter() - t0) * 1e3)
        all_logs.append({k: float(x) for k, x in out.items()})
    finite = all(math.isfinite(x) for lg in all_logs for x in lg.values())
    check(finite, f"train losses {all_logs}")
    p50 = float(np.percentile(times, 50))
    fps = B * T / p50 * 1e3
    print(f"train steps: {len(all_logs)} finite losses, last "
          f"{json.dumps(all_logs[-1])}")

    # the non-finite guard: a NaN pixel leaves every state as it was
    before = snapshot(model)
    bad = batches[14][0].clone()
    bad[0, 0, 5, 7, 1] = float("nan")
    logs = model.train_step(bad, batches[14][1], batches[13][0])
    torch.cuda.synchronize()
    kept = all(torch.equal(a, b) for a, b in zip(snapshot(model), before))
    check(not math.isfinite(float(logs["loss"])) and kept,
          f"guard: loss {float(logs['loss'])}, state kept {kept}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train guard: a batch with a NaN pixel gives loss "
          f"{float(logs['loss'])} and keeps every parameter, moment, step "
          f"count and running statistic ({len(before)} tensors)")
    print(f"train step p50_ms={p50:.3f} frames_per_s={fps:.1f} over "
          f"{len(times)} timed steps of {B}x{T}x{S}x{S} bf16 (2 warm-up); "
          f"peak memory {peak:.2f} GiB [{card}]")
    print(json.dumps({"training": {
        "train_step_p50_ms": p50, "frames_per_s": fps,
        "timed_steps": len(times), "peak_memory_gib": peak, "batch": B,
        "frames": T, "size": S, "loss_terms": {"kernels": lk, "plain": lp},
        "gradients": grad_stats, "card": card}}))
    return launches


# ------------------------------------------------------------ phase 7


def eval_preds(model, video, mask_, prev, draws):
    """The eval step's prediction, rebuilt from its public parts."""
    with torch.no_grad():
        fwd = model.embed(video)
        attacked = attack_pool_video(fwd * (1.0 - mask_) + prev * mask_,
                                     draws, model.attack_ratios,
                                     model.kernels).clamp(0.0, 1.0)
        return model.predict_mask(attacked)


def f1_bounds(pk, pp, gt):
    """Per level, ``4·n/(2·tp + fp + fn)`` with ``n`` the pixels whose
    predictions lie on the two sides of the level on the two paths; and the
    ``n``."""
    pkl, ppl = torch.trunc(pk * 255.0), torch.trunc(pp * 255.0)
    g = gt > 0.5
    out, flips = [], []
    for t in LEVELS:
        on = pkl > t
        n = int(((pkl > t) != (ppl > t)).sum())
        denom = 2 * int((on & g).sum()) + int((on ^ g).sum())
        out.append(4.0 * n / max(denom, 1))
        flips.append(n)
    return out, flips


def run_eval(card):
    """The flagship eval step at full width through KERNELS, with the
    launch counts at 0 just before and read just after; KERNELS against
    PLAIN on the same weights, batch, previous batch and draws; then 2
    warm-up and 10 timed steps."""
    cfg = load_config(FLAGSHIP_CONFIG)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    states = perturbed_states(cfg, seed=7)
    model = VideoWatermarkModel(cfg)
    model.load_states(states)
    plain = VideoWatermarkModel(cfg, kernels=PLAIN)
    plain.load_states(states)
    loader = Loader(SyntheticVideoDataset(size=S, frames=T, length=14 * B,
                                          seed=cfg.train.seed), B,
                    seed=cfg.train.seed)
    batches = [model.to_device(v, m) for v, m in loader]  # 14 batches
    prev, (video, mask_) = batches[0][0], batches[1]
    draws = model.sample_draws(B, T)
    model.eval_step(video, mask_, prev, draws)  # warm up cuDNN/cuBLAS
    torch.cuda.synchronize()

    # the main path, with the launch counts at 0 just before
    reset_launch_counts()
    out_k = model.eval_step(video, mask_, prev, draws)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path launches per eval step: {json.dumps(launches)}")
    check(launches == EVAL_LAUNCHES, f"eval launch counts {launches}")

    out_p = plain.eval_step(video, mask_, prev, draws)
    mk = {k: v.tolist() for k, v in out_k.items()}
    mp = {k: v.tolist() for k, v in out_p.items()}
    check(all(np.isfinite(np.asarray(v)).all() for v in mk.values()),
          f"eval metrics {mk}")
    check(mk["psnr_forward"] > 30.0 and 0.0 < mk["ssim_forward"] <= 1.0
          and 0.0 <= mk["f1_best"] <= 1.0, f"eval metrics {mk}")
    dpsnr = abs(mk["psnr_forward"] - mp["psnr_forward"])
    dssim = abs(mk["ssim_forward"] - mp["ssim_forward"])
    check(dpsnr <= EVAL_PSNR_ATOL, f"eval psnr kernels {mk} plain {mp}")
    check(dssim <= EVAL_SSIM_ATOL, f"eval ssim kernels {mk} plain {mp}")
    bounds, flips = f1_bounds(eval_preds(model, video, mask_, prev, draws),
                              eval_preds(plain, video, mask_, prev, draws),
                              mask_)
    df1 = [abs(a - b) for a, b in zip(mk["f1_sweep"], mp["f1_sweep"])]
    check(all(d <= b + 1e-6 for d, b in zip(df1, bounds)),
          f"eval f1 kernels {mk['f1_sweep']} plain {mp['f1_sweep']} "
          f"bounds {bounds}")
    print(f"eval step bf16 {B}x{T}x{S}x{S}: kernels {json.dumps(mk)} plain "
          f"{json.dumps(mp)}; |dpsnr| {dpsnr:.3g} dB (tol "
          f"{EVAL_PSNR_ATOL}), |dssim| {dssim:.3g} (tol {EVAL_SSIM_ATOL}), "
          f"|df1| per level {[round(d, 8) for d in df1]} within "
          f"{[round(b, 8) for b in bounds]} (pixels across a level "
          f"between the paths {flips} of {video.numel() // 3})")

    times, psnrs = [], []
    for i in range(2, 14):
        p, (v, m) = batches[i - 1][0], batches[i]
        t0 = time.perf_counter()
        out = model.eval_step(v, m, p)
        torch.cuda.synchronize()
        if i >= 4:
            times.append((time.perf_counter() - t0) * 1e3)
        psnrs.append(float(out["psnr_forward"]))
    check(all(math.isfinite(x) for x in psnrs), f"eval psnr {psnrs}")
    p50 = float(np.percentile(times, 50))
    fps = B * T / p50 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"eval step p50_ms={p50:.3f} frames_per_s={fps:.1f} over "
          f"{len(times)} timed steps of {B}x{T}x{S}x{S} bf16 (2 warm-up); "
          f"peak memory {peak:.2f} GiB [{card}]")
    print(json.dumps({"eval": {
        "eval_step_p50_ms": p50, "frames_per_s": fps,
        "timed_steps": len(times), "peak_memory_gib": peak, "batch": B,
        "frames": T, "size": S, "metrics": {"kernels": mk, "plain": mp},
        "f1_flips_per_level": flips, "card": card}}))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        sys.exit(2)
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    _lib.load()
    built = ("already built" if _lib.build_seconds is None
             else f"nvcc {_lib.build_seconds:.1f} s")
    print(f"build: {_lib.library_path().name} loaded in "
          f"{time.perf_counter() - t0:.1f} s ({built})")

    rows = {n: Row(n) for n in KERNEL_SOURCES}
    check_transition(rows, card)
    check_coupling(rows, card)
    check_wire(rows, card)
    check_mask(rows, card)
    check_jpeg(rows, card)
    check_median(rows, card)
    check_f1(rows, card)
    check_ssim(rows, card)
    errs = {n: r.err for n, r in rows.items()}
    print(f"kernels max_abs_err (bf16 vs plain): {json.dumps(errs)}")

    server, plain, clips, launches = run_slice(card)
    run_timing(server, plain, clips, card)
    del server, plain
    train_launches = run_train(card)
    eval_launches = run_eval(card)

    by_path = {"roundtrip": launches, "train_step": train_launches,
               "eval_step": eval_launches}
    print(json.dumps({"kernels": [rows[n].json(by_path)
                                  for n in KERNEL_SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
