"""K20 ``crop_cubic`` and K21 ``rectify`` (forward, backward) and K22
``ssim_grad`` timed on the card, each launch apart, at CLR's step shapes.

    python port_tools/time_clr_kernels.py [--root DIR] [--label NAME]
        [--reps 20] [--only crop_cubic,rectify,ssim_grad] [--out FILE]

Imports ``vwfd_tpu_torch`` from ``--root`` (default: this checkout; an
earlier commit unpacked with ``git archive`` times that commit's kernels in
the same call), builds its kernels and measures, at the 256² b8 train
step's shapes (K21: 48 copies against 8 clean images; K22: (8, 256, 256,
3)) and the 512² b3 record's (K21: 9 copies against 3; K22: (3, 512, 512,
3)):

- K21's forward and its backward under autograd (whatever the tree's
  backward is: the kernel, or PyTorch ops in a tree without one), and the
  backward's PyTorch ops (``g·inside`` summed per clean image) as a
  function of their own: ms warm (CUDA events around ``--reps`` calls
  queued behind a device sleep) and with a cold L2 (the calls rotate over
  inputs of at least 100 MB, twice the L2);
- K22 the same way, called as ``ssim_grad.ssim_grad``;
- K20's forward and its backward under autograd at the train step's (8,
  256, 256, 3) and the record's (3, 512, 512, 3), the window chip_smoke.py
  times and two narrow ones, warm and cold, by profiler op and bytes
  beyond the output; the forward ``torch.equal`` to the plain version,
  the gradient's max |Δ| over the plain gradient's max, both outputs
  bit-identical over two calls, and a SHA-256 of the gradient's bytes
  (equal digests in two trees' lines: bit-equal gradients);
- each device operation's ms per call under ``torch.profiler`` and its
  count per call; the bytes a call allocates beyond its output; for K20's
  backward, 1,000 calls timed each apart (min, p10, median, p90, max) and
  the SM clock ``nvidia-smi`` samples meanwhile;
- the outputs against the plain versions: K21's forward ``torch.equal``,
  its gradient's and K22's max |Δ| over the plain gradient's max.

Prints one JSON line per kernel and shape (and appends it to ``--out``)
with the card's name and power limit. Needs one CUDA card and ``nvcc``. A
measurement tool, not part of the package: nothing imports it.
"""

import argparse
import collections
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

# (clean images, copies of each, size, window) as chip_smoke.py's
# check_rectify times them; K22's shapes are the clean batches'
RECT_CASES = [(8, 6, 256, (10.0, 230.0, 3.0, 256.0)),
              (3, 3, 512, (31.0, 480.0, 0.0, 400.0))]
COLD_BYTES = 100e6


def time_ms(fn, iters, warmup=3):
    """Mean device ms of one call: events around ``iters`` calls queued
    behind a device sleep."""
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


def per_call_ms(fn, calls):
    """Each of ``calls`` calls' device ms (events between calls queued
    behind a device sleep), and the SM clock in MHz as ``nvidia-smi``
    samples it every 20 ms meanwhile."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    try:
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        smi = None
    time.sleep(0.5)  # its first sample
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for k in range(calls):
        fn()
        ev[k + 1].record()
    ev[-1].synchronize()
    time.sleep(0.05)
    clocks = []
    if smi is not None:
        smi.terminate()
        clocks = [int(v) for v in smi.communicate()[0].split()
                  if v.isdigit()]
    ms = sorted(ev[k].elapsed_time(ev[k + 1]) for k in range(calls))
    return {"min": ms[0], "p10": ms[calls // 10], "median": ms[calls // 2],
            "p90": ms[calls * 9 // 10], "max": ms[-1],
            "sm_clock_mhz": clocks}


def time_cold_ms(fn, sets, iters):
    """Mean device ms of one call rotating over ``sets``, each call's
    output alive until its set comes round again."""
    n = len(sets)
    keep = collections.deque(maxlen=n - 1)
    for k in range(n):
        keep.append(fn(*sets[k]))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    count = max(iters, 4 * n)
    for k in range(count):
        keep.append(fn(*sets[k % n]))
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def by_op(fn, reps):
    """Each device operation's ms and count per call of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, count = ops.get(e.name, (0.0, 0))
        ops[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return {k[:80]: {"ms": ms / reps, "per_call": count / reps}
            for k, (ms, count) in sorted(ops.items(),
                                         key=lambda kv: -kv[1][0])}


def extra_bytes(fn):
    """Peak bytes a call allocates beyond what it returns."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - base
    return torch.cuda.max_memory_allocated() - base - kept, out


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def rect_inputs(g, b, reps, s):
    att = torch.rand((b * reps, s, s, 3), device="cuda", generator=g) * 1.2 \
        - 0.1
    return att, torch.rand((b, s, s, 3), device="cuda", generator=g)


def measure_rectify(rectify, rect_mask, case, reps_t):
    b, reps, s, apex = case
    g = torch.Generator("cuda").manual_seed(76)
    att, clean = rect_inputs(g, b, reps, s)
    ap = torch.tensor(apex, device="cuda")
    cot = torch.randn(att.shape, device="cuda", generator=g)
    inside = rect_mask((s, s), ap.unbind())[..., None]

    def ops(gv):
        return (gv * inside).reshape(reps, b, s, s, 3).sum(0)

    cg = clean.clone().requires_grad_(True)
    y = rectify.rectify(att, cg, ap)
    gk, = torch.autograd.grad(y, cg, cot, retain_graph=True)
    yp = rectify.rectify_plain(att, clean, ap)
    gp = ops(cot)
    fwd = time_ms(lambda: rectify.rectify(att, clean, ap), reps_t)
    bwd = time_ms(lambda: torch.autograd.grad(y, cg, cot, retain_graph=True),
                  reps_t)
    ops_ms = time_ms(lambda: ops(cot), reps_t)
    moved = 2 * att.numel() * 4 + clean.numel() * 4
    n_sets = max(2, math.ceil(COLD_BYTES / moved))
    sets = [rect_inputs(g, b, reps, s) for _ in range(n_sets)]
    cold_fwd = time_cold_ms(lambda a, c: rectify.rectify(a, c, ap), sets,
                            reps_t)
    graphs = []
    for a, c in sets:
        c = c.requires_grad_(True)
        graphs.append((rectify.rectify(a, c, ap), c, torch.randn(
            a.shape, device="cuda", generator=g)))
    cold_bwd = time_cold_ms(lambda o, c, gv: torch.autograd.grad(
        o, c, gv, retain_graph=True), graphs, reps_t)
    cold_ops = time_cold_ms(lambda o, c, gv: ops(gv), graphs, reps_t)
    del graphs, sets
    fwd_extra, _ = extra_bytes(lambda: rectify.rectify(att, clean, ap))
    bwd_extra, _ = extra_bytes(lambda: torch.autograd.grad(
        y, cg, cot, retain_graph=True))
    return {
        "kernel": "rectify", "copies": b * reps, "clean": b, "size": s,
        "apex": list(apex), "fwd_ms": fwd, "cold_fwd_ms": cold_fwd,
        "bwd_ms": bwd, "cold_bwd_ms": cold_bwd,
        "bwd_pytorch_ops_ms": ops_ms, "cold_bwd_pytorch_ops_ms": cold_ops,
        "fwd_by_op": by_op(lambda: rectify.rectify(att, clean, ap), reps_t),
        "bwd_by_op": by_op(lambda: torch.autograd.grad(
            y, cg, cot, retain_graph=True), reps_t),
        "fwd_extra_bytes": fwd_extra, "bwd_extra_bytes": bwd_extra,
        "fwd_equal_plain": bool(torch.equal(y, yp)),
        "grad_err_of_plain_max": float((gk - gp).abs().max())
        / float(gp.abs().max())}


def ssim_inputs(g, shape):
    img = torch.rand(shape, device="cuda", generator=g)
    x1 = (img + 0.01 * torch.randn(shape, device="cuda", generator=g)
          ).clamp(0, 1)
    x1[:, 40:120, 30:200] = img[:, 40:120, 30:200] = 0.25
    return x1, img


def measure_ssim_grad(ssim_grad, shape, reps_t):
    g = torch.Generator("cuda").manual_seed(77)
    x1, img = ssim_inputs(g, shape)
    sc = ssim_grad.scale_of(torch.zeros(shape[0], device="cuda"),
                            torch.ones((), device="cuda"), shape)
    gk = ssim_grad.ssim_grad(x1, img, sc)
    gk2 = ssim_grad.ssim_grad(x1, img, sc)
    gp = ssim_grad.ssim_grad_plain(x1, img, sc)
    ms = time_ms(lambda: ssim_grad.ssim_grad(x1, img, sc), reps_t)
    moved = 3 * x1.numel() * 4
    sets = [ssim_inputs(g, shape)
            for _ in range(max(2, math.ceil(COLD_BYTES / moved)))]
    cold = time_cold_ms(lambda a, b: ssim_grad.ssim_grad(a, b, sc), sets,
                        reps_t)
    del sets
    extra, _ = extra_bytes(lambda: ssim_grad.ssim_grad(x1, img, sc))
    return {"kernel": "ssim_grad", "shape": list(shape), "ms": ms,
            "cold_ms": cold,
            "by_op": by_op(lambda: ssim_grad.ssim_grad(x1, img, sc), reps_t),
            "extra_bytes": extra, "dx_bytes": x1.numel() * 4,
            "bit_identical": bool(torch.equal(gk, gk2)),
            "grad_err_of_plain_max": float((gk - gp).abs().max())
            / float(gp.abs().max())}


# (images, size, window) as chip_smoke.py's check_crop_cubic times them,
# a one-pixel window (every output taps one pixel) and a 30-column one (30
# pixels of about 34 column terms each): the backward's path for pixels
# with more terms than it keeps in registers
CUBIC_CASES = [(8, 256, (10.0, 230.0, 3.0, 256.0)),
               (3, 512, (31.0, 480.0, 0.0, 400.0)),
               (8, 256, (100.0, 101.0, 7.0, 8.0)),
               (8, 256, (10.0, 250.0, 100.0, 130.0))]


def measure_crop_cubic(crop_cubic, case, reps_t):
    b, s, apex = case
    g = torch.Generator("cuda").manual_seed(75)
    shape = (b, s, s, 3)

    def inputs():
        return (torch.rand(shape, device="cuda", generator=g) * 1.2 - 0.1,
                torch.randn(shape, device="cuda", generator=g))
    x, cot = inputs()
    ap = torch.tensor(apex, device="cuda")

    def grad_of(v, gv):
        vg = v.clone().requires_grad_(True)
        y = crop_cubic.crop_cubic(vg, ap)
        return y, torch.autograd.grad(y, vg, gv)[0]
    yk, gk = grad_of(x, cot)
    yk2, gk2 = grad_of(x, cot)
    xp = x.clone().requires_grad_(True)
    yp = crop_cubic.crop_cubic_plain(xp, ap)
    gp, = torch.autograd.grad(yp, xp, cot)
    xg = x.clone().requires_grad_(True)
    y = crop_cubic.crop_cubic(xg, ap)
    fwd = time_ms(lambda: crop_cubic.crop_cubic(x, ap), reps_t)
    bwd = time_ms(lambda: torch.autograd.grad(y, xg, cot, retain_graph=True),
                  reps_t)
    sets = [inputs() for _ in range(max(2, math.ceil(
        COLD_BYTES / (2 * x.numel() * 4))))]
    cold_fwd = time_cold_ms(lambda v, c: crop_cubic.crop_cubic(v, ap), sets,
                            reps_t)
    graphs = []
    for v, c in sets:
        v = v.requires_grad_(True)
        graphs.append((crop_cubic.crop_cubic(v, ap), v, c))
    cold_bwd = time_cold_ms(lambda o, v, c: torch.autograd.grad(
        o, v, c, retain_graph=True), graphs, reps_t)
    del graphs, sets
    fwd_extra, _ = extra_bytes(lambda: crop_cubic.crop_cubic(x, ap))
    bwd_extra, _ = extra_bytes(lambda: torch.autograd.grad(
        y, xg, cot, retain_graph=True))
    digest = hashlib.sha256(gk.cpu().numpy().tobytes()).hexdigest()
    return {
        "kernel": "crop_cubic", "shape": list(shape), "apex": list(apex),
        "fwd_ms": fwd, "cold_fwd_ms": cold_fwd, "bwd_ms": bwd,
        "cold_bwd_ms": cold_bwd,
        "fwd_by_op": by_op(lambda: crop_cubic.crop_cubic(x, ap), reps_t),
        "bwd_by_op": by_op(lambda: torch.autograd.grad(
            y, xg, cot, retain_graph=True), reps_t),
        "bwd_per_call_ms": per_call_ms(lambda: torch.autograd.grad(
            y, xg, cot, retain_graph=True), 1000),
        "fwd_extra_bytes": fwd_extra, "bwd_extra_bytes": bwd_extra,
        "fwd_equal_plain": bool(torch.equal(yk, yp)),
        "bit_identical": bool(torch.equal(yk, yk2) and torch.equal(gk, gk2)),
        "grad_err_of_plain_max": float((gk - gp).abs().max())
        / float(gp.abs().max()),
        "grad_sha256": digest}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="crop_cubic,rectify,ssim_grad")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        sys.exit("time_clr_kernels: needs a CUDA card")
    sys.path.insert(0, str(args.root.resolve()))
    from vwfd_tpu_torch.attacks.spatial import rect_mask
    from vwfd_tpu_torch.kernels import _lib, crop_cubic, rectify, ssim_grad
    _lib.load()
    name = card()
    recs = []
    if "crop_cubic" in only:
        recs += [measure_crop_cubic(crop_cubic, c, args.reps)
                 for c in CUBIC_CASES]
    if "rectify" in only:
        recs += [measure_rectify(rectify, rect_mask, c, args.reps)
                 for c in RECT_CASES]
    if "ssim_grad" in only:
        recs += [measure_ssim_grad(ssim_grad, (b, s, s, 3), args.reps)
                 for b, _, s, _ in RECT_CASES]
    for rec in recs:
        line = json.dumps({"label": args.label or str(args.root),
                           "card": name, **rec})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
