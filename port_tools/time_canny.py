"""K19 ``canny_soft`` timed on the card, whole and by device operation.

    python port_tools/time_canny.py [--root DIR] [--label NAME] [--reps 20]
        [--out FILE]

Imports ``vwfd_tpu_torch`` from ``--root`` (default: this checkout; an
earlier commit unpacked with ``git archive`` times that commit's K19 in the
same call), builds its kernels, and at the PAMI step's (48, 256, 256, 3)
and the PAMI-512 record's (9, 512, 512, 3), on 8-bit-level images (the
check's ``levels`` input) with a normal cotangent, measures:

- forward and backward ms, warm (CUDA events around ``--reps`` calls queued
  behind a device sleep) and with a cold L2 (the calls rotate over inputs
  of at least 100 MB, twice the L2);
- each device operation's ms per call under ``torch.profiler`` (kernels
  and memsets by name, ``--reps`` forward + backward pairs after 3 warm-up
  pairs), and their count per call;
- the bytes a forward under grad leaves allocated beyond its input, and
  the backward's peak beyond what was allocated before it.

Prints one JSON line per shape (and appends it to ``--out``) with the
card's name and power limit. Needs one CUDA card and ``nvcc``. A
measurement tool, not part of the package: nothing imports it.
"""

import argparse
import collections
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

SHAPES = [(48, 256, 256, 3), (9, 512, 512, 3)]
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
    for k in range(max(iters, 4 * n)):
        keep.append(fn(*sets[k % n]))
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / max(iters, 4 * n)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def levels(shape, g):
    return torch.randint(0, 256, shape, device="cuda",
                         generator=g).float() / 255.0


def measure(canny, shape, reps):
    g = torch.Generator("cuda").manual_seed(71)
    x = levels(shape, g).requires_grad_()
    cot = torch.randn(shape[:3] + (1,), device="cuda", generator=g)
    fwd = time_ms(lambda: canny.canny_soft(x), reps)
    y = canny.canny_soft(x)
    bwd = time_ms(lambda: torch.autograd.grad(y, x, cot, retain_graph=True),
                  reps)

    moved = x.numel() * 4 * 2 + cot.numel() * 4 * 2
    sets = [(levels(shape, g).requires_grad_(),
             torch.randn(cot.shape, device="cuda", generator=g))
            for _ in range(max(2, math.ceil(COLD_BYTES / moved)))]
    cold_fwd = time_cold_ms(lambda v, c: canny.canny_soft(v), sets, reps)
    graphs = [(canny.canny_soft(v), v, c) for v, c in sets]
    cold_bwd = time_cold_ms(lambda o, v, c: torch.autograd.grad(
        o, v, c, retain_graph=True), graphs, reps)
    del graphs, sets

    for _ in range(3):
        torch.autograd.grad(canny.canny_soft(x), x, cot)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.autograd.grad(canny.canny_soft(x), x, cot)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, count = ops.get(e.name, (0.0, 0))
        ops[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    by_op = {k[:80]: {"ms": ms / reps, "per_call": count / reps}
             for k, (ms, count) in sorted(ops.items(),
                                          key=lambda kv: -kv[1][0])}

    del y
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = canny.canny_soft(x)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (dx,) = torch.autograd.grad(y, x, cot)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return {"shape": list(shape), "fwd_ms": fwd, "bwd_ms": bwd,
            "ms": fwd + bwd, "cold_fwd_ms": cold_fwd,
            "cold_bwd_ms": cold_bwd, "cold_ms": cold_fwd + cold_bwd,
            "profiled_ms_by_op": by_op,
            "profiled_ms": sum(v["ms"] for v in by_op.values()),
            "fwd_kept_bytes": kept, "bwd_peak_bytes": peak,
            "y_bytes": y.numel() * 4, "dx_bytes": dx.numel() * 4}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_canny: needs a CUDA card")
    sys.path.insert(0, str(args.root.resolve()))
    from vwfd_tpu_torch.kernels import _lib, canny
    _lib.load()
    name = card()
    for shape in SHAPES:
        rec = {"label": args.label or str(args.root), "card": name,
               **measure(canny, shape, args.reps)}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
