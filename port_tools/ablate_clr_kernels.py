"""K20 ``crop_cubic``, K21 ``rectify`` and K22 ``ssim_grad`` built and
launched in other forms, timed beside the committed ones on the card.

    python port_tools/ablate_clr_kernels.py [--reps 20]
        [--only crop,rect,ssim] [--out FILE]

Needs one CUDA card and ``nvcc``. Compiles ``crop_cubic.cu``,
``rectify.cu`` and ``ssim_grad.cu`` into libraries of their own under
``build/ablate_clr_kernels/``, each with the ``-D`` flags of a form:

- K20 as committed (``crop_base``: the forward's next row's loads issued
  before this row's column pass), with those loads in the phase that uses
  them (``crop_no_prefetch``, ``-DVWFD_CROP_PREFETCH=0``), with every
  pixel's column sums formed by the CTA in shared memory, none in
  registers (``crop_smem_gt``, ``-DVWFD_CROP_SMEM_GT=1``), and with phases
  cut out (``-DVWFD_CROP_CUT``: ``crop_cut_fwd_loads`` (the row pass's
  loads), ``_fwd_column`` (the column pass), ``_fwd_all``,
  ``_bwd_transpose`` (the column transpose, gt, with its loads of g),
  ``_bwd_all`` (the accumulation too)); the forward at bands of 4 and 8
  output rows, the backward at 4, 8 and 16 input rows
  (``crop_cubic.plan``'s tiles), at (8, 256, 256, 3) and (3, 512, 512, 3)
  with chip_smoke.py's windows;

- K22 as committed (``ssim_base``) and with phases cut out
  (``-DVWFD_SSIMG_CUT``: ``ssim_cut_v1``, ``_h1``, ``_v2``, ``_h2``,
  ``_all``), at (8, 256, 256, 3) and (3, 512, 512, 3);
- K21's forward as committed (``rect_base``: the next row's loads issued
  before the column pass), with the loads in the phase that uses them
  (``rect_no_prefetch``, ``-DVWFD_RECT_PREFETCH=0``), and with phases cut
  out (``-DVWFD_RECT_CUT``: ``rect_cut_column``, ``_loads`` (the row
  pass's loads), ``_combine``, ``_all``), each with bands of 4 and 8
  output rows (``rectify.plan`` takes 8 at 256² and 4 at 512²), at 48
  copies of 256² against 8 and 9 of 512² against 3.

A cut form's output is wrong by design; its ms says what the phase costs.
Prints each kernel's registers and spills (``ptxas -v``), and for each form
and shape the device ms (CUDA events around ``--reps`` calls behind a device
sleep) and its output against the plain version (K20's forward and K21
``torch.equal``, K20's gradient and K22 max |Δ| over the plain gradient's
max; a SHA-256 of K20's gradient, equal in two forms' lines where they sum
in the same order), one JSON line each (appended to ``--out``) with the
card's name and power limit. A measurement tool, not
part of the package: nothing imports it.
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from vwfd_tpu_torch.kernels import (  # noqa: E402
    _lib, crop_cubic, rectify, ssim_grad)
from vwfd_tpu_torch.kernels.ssim import _TAPS  # noqa: E402

OUT_DIR = _lib.BUILD_DIR.parent / "ablate_clr_kernels"
SSIM_FORMS = {"ssim_base": [],
              **{f"ssim_cut_{name}": [f"-DVWFD_SSIMG_CUT={bit}"]
                 for name, bit in (("v1", 1), ("h1", 2), ("v2", 4),
                                   ("h2", 8), ("all", 15))}}
RECT_FORMS = {"rect_base": [],
              "rect_no_prefetch": ["-DVWFD_RECT_PREFETCH=0"],
              **{f"rect_cut_{name}": [f"-DVWFD_RECT_CUT={bit}"]
                 for name, bit in (("column", 1), ("loads", 2),
                                   ("combine", 4), ("all", 7))}}
RECT_CASES = [(8, 6, 256, (10.0, 230.0, 3.0, 256.0)),
              (3, 3, 512, (31.0, 480.0, 0.0, 400.0))]
CROP_FORMS = {"crop_base": [],
              "crop_no_prefetch": ["-DVWFD_CROP_PREFETCH=0"],
              "crop_smem_gt": ["-DVWFD_CROP_SMEM_GT=1"],
              **{f"crop_cut_{name}": [f"-DVWFD_CROP_CUT={bit}"]
                 for name, bit in (("fwd_loads", 1), ("fwd_column", 2),
                                   ("fwd_all", 3), ("bwd_transpose", 4),
                                   ("bwd_all", 12))}}


def time_ms(fn, iters, warmup=3):
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


def build_all(forms):
    """Compile each ``(name, source, flags)`` into its own library, all at
    once; returns {name: (library, ptxas lines)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src, flags in forms:
        so = OUT_DIR / f"{name}.so"
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, *flags, "-Xptxas", "-v",
               "-shared", "-I", str(_lib.CSRC), "-o", str(so),
               str(_lib.CSRC / src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if re.search(r"registers|spill", line)]
        out[name] = (so, regs)
    return out


def load(so, fn):
    lib = ctypes.CDLL(str(so))
    f = getattr(lib, fn)
    f.argtypes = _lib._SIGNATURES[fn]
    f.restype = ctypes.c_int
    return f


def check_rc(rc, what):
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def ssim_rows(libs, reps):
    g = torch.Generator("cuda").manual_seed(77)
    sms = _lib.sm_count(torch.device("cuda"))
    for b, _, s, _ in RECT_CASES:
        shape = (b, s, s, 3)
        img = torch.rand(shape, device="cuda", generator=g)
        x1 = (img + 0.01 * torch.randn(shape, device="cuda", generator=g)
              ).clamp(0, 1)
        x1[:, 40:120, 30:200] = img[:, 40:120, 30:200] = 0.25
        sc = ssim_grad.scale_of(torch.zeros(b, device="cuda"),
                                torch.ones((), device="cuda"), shape)
        gp = ssim_grad.ssim_grad_plain(x1, img, sc)
        _, segments, rows = ssim_grad.plan(b, s, s, sms)
        for name in SSIM_FORMS:
            fn = load(libs[name][0], "vwfd_ssim_grad")
            dx = torch.empty_like(x1)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                check_rc(fn(x1.data_ptr(), img.data_ptr(), sc.data_ptr(),
                            _TAPS, dx.data_ptr(), b, s, s, segments, rows,
                            stream), name)
            run()
            torch.cuda.synchronize()
            err = float((dx - gp).abs().max()) / float(gp.abs().max())
            yield {"kernel": "ssim_grad", "form": name, "shape": list(shape),
                   "plan": [segments, rows], "ms": time_ms(run, reps),
                   "grad_err_of_plain_max": err,
                   "ptxas": libs[name][1]}


def rect_rows(libs, reps):
    g = torch.Generator("cuda").manual_seed(76)
    for b, k, s, apex in RECT_CASES:
        att = torch.rand((b * k, s, s, 3), device="cuda", generator=g) * 1.2 \
            - 0.1
        clean = torch.rand((b, s, s, 3), device="cuda", generator=g)
        ap = torch.tensor(apex, device="cuda")
        yp = rectify.rectify_plain(att, clean, ap)
        for name in RECT_FORMS:
            fn = load(libs[name][0], "vwfd_rectify")
            for band in (4, 8):
                out = torch.empty_like(att)
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    check_rc(fn(att.data_ptr(), clean.data_ptr(),
                                ap.data_ptr(), out.data_ptr(), b * k, b, s,
                                s, 3, band, stream), name)
                run()
                torch.cuda.synchronize()
                yield {"kernel": "rectify", "form": name, "band": band,
                       "copies": b * k,
                       "size": s, "ms": time_ms(run, reps),
                       "equal_plain": bool(torch.equal(out, yp)),
                       "ptxas": libs[name][1]}


def crop_rows(libs, reps):
    g = torch.Generator("cuda").manual_seed(75)
    sms = _lib.sm_count(torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    for b, _, s, apex in RECT_CASES:
        shape = (b, s, s, 3)
        x = torch.rand(shape, device="cuda", generator=g) * 1.2 - 0.1
        cot = torch.randn(shape, device="cuda", generator=g)
        ap = torch.tensor(apex, device="cuda")
        xp = x.clone().requires_grad_(True)
        yp = crop_cubic.crop_cubic_plain(xp, ap)
        gp, = torch.autograd.grad(yp, xp, cot)
        p = crop_cubic.plan(b, s, s, 3, s, s, sms)
        for name in CROP_FORMS:
            fwd = load(libs[name][0], "vwfd_crop_cubic_fwd")
            bwd = load(libs[name][0], "vwfd_crop_cubic_bwd")
            out = torch.empty_like(x)
            for band in (4, 8):
                def run():
                    check_rc(fwd(x.data_ptr(), ap.data_ptr(), out.data_ptr(),
                                 b, s, s, 3, s, s, band, p.fwd_tile, stream),
                             name)
                run()
                torch.cuda.synchronize()
                yield {"kernel": "crop_cubic_fwd", "form": name,
                       "band": band, "shape": list(shape),
                       "planned": band == p.fwd_band,
                       "ms": time_ms(run, reps),
                       "equal_plain": bool(torch.equal(out, yp)),
                       "ptxas": libs[name][1]}
            for band in (4, 8, 16):
                def run():
                    check_rc(bwd(cot.data_ptr(), ap.data_ptr(),
                                 out.data_ptr(), b, s, s, 3, s, s, band,
                                 p.bwd_tile, stream), name)
                run()
                torch.cuda.synchronize()
                err = float((out - gp).abs().max()) / float(gp.abs().max())
                yield {"kernel": "crop_cubic_bwd", "form": name,
                       "band": band, "shape": list(shape),
                       "planned": band == p.bwd_band,
                       "ms": time_ms(run, reps),
                       "grad_err_of_plain_max": err,
                       "grad_sha256": hashlib.sha256(
                           out.cpu().numpy().tobytes()).hexdigest()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="crop,rect,ssim")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        sys.exit("ablate_clr_kernels: needs a CUDA card")
    forms = []
    if "ssim" in only:
        forms += [(n, "ssim_grad.cu", f) for n, f in SSIM_FORMS.items()]
    if "rect" in only:
        forms += [(n, "rectify.cu", f) for n, f in RECT_FORMS.items()]
    if "crop" in only:
        forms += [(n, "crop_cubic.cu", f) for n, f in CROP_FORMS.items()]
    libs = build_all(forms)
    name = card()
    rows = []
    if "crop" in only:
        rows.append(crop_rows(libs, args.reps))
    if "ssim" in only:
        rows.append(ssim_rows(libs, args.reps))
    if "rect" in only:
        rows.append(rect_rows(libs, args.reps))
    for rec in (r for gen in rows for r in gen):
        line = json.dumps({"card": name, **rec})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
