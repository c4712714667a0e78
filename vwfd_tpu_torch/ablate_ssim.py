"""Where K8 ``ssim`` spends its time: the kernel timed whole, with one phase
cut out, and in two other shapes, each variant compiled from a patched copy
of ``csrc/ssim.cu``.

    python -m vwfd_tpu_torch.ablate_ssim [--reps 50] [--variant NAME ...]

Needs one CUDA card and ``nvcc``. Variants: ``base``; ``no_vertical`` (the
vertical pass keeps 2 of its 11 taps); ``no_horizontal`` (the horizontal
pass keeps 2 of its 11 taps); ``no_map`` (the map is the sum of the four
window sums: no division); ``no_sync`` (no barrier between the passes);
``occ3`` (three CTAs an SM: at most 96 registers a thread); ``tw128`` (128
columns a CTA, 448 threads, one CTA an SM: less halo, the same warps).
The cut variants compute a wrong SSIM; only their time means anything. Each
is timed at the eval shape (64 frames of 256²×3 f32) with CUDA events over
``--reps`` launches behind a device sleep, its grid from
``kernels.ssim.geometry`` with that module's columns and CTAs an SM set to
the variant's. Prints one
JSON line: ms, registers and spill bytes per variant (``ptxas -v``), and
the card. The patches name lines of ``ssim.cu``; when the source changes
under them, the script stops and says which. ``--variant`` runs only the
named variants (one process each keeps a variant that faults from taking
the others with it).
"""

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from .ablate_median import _time_ms
from .kernels import _lib, ssim

# (columns of a CTA, CTAs an SM) of each variant; ``base`` is the kernel's
_SHAPES = {"occ3": (64, 3), "tw128": (128, 1)}


def _variants(src: str):
    return {
        "base": [],
        "no_vertical": [("#pragma unroll\n        for (int k = 1; k < kWin - "
                         "1; ++k) m = fmaf(taps.g[k], win[q][k], m);\n",
                         "")],
        "no_horizontal": [("        for (int k = 1; k < kWin; ++k)\n",
                           "        for (int k = 1; k < 2; ++k)\n")],
        "no_map": [("ssim_value(m[0][o], m[1][o], m[2][o], m[3][o])",
                    "(m[0][o] + m[1][o] + m[2][o] + m[3][o])")],
        "no_sync": [("    __syncthreads();  // raw staged; the last chunk's vs "
                     "read\n", ""),
                    ("    __syncthreads();  // vs written; raw read\n", "")],
        "occ3": [("constexpr int kCtasPerSm = 2;",
                  "constexpr int kCtasPerSm = 3;")],
        "tw128": [("constexpr int kTW = 64;", "constexpr int kTW = 128;"),
                  ("constexpr int kStride = 224;",
                   "constexpr int kStride = 448;"),
                  ("constexpr int kBlock = 224;",
                   "constexpr int kBlock = 448;"),
                  ("constexpr int kCtasPerSm = 2;",
                   "constexpr int kCtasPerSm = 1;")],
    }


_PTXAS = re.compile(r"(\d+) bytes spill stores.*?Used (\d+) registers",
                    re.S)


def _geometry(n, h, w, sms, tile_cols, per_sm):
    """``ssim.geometry`` for a variant's columns and CTAs an SM."""
    saved = ssim._TW, ssim._CTAS_PER_SM
    ssim._TW, ssim._CTAS_PER_SM = tile_cols, per_sm
    try:
        return ssim.geometry(n, h, w, sms)
    finally:
        ssim._TW, ssim._CTAS_PER_SM = saved


def _build(tmp: Path, name: str, text: str):
    cu, so = tmp / f"{name}.cu", tmp / f"{name}.so"
    cu.write_text(text)
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
           str(_lib.CSRC), "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variant", nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_ssim: needs a CUDA card")
    src = (_lib.CSRC / "ssim.cu").read_text()
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.rand(64, 256, 256, 3, device="cuda", generator=g)
    y = (x + 0.05 * torch.randn(x.shape, device="cuda", generator=g)).clamp(
        0, 1)
    n, h, w, _ = x.shape
    dev = x.device
    sms = _lib.sm_count(dev)
    means = torch.empty(n, device=dev)
    mean = torch.empty((), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out, regs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name, patches in _variants(src).items():
            if args.variant is not None and name not in args.variant:
                continue
            text = src
            for old, new in patches:
                if old not in text:
                    raise SystemExit(f"ablate_ssim: {name}: ssim.cu no "
                                     f"longer holds {old[:60]!r}")
                text = text.replace(old, new)
            builds[name] = _build(Path(tmp), name, text)
        for name, (so, proc) in builds.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"ablate_ssim: {name}: nvcc failed\n{err}")
            m = _PTXAS.search(err)
            regs[name] = {"registers": int(m.group(2)),
                          "spill_store_bytes": int(m.group(1))} if m else err
            fn = ctypes.CDLL(str(so)).vwfd_ssim
            fn.argtypes = _lib._SIGNATURES["vwfd_ssim"]
            fn.restype = ctypes.c_int
            tile_cols, per_sm = _SHAPES.get(
                name, (ssim._TW, ssim._CTAS_PER_SM))
            tiles, splits, rows = _geometry(n, h, w, sms, tile_cols, per_sm)
            ticket = torch.zeros(1, device=dev, dtype=torch.int32)
            partial = torch.empty(n * splits * tiles, device=dev,
                                  dtype=torch.float64)
            img_sum = torch.empty(n, device=dev, dtype=torch.float64)

            def call():
                rc = fn(x.data_ptr(), y.data_ptr(), n, h, w, splits, rows,
                        ssim._TAPS, partial.data_ptr(), img_sum.data_ptr(),
                        ticket.data_ptr(), means.data_ptr(),
                        mean.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            out[name] = _time_ms(call, args.reps)
            if name in ("base", "occ3", "tw128"):  # the whole computation
                want = ssim.ssim_plain(x[:4], y[:4])[0]
                err = float((means[:4] - want).abs().max())
                regs[name]["max_abs_err"] = err
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"ssim_ms": out, "build": regs, "card": card}))


if __name__ == "__main__":
    main()
