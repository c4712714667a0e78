"""Where K6's backward spends its time: ``median3_bwd`` timed whole and with
one phase cut out, each variant compiled from a patched copy of
``csrc/median.cu``.

    python -m vwfd_tpu_torch.ablate_median [--reps 50]

Needs one CUDA card and ``nvcc``. Variants: ``base``; ``no_codes`` (no
median network or first-match search: the codes stay unset); ``no_ring``
(codes of the tile's own outputs only); ``no_gather`` (the gather adds
nothing); ``no_g_stage`` (the cotangents are not loaded). A variant
computes a wrong gradient; only its time means anything. Each is timed at
the training shape (64 frames of 256²×3 f32, 4 levels) with CUDA events
over ``--reps`` launches behind a device sleep. Prints one JSON line of ms
per variant and the card. The patches name lines of ``median.cu``; when
the source changes under them, the script stops and says which.
"""

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from .kernels import _lib


def _variants(src: str):
    codes = src[src.index("  // codes of the tile's outputs"):
                src.index("  // gather: thread (tx, band)")]
    g0 = src.index("  // cotangents of the outputs (0 off the image)")
    g_stage = src[g0:src.index("  __syncthreads();", g0)]
    return {
        "base": [],
        "no_codes": [(codes, "  const int tx = threadIdx.x & 31, "
                             "r0 = (threadIdx.x >> 5) * kRows;\n"
                             "  __syncthreads();\n\n")],
        "no_ring": [("i < kC * kRing;", "i < 0;")],
        "no_gather": [("        if (__float_as_uint(o.y) == "
                       "(uint32_t)((1 - dy) * 3 + 1 - dx))\n"
                       "          acc += o.x;", "        acc += 0.f * o.x;")],
        "no_g_stage": [(g_stage, "")],
    }


def _time_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_median: needs a CUDA card")
    src = (_lib.CSRC / "median.cu").read_text()
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randint(0, 4, (64, 256, 256, 3), device="cuda",
                      generator=g).float() / 255.0
    cot = torch.randn(x.shape, device="cuda", generator=g)
    gx = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, patches in _variants(src).items():
            text = src
            for old, new in patches:
                if old not in text:
                    raise SystemExit(f"ablate_median: {name}: median.cu no "
                                     f"longer holds {old[:60]!r}")
                text = text.replace(old, new)
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            cu.write_text(text)
            subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I",
                            str(_lib.CSRC), "-o", str(so), str(cu)],
                           check=True, capture_output=True, text=True)
            fn = ctypes.CDLL(str(so)).vwfd_median3_bwd
            fn.argtypes = _lib._SIGNATURES["vwfd_median3_bwd"]
            fn.restype = ctypes.c_int

            def call():
                rc = fn(x.data_ptr(), cot.data_ptr(), gx.data_ptr(),
                        *x.shape[:3], stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            out[name] = _time_ms(call, args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"median3_bwd_ms": out, "card": card}))


if __name__ == "__main__":
    main()
