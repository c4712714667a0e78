"""What limits K11 ``qconv`` (and the int8 core ``csrc/qmma.cuh`` that K12 and
K13 share): the kernel timed whole and with one part cut out, each variant
compiled from a patched copy of ``csrc/qconv.cu`` with ``csrc/qmma.cuh``.

    python -m vwfd_tpu_torch.ablate_qconv [--reps 30] [--variant NAME ...]

Needs one CUDA card and ``nvcc``. Variants: ``base``; ``occ2`` (two blocks
an SM: at most 128 registers a thread); ``no_mma`` (the stages are loaded
but never multiplied); ``no_stage`` (the products run on whatever shared
memory holds: no loads, no quantizing, the barriers kept). The cut
variants compute wrong outputs; only their time means anything. Shapes,
from the flagship int8 roundtrip (batch 16, T=4, 256²): ``enc2.1`` (3×3,
64 frames of 64²×128 → 128), ``dec2`` (the dual decoder conv, 2 × 128 →
128), ``gemm1x1`` (1×1, 64²×128 → 256 signed: the GEMM K12's up1 runs)
and ``inn.conv0`` (3×3 on a bf16 coupling half quantized on load, 16
frames of 64²×96 → 128, ELU). Each is timed with CUDA events over
``--reps`` launches behind a device sleep. Prints one JSON line: ms per
variant and shape, registers and spill bytes per variant (``ptxas -v``),
and the card. The patches name lines of the sources; when a source
changes under them, the script stops and says which. ``--variant`` runs
only the named variants (one process each keeps a variant that faults
from taking the others with it).
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
from .kernels import _lib, qconv

_VARIANTS = {
    "base": [],
    "occ2": [("qconv.cu", "__global__ void __launch_bounds__(kThreads) "
              "qconv_kernel", "__global__ void __launch_bounds__(kThreads, "
              "2) qconv_kernel")],
    "no_mma": [("qmma.cuh", "    mma_stage<KS>(sa, sb, acc);\n", "")],
    "no_stage": [("qmma.cuh",
                  "    stage<KS>(sa, sb, s, g, n0, rows, st_c, c0);\n", "")],
}
_PTXAS = re.compile(r"Compiling entry function '(\S+)'.*?(\d+) bytes spill "
                    r"stores.*?Used (\d+) registers", re.S)


def _shapes(g):
    """(name, inputs of ``qconv.qconv`` as args and kwargs)."""
    def i8(shape, lo=-127):
        return torch.randint(lo, 128, shape, device="cuda", generator=g,
                             dtype=torch.int8)

    def vec(n, scale):
        return scale * (0.5 + torch.rand(n, device="cuda", generator=g))

    half = torch.randn((16, 64, 64, 192), device="cuda",
                       generator=g).to(torch.bfloat16)[..., 96:]
    return [
        ("enc2.1", (i8((64, 64, 64, 128), 0), i8((128, 3, 3, 128)),
                    vec(128, 1e-3), vec(128, 1.0), "relu"), {}),
        ("dec2", (i8((64, 64, 64, 128), -127), i8((128, 3, 3, 128)),
                  vec(128, 1e-3), vec(128, 1.0), "relu"),
         {"x2": i8((64, 64, 64, 128), 0), "w2": i8((128, 3, 3, 128)),
          "m2": vec(128, 1e-3)}),
        ("gemm1x1", (i8((64, 64, 64, 128), 0), i8((256, 1, 1, 128)),
                     vec(256, 1e-3), vec(256, 1.0), "signed"), {}),
        ("inn.conv0", (half, i8((128, 3, 3, 96)), vec(128, 1e-5),
                       vec(128, 0.1), "elu"),
         {"x_scale": torch.tensor(0.02, device="cuda"),
          "out_scale": torch.tensor(0.015, device="cuda")}),
    ]


def _source(name):
    """qconv.cu with qmma.cuh pasted in place of its include, patched."""
    text = {f: (_lib.CSRC / f).read_text() for f in ("qconv.cu", "qmma.cuh")}
    for where, old, new in _VARIANTS[name]:
        if old not in text[where]:
            raise SystemExit(f"ablate_qconv: {name}: {where} no longer "
                             f"holds {old[:60]!r}")
        text[where] = text[where].replace(old, new)
    head = text["qmma.cuh"].replace("#pragma once\n", "")
    return text["qconv.cu"].replace('#include "qmma.cuh"\n', head)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--variant", nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_qconv: needs a CUDA card")
    names = [n for n in _VARIANTS if args.variant is None
             or n in args.variant]
    shapes = _shapes(torch.Generator("cuda").manual_seed(0))
    stream = torch.cuda.current_stream().cuda_stream
    out, regs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name in names:
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            cu.write_text(_source(name))
            cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v",
                   "-shared", "-I", str(_lib.CSRC), "-o", str(so), str(cu)]
            builds[name] = so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        for name, (so, proc) in builds.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"ablate_qconv: {name}: nvcc failed\n{err}")
            regs[name] = {k: {"registers": int(r), "spill_store_bytes": int(s)}
                          for k, s, r in _PTXAS.findall(err)}
            fn = ctypes.CDLL(str(so)).vwfd_qconv
            fn.argtypes = _lib._SIGNATURES["vwfd_qconv"]
            fn.restype = ctypes.c_int
            out[name] = {}
            for shape, a, kw in shapes:
                dst, cargs = qconv.launch_args(*a, **kw)  # dst: kept alive

                def call():
                    rc = fn(*cargs, stream)
                    if rc:
                        raise RuntimeError(f"{name} {shape}: launch failed "
                                           f"({rc})")
                out[name][shape] = _time_ms(call, args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"qconv_ms": out, "build": regs, "card": card}))


if __name__ == "__main__":
    main()
