"""What limits K11 ``qconv`` and K12 ``qconv_t`` on the int8 wgmma core
(``csrc/qwgmma.cuh``): the kernel timed whole, with one part cut out, and
with its plan changed, each variant compiled from a patched copy of the
kernel's source (``csrc/qconv.cu`` or ``csrc/qconv_t.cu``) and
``csrc/qwgmma.cuh``.

    python -m vwfd_tpu_torch.ablate_qconv [--kernel qconv|qconv_t]
        [--reps 30] [--variant NAME ...]

Needs one CUDA card and ``nvcc``. Variants: ``base``; ``no_mma`` (the
stages are loaded but never multiplied); ``no_tma`` (the producer issues no
TMA loads and arrives on the stage barriers at once, so the consumers
multiply whatever the ring holds: what is left is the products, the
barriers and the epilogue); ``no_store`` (the int8 epilogue computes and
stages its bytes in shared memory but stores none to global memory: K11's
16-byte stores, K12's TMA store);
``no_epi`` (no epilogue: nothing is stored,
and the compiler then drops the products whose sums nobody reads, so what
is left is the loads, the barriers and the tile loop);
``stages2`` (the plan's ring cut to 2 slots:
loads in flight against the plan's 3–6; null where the producer's threads
load, which need 3); ``a_cpasync`` (int8 activations
through the producer threads' ``cp.async`` instead of TMA's 16-byte rows).
The cut variants compute wrong outputs; only their time means anything.
Shapes, from the flagship int8 roundtrip (batch 16, T=4, 256²):
``enc1.0`` (Cin 12 by ``cp.async``, 64 frames of 128² → 64), ``enc1.1``
(3×3, 128²×64 → 64), ``enc2.1`` (64²×128 →
128), ``enc2.0`` (the pool prologue, 128²×64 pooled → 128), ``dec2`` (the
dual decoder conv, 2 × 128 → 128), ``head`` (1×1, 128²×64 → 4, float32)
and ``inn.conv0`` (3×3 on a bf16 coupling half quantized on load, 16
frames of 64²×96 → 128, ELU, writing ``xi``) and ``inn.conv1`` (its int8
64²×128 → 128); K12's four upsamples ``up4`` (64 frames of 8²×1024 →
16²×512) to ``up1`` (64²×128 → 128²×64). Each is timed with CUDA
events over ``--reps`` launches behind a device sleep. Prints one JSON
line: ms per variant and shape, registers and spill bytes per variant
(``ptxas -v``), and the card. The patches name lines of the sources; when
a source changes under them, the script stops and says which.
``--variant`` runs only the named variants (one process each keeps a
variant that faults from taking the others with it).
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .ablate_median import _time_ms
from .kernels import _lib, qconv, qconv_t

_CORE = "qwgmma.cuh"
# name -> (patches as (file, old, new), launch_args overrides); a patch of
# a kernel's own source applies when that kernel is ablated
_VARIANTS = {
    "base": ([], {}),
    "no_mma": ([(_CORE, "  if constexpr (BN == 64)\n    wgmma_n64(d, da, db);"
                 "\n  else\n    wgmma_n128(d, da, db);\n", "")], {}),
    "no_tma": ([(_CORE, "          if (bytes)\n            mbar_expect_tx(",
                 "          if (false)\n            mbar_expect_tx("),
                (_CORE, "          if (op.a_tma) {", "          if (false) {"),
                (_CORE, "          if (op.b_tma && load_b) {",
                 "          if (false) {")], {}),
    "no_store": ([("qconv.cu", "      if (y >= c.H || x >= c.W",
                   "      if (true || y >= c.H || x >= c.W"),
                  ("qconv_t.cu", "        tma_store_4d(&a.out_map,",
                   "        if (false) tma_store_4d(&a.out_map,")], {}),
    "no_epi": ([(_CORE,
                 "    epi(c, tl, wg, acc, acc2, staging, params, pre);\n",
                 "")], {}),
    "stages2": ([], {"stages": 2}),
    "a_cpasync": ([], {"a_threads": True}),
}
# kernel -> (source, C entry point, launch_args)
_KERNELS = {"qconv": ("qconv.cu", "vwfd_qconv", qconv.launch_args),
            "qconv_t": ("qconv_t.cu", "vwfd_qconv_t", qconv_t.launch_args)}
_PTXAS = re.compile(r"Compiling entry function '(\S+)'.*?(\d+) bytes spill "
                    r"stores.*?Used (\d+) registers", re.S)


def _shapes(g, kernel="qconv"):
    """(name, inputs of ``qconv.qconv`` or ``qconv_t.qconv_t`` as args and
    kwargs)."""
    def i8(shape, lo=-127):
        return torch.randint(lo, 128, shape, device="cuda", generator=g,
                             dtype=torch.int8)

    def vec(n, scale):
        return scale * (0.5 + torch.rand(n, device="cuda", generator=g))

    if kernel == "qconv_t":
        return [(f"up{lv}", (i8((64, 128 >> lv, 128 >> lv, cin), 0),
                             i8((2, 2, cin // 2, cin)),
                             vec(cin // 2, 1e-3), vec(cin // 2, 1.0)), {})
                for lv, cin in ((4, 1024), (3, 512), (2, 256), (1, 128))]

    half = torch.randn((16, 64, 64, 192), device="cuda",
                       generator=g).to(torch.bfloat16)[..., 96:]
    return [
        ("enc1.0", (i8((64, 128, 128, 12), 0), i8((64, 3, 3, 12)),
                    vec(64, 1e-3), vec(64, 1.0), "relu"), {}),
        ("enc1.1", (i8((64, 128, 128, 64), 0), i8((64, 3, 3, 64)),
                    vec(64, 1e-3), vec(64, 1.0), "relu"), {}),
        ("enc2.1", (i8((64, 64, 64, 128), 0), i8((128, 3, 3, 128)),
                    vec(128, 1e-3), vec(128, 1.0), "relu"), {}),
        ("enc2.0", (i8((64, 128, 128, 64), 0), i8((128, 3, 3, 64)),
                    vec(128, 1e-3), vec(128, 1.0), "relu"), {"pool": True}),
        ("dec2", (i8((64, 64, 64, 128), -127), i8((128, 3, 3, 128)),
                  vec(128, 1e-3), vec(128, 1.0), "relu"),
         {"x2": i8((64, 64, 64, 128), 0), "w2": i8((128, 3, 3, 128)),
          "m2": vec(128, 1e-3)}),
        ("head", (i8((64, 128, 128, 64), 0), i8((4, 1, 1, 64)),
                  vec(4, 1e-3), vec(4, 1.0), "f32"), {}),
        ("inn.conv1", (i8((16, 64, 64, 128)), i8((128, 3, 3, 128)),
                       vec(128, 1e-5), vec(128, 0.1), "elu"),
         {"out_scale": torch.tensor(0.015, device="cuda")}),
        ("inn.conv0", (half, i8((128, 3, 3, 96)), vec(128, 1e-5),
                       vec(128, 0.1), "elu"),
         {"x_scale": torch.tensor(0.02, device="cuda"),
          "out_scale": torch.tensor(0.015, device="cuda"),
          "xi_out": torch.empty(half.shape, device="cuda",
                                dtype=torch.int8)}),
    ]


def _sources(name, kernel="qconv"):
    """{file: text}: the kernel's source and qwgmma.cuh, patched."""
    src = _KERNELS[kernel][0]
    text = {f: (_lib.CSRC / f).read_text() for f in (src, _CORE)}
    for f, old, new in _VARIANTS[name][0]:
        if f not in text:  # another kernel's source
            continue
        if text[f].count(old) != 1:
            raise SystemExit(f"ablate_qconv: {name}: {f} no longer holds "
                             f"{old[:60]!r} once")
        text[f] = text[f].replace(old, new)
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(_KERNELS), default="qconv")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--variant", nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_qconv: needs a CUDA card")
    names = [n for n in _VARIANTS if args.variant is None
             or n in args.variant]
    src, entry, launch_args = _KERNELS[args.kernel]
    shapes = _shapes(torch.Generator("cuda").manual_seed(0), args.kernel)
    stream = torch.cuda.current_stream().cuda_stream
    out, regs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name in names:
            d = Path(tmp) / name
            d.mkdir()
            for f, text in _sources(name, args.kernel).items():
                (d / f).write_text(text)
            so = d / "kernel.so"
            cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v",
                   "-shared", "-I", str(_lib.CSRC), "-o", str(so),
                   str(d / src)]
            builds[name] = so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        for name, (so, proc) in builds.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"ablate_qconv: {name}: nvcc failed\n{err}")
            regs[name] = {k: {"registers": int(r), "spill_store_bytes": int(s)}
                          for k, s, r in _PTXAS.findall(err)}
            fn = getattr(ctypes.CDLL(str(so)), entry)
            fn.argtypes = _lib._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            out[name] = {}
            for shape, a, kw in shapes:
                try:  # dst: kept alive while the launches run
                    dst, cargs = launch_args(*a, **kw, **_VARIANTS[name][1])
                except ValueError:  # a plan this shape cannot take
                    out[name][shape] = None
                    continue

                def call():
                    rc = fn(*cargs, stream)
                    if rc:
                        raise RuntimeError(f"{name} {shape}: launch failed "
                                           f"({rc})")
                out[name][shape] = _time_ms(call, args.reps)
                print(f"ablate_qconv {name} {shape} {out[name][shape]:.4f} ms",
                      file=sys.stderr, flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({f"{args.kernel}_ms": out, "build": regs,
                      "card": card}))


if __name__ == "__main__":
    main()
