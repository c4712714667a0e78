"""Where K18's launches spend their time: its forward and backward at
SUNet's four stage shapes of 256² b8, each timed whole and with one part
cut out, each variant compiled from a patched copy of
``csrc/window_attention.cu``.

    python port_tools/ablate_window_attention.py [--reps 20] [--variants V ...]
        [--out FILE]

Needs one CUDA card and ``nvcc``. Shapes: qkv on the map (8, 64 >> i,
64 >> i, 3, 3·2^i, 32), windows of 8, shift 4 at stages 0-2 and 0 at
stage 3 (its window covers the map). Variants (the wgmma kernels of
d = 32): ``base``; ``hi_only`` (one TF32 product in place of 3xTF32's
three: the cross terms cut); ``no_mma`` (no wgmma issues: their operands
are still formed); ``no_split`` (the problem's tiles are not split: hi and
lo read as they lie); ``loads_only`` (copies and the split, no products,
no stores); ``no_table_sum`` (the last CTA of a head does not sum the
head's rows of the table gradient); ``timeline`` (thread 0 of each CTA
adds its clock cycles between phase points to counters: cycles per
problem in each phase, its own warp's view and the barriers' waits). The
variants that cut a part out compute wrong values; only their times mean
anything. Each is timed with
CUDA events over ``--reps`` launches behind a device sleep, at the
persistent grid the wrapper would use. Prints one JSON line of ms per
stage, kernel (``fwd``, ``bwd``: the backward's two launches) and variant,
with the card. The patches name lines of the source; when the source
changes under them, the script stops and says which. A measurement tool,
not part of the package: nothing imports it.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from vwfd_tpu_torch.kernels import _lib  # noqa: E402

WS = 8
STAGES = [((8, 64 >> i, 64 >> i, 3, 3 << i, 32), 4 if i < 3 else 0)
          for i in range(4)]

_TIMER = (
    '#include "common.cuh"\n', '#include "common.cuh"\n'
    "__device__ unsigned long long k18_acc[32];\n"
    "__shared__ long long k18_last;\n"
    "#define K18T(n) do { if (threadIdx.x == 0) { const long long t_ = "
    "clock64(); atomicAdd(&k18_acc[n], (unsigned long long)(t_ - "
    "k18_last)); k18_last = t_; } } while (0)\n"
    'extern "C" int k18_acc_read(unsigned long long* dst) { return '
    "(int)cudaMemcpyFromSymbol(dst, k18_acc, sizeof(k18_acc)); }\n"
    'extern "C" int k18_acc_reset() { static unsigned long long z[32] = '
    "{0}; return (int)cudaMemcpyToSymbol(k18_acc, z, sizeof(z)); }\n")


def _after(anchor, n):
    return (anchor, anchor + f"    K18T({n});\n")


def _before(anchor, n):
    return (anchor, f"    K18T({n});\n" + anchor)


VARIANTS = {
    "base": [],
    # one TF32 product in place of 3xTF32's three
    "hi_only": [
        ("    rs64(c, a.lo[ks], desc(bh + 8 * ks));\n"
         "    rs64(c, a.hi[ks], desc(bl + 8 * ks));\n", ""),
        ("    rs32(c, al[kb], desc(xh + o));\n"
         "    rs32(c, ah[kb], desc(xl + o));\n", ""),
        ("    ss32(c, desc(tl + oa), desc(xh + ob));\n"
         "    ss32(c, desc(th + oa), desc(xl + ob));\n", "")],
    # no wgmma issues (their operands are still formed)
    "no_mma": [(f"  asm volatile(\n      \"{{\\n.reg .pred p;\\nsetp.ne.b32 p, "
                f"1, 0;\\n\"\n      \"wgmma.mma_async.sync.aligned.{shape}",
                f"  if (db == 1) asm volatile(\n      \"{{\\n.reg .pred p;\\n"
                f"setp.ne.b32 p, 1, 0;\\n\"\n      \"wgmma.mma_async.sync."
                f"aligned.{shape}") for shape in ("m64n64k8", "m64n32k8")],
    "no_split": [("  for (int i = threadIdx.x; i < 64 * 8; i += kThr) {",
                  "  for (int i = threadIdx.x; i < 0; i += kThr) {")],
    # copies and the split; no products, no stores
    "loads_only": [
        ("    split_bwd(sm);\n", "    split_bwd(sm);\n"
         "    if (g.G > 0) continue;\n"),
        ("    split_fwd(sm, g.nb);\n", "    split_fwd(sm, g.nb);\n"
         "    if (g.G > 0) continue;\n")],
    "no_table_sum": [("  if (last) {", "  if (last && g.G < 0) {")],
    "timeline": [
        _TIMER,
        ("  const int p0 = (int)((long long)blockIdx.x * g.P / g.G);\n",
         "  if (threadIdx.x == 0) k18_last = clock64();\n"
         "  const int p0 = (int)((long long)blockIdx.x * g.P / g.G);\n"),
        _after("    cp_async_wait_all();\n    __syncthreads();  // p's copies "
               "landed; the last problem is done\n", 0),
        _after("    cp_async_wait_all();\n    __syncthreads();  // p staged; "
               "the last problem's reads are done\n", 0),
        _after("    split_bwd(sm);\n", 1),
        _after("    split_fwd(sm, g.nb);\n", 1),
        _after("      commit();\n      wait<0>();\n    }\n", 2),
        _after("    commit();\n    wait<0>();\n    pin(s);\n", 2),
        _before("    __syncthreads();  // every warp's S and dP are done", 3),
        _before("    float o[4][4];\n", 3),
        _before("    float dv[4][4], dq[4][4], dk[4][4];\n", 4),
        _after("    pin(dv);\n    pin(dq);\n", 5),
        _before("    product_tn(dk, ", 6),
        _before("    wait<0>();\n    pin(dk);\n", 7),
        _after("    store_rows<32>(dst + HD, 3 * HD, rowidx, dk, g.N, i0, gi, "
               "tq, g.scale);\n", 8),
        _after("                   i0, gi, tq, 1.f);\n", 4),
        _after("                 tq);\n      zero(acc);\n      hc = h;\n    }\n",
               9)],
}
# the timeline variant's phases (thread 0's clock between points, summed
# over CTAs, per problem)
PHASES = {0: "load (copies, waited)", 1: "split", 2: "S (and dP) products",
          3: "softmax (and dS)", 4: "backward: P^T store and barriers; "
          "forward: P.V products and store", 5: "dV, dQ products",
          6: "dS^T store and barriers", 7: "dK issue, dV and dQ stores",
          8: "dK wait and store", 9: "table flush"}


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


def _build(src: str, patches, name: str, tmp: Path):
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"ablate_window_attention: patch for {name} no "
                             f"longer matches the source: {old!r}")
        src = src.replace(old, new)
    cu = tmp / f"{name}.cu"
    cu.write_text(src)
    so = tmp / f"{name}.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared",
                    f"-I{_lib.CSRC}", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _lib._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed ({rc})")


def _timeline(lib, problems, fwd, bwd, reps=10):
    """Thread 0's clock cycles per problem in each phase, forward and
    backward (the ``timeline`` variant's counters)."""
    out = {}
    acc = (ctypes.c_ulonglong * 32)()
    for what, fn in (("fwd", fwd), ("bwd", bwd)):
        torch.cuda.synchronize()
        _check(lib.k18_acc_reset(), "reset")
        for _ in range(reps):
            _check(fn(), what)
        torch.cuda.synchronize()
        _check(lib.k18_acc_read(acc), "read")
        out[what] = {PHASES[k]: acc[k] / (reps * problems)
                     for k in PHASES if acc[k]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--out", default=None, help="also write the line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_window_attention: needs a CUDA card")
    g = torch.Generator("cuda").manual_seed(0)
    st = torch.cuda.current_stream().cuda_stream
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = (_lib.CSRC / "window_attention.cu").read_text()
        for name in args.variants:
            lib = _build(src, VARIANTS[name], name, Path(tmp))
            for i, (shape, shift) in enumerate(STAGES):
                b, hm, wm, _, h, d = shape
                qkv = torch.randn(shape, device="cuda", generator=g)
                table = 0.02 * torch.randn(((2 * WS - 1) ** 2, h),
                                           device="cuda", generator=g)
                gout = torch.randn((b, hm, wm, h * d), device="cuda",
                                   generator=g)
                out, dqkv = torch.empty_like(gout), torch.empty_like(qkv)
                dtable = torch.empty_like(table)
                problems = b * (hm // WS) * (wm // WS) * h
                ctas = [min(problems, lib.vwfd_window_attention_ctas(d, k))
                        for k in (0, 1)]
                part = torch.empty(h * ctas[1] * (2 * WS - 1) ** 2,
                                   device="cuda")
                tickets = torch.zeros(h, device="cuda", dtype=torch.int32)
                geo = (b, hm, wm, WS, shift, h, d)
                res[f"stage {i} {name}"] = {
                    "fwd": _time_ms(lambda: _check(
                        lib.vwfd_window_attention_fwd(
                            qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
                            *geo, ctas[0], d ** -0.5, st), "fwd"), args.reps),
                    "bwd": _time_ms(lambda: _check(
                        lib.vwfd_window_attention_bwd(
                            qkv.data_ptr(), table.data_ptr(),
                            gout.data_ptr(), dqkv.data_ptr(),
                            part.data_ptr(), tickets.data_ptr(),
                            dtable.data_ptr(), *geo,
                            ctas[1], d ** -0.5, st), "bwd"), args.reps)}
                if name == "timeline":
                    res[f"stage {i} timeline"] = _timeline(
                        lib, problems, lambda: lib.vwfd_window_attention_fwd(
                            qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
                            *geo, ctas[0], d ** -0.5, st),
                        lambda: lib.vwfd_window_attention_bwd(
                            qkv.data_ptr(), table.data_ptr(),
                            gout.data_ptr(), dqkv.data_ptr(),
                            part.data_ptr(), tickets.data_ptr(),
                            dtable.data_ptr(), *geo, ctas[1], d ** -0.5, st))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    line = json.dumps({"ms": res, "card": card})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
