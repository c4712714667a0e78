"""What holds K24 ``diffjpeg`` back: the kernel whole and with parts cut
out, from patched copies of ``csrc/diffjpeg.cu``.

    python port_tools/ablate_diffjpeg.py [--csrc DIR] [--reps 20]
        [--variants NAME ...] [--shapes NxHxW ...] [--out FILE]

Needs one CUDA card and ``nvcc``. Compiles ``diffjpeg.cu`` of ``--csrc``
(default: the package's; ``build/parent/vwfd_tpu_torch/csrc`` for an
unpacked earlier tree) into libraries of their own under
``build/ablate_diffjpeg/``: as it is (``base``) and with

- ``no_transform``: the colour maps, the block passes (DCT, soft round,
  IDCT) and the divisions cut out: the loads, the chroma means and the
  stores are left (load + store only);
- ``no_load``: the loads of x (and g) from device memory cut out: each
  thread makes its values from its indices, everything else is left;
- ``no_div``: every correctly rounded division a product (the cost of
  ``c/t``, ``/255`` and the backward's ``/t``).

Runs each through the C interface at the batch shape (64, 256, 256, 3)
and the study's (1, 32, 32, 3), or at ``--shapes`` (``--variants`` with
no name and a run of batch sizes times the routes alone, either side of
``plan``'s choice), on uniform images at Q75 with a normal
cotangent, and times the forward and the backward with CUDA events over
``--reps`` calls behind a device sleep. A source with the two routes is
launched on each route at each shape, each on the whole card (the bytes
route's persistent grids as ``kernels/diffjpeg.py::plan`` of the tree that
runs the script sizes them for the card, the latency route's a CTA a
macroblock), and ``planned`` says which route the plan picks; an earlier
source with one route as it was. Prints one JSON line
(and appends it to ``--out``) with the card's name, power limit and SM
clock, and the launch floor beside them (``floor_ms``: a one-element
``add_``, timed the same way). The patches name lines of the source; when
the source changes under them the script stops and says which. A
measurement tool, not part of the package: nothing imports it.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from vwfd_tpu_torch.kernels import _lib  # noqa: E402
from vwfd_tpu_torch.ops.quantize import quality_to_factor  # noqa: E402

SHAPES = ((64, 256, 256, 3), (1, 32, 32, 3))
ALL = "*"  # a patch whose anchor is replaced everywhere it occurs

# the first version's source: one route, a CTA of 256 threads a run of 4
# macroblocks
FIRST = {
    "no_transform": [
        ("    float o[3];\n    to_ycc(v, o);\n", "    const float* o = v;\n"),
        ("  blocks<0>(s, mb0, factor, N, H, W);\n", ""),
        ("  blocks<1>(s, mb0, factor, N, H, W);\n", ""),
        ("  blocks<2>(s, mb0, factor, N, H, W);\n", ""),
        ("    float o[3];\n    to_rgb(v, o);\n    float* p = y",
         "    const float* o = v;\n    float* p = y"),
        ("p[ch] = __fdiv_rn(clip255(o[ch]), 255.f);", "p[ch] = o[ch];"),
        ("    float o[3];\n    to_rgb(v, o);\n    const float* pg",
         "    const float* o = v;\n    const float* pg"),
        ("gr[ch] = __fmul_rn(__fdiv_rn(pg[ch], 255.f), clip255_grad(o[ch]));",
         "gr[ch] = __fmul_rn(pg[ch], o[ch]);"),
    ],
    "no_load": [
        ("    const float* p = x + (g.px0 + (long long)py * W + px) * 3;\n"
         "    const float v[3] = {__fmul_rn(p[0], 255.f), __fmul_rn(p[1], "
         "255.f),\n                        __fmul_rn(p[2], 255.f)};\n",
         "    const float v[3] = {(float)((t * 7 + m) & 255), (float)(py * 9),"
         " (float)(px * 5)};\n"),
        ("    const float* pg = g + (gm.px0 + (long long)py * W + px) * 3;\n",
         "    const float pg[3] = {(float)t, 1.f, -1.f};\n"),
    ],
    "no_div": [(ALL, "__fdiv_rn(", "__fmul_rn(")],
}

# this source: two routes chosen by kernels/diffjpeg.py::plan
ROUTED = {
    "no_transform": [
        (ALL, "to_ycc(v, p);", "p[0] = v[0], p[1] = v[1], p[2] = v[2];"),
        (ALL, "to_rgb(v, o);", "o[0] = v[0], o[1] = v[1], o[2] = v[2];"),
        ("// ------------------------------------------------------------ "
         "bytes route\n",
         "template <typename... A>\n__device__ __forceinline__ void "
         "no_block(A...) {}\n"),
        (ALL, "block_fwd<kSave>(tile", "no_block(tile"),
        (ALL, "block_bwd(tile", "no_block(tile"),
        (ALL, "lat_passes<0>(L, M, b, r, s, f, dr);", ""),
        (ALL, "lat_passes<1>(L, M, b, r, s, f, dr);", ""),
        (ALL, "lat_passes<2>(L, M, b, r, s, f, dr);", ""),
        (ALL, "__fdiv_rn(", "__fmul_rn("),
    ],
    "no_load": [
        ("    vwfd::mbar_expect_tx(bar, 16 * a.bytes * (kBwd ? 2 : 1));",
         "    vwfd::mbar_arrive(bar);"),
        ("    vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(sx + s * "
         "kSlotF),",
         "    if (0) vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(sx + s "
         "* kSlotF),"),
        ("      vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(sg + s * "
         "kSlotF),",
         "      if (0) vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(sg + "
         "s * kSlotF),"),
        ("    reinterpret_cast<float4*>(s)[i] = __ldg(\n"
         "        reinterpret_cast<const float4*>(src + (px0 + (long long)r * "
         "W) * 3) +\n        k);",
         "    reinterpret_cast<float4*>(s)[i] = make_float4(i, 1.f, 2.f, k);"),
    ],
    "no_div": [(ALL, "__fdiv_rn(", "__fmul_rn(")],
}


def patched(src: str, patches) -> str:
    for patch in patches:
        if patch[0] is ALL:
            _, old, new = patch
            n = src.count(old)
        else:
            old, new = patch
            n = src.count(old)
            if n != 1:
                sys.exit(f"ablate_diffjpeg: the patch anchor {old[:70]!r} is "
                         f"found {n} times in diffjpeg.cu (expected once): "
                         f"the source changed under the patch")
        if n == 0:
            sys.exit(f"ablate_diffjpeg: {old[:70]!r} is not in diffjpeg.cu")
        src = src.replace(old, new)
    return src


def build(name: str, src: str, csrc: Path, out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"diffjpeg_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"diffjpeg_{name}.so"
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(csrc),
           "-o", str(so), str(cu)]
    return cmd, so


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=30).stdout.strip().splitlines()[0]


def time_ms(fn, reps):
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
    ap.add_argument("--csrc", type=Path, default=_lib.CSRC)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--variants", nargs="*",
                    default=["no_transform", "no_load", "no_div"])
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="NxHxW each (default: 64x256x256 1x32x32)")
    args = ap.parse_args(argv)
    shapes = SHAPES if args.shapes is None else [
        (*map(int, v.split("x")), 3) for v in args.shapes]
    if not torch.cuda.is_available():
        sys.exit("ablate_diffjpeg: needs a CUDA card")
    src = (args.csrc / "diffjpeg.cu").read_text()
    routed = "diffjpeg_fwd_bytes" in src
    table = ROUTED if routed else FIRST
    for v in args.variants:
        if v not in table:
            sys.exit(f"ablate_diffjpeg: no variant {v!r} (choose from "
                     f"{sorted(table)})")
    out_dir = _lib.BUILD_DIR.parent / "ablate_diffjpeg" / (
        "routed" if routed else "first")
    names = ["base", *args.variants]
    jobs = [build(n, patched(src, table.get(n, [])), args.csrc, out_dir)
            for n in names]
    _lib._run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
               for cmd, _ in jobs])

    from vwfd_tpu_torch.kernels import diffjpeg
    g = torch.Generator("cuda").manual_seed(28)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = torch.zeros(1, device="cuda")
    rec = {"card": card(), "source": str(args.csrc),
           "design": "routed" if routed else "first",
           "floor_ms": time_ms(lambda: one.add_(1.0), args.reps), "ms": {}}
    for shape in shapes:
        n, h, w, _ = shape
        x = torch.rand(shape, device="cuda", generator=g)
        cot = torch.randn(shape, device="cuda", generator=g)
        f = torch.full((n,), quality_to_factor(75), device="cuda")
        y, gx = torch.empty_like(x), torch.empty_like(x)
        key = "x".join(map(str, shape))
        # the routed source at each shape on each route, each on the whole
        # card: the bytes route's persistent grids as plan sizes them for
        # this card, the latency route's a CTA a macroblock
        plans = [None]
        if routed:
            plans = [diffjpeg.plan(n, h, w, sms, r)
                     for r in ("bytes", "latency")]
            rec.setdefault("planned", {})[key] = diffjpeg.plan(
                n, h, w, sms).route
        for p in plans:
            pkey = key if p is None else f"{key}_{p.route}"
            rec["ms"][pkey] = {}
            extra = [] if p is None else [diffjpeg.ROUTES[p.route]]
            for (_, so), name in zip(jobs, names):
                lib = ctypes.CDLL(str(so))
                fwd_c, bwd_c = lib.vwfd_diffjpeg_fwd, lib.vwfd_diffjpeg_bwd
                nx = 3 + (2 if p is not None else 0)
                fwd_c.argtypes = [_lib._P] * 3 + [_lib._I] * nx + [_lib._P]
                bwd_c.argtypes = [_lib._P] * 4 + [_lib._I] * nx + [_lib._P]
                fwd_c.restype = bwd_c.restype = ctypes.c_int
                gf = [] if p is None else [p.grid_fwd]
                gb = [] if p is None else [p.grid_bwd]

                def fwd():
                    rc = fwd_c(x.data_ptr(), y.data_ptr(), f.data_ptr(), n,
                               h, w, *extra, *gf, stream)
                    assert rc == 0, rc

                def bwd():
                    rc = bwd_c(x.data_ptr(), cot.data_ptr(), gx.data_ptr(),
                               f.data_ptr(), n, h, w, *extra, *gb, stream)
                    assert rc == 0, rc
                rec["ms"][pkey][name] = {"fwd": time_ms(fwd, args.reps),
                                         "bwd": time_ms(bwd, args.reps)}
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
