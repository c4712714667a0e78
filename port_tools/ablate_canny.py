"""Where K19's four launches spend their time: a per-phase clock inside each
CTA, from a patched copy of ``csrc/canny.cu``.

    python port_tools/ablate_canny.py [--shape N H W] [--reps 20]
        [--variants NAME ...] [--out FILE]

Needs one CUDA card and ``nvcc``. Compiles ``canny.cu`` into libraries of
their own under ``build/ablate_canny/``: as it is (``base``), with a
clock (``timeline``: thread 0 of each CTA adds the ``clock64()`` cycles
between the phase points below, each taken after the phase's barrier, to
per-kernel counters), and each of ``--variants`` (another minimum of CTAs
an SM, that is another register cap, for one kernel; ``max_forward``: the
max kernel taking the images in the map kernel's order). Runs each through
the C interface on 8-bit-level images with a normal cotangent, times the
forward and the backward of each
with CUDA events over ``--reps`` calls behind a device sleep, and reads the
counters of one more call of the timeline build: the mean cycles a CTA
spends in each phase, split into edge tiles (the reflect, mask and fold
code) and interior ones. Phases:

- ``max``: gray (±3) and the gaussian (±1); the mirror at edges,
  the Sobel and the tile's max;
- ``map``: gray (±4) and the gaussian (±2); the mirror, waiting for ``max``
  and reading its slots; mag (±1); the NMS and the thresholds;
- ``local``: gray (±5) and the gaussian (±3); the mirror and mag (±2); the
  sweep;
- ``input``: waiting for ``local``; the planes (±3); the slots' sums and the
  ties (the phase is 0 on a tile that recomputes); the Sobel's transpose;
  then on interior tiles the gaussian's transpose and dx, on edge tiles the
  Sobel's folds, the gaussian's transpose, its folds, dx.

Prints one JSON line (and appends it to ``--out``) with the card's name,
power limit and SM clock. The patches name lines of the source; when the
source changes under them, the script stops and says which. A measurement
tool, not part of the package: nothing imports it.
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
from vwfd_tpu_torch.kernels import _lib, canny  # noqa: E402

KERNELS = ("max", "map", "local", "input")
PHASES = {
    "max": ["gray_gaussian", "mirror_sobel_max"],
    "map": ["gray_gaussian", "mirror_wait_slots", "mag", "nms"],
    "local": ["gray_gaussian", "mirror_mag", "sweep"],
    "input": ["wait", "planes", "slots_ties", "sobel_t", "gauss_t_dx",
              "fold_sobel", "gauss_t", "fold_gauss", "dx"],
}

_HEAD = (
    '#include "common.cuh"\n', '#include "common.cuh"\n'
    "__device__ unsigned long long k19_acc[2][4][10];\n"
    "__device__ unsigned long long k19_cnt[2][4];\n"
    "__shared__ long long k19_last;\n"
    "__shared__ int k19_edge;\n"
    "#define K19T0(k, e) do { if (threadIdx.x == 0) { k19_edge = (e); "
    "k19_last = clock64(); atomicAdd(&k19_cnt[k19_edge][k], 1ull); } } "
    "while (0)\n"
    "#define K19T(k, p) do { if (threadIdx.x == 0) { const long long t_ = "
    "clock64(); atomicAdd(&k19_acc[k19_edge][k][p], (unsigned long long)"
    "(t_ - k19_last)); k19_last = t_; } } while (0)\n"
    'extern "C" int k19_read(unsigned long long* a, unsigned long long* c) '
    "{ cudaError_t e = cudaMemcpyFromSymbol(a, k19_acc, sizeof(k19_acc)); "
    "if (e == cudaSuccess) e = cudaMemcpyFromSymbol(c, k19_cnt, "
    "sizeof(k19_cnt)); return (int)e; }\n"
    'extern "C" int k19_reset() { static unsigned long long z[90] = {0}; '
    "cudaError_t e = cudaMemcpyToSymbol(k19_acc, z, sizeof(k19_acc)); "
    "if (e == cudaSuccess) e = cudaMemcpyToSymbol(k19_cnt, z, "
    "sizeof(k19_cnt)); return (int)e; }\n")


def _after(anchor, line):
    return anchor, anchor + line


TIMELINE = [
    _HEAD,
    # max
    _after("  float* S = sm + Region<3>::size;\n", "  K19T0(0, kEdge);\n"),
    _after("  stage_gray_smooth<1, kEdge>(x, tl, G, S);\n", "  K19T(0, 0);\n"),
    _after("  best = block_max(best, red);\n", "  K19T(0, 1);\n"),
    # map
    _after("  float* S = sm + cmax(Region<4>::size, RM::size);\n",
           "  K19T0(1, kEdge);\n"),
    _after("  stage_gray_smooth<2, kEdge>(x, tl, MG, S);\n",
           "  K19T(1, 0);\n"),
    _after("  const float D = __fadd_rn(image_max(mslot, tl), 1e-12f);"
           "  // syncs\n", "  K19T(1, 1);\n"),
    _after("  stage_mag<1, kEdge>(tl, S, D, MG);\n  __syncthreads();\n",
           "  K19T(1, 2);\n"),
    ("    y[tl.pixel(r, c)] = threshold(q.e);\n  }\n}",
     "    y[tl.pixel(r, c)] = threshold(q.e);\n  }\n  __syncthreads();\n"
     "  K19T(1, 3);\n}"),
    # local
    _after("  float* S = sm + cmax(Region<5>::size, Region<2>::size);\n",
           "  K19T0(2, kEdge);\n"),
    _after("  stage_gray_smooth<3, kEdge>(x, tl, MG, S);\n",
           "  K19T(2, 0);\n"),
    _after("  stage_mag<2, kEdge>(tl, S, D, MG);\n  __syncthreads();\n",
           "  K19T(2, 1);\n"),
    _after("  sweep<kEdge>(tl, MG, S, gout, D, M, px, py, psum, pcnt, tie_n,"
           " tie_pos,\n               tie_g);\n",
           "  __syncthreads();\n  K19T(2, 2);\n"),
    # input
    ("  const Tile tl(H, W, tiles_y, tiles_x);\n  // canny_local_kernel's "
     "slots, lists and planes of this image\n  wait_image(done, tl.n, "
     "tl.slots);",
     "  const Tile tl(H, W, tiles_y, tiles_x);\n  K19T0(3, tl.edge(4));\n"
     "  wait_image(done, tl.n, tl.slots);\n  K19T(3, 0);"),
    _after("  load_dgrad<kEdge, false>(tl, px, py, nullptr, 0.f, 0.f, DX, DY);"
           "\n", "  __syncthreads();\n  K19T(3, 1);\n"),
    _after("    add_ties(tl, pcnt, tie_pos, tie_g, tiles_y, tiles_x, share, "
           "DX, DY);\n    __syncthreads();\n", "    K19T(3, 2);\n"),
    _after("  stage_sobel_t(DX, DY, dS);\n  __syncthreads();\n",
           "  K19T(3, 3);\n"),
    ("      store_dx(dx, tl, tl.r0 + lr, tl.c0 + lc, v);\n    });\n"
     "    return;",
     "      store_dx(dx, tl, tl.r0 + lr, tl.c0 + lc, v);\n    });\n"
     "    __syncthreads();\n    K19T(3, 4);\n    return;"),
    _after("  fold_sobel_t(tl, DX, DY, dS, lines);\n  __syncthreads();\n",
           "  K19T(3, 5);\n"),
    _after("    lines[1].find(tl.c0, tl.c0 + kTW, tl.W, 2);\n  }\n"
           "  __syncthreads();\n", "  K19T(3, 6);\n"),
    ("  });\n  __syncthreads();\n  for (int i = threadIdx.x; i < "
     "Region<0>::size; i += kThreads) {\n",
     "  });\n  __syncthreads();\n  K19T(3, 7);\n  for (int i = threadIdx.x;"
     " i < Region<0>::size; i += kThreads) {\n"),
    ("    if (tl.in_image(a, b)) store_dx(dx, tl, a, b, dG[i]);\n  }\n}",
     "    if (tl.in_image(a, b)) store_dx(dx, tl, a, b, dG[i]);\n  }\n"
     "  __syncthreads();\n  K19T(3, 8);\n}"),
]


def _bounds(kernel, blocks, new_blocks):
    """A variant with another minimum of CTAs an SM for one kernel."""
    return (f"__launch_bounds__(kThreads, {blocks})\n{kernel}(",
            f"__launch_bounds__(kThreads, {new_blocks})\n{kernel}(")


# the max kernel back to taking the images first to last (as the map kernel)
_MAX_FORWARD = ("  tl.n = gridDim.z - 1 - tl.n;\n", "")


# variants timed beside ``base``: each kernel's CTAs an SM (its register
# cap) one step either side of the source's; the max kernel's image order
VARIANTS = {
    "max_6": [_bounds("canny_max_kernel", 8, 6)],
    "map_7": [_bounds("canny_map_kernel", 6, 7)],
    "map_5": [_bounds("canny_map_kernel", 6, 5)],
    "local_4": [_bounds("canny_local_kernel", 5, 4)],
    "input_4": [_bounds("canny_input_kernel", 5, 4)],
    "max_forward": [_MAX_FORWARD],
}


def patched(src: str, patches) -> str:
    for old, new in patches:
        if src.count(old) != 1:
            sys.exit(f"ablate_canny: the patch anchor {old[:70]!r} is found "
                     f"{src.count(old)} times in canny.cu (expected once): "
                     f"the source changed under the patch")
        src = src.replace(old, new)
    return src


def build(name: str, src: str, out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"canny_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"canny_{name}.so"
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(_lib.CSRC),
           "-o", str(so), str(cu)]
    return cmd, so


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=30).stdout.strip().splitlines()[0]
    return out


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
    ap.add_argument("--shape", type=int, nargs=3, default=[48, 256, 256])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(VARIANTS),
                    help="other builds to time beside base")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ablate_canny: needs a CUDA card")
    src = (_lib.CSRC / "canny.cu").read_text()
    out_dir = _lib.BUILD_DIR.parent / "ablate_canny"
    names = ["base", "timeline", *args.variants]
    jobs = [build(name, patched(src, TIMELINE if name == "timeline" else
                                VARIANTS.get(name, [])), out_dir)
            for name in names]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd, _ in jobs]
    _lib._run(procs)

    n, h, w = args.shape
    p = canny.plan(n, h, w)
    g = torch.Generator("cuda").manual_seed(71)
    x = torch.randint(0, 256, (n, h, w, 3), device="cuda",
                      generator=g).float() / 255.0
    cot = torch.randn((n, h, w), device="cuda", generator=g)
    i32 = dict(device="cuda", dtype=torch.int32)
    f32 = dict(device="cuda", dtype=torch.float32)
    mslot, y = torch.empty(n * p.slots, **i32), torch.empty(n, h, w, **f32)
    psum, pcnt = torch.empty(n * p.slots, **f32), torch.empty(n * p.slots,
                                                              **i32)
    tie_pos = torch.empty(n * p.slots * canny.TIES, **i32)
    tie_g = torch.empty(2 * n * p.slots * canny.TIES, **f32)
    planes, dx = torch.empty(2, n, h, w, **f32), torch.empty(n, h, w, 3,
                                                             **f32)
    done = torch.zeros(4 * n, **i32)  # the kernels leave their counts at 0
    stream = torch.cuda.current_stream().cuda_stream
    rec = {"card": card(), "shape": [n, h, w, 3], "ms": {}, "cycles": {}}
    for (_, so), name in zip(jobs, names):
        lib = ctypes.CDLL(str(so))
        for fn in ("vwfd_canny_fwd", "vwfd_canny_bwd"):
            getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int

        def fwd():
            rc = lib.vwfd_canny_fwd(x.data_ptr(), mslot.data_ptr(),
                                    y.data_ptr(), done.data_ptr(), n, h, w,
                                    p.tiles_y, p.tiles_x, stream)
            assert rc == 0, rc

        def bwd():
            rc = lib.vwfd_canny_bwd(
                x.data_ptr(), cot.data_ptr(), mslot.data_ptr(),
                psum.data_ptr(), pcnt.data_ptr(), tie_pos.data_ptr(),
                tie_g.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(),
                dx.data_ptr(), done[2 * n:].data_ptr(), n, h, w, p.tiles_y,
                p.tiles_x, stream)
            assert rc == 0, rc
        rec["ms"][name] = {"fwd": time_ms(fwd, args.reps),
                           "bwd": time_ms(bwd, args.reps)}
        if name != "timeline":
            continue
        lib.k19_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        assert lib.k19_reset() == 0
        fwd()
        bwd()
        torch.cuda.synchronize()
        acc = (ctypes.c_ulonglong * 80)()
        cnt = (ctypes.c_ulonglong * 8)()
        assert lib.k19_read(acc, cnt) == 0
        for edge in (0, 1):
            for k, kern in enumerate(KERNELS):
                ctas = cnt[edge * 4 + k]
                key = f"{kern}_{'edge' if edge else 'interior'}"
                rec["cycles"][key] = {"ctas": ctas, **{
                    ph: acc[(edge * 4 + k) * 10 + i] / max(ctas, 1)
                    for i, ph in enumerate(PHASES[kern])}}
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
