"""Time K2 `coupling_head` at other W-slice widths and consumer counts.

    python -m vwfd_tpu_torch.sweep_coupling [--configs 64x4,128x3,...]

The bf16 kernel (``csrc/coupling.cu``) picks its W-slice width BN and its
number of consumer warpgroups NC per head width. This script builds a small
library that instantiates the same kernel template at each (BN, NC) of
``--configs`` (one ``nvcc`` call into ``build/vwfd_tpu_torch/``), checks
each against ``coupling_head_plain`` at the flagship's two coupling shapes
(batch 16, 256²: level 48, and the 768-channel levels), and prints its time
beside ``torch.cat`` + ``torch.matmul`` of the same shapes, with the card's
name and power limit. Needs the CUDA card and ``nvcc``.
"""

import argparse
import ctypes
import subprocess
import sys
import time

import torch

from .kernels import _lib, coupling

_SOURCE = """#include "{csrc}/coupling.cu"
extern "C" int sweep_head(int variant, const void* xin, int ldxin,
                          const void* h, int ldh, int kx, int F,
                          const void* w, const void* bias, const void* x,
                          int ldx, void* out, int ldo, int M, int C,
                          void* stream) {{
  Args a{{xin, h, w, static_cast<const float*>(bias), x, out,
         ldxin, ldh, ldx, ldo, kx, kx + F, M, 2 * C, 0}};
  cudaError_t rc = cudaErrorInvalidValue;
  switch (variant) {{
{cases}
  }}
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}}
"""


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call (CUDA events around ``iters`` calls
    queued behind a device sleep, as ``chip_smoke.py`` times kernels)."""
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


def build(configs):
    cases = "\n".join(
        f"    case {i}: rc = launch_bf16<{bn}, {nc}>(a, "
        f"static_cast<cudaStream_t>(stream)); break;"
        for i, (bn, nc) in enumerate(configs))
    src = _SOURCE.format(csrc=_lib.CSRC, cases=cases)
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _lib.BUILD_DIR / "sweep_coupling.cu"
    so = _lib.BUILD_DIR / "libsweep_coupling.so"
    cu.write_text(src)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_head.argtypes = [i, p, i, p, i, i, i, p, p, p, i, p, i, i, i, p]
    lib.sweep_head.restype = i
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="64x4,128x3,128x2,64x2,192x3",
                    help="comma-separated BNxNC")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("sweep_coupling: no CUDA card")
    configs = [tuple(int(v) for v in c.split("x"))
               for c in args.configs.split(",")]
    t0 = time.perf_counter()
    lib = build(configs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"built {len(configs)} variants in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    dev = torch.device("cuda")
    g = torch.Generator("cuda").manual_seed(1)
    for hw, cz in ((64, 192), (32, 768)):
        c, k = cz // 2, cz // 2 + 128
        z = torch.randn(16, hw, hw, cz, device=dev, generator=g).bfloat16()
        h = torch.randn(16, hw, hw, 128, device=dev, generator=g).bfloat16()
        p = {"wh": (torch.randn(cz, k, device=dev, generator=g)
                    / k ** 0.5).bfloat16(),
             "bh": 0.1 * torch.randn(cz, device=dev, generator=g)}
        xin, x = z[..., c:], z[..., :c]
        ref = torch.empty_like(z)
        coupling.coupling_head_plain(xin, h, p, x, out=ref[..., :c])
        cat_mm = time_ms(lambda: torch.matmul(
            torch.cat([xin, h], -1).reshape(-1, k), p["wh"].t()))
        print(f"z={cz} M={16 * hw * hw} K={k} N={cz}: cat+matmul "
              f"{cat_mm:.4f} ms [{card}]")
        for v, (bn, nc) in enumerate(configs):
            out = torch.empty_like(z)
            o = out[..., :c]

            def run():
                rc = lib.sweep_head(
                    v, xin.data_ptr(), cz, h.data_ptr(), 128, c, 128,
                    p["wh"].data_ptr(), p["bh"].data_ptr(), x.data_ptr(), cz,
                    o.data_ptr(), cz, 16 * hw * hw, c,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch refused ({rc})")

            try:
                run()
            except RuntimeError as e:
                print(f"  BN={bn} NC={nc}: {e}")
                continue
            torch.cuda.synchronize()
            same = torch.equal(out[..., :c], ref[..., :c])
            print(f"  BN={bn} NC={nc}: {time_ms(run):.4f} ms "
                  f"equal_to_plain={same}")


if __name__ == "__main__":
    main()
