"""Where K16's and K17's launches spend their time: each timed whole and
with one phase cut out, each variant compiled from a patched copy of
``csrc/zigzag.cu`` or ``csrc/crop_resize.cu``.

    python port_tools/ablate_hidden.py [--reps 50]

Needs one CUDA card and ``nvcc``. At HiDDeN's (8, 128, 128, 3) f32, K17's
window (10, 100, 3, 128). Variants of K17: ``base``; ``no_gather`` (the
forward computes nothing: copies and tables only); ``no_w`` and ``no_h``
(the backward without its W or its H transpose); ``band8``, ``band2`` (8
or 2 rows a CTA); ``chunk8`` (8 g rows staged); ``bwd_threads256`` (256
threads a backward CTA, not 512). Of K16 (forward with the clip, writing
the clip's codes; backward reading them): ``base``; ``no_chain`` (no
colour maps or DCTs: copies only); ``no_dct`` (the colour maps without the
DCTs); ``units4`` (4 blocks a unit: 512 CTAs); ``recompute`` (the backward
loads x and recomputes z for the clip's derivative in place of reading the
codes: the other design the kernel's header weighs). The variants that
cut a phase out compute wrong values; only their times mean anything. Each
is timed with CUDA events over ``--reps`` launches behind a device sleep.
Prints one JSON line of ms per kernel and variant, with the card. The
patches name lines of the sources; when a source changes under them, the
script stops and says which. A measurement tool, not part of the package:
nothing imports it.
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
from vwfd_tpu_torch.kernels import _lib, zigzag  # noqa: E402

SHAPE = (8, 128, 128, 3)
APEX = (10.0, 100.0, 3.0, 128.0)

_CROP = {
    "base": [],
    "no_gather": [("  for (int p = threadIdx.x; p < nr * OW; p += kThrF) {",
                   "  for (int p = threadIdx.x; p < 0; p += kThrF) {")],
    "no_w": [("q = threadIdx.x - i * W; i < rows;",
              "q = threadIdx.x - i * W; i < 0;")],
    "no_h": [("q = threadIdx.x - k * W; k < nr;",
              "q = threadIdx.x - k * W; k < 0;")],
    "band8": [("constexpr int kBand = 4;", "constexpr int kBand = 8;")],
    "band2": [("constexpr int kBand = 4;", "constexpr int kBand = 2;")],
    "chunk8": [("constexpr int kChunk = 16;", "constexpr int kChunk = 8;")],
    "bwd_threads256": [("constexpr int kThrB = 512;",
                        "constexpr int kThrB = 256;")],
}
_ZIGZAG = {
    "base": [],
    "no_chain": [("    chain(stage, smid, stage, px, ch, c, rgb_to_yuv(ch),",
                  "    if (false) chain(stage, smid, stage, px, ch, c, "
                  "rgb_to_yuv(ch),"),
                 ("    chain(stage, smid, stage, px, ch, c, yuv_to_rgb_t(ch),",
                  "    if (false) chain(stage, smid, stage, px, ch, c, "
                  "yuv_to_rgb_t(ch),")],
    "no_dct": [("  float a[8], row[8];\n  dct8<false>(v, a);",
                "  float a[8], row[8];\n  if (v[0] != 12345.f) return;\n"
                "  dct8<false>(v, a);")],
    "units4": [("constexpr int kBlk = 8; ", "constexpr int kBlk = 4; ")],
    # the backward loads x (handed over in the code pointer's place),
    # recomputes z in a third stage and takes clip'(z) from it
    "recompute": [
        ("  __shared__ __align__(16) float smid[kSlotF];\n",
         "  __shared__ __align__(16) float smid[kSlotF];\n"
         "  __shared__ __align__(16) float sz[kBwd ? kSlotF : 4];\n"),
        ("    vwfd::mbar_expect_tx(b, 8 * rowb);\n",
         "    vwfd::mbar_expect_tx(b, 8 * rowb * (kBwd ? 2 : 1));\n"
         "    if (kBwd)\n"
         "      vwfd::bulk_load_rows(reinterpret_cast<uint8_t*>(sz), "
         "kRowF * 4, reinterpret_cast<const uint8_t*>(\n"
         "            reinterpret_cast<const float*>(code) + a.px0 * 3), 8, "
         "W * 12, rowb, b);\n"),
        ("  if (kBwd && clip && active) {", "  if (false) {"),
        ("          const uint8_t k = codes[r];",
         "          const uint8_t k = clip01_code(sz[r * kRowF + px + ch]);"),
        ("    if (clip) {  // g' = g·clip'(z) in place",
         "    if (clip) {\n      chain(sz, smid, sz, px, ch, c, "
         "rgb_to_yuv(ch), yuv_to_rgb(ch), kp, tile, gm, active);\n"
         "      __syncthreads();  // g' = g·clip'(z) in place"),
        ("  uint8_t* cp = static_cast<uint8_t*>(code);",
         "  uint8_t* cp = static_cast<uint8_t*>(backward ? "
         "const_cast<void*>(x) : code);")],
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


def _build(src: str, patches, name: str, tmp: Path):
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"ablate_hidden: patch for {name} no longer "
                             f"matches the source: {old!r}")
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_hidden: needs a CUDA card")
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.rand(SHAPE, device="cuda", generator=g)
    cot = torch.randn(SHAPE, device="cuda", generator=g)
    out = torch.empty_like(x)
    code = torch.empty(SHAPE, device="cuda", dtype=torch.uint8)
    apex = torch.tensor(APEX, device="cuda")
    n, h, w, c = SHAPE
    st = torch.cuda.current_stream().cuda_stream
    keep = zigzag.keep_bits()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = (_lib.CSRC / "crop_resize.cu").read_text()
        for name, patches in _CROP.items():
            lib = _build(src, patches, f"crop_{name}", Path(tmp))
            res[f"crop_resize {name}"] = {
                "fwd": _time_ms(lambda: _check(lib.vwfd_crop_resize_fwd(
                    x.data_ptr(), apex.data_ptr(), out.data_ptr(), n, h, w,
                    c, h, w, st), "fwd"), args.reps),
                "bwd": _time_ms(lambda: _check(lib.vwfd_crop_resize_bwd(
                    cot.data_ptr(), apex.data_ptr(), out.data_ptr(), n, h,
                    w, c, h, w, st), "bwd"), args.reps)}
        src = (_lib.CSRC / "zigzag.cu").read_text()
        for name, patches in _ZIGZAG.items():
            lib = _build(src, patches, f"zigzag_{name}", Path(tmp))

            def call(bwd):
                _check(lib.vwfd_zigzag_jpeg(
                    x.data_ptr(), cot.data_ptr(), out.data_ptr(),
                    code.data_ptr(), *keep, n, h, w, 1, bwd, st), "zigzag")
            res[f"zigzag_jpeg {name}"] = {
                "fwd": _time_ms(lambda: call(0), args.reps),
                "bwd": _time_ms(lambda: call(1), args.reps)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"ms": res, "card": card}))


if __name__ == "__main__":
    main()
