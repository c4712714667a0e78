"""Where the serving roundtrip's, the train step's or the eval step's time
goes on the card.

    python -m vwfd_tpu_torch.profile_roundtrip [--requests 10] [--trace PATH]
    python -m vwfd_tpu_torch.profile_roundtrip --mode train [--requests 5]
    python -m vwfd_tpu_torch.profile_roundtrip --mode eval [--requests 5]

``--mode roundtrip`` (the default) serves the flagship roundtrip
(``configs/video.yaml``: batch 16, T=4, 256², bf16; random weights from a
seed); ``--mode train`` runs the flagship ``train_step`` and ``--mode
eval`` its ``eval_step`` on synthetic batches. Each runs under
``torch.profiler`` after a warm-up, then prints one JSON line: the host
wall time per request (or step), the device time per request by kernel
class (the port's kernels, convolutions, GEMMs, BatchNorm, concatenations,
other elementwise work, copies), the kernels of the GEMM class and the
twelve longest kernels by name, and the device's idle share over the
window (1 − device busy time / host wall time).
Needs the CUDA card; ``--trace`` also writes a Chrome trace.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import FLAGSHIP_CONFIG, load_config
from .data import Loader, SyntheticVideoDataset
from .models import VideoWatermarkModel
from .serving import WatermarkServer

# substrings of the port's kernel names (csrc/*.cu), by kernel
PORT_KERNELS = {"transition": ("transition_entry", "transition_p2p",
                               "transition_p2u"),
                "coupling_head": ("coupling_head",),
                "wire": ("wire_decode_rows", "wire_encode_rows",
                         "u8_to_channels", "channels_to_u8", "u8_to_s2d"),
                "mask_pack": ("mask_pack",),
                "jpeg_pair": ("jpeg_pair",), "median3": ("median3",),
                "f1_sweep": ("f1_sweep_counts",), "ssim": ("ssim_tiles",)}


def classify(name: str) -> str:
    low = name.lower()
    for kernel, keys in PORT_KERNELS.items():
        if any(k in name for k in keys):
            return f"port:{kernel}"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "catarray" in low:  # torch.cat
        return "concat"
    if "batch_norm" in low or "batchnorm" in low or "bn_" in low:
        return "batchnorm"
    # cuDNN's implicit-GEMM convolutions carry "gemm" in their names too
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                              "cudnn")):
        return "convolutions"
    if any(k in low for k in ("gemm", "cutlass", "cublas", "xmma")):
        return "gemm"
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="roundtrip",
                    choices=["roundtrip", "train", "eval"])
    ap.add_argument("--requests", type=int, default=10,
                    help="requests (or train or eval steps) in the window")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    cfg = load_config(FLAGSHIP_CONFIG)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    if args.mode in ("train", "eval"):
        model = VideoWatermarkModel(cfg)
        model.init_states(cfg.train.seed)
        loader = Loader(SyntheticVideoDataset(size=s, frames=t, length=4 * b),
                        b)
        batches = [model.to_device(v, m) for v, m in loader]
        step_fn = model.train_step if args.mode == "train" else \
            model.eval_step
        step = [0]

        def one():
            i = step[0] = step[0] + 1
            video, mask = batches[i % len(batches)]
            prev = batches[(i - 1) % len(batches)][0]
            return step_fn(video, mask, prev)
    else:
        server = WatermarkServer(cfg, modes=("roundtrip",))
        clip = np.random.default_rng(0).integers(0, 256, (b, t, s, s, 3),
                                                 dtype=np.uint8)

        def one():
            r = server.serve(clip, "roundtrip")
            return r.watermarked, r.mask_bits, r.tamper_fraction

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        prof.export_chrome_trace(args.trace)

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, z in sorted(spans):  # union of device intervals
        if z > end:
            busy += z - max(a, end)
            end = z
    by_class = {}
    for name, us in by_name.items():
        c = classify(name)
        by_class[c] = by_class.get(c, 0.0) + us
    n = args.requests
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "card": card, "mode": args.mode, "requests": n, "batch": b,
        "frames": t, "size": s,
        "wall_ms_per_request": wall_us / n / 1e3,
        "device_busy_ms_per_request": busy / n / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_ms_per_request_by_class": {
            k: v / n / 1e3 for k, v in sorted(by_class.items(),
                                               key=lambda kv: -kv[1])},
        "gemm_kernels_ms_per_request": {
            k[:90]: v / n / 1e3 for k, v in by_name.items()
            if classify(k) == "gemm"},
        "top_kernels_ms_per_request": {k[:90]: v / n / 1e3 for k, v in top},
    }))


if __name__ == "__main__":
    main()
