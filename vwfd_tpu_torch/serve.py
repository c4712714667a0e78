"""Serving CLI of the port (counterpart of scripts/serve_video.py:82-200).

    python -m vwfd_tpu_torch.serve --mode roundtrip --synthetic 32
    python -m vwfd_tpu_torch.serve --mode roundtrip --latency 50
    python -m vwfd_tpu_torch.serve --mode roundtrip --synthetic 32 \\
        --ckpt-dir checkpoints/video
    python -m vwfd_tpu_torch.serve --mode detect --synthetic 8 --device cpu \\
        --batch 2 --size 64
    python -m vwfd_tpu_torch.serve --mode roundtrip --synthetic 32 --int8 \\
        --int8-embed

Serves synthetic uint8 clips through ``WatermarkServer`` and prints one JSON
line: clips and frames per second over the stream (``--synthetic N``) or
per-request latency percentiles (``--latency N``), with the weights of a
checkpoint directory (``--ckpt-dir``, its latest step or ``--step``), of a
``--weights`` file, or random ones. ``--int8`` serves detect / roundtrip
through the int8 PTQ extractor and ``--int8-embed`` embed / roundtrip
through the int8 PTQ INN, both self-calibrated at start-up
(``WatermarkServer(int8_extract=, int8_embed=, int8_margin=)``). Runs on the CUDA card unless
``--device cpu``. Reading clips from a media folder is not ported
yet.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from . import FLAGSHIP_CONFIG, load_config
from .serving import WatermarkServer


def _materialize(res):
    for k in res.keys():
        getattr(res, "mask" if k == "mask_bits" else k)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="roundtrip",
                    choices=["embed", "detect", "roundtrip"])
    ap.add_argument("--synthetic", type=int, default=0,
                    help="serve N synthetic request batches")
    ap.add_argument("--latency", type=int, default=0,
                    help="serve N synchronous requests; report p50/p95/p99")
    ap.add_argument("--config", default=None,
                    help="YAML config (defaults to the packaged video.yaml)")
    ap.add_argument("--weights", default=None,
                    help="weights file written by serving.save_weights")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (models/state.py layout)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: the latest)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--window", type=int, default=2,
                    help="in-flight request window (double-buffer = 2)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--int8", action="store_true",
                    help="detect/roundtrip through the int8 PTQ extractor "
                         "(nets/unet_int8.py)")
    ap.add_argument("--int8-embed", action="store_true",
                    help="embed/roundtrip through the int8 PTQ INN "
                         "(nets/inn_int8.py)")
    ap.add_argument("--int8-margin", type=float, default=1.0,
                    help="calibration amax head-room multiplier")
    args = ap.parse_args(argv)
    if not (args.synthetic or args.latency):
        ap.error("need --synthetic N or --latency N (media folders are "
                 "not ported yet)")

    cfg = load_config(args.config or FLAGSHIP_CONFIG)
    data = dict(batch_size=args.batch or cfg.data.batch_size,
                frames=args.frames or cfg.data.frames,
                gt_size=args.size or cfg.data.gt_size)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))
    t0 = time.perf_counter()
    server = WatermarkServer(cfg, device=args.device, weights=args.weights,
                             modes=(args.mode,), threshold=args.threshold,
                             ckpt_dir=args.ckpt_dir, step=args.step,
                             int8_extract=args.int8,
                             int8_embed=args.int8_embed,
                             int8_margin=args.int8_margin)
    setup_s = time.perf_counter() - t0
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    clip = np.random.default_rng(0).integers(0, 256, (b, t, s, s, 3),
                                             dtype=np.uint8)
    info = {"mode": args.mode, "batch": b, "frames": t, "size": s,
            "device": str(server.device),
            "device_name": (torch.cuda.get_device_name(server.device)
                            if server.device.type == "cuda" else "cpu"),
            "setup_s": setup_s, "int8": args.int8,
            "int8_embed": args.int8_embed}
    for _ in range(3):  # warm-up: cuDNN/cuBLAS plans, kernel build
        _materialize(server.serve(clip, args.mode))

    if args.latency:
        times = []
        for _ in range(args.latency):
            t1 = time.perf_counter()
            _materialize(server.serve(clip, args.mode))
            times.append((time.perf_counter() - t1) * 1e3)
        times = np.asarray(times)
        info.update(requests=args.latency,
                    p50_ms=float(np.percentile(times, 50)),
                    p95_ms=float(np.percentile(times, 95)),
                    p99_ms=float(np.percentile(times, 99)),
                    mean_ms=float(times.mean()))
    else:
        n = 0
        t1 = time.perf_counter()
        for res in server.serve_stream((clip for _ in range(args.synthetic)),
                                       args.mode, window=args.window):
            _materialize(res)
            n += res.n
        wall = time.perf_counter() - t1
        info.update(requests=args.synthetic, window=args.window, clips=n,
                    wall_s=wall, clips_per_s=n / wall,
                    frames_per_s=n * t / wall)
    print(json.dumps(info))


if __name__ == "__main__":
    main()
