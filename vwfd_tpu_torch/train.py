"""Training CLI of the port (counterpart of ``train.py --task video
--synthetic --steps N``).

    python -m vwfd_tpu_torch.train --synthetic --steps 100
    python -m vwfd_tpu_torch.train --synthetic --steps 3 --device cpu \\
        --batch 2 --size 32 --frames 2

Trains the flagship video model (``configs/video.yaml`` unless ``--config``)
on the synthetic dataset for N steps (the first batch only seeds the
previous-batch buffer) and prints one JSON line: the last step's losses
(``loss``, ``lF``, ``lB``, ``PF``), ms per step and frames/s (B·T per step
time) over the steps after the first, and the device. Runs on the CUDA card
unless ``--device cpu``; without a card it raises. Real datasets, eval and
checkpoints are not ported yet.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from . import FLAGSHIP_CONFIG, load_config
from .data import Loader, SyntheticVideoDataset
from .models import VideoWatermarkModel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", action="store_true", required=True,
                    help="train on the synthetic dataset (the only data "
                         "the port reads yet)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--config", default=None,
                    help="YAML config (defaults to the packaged video.yaml)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_config(args.config or FLAGSHIP_CONFIG)
    data = dict(batch_size=args.batch or cfg.data.batch_size,
                frames=args.frames or cfg.data.frames,
                gt_size=args.size or cfg.data.gt_size, synthetic=True)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))
    model = VideoWatermarkModel(cfg, device=args.device)
    model.init_states(cfg.train.seed)
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    loader = Loader(SyntheticVideoDataset(size=s, frames=t, length=2000,
                                          seed=cfg.train.seed),
                    b, seed=cfg.train.seed)
    cuda = model.device.type == "cuda"
    times, logs, prev = [], {}, None
    batches = iter(loader)
    while len(times) < args.steps:
        video, mask = model.to_device(*next(batches))
        if prev is None:
            prev = video
            continue
        t0 = time.perf_counter()
        out = model.train_step(video, mask, prev)
        if cuda:
            torch.cuda.synchronize(model.device)
        times.append((time.perf_counter() - t0) * 1e3)
        logs = {k: float(v) for k, v in out.items()}
        prev = video
    steady = times[1:] or times
    ms = float(np.median(steady))
    print(json.dumps({
        **logs, "steps": args.steps, "ms_per_step": ms,
        "frames_per_s": b * t / ms * 1e3, "batch": b, "frames": t,
        "size": s, "device": str(model.device),
        "device_name": (torch.cuda.get_device_name(model.device) if cuda
                        else "cpu")}))


if __name__ == "__main__":
    main()
