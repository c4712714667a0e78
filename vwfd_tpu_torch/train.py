"""Training and evaluation CLI of the port (counterpart of ``train.py --task
video --synthetic [--steps N | --val] [--resume]``).

    python -m vwfd_tpu_torch.train --synthetic --steps 100
    python -m vwfd_tpu_torch.train --synthetic --steps 3 --device cpu \\
        --batch 2 --size 32 --frames 2
    python -m vwfd_tpu_torch.train --synthetic --val --resume
    python -m vwfd_tpu_torch.train --synthetic --val --val-batches 2 \\
        --device cpu --batch 2 --size 32 --frames 2

Builds the flagship video model (``configs/video.yaml`` unless
``--config``) on the synthetic dataset; the first batch only seeds the
previous-batch buffer. ``--resume`` first restores the latest checkpoint of
the checkpoint directory (``--ckpt-dir``, else the config's ``ckpt_dir``).

Training takes N steps, writes a checkpoint every ``save_interval`` steps
(numbered on from the restored step) and prints one JSON line: the last
step's losses (``loss``, ``lF``, ``lB``, ``PF``), ms per step and frames/s
(B·T per step time) over the steps after the first, and the device.
``--val`` instead runs ``eval_step`` on ``--val-batches`` batches (default
10) and prints one JSON line: the means of ``psnr_forward``,
``ssim_forward`` and ``f1_best``, ms per eval step and frames/s over the
steps after the first, the restored step and the device. Runs on the CUDA
card unless ``--device cpu``; without a card it raises. Real datasets are
not ported yet.
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
from .models.state import latest_step, restore_checkpoint, save_checkpoint


def _timed(model, batches, n, step_fn):
    """Run ``step_fn(video, mask, prev)`` on ``n`` batches after the one
    that seeds the previous-batch buffer; returns each step's outputs as
    floats (0-dim tensors only) and its ms, ended by a synchronize."""
    cuda = model.device.type == "cuda"
    times, outs, prev = [], [], None
    while len(times) < n:
        video, mask = model.to_device(*next(batches))
        if prev is None:
            prev = video
            continue
        t0 = time.perf_counter()
        out = step_fn(video, mask, prev)
        if cuda:
            torch.cuda.synchronize(model.device)
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append({k: float(v) for k, v in out.items() if v.dim() == 0})
        prev = video
    return outs, float(np.median(times[1:] or times))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", action="store_true", required=True,
                    help="use the synthetic dataset (the only data the port "
                         "reads yet)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--val", action="store_true",
                    help="evaluate with eval_step instead of training")
    ap.add_argument("--val-batches", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint first")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: the config's)")
    ap.add_argument("--config", default=None,
                    help="YAML config (defaults to the packaged video.yaml)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if min(args.steps, args.val_batches) < 1:
        ap.error("--steps and --val-batches take at least 1")

    cfg = load_config(args.config or FLAGSHIP_CONFIG)
    data = dict(batch_size=args.batch or cfg.data.batch_size,
                frames=args.frames or cfg.data.frames,
                gt_size=args.size or cfg.data.gt_size, synthetic=True)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data),
                              ckpt_dir=args.ckpt_dir or cfg.ckpt_dir)
    model = VideoWatermarkModel(cfg, device=args.device)
    model.init_states(cfg.train.seed)
    step0 = latest_step(cfg.ckpt_dir) if args.resume else None
    if step0 is not None:
        restore_checkpoint(cfg.ckpt_dir, step0, model)
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    batches = iter(Loader(SyntheticVideoDataset(size=s, frames=t, length=2000,
                                                seed=cfg.train.seed),
                          b, seed=cfg.train.seed))
    if args.val:
        outs, ms = _timed(model, batches, args.val_batches, model.eval_step)
        result = {k: float(np.mean([o[k] for o in outs])) for k in outs[0]}
        result.update(val_batches=args.val_batches, ms_per_eval_step=ms)
    else:
        step = step0 or 0

        def train_step(video, mask, prev):
            nonlocal step
            out = model.train_step(video, mask, prev)
            step += 1
            if step % cfg.train.save_interval == 0:
                save_checkpoint(cfg.ckpt_dir, step, model)
            return out

        outs, ms = _timed(model, batches, args.steps, train_step)
        result = {**outs[-1], "steps": args.steps, "ms_per_step": ms}
    cuda = model.device.type == "cuda"
    print(json.dumps({
        **result, "frames_per_s": b * t / ms * 1e3, "batch": b, "frames": t,
        "size": s, "resumed_step": step0, "device": str(model.device),
        "device_name": (torch.cuda.get_device_name(model.device) if cuda
                        else "cpu")}))


if __name__ == "__main__":
    main()
