"""Training and evaluation CLI of the port (counterpart of ``train.py --task
video [--root DIR | --synthetic] [--steps N | --val] [--resume]``).

    python -m vwfd_tpu_torch.train --root /data/DAVIS --steps 1000
    python -m vwfd_tpu_torch.train --synthetic --steps 100
    python -m vwfd_tpu_torch.train --synthetic --steps 3 --device cpu \\
        --batch 2 --size 32 --frames 2
    python -m vwfd_tpu_torch.train --synthetic --val --resume
    python -m vwfd_tpu_torch.train --synthetic --val --val-batches 2 \\
        --device cpu --batch 2 --size 32 --frames 2

Builds the flagship video model (``configs/video.yaml`` unless
``--config``) on DAVIS (``--root``, or the config's ``data.root``: frames
and masks decoded by OpenCV, which must import) or on the synthetic dataset
(``--synthetic``); with neither it stops, it never picks data on its own.
The first batch only seeds the previous-batch buffer. ``--resume`` first
restores the latest checkpoint of the checkpoint directory
(``--ckpt-dir``, else the config's ``ckpt_dir``), the port's own or one
``tools/jax_checkpoint_to_torch.py`` converted from the JAX package.

Training runs ``fit`` for N steps: a progress bar, a checkpoint every
``save_interval`` steps (numbered on from the restored step) and, unless
``--no-telemetry``, the scalar log (``<logdir>/scalars.jsonl``, logdir
``runs/<name>_<task>`` unless ``--logdir``) and a montage PNG every
``montage_interval`` steps in ``<out_dir>/montage``. It prints one JSON
line: the last step's losses (``loss``, ``lF``, ``lB``, ``PF``), ms per
step and frames/s (B·T per step time) over the steps after the first, and
the device. ``--val`` instead runs ``eval_step`` on ``--val-batches``
batches (default 10) and prints one JSON line: the means of
``psnr_forward``, ``ssim_forward`` and ``f1_best``, ms per eval step and
frames/s over the steps after the first, the restored step and the device.
Runs on the CUDA card unless ``--device cpu``; without a card it raises.
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from . import FLAGSHIP_CONFIG, load_config
from .data import DavisVideoDataset, Loader, SyntheticVideoDataset, cv2_readers
from .models import VideoWatermarkModel
from .models.state import latest_step, restore_checkpoint
from .utils import Progbar, ScalarLogger, setup_logger


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


def _dataset(cfg, synthetic: bool, ap):
    d = cfg.data
    if synthetic:
        return SyntheticVideoDataset(size=d.gt_size, frames=d.frames,
                                     length=2000, seed=cfg.train.seed)
    if not d.root:
        ap.error("no data: pass --root (a DAVIS tree) or --synthetic")
    try:
        read_frame, read_mask = cv2_readers()
    except ImportError:
        ap.error("--root needs OpenCV (cv2) to decode the DAVIS JPEG frames "
                 "and PNG masks, and it does not import here")
    return DavisVideoDataset(d.root, read_frame, read_mask, size=d.gt_size,
                             frames=d.frames, mask_rate_max=d.mask_rate_max,
                             seed=cfg.train.seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset")
    ap.add_argument("--root", default=None,
                    help="a DAVIS tree (JPEGImages/480p, Annotations/480p)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--val", action="store_true",
                    help="evaluate with eval_step instead of training")
    ap.add_argument("--val-batches", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint first")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: the config's)")
    ap.add_argument("--logdir", default=None,
                    help="scalar log directory (default runs/<name>_<task>)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="no scalar log and no montages")
    ap.add_argument("--config", default=None,
                    help="YAML config (defaults to the packaged video.yaml)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if min(args.steps, args.val_batches) < 1:
        ap.error("--steps and --val-batches take at least 1")
    if args.synthetic and args.root:
        ap.error("--synthetic and --root exclude each other")

    logger = setup_logger("base")
    cfg = load_config(args.config or FLAGSHIP_CONFIG)
    data = dict(batch_size=args.batch or cfg.data.batch_size,
                frames=args.frames or cfg.data.frames,
                gt_size=args.size or cfg.data.gt_size,
                root=args.root or cfg.data.root, synthetic=args.synthetic)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data),
                              ckpt_dir=args.ckpt_dir or cfg.ckpt_dir)
    dataset = _dataset(cfg, args.synthetic, ap)
    model = VideoWatermarkModel(cfg, device=args.device)
    model.init_states(cfg.train.seed)
    step0 = latest_step(cfg.ckpt_dir) if args.resume else None
    if step0 is not None:
        logger.info("resuming from step %d", step0)
        restore_checkpoint(cfg.ckpt_dir, step0, model)
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    loader = Loader(dataset, b, seed=cfg.train.seed)
    if args.val:
        outs, ms = _timed(model, iter(loader), args.val_batches,
                          model.eval_step)
        result = {k: float(np.mean([o[k] for o in outs])) for k in outs[0]}
        result.update(val_batches=args.val_batches, ms_per_eval_step=ms)
        logger.info("eval: %s", result)
    else:
        scalar_logger = montage_dir = None
        if not args.no_telemetry:
            scalar_logger = ScalarLogger(args.logdir or os.path.join(
                "runs", f"{cfg.name}_{cfg.task}"))
            montage_dir = os.path.join(cfg.out_dir, "montage")
        times = []
        try:
            _, logs = model.fit(loader, args.steps, ckpt_dir=cfg.ckpt_dir,
                                progbar=Progbar(args.steps,
                                                stateful_metrics=["PF"]),
                                scalar_logger=scalar_logger,
                                montage_dir=montage_dir,
                                start_step=step0 or 0, step_ms=times)
        finally:
            if scalar_logger is not None:
                scalar_logger.close()
        ms = float(np.median(times[1:] or times))
        result = {**logs, "steps": args.steps, "ms_per_step": ms}
        logger.info("done: %s", logs)
    cuda = model.device.type == "cuda"
    print(json.dumps({
        **result, "frames_per_s": b * t / ms * 1e3, "batch": b, "frames": t,
        "size": s, "data": "synthetic" if args.synthetic else "davis",
        "resumed_step": step0, "device": str(model.device),
        "device_name": (torch.cuda.get_device_name(model.device) if cuda
                        else "cpu")}))


if __name__ == "__main__":
    main()
