"""Convergence runs of the message and image families (port of
tools/run_family_convergence.py; MBRS: ``_mbrs``, :351-420).

    python -m vwfd_tpu_torch.run_family_convergence --task mbrs \\
        --steps 15000 --eval-every 500 --out runs/conv_torch_mbrs.jsonl \\
        --ckpt-dir build/mbrs_ckpt
    # the same run in segments: each ends cleanly with a checkpoint
    python -m vwfd_tpu_torch.run_family_convergence --task mbrs ... \\
        --resume --stop-at-step 5000
    python -m vwfd_tpu_torch.run_family_convergence --task mbrs --steps 4 \\
        --eval-every 2 --log-every 1 --size 32 --batch 2 --device cpu \\
        --out build/mbrs.jsonl

``--task mbrs`` trains ``MBRSModel`` (128², b16 unless ``--size`` /
``--batch``) on the JAX runner's data: ``SyntheticImageDataset(size, 2000,
10)`` through ``Loader(..., seed=10, ratio=200)`` and messages from
``default_rng(10)`` (10 is the JAX runner's ``cfg.train.seed``), so its
batches and messages are the JAX run's. The weights and the noise draws
(``MBRSSampler``) come from ``--seed`` (default 0): ``jax.random`` cannot
be replayed. Adam runs at the model's 1e-3, the rate the JAX record
trained at (its config line's ``"lr": 1e-05`` is a config value its runner
never passed); the config line here states the rate used.

The JSONL record is the JAX runner's, key for key: a config line (with the
device, its name and the seeds), at step 1 and every ``--log-every`` steps
the logs (``loss``, ``encoder_mse``, ``message_mse``, ``bitwise_error``)
and ``wall`` (seconds since the start), and at every ``--eval-every`` step
and the last an eval record on 16 held-out images (``SyntheticImageDataset
(size, 16, 10 + 7777)``, messages from ``default_rng(7777)``): the encoded
PSNR (``psnr255_int`` of the clipped encoding) and the bitwise error on it
(``bitwise_error_identity``) and after PIL's libjpeg at QF 50, 70 and 90
(``bitwise_error_jpeg{q}``, ``attacks.jpeg_real``). A last line gives
``wall_s`` and ``ms_per_step`` (the run's wall time over its steps, evals
included).

``--resume`` restores the latest checkpoint of ``--ckpt-dir`` (parameters,
BatchNorm statistics, Adam moments and count), keeps ``--out`` up to that
step and continues with the batches, messages and draws an unbroken run
would see (the loader's order, the message and draw generators replayed
to the step). ``--stop-at-step`` ends a segment with a checkpoint. Only
the latest checkpoint is kept. Runs on the CUDA card unless ``--device
cpu``; without a card it raises. The other tasks are not ported yet: each
raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .attacks import jpeg_real
from .data import Loader, SyntheticImageDataset
from .metrics import bitwise_message_error, psnr255_int
from .models import MBRSModel
from .models.mbrs_model import MBRSSampler
from .models.state import latest_step, restore_checkpoint
from .run_convergence import _keep_upto, _save
from .utils import setup_logger

__all__ = ["DATA_SEED", "EVAL_QUALITIES", "NOT_PORTED", "MBRSStreams",
           "parse_args", "run", "main"]

DATA_SEED = 10  # the JAX runner's cfg.train.seed: data and messages
EVAL_QUALITIES = (50, 70, 90)
NOT_PORTED = {"tianchi": "ROADMAP.md §1, its Tianchi item",
              "pami": "ROADMAP.md §1, its image family item",
              "clr": "ROADMAP.md §1, its image family item",
              "imuge": "ROADMAP.md §1, its image family item",
              "kdjpeg": "ROADMAP.md §1, its KD-JPEG item"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", required=True,
                    choices=("mbrs", *NOT_PORTED))
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="the weights' and the noise draws' seed")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--eval-batch", type=int, default=16)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir")
    ap.add_argument("--stop-at-step", type=int, default=None,
                    help="end this segment with a checkpoint at this step")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if (args.resume or args.stop_at_step) and not args.ckpt_dir:
        ap.error("--resume and --stop-at-step need --ckpt-dir")
    return args


class MBRSStreams:
    """The run's batches, messages and noise draws from step ``start + 1``
    on, as an unbroken run sees them."""

    def __init__(self, model: MBRSModel, batch: int, seed: int,
                 start: int = 0):
        ds = SyntheticImageDataset(size=model.image_size, length=2000,
                                   seed=DATA_SEED)
        loader = Loader(ds, batch, seed=DATA_SEED, ratio=200)
        self.batches = loader.stream(start)
        self.rng = np.random.default_rng(DATA_SEED)
        self.sampler = MBRSSampler(seed)
        self.shape = (batch, model.message_length)
        for _ in range(start):
            self.rng.random(self.shape)
            self.sampler()

    def __next__(self):
        imgs = next(self.batches)
        msgs = (self.rng.random(self.shape) > 0.5).astype(np.float32)
        return imgs, msgs, self.sampler()


def eval_set(size: int, n: int, message_length: int):
    """The held-out images and messages of the JAX runner."""
    held = SyntheticImageDataset(size=size, length=n, seed=DATA_SEED + 7777)
    imgs = np.stack([held[i] for i in range(n)])
    msgs = (np.random.default_rng(7777).random((n, message_length))
            > 0.5).astype(np.float32)
    return imgs, msgs


def mbrs_eval(model: MBRSModel, imgs: np.ndarray, msgs: np.ndarray) -> dict:
    """Encoded PSNR and the bitwise errors on identity and after libjpeg."""
    it, mt = model.to_device(imgs, msgs)
    enc = torch.clamp(model.encode(it, mt), 0, 1)
    rec = {"psnr_encoded": float(psnr255_int(it, enc))}
    enc_np = enc.cpu().numpy()
    for q in EVAL_QUALITIES:
        dec = model.decode(jpeg_real(enc_np, q))
        rec[f"bitwise_error_jpeg{q}"] = float(bitwise_message_error(dec, mt))
    rec["bitwise_error_identity"] = float(bitwise_message_error(
        model.decode(enc), mt))
    return rec


def _emit(f, rec: dict) -> None:
    line = json.dumps(rec)
    f.write(line + "\n")
    f.flush()
    print(line, flush=True)


def run(args: argparse.Namespace,
        on_step: Optional[Callable] = None) -> str:
    """The run of ``args`` (``parse_args``); ``on_step(step, images,
    messages, draws)``, if given, sees each train step's inputs. Returns
    ``"done"`` or ``"stopped"`` (a segment's end)."""
    if args.task in NOT_PORTED:
        raise NotImplementedError(f"--task {args.task} is not ported yet: "
                                  f"{NOT_PORTED[args.task]}")
    log = setup_logger("base")
    model = MBRSModel(image_size=args.size, device=args.device)
    model.init_states(args.seed)
    out_path = args.out or os.path.join("build", "conv_torch_mbrs.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    start = latest_step(args.ckpt_dir) if args.resume else None
    if start is not None:
        restore_checkpoint(args.ckpt_dir, start, model)
        wall0 = _keep_upto(out_path, start, "wall")
        log.info("resumed from step %d of %s", start, args.ckpt_dir)
    else:
        start, wall0 = 0, 0.0
        cuda = model.device.type == "cuda"
        with open(out_path, "w") as f:
            _emit(f, {"config": True, "task": args.task, "size": args.size,
                      "batch": args.batch, "steps": args.steps,
                      "lr": model.lr, "seed": args.seed,
                      "data_seed": DATA_SEED, "device": model.device.type,
                      "device_name": (torch.cuda.get_device_name(
                          model.device) if cuda else "cpu")})
    streams = MBRSStreams(model, args.batch, args.seed, start)
    held = eval_set(args.size, args.eval_batch, model.message_length)
    t0 = time.time()
    step = start
    with open(out_path, "a") as f:
        for step in range(start + 1, args.steps + 1):
            imgs, msgs, draws = next(streams)
            if on_step is not None:
                on_step(step, imgs, msgs, draws)
            logs = model.train_step(imgs, msgs, draws)
            if step % args.log_every == 0 or step == 1:
                _emit(f, {"step": step, "wall": wall0 + time.time() - t0,
                          **{k: float(v) for k, v in logs.items()}})
            if step % args.eval_every == 0 or step == args.steps:
                _emit(f, {"step": step, "eval": True,
                          **mbrs_eval(model, *held)})
            if args.ckpt_dir and step % args.save_every == 0:
                _save(model, args.ckpt_dir, step, log)
            if step == args.stop_at_step and step < args.steps:
                _save(model, args.ckpt_dir, step, log)
                log.info("stopped at step %d: continue with --resume", step)
                return "stopped"
        wall = time.time() - t0
        _emit(f, {"step": step, "done": True, "wall_s": wall0 + wall,
                  "ms_per_step": wall / max(step - start, 1) * 1e3})
    if args.ckpt_dir:
        _save(model, args.ckpt_dir, step, log)
    log.info("wrote %s", out_path)
    return "done"


def main(argv=None) -> str:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
