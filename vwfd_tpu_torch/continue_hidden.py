"""Continue HiDDeN's combined-pool training with hard-member oversampling
(counterpart of ``tools/continue_hidden.py``).

    python -m vwfd_tpu_torch.continue_hidden --from-ckpt checkpoints_hidden_torch \\
        --from-step 15000 --steps 8000 --ckpt-dir build/hidden_torch_r5 \\
        --out runs/hidden_torch_r5.jsonl
    python -m vwfd_tpu_torch.continue_hidden --from-ckpt DIR --steps 4 \\
        --size 32 --batch 2 --log-every 2 --eval-every 2 --eval-batches 1 \\
        --ckpt-dir OUT --device cpu

Restores a port checkpoint (``port_tools/hidden_checkpoint_to_torch.py``
converts a JAX one: params, BatchNorm statistics, Adam moments and counts)
and trains on with the JAX tool's defaults: a weighted combined noiser
(``--weights`` over identity, crop, cropout, dropout, gaussian, jpeg_mask;
default 0.5,2,3,1,0.5,1), the encoder loss weight ``--w-enc`` (1.0), b8 at
128², the same data streams (``SyntheticImageDataset(seed=10)`` through
``Loader(seed=10, ratio=200)``, messages from ``default_rng(10)``) and the
same JSONL records: a config line, the losses every ``--log-every`` steps
with the wall time since the first step began, the per-member eval
(``eval_hidden.evaluate`` on ``--eval-batches`` batches, the paper-geometry
cropout too) every ``--eval-every`` steps and at the end, a checkpoint
every ``--save-every`` steps and at the end. The noise draws come from the
port's sampler (seeded with ``--seed``, by default the start step, as the
JAX tool's key; each eval's from the step); the logs are read from the card only at a log step.
Runs on the CUDA card unless ``--device cpu``.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from .data import Loader, SyntheticImageDataset
from .eval_hidden import evaluate
from .models.hidden_model import (EVAL_MEMBERS, NOISE_POOL, HiddenModel,
                                  HiddenSampler)
from .models.state import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--from-ckpt", default="checkpoints_hidden_torch")
    ap.add_argument("--from-step", type=int, default=None)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--weights", default="0.5,2,3,1,0.5,1",
                    help="noise-pool draw weights: identity,crop,cropout,"
                         "dropout,gaussian,jpeg_mask")
    ap.add_argument("--w-enc", type=float, default=1.0,
                    help="encoder (image fidelity) loss weight")
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--eval-batches", type=int, default=16)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--save-every", type=int, default=2500)
    ap.add_argument("--ckpt-dir", default="checkpoints_hidden_torch_r5")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=None,
                    help="the noise sampler's seed (default: the start "
                         "step, as the JAX tool's key)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    weights = [float(s) for s in args.weights.split(",")]
    model = HiddenModel(image_size=args.size, encoder_loss_weight=args.w_enc,
                        device=args.device)
    step0 = (args.from_step if args.from_step is not None
             else latest_step(args.from_ckpt))
    if step0 is None:
        ap.error(f"no checkpoint under {args.from_ckpt}")
    restore_checkpoint(args.from_ckpt, step0, model)
    cuda = model.device.type == "cuda"

    out = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        out = open(args.out, "a")

    def emit(rec):
        line = json.dumps(rec)
        if out is not None:
            out.write(line + "\n")
            out.flush()
        print(line, flush=True)

    emit({"config": True, "from_step": int(step0), "steps": args.steps,
          "seed": step0 if args.seed is None else args.seed,
          "weights": weights, "w_enc": args.w_enc, "batch": args.batch,
          "pool": list(NOISE_POOL), "device": str(model.device),
          "device_name": (torch.cuda.get_device_name(model.device) if cuda
                          else "cpu")})

    ds = SyntheticImageDataset(size=args.size, length=2000, seed=10)
    loader = Loader(ds, args.batch, seed=10, ratio=200)
    rng = np.random.default_rng(10)
    seed = step0 if args.seed is None else args.seed
    sampler = HiddenSampler(seed, model.device, weights)
    step, target = step0, step0 + args.steps
    t0 = time.time()
    while step < target:
        for imgs in loader:
            if step >= target:
                break
            msgs = (rng.random((imgs.shape[0], model.message_length)) > 0.5
                    ).astype(np.float32)
            logs = model.train_step(imgs, msgs, sampler(imgs.shape))
            step += 1
            if step % args.log_every == 0:
                vals = {k: float(v) for k, v in sorted(logs.items())}
                emit({"step": step, "wall": round(time.time() - t0, 1),
                      **vals})
            if step % args.eval_every == 0 or step == target:
                ev = HiddenSampler(step, model.device, members=EVAL_MEMBERS)
                emit({"step": step, "eval": True,
                      **evaluate(model, args.eval_batches, args.batch, ev)})
            if step % args.save_every == 0 or step == target:
                save_checkpoint(args.ckpt_dir, step, model)
    if cuda:
        torch.cuda.synchronize(model.device)
    emit({"step": step, "done": True,
          "wall_s": round(time.time() - t0, 1),
          "ms_per_step": (time.time() - t0) / max(args.steps, 1) * 1e3})
    if out is not None:
        out.close()


if __name__ == "__main__":
    main()
