"""Convergence run of the video trainer (port of
tools/run_convergence.py:24-217).

    # the reference shapes, the JAX runner's defaults (ModelConfig()'s nets:
    # res subnets, lifting Haar, the INN module path, the reference UNet)
    python -m vwfd_tpu_torch.run_convergence --steps 10000 --criterion l1 \\
        --eval-every 500 --ckpt-dir build/conv_ckpt --out build/conv.jsonl \\
        [--nets-out DIR]
    # the flagship: packed res_tpu2 INN with conv Haar, UNetTPU
    python -m vwfd_tpu_torch.run_convergence --steps 10000 --criterion l1 \\
        --eval-every 500 --subnet res_tpu2 --extractor unet_tpu --haar conv \\
        --packed --econvs 2,2,1,1,1 --ckpt-dir build/conv_ckpt \\
        --out build/conv.jsonl
    # the same run in segments: each ends cleanly with a checkpoint
    python -m vwfd_tpu_torch.run_convergence ... --resume --stop-at-step 5000
    # the libjpeg line of a saved checkpoint, where PIL is
    python -m vwfd_tpu_torch.run_convergence --libjpeg-only \\
        --ckpt-dir DIR --device cpu --out build/conv.jsonl

Trains on synthetic clips made on the device
(``data/ondevice.py``: the JAX runner's clip family) and writes the JAX
runner's JSONL record, key for key: first the config line (with the
device and its name added), then every 20 steps (``LOG_EVERY``) and at
step 1 the losses ``PF``, ``lB``, ``lF``, ``loss`` and ``wall_s``, with
``psnr_forward``, ``ssim_forward`` and ``f1_best`` of an ``eval_step`` on
the same batch at every ``--eval-every`` step and at the last; the
``bce_finetune`` event line where ``--bce-finetune-at`` switches the
forward criterion to BCE; last the ``libjpeg_f1`` line: ``--libjpeg-batches``
fresh batches through embed, splice and PIL's libjpeg at QF 50, 70 and 90
(``attacks.jpeg_real``). Where PIL does not import, the runner writes no
libjpeg line and says so in the log; ``--libjpeg-only`` appends it later
from the checkpoint on a machine that has PIL.

Every random stream is a function of ``(SEED, step)``: the clips (batch
``step`` is trained on with batch ``step − 1`` spliced in), the train
step's and the eval step's attack draws, and the libjpeg batches. So a run
resumed from a checkpoint (``--resume``: the latest in ``--ckpt-dir``,
parameters, BatchNorm statistics and AdamW moments; ``--out`` is kept up to
that step and appended to) sees exactly what an unbroken run sees.
``--stop-at-step`` ends a segment cleanly with a checkpoint. Only the
latest checkpoint in ``--ckpt-dir`` is kept. ``--nets-out`` also writes
the final nets alone, the extractor's convolutions in the compute dtype
(``models.state.save_nets``).

The model options and their defaults are the JAX runner's
(tools/run_convergence.py:34-52): ``--extractor unet --subnet res --haar
lift``, ``--packed`` off; ``--down-num`` and ``--width`` are the port's own
(``ModelConfig.inn_down_num`` and ``inn_width``, at their defaults the
JAX runner's nets). ``--packed`` needs ``--subnet res_tpu2`` (the JAX
package's rule, ``ValueError``). Runs on the CUDA card unless ``--device
cpu``; without a card it raises.
"""

import argparse
import dataclasses
import json
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch

from .attacks import AttackDraws, jpeg_real, sample_attack_draws
from .config import Config, DataConfig, ModelConfig, TrainConfig
from .data import seeded_generator, synthetic_clips
from .device import resolve_device
from .models import VideoWatermarkModel
from .models.state import (latest_step, load_nets, restore_checkpoint,
                           save_checkpoint, save_nets)
from .utils import setup_logger

__all__ = ["SEED", "LOG_EVERY", "Streams", "model_options", "build_config",
           "parse_args", "run", "main"]

SEED = 0  # the weights' and every stream's seed
LOG_EVERY = 20  # steps between records, as the JAX runner's
# the random streams of a run, each a function of (SEED, step)
CLIPS, TRAIN_DRAWS, EVAL_DRAWS, LIBJPEG_CLIPS = 1, 2, 3, 4


def model_options() -> argparse.ArgumentParser:
    """The options that pick the model and its data shape, shared with
    ``int8_eval`` (an ``argparse`` parent)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--extractor", default="unet",
                    help="unet (reference-exact) | unet_tpu | unet_tpu_slim "
                         "| unet_tpu2")
    ap.add_argument("--subnet", default="res",
                    help="INN coupling subnet: res (reference-exact) | "
                         "res_tpu | res_tpu2 | dense")
    ap.add_argument("--s2d", type=int, default=2,
                    help="UNetTPU space-to-depth stem factor")
    ap.add_argument("--efeatures", type=int, default=64,
                    help="UNetTPU channel base")
    ap.add_argument("--block-num", default=None,
                    help="INN coupling schedule, e.g. '1,1,1'")
    ap.add_argument("--down-num", type=int, default=3,
                    help="INN Haar levels")
    ap.add_argument("--width", type=int, default=0,
                    help="INN coupling trunk width (0: the default)")
    ap.add_argument("--haar", default="lift",
                    help="INN Haar: lift | conv | mixed")
    ap.add_argument("--packed", action="store_true",
                    help="packed-space INN executor (nets/inn_packed.py; "
                         "needs --subnet res_tpu2)")
    ap.add_argument("--econvs", default=None,
                    help="UNetTPU per-level encoder-conv plan, e.g. "
                         "'2,2,1,1,1'")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 parents=[model_options()])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--criterion", default="l1", choices=["l1", "l2", "bce"])
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--out", default=None,
                    help="JSONL record (default build/conv_torch_<criterion>"
                         ".jsonl)")
    ap.add_argument("--bce-finetune-at", type=int, default=0,
                    help="switch the forward criterion to bce after this "
                         "many steps (0: off)")
    ap.add_argument("--libjpeg-batches", type=int, default=4,
                    help="batches of the final real-libjpeg F1 line (0: "
                         "none)")
    ap.add_argument("--libjpeg-only", action="store_true",
                    help="only append the libjpeg line of the latest "
                         "checkpoint in --ckpt-dir (needs PIL)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: the final state, segment "
                         "ends and --resume")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir "
                         "(a fresh start if there is none)")
    ap.add_argument("--stop-at-step", type=int, default=None,
                    help="end this segment cleanly after this step")
    ap.add_argument("--nets-out", default=None,
                    help="also write the final nets alone here "
                         "(models.state.save_nets, compact)")
    ap.add_argument("--init-nets", default=None,
                    help="start from the nets of the latest checkpoint in "
                         "this directory (fresh optimizers, step 0)")
    args = ap.parse_args(argv)
    if (args.libjpeg_only or args.resume or args.stop_at_step is not None) \
            and not args.ckpt_dir:
        ap.error("--libjpeg-only, --resume and --stop-at-step need "
                 "--ckpt-dir")
    if min(args.steps, args.eval_every) < 1:
        ap.error("--steps and --eval-every take at least 1")
    return args


def build_config(args, criterion: str = "l1") -> Config:
    """The JAX runner's ``Config``: the defaults but for the data shape,
    the nets named by ``model_options`` and the forward criterion."""
    mc = {"inn_down_num": args.down_num, "inn_width": args.width,
          "inn_block_num": (tuple(int(s) for s in args.block_num.split(","))
                            if args.block_num else (1,) * args.down_num)}
    return Config(
        data=DataConfig(gt_size=args.size, batch_size=args.batch,
                        frames=args.frames),
        model=ModelConfig(
            extractor=args.extractor, inn_subnet=args.subnet,
            extractor_s2d=args.s2d, extractor_features=args.efeatures,
            inn_haar=args.haar, inn_packed=args.packed,
            extractor_enc_convs=(tuple(int(s) for s in args.econvs.split(","))
                                 if args.econvs else None), **mc),
        train=TrainConfig(forward_criterion=criterion))


class Streams:
    """The run's batches and attack draws, each made on ``device`` from a
    generator seeded by ``(seed, stream, step)`` alone; the runner's
    streams are ``CLIPS`` … ``LIBJPEG_CLIPS``, ``int8_eval``'s its own."""

    def __init__(self, model: VideoWatermarkModel, seed: int):
        d = model.cfg.data
        self.device, self.seed = model.device, seed
        self.b, self.t, self.s = d.batch_size, d.frames, d.gt_size
        self.n_ratios = len(model.attack_ratios)

    def clips(self, step: int, stream: int = CLIPS):
        return synthetic_clips(self.device, self.seed, stream, step, self.b,
                               self.t, self.s)

    def draws(self, step: int, stream: int) -> AttackDraws:
        gen = seeded_generator(self.device, self.seed, stream, step)
        return sample_attack_draws(gen, self.b, self.t, self.n_ratios)


def _with_criterion(model: VideoWatermarkModel, criterion: str) -> None:
    """The l1→bce handoff: the same parameters and optimizer states, a new
    loss (``_loss`` reads the criterion from the config)."""
    model.cfg = dataclasses.replace(model.cfg, train=dataclasses.replace(
        model.cfg.train, forward_criterion=criterion))


def libjpeg_line(model: VideoWatermarkModel, streams: Streams, step: int,
                 batches: int) -> dict:
    """Mean real-libjpeg F1 (``eval_real_jpeg`` with ``jpeg_real``) over
    ``batches`` batches of the libjpeg stream, batch ``i`` spliced with
    batch ``i − 1``."""
    accs = {}
    prev = streams.clips(0, LIBJPEG_CLIPS)[0]
    for i in range(1, batches + 1):
        video, mask = streams.clips(i, LIBJPEG_CLIPS)
        for k, v in model.eval_real_jpeg(video, mask, prev,
                                         jpeg_real).items():
            accs.setdefault(k, []).append(v)
        prev = video
    return {"step": step, "libjpeg_f1": {
        k: round(float(np.mean(v)), 4) for k, v in accs.items()},
        "batches": batches, "device": model.device.type}


def _require_pil() -> None:
    """Raise ``jpeg_real``'s ``ImportError`` where PIL is missing."""
    jpeg_real(np.zeros((8, 8, 3), np.float32), 90)


def _has_pil() -> bool:
    try:
        _require_pil()
    except ImportError:
        return False
    return True


def _keep_upto(path: str, step: int, wall: str = "wall_s") -> float:
    """Drop the records of ``path`` past ``step`` (a segment cut off after
    its last checkpoint); returns the last kept record's ``wall``."""
    if not os.path.exists(path):
        return 0.0
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    kept = [r for r in recs if r.get("step", -1) <= step]
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in kept)
    walls = [r[wall] for r in kept if wall in r]
    return walls[-1] if walls else 0.0


def _keep_latest(ckpt_dir: str, step: int) -> None:
    for d in os.listdir(ckpt_dir):
        if d.isdigit() and int(d) != step:
            shutil.rmtree(os.path.join(ckpt_dir, d))


def _save(model, ckpt_dir: str, step: int, log) -> None:
    save_checkpoint(ckpt_dir, step, model)
    _keep_latest(ckpt_dir, step)
    log.info("saved checkpoint %s step %d", ckpt_dir, step)


def run(args: argparse.Namespace,
        on_step: Optional[Callable] = None) -> str:
    """The run of ``args`` (``parse_args``); ``on_step(step, video, mask,
    prev, draws)``, if given, sees each train step's inputs. Returns
    ``"done"``, ``"stopped"`` (a segment's end) or ``"libjpeg"``."""
    log = setup_logger("base")
    if args.libjpeg_only:
        _require_pil()
    device = resolve_device(args.device)
    cfg = build_config(args, args.criterion)
    model = VideoWatermarkModel(cfg, device=device)
    model.init_states(SEED)
    streams = Streams(model, SEED)
    out_path = args.out or os.path.join(
        "build", f"conv_torch_{args.criterion}.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    if args.libjpeg_only:
        step = latest_step(args.ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
        model.load_states(load_nets(args.ckpt_dir, step))
        rec = libjpeg_line(model, streams, step, args.libjpeg_batches)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec))
        return "libjpeg"

    start = latest_step(args.ckpt_dir) if args.resume else None
    if start is not None:
        restore_checkpoint(args.ckpt_dir, start, model)
        wall0 = _keep_upto(out_path, start)
        log.info("resumed from step %d of %s", start, args.ckpt_dir)
    else:
        if args.init_nets:
            at = latest_step(args.init_nets)
            if at is None:
                raise FileNotFoundError(f"no checkpoint in {args.init_nets}")
            model.load_states(load_nets(args.init_nets, at))
        start, wall0 = 0, 0.0
        cuda = device.type == "cuda"
        with open(out_path, "w") as f:
            f.write(json.dumps({"config": {
                "subnet": args.subnet, "extractor": args.extractor,
                "s2d": args.s2d, "efeatures": args.efeatures,
                "haar": args.haar, "block_num": args.block_num or ",".join(
                    ["1"] * args.down_num),
                "size": args.size, "batch": args.batch,
                "frames": args.frames, "criterion": args.criterion,
                "device": device.type,
                "device_name": (torch.cuda.get_device_name(device) if cuda
                                else "cpu")}}) + "\n")
    at = args.bce_finetune_at
    if at and start > at:
        _with_criterion(model, "bce")

    t0 = time.time()
    prev = streams.clips(start)[0]
    with open(out_path, "a") as f:
        for step in range(start + 1, args.steps + 1):
            video, mask = streams.clips(step)
            if at and step - 1 == at:
                _with_criterion(model, "bce")
                f.write(json.dumps({"step": at, "event": "bce_finetune"})
                        + "\n")
            draws = streams.draws(step, TRAIN_DRAWS)
            if on_step is not None:
                on_step(step, video, mask, prev, draws)
            logs = model.train_step(video, mask, prev, draws)
            if step % LOG_EVERY == 0 or step == 1:
                rec = {"step": step, "criterion": args.criterion,
                       "source": "synthetic",
                       **{k: float(logs[k]) for k in sorted(logs)}}
                if step % args.eval_every == 0 or step == args.steps:
                    ev = model.eval_step(video, mask, prev,
                                         streams.draws(step, EVAL_DRAWS))
                    rec.update({k: float(ev[k]) for k in
                                ("psnr_forward", "ssim_forward", "f1_best")})
                rec["wall_s"] = round(wall0 + time.time() - t0, 1)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                print(json.dumps(rec))
            prev = video
            if step == args.stop_at_step and step < args.steps:
                _save(model, args.ckpt_dir, step, log)
                log.info("stopped at step %d: continue with --resume", step)
                return "stopped"
        step = max(start, args.steps)
        if args.libjpeg_batches > 0:
            if _has_pil():
                rec = libjpeg_line(model, streams, step,
                                   args.libjpeg_batches)
                f.write(json.dumps(rec) + "\n")
                print(json.dumps(rec))
            else:
                log.info("no PIL here: no libjpeg line written; append it "
                         "with --libjpeg-only --ckpt-dir DIR where PIL is")
    if args.ckpt_dir:
        _save(model, args.ckpt_dir, step, log)
    if args.nets_out:
        save_nets(args.nets_out, step, model, compact=True)
        log.info("saved nets %s step %d", args.nets_out, step)
    log.info("wrote %s", out_path)
    return "done"


def main(argv=None) -> str:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
