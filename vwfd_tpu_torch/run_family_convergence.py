"""Convergence runs of the message and image families (port of
tools/run_family_convergence.py; MBRS: ``_mbrs``, :351-420; Tianchi:
``_tianchi``, :279-341; PAMI, ImugeV2 and CLR: ``_image_family``,
:73-167).

    python -m vwfd_tpu_torch.run_family_convergence --task mbrs \\
        --steps 15000 --eval-every 500 --out runs/conv_torch_mbrs.jsonl \\
        --ckpt-dir build/mbrs_ckpt
    python -m vwfd_tpu_torch.run_family_convergence --task tianchi \\
        --steps 3000 --size 256 --batch 8 --lr 1e-4 --eval-every 250 \\
        --out runs/conv_torch_tianchi.jsonl --ckpt-dir build/tianchi_ckpt
    # the same run in segments: each ends cleanly with a checkpoint
    python -m vwfd_tpu_torch.run_family_convergence --task mbrs ... \\
        --resume --stop-at-step 5000
    python -m vwfd_tpu_torch.run_family_convergence --task mbrs --steps 4 \\
        --eval-every 2 --log-every 1 --size 32 --batch 2 --device cpu \\
        --out build/mbrs.jsonl
    python -m vwfd_tpu_torch.run_family_convergence --task imuge \\
        --steps 3750 --size 256 --batch 8 --reverse-k 0 --eval-every 250 \\
        --out runs/conv_torch_imuge.jsonl --ckpt-dir build/imuge_ckpt
    python -m vwfd_tpu_torch.run_family_convergence --task pami \\
        --steps 1000 --size 512 --batch 3 --reverse-k 3 --eval-every 250
    python -m vwfd_tpu_torch.run_family_convergence --task clr \\
        --steps 1150 --size 512 --batch 3 --reverse-k 3 --eval-every 250 \\
        --out runs/conv_torch_clr512.jsonl

``--task mbrs`` trains ``MBRSModel`` (128², b16 unless ``--size`` /
``--batch``) on the JAX runner's data: ``SyntheticImageDataset(size, 2000,
10)`` through ``Loader(..., seed=10, ratio=200)`` and messages from
``default_rng(10)`` (10 is the JAX runner's ``cfg.train.seed``), so its
batches and messages are the JAX run's. The weights and the noise draws
(``MBRSSampler``) come from ``--seed`` (default 0): ``jax.random`` cannot
be replayed. Adam runs at the model's 1e-3 unless ``--lr``, the rate the
JAX record trained at (its config line's ``"lr": 1e-05`` is a config value
its runner never passed); the config line here states the rate used.

``--task tianchi`` trains ``TianchiModel`` (SUNet at the published widths;
512², b4 unless ``--size`` / ``--batch``, the JAX runner's defaults; the
port's ``configs/tianchi.yaml``, AdamW at the config's rate unless
``--lr``) on the JAX runner's composed splice forgeries
(``data.SpliceForgeryDataset(size, 2000, 10)``: a one-frame
``SyntheticVideoDataset`` item with the donor ``(i·7919 + 1) mod 2000``
pasted through its mask) through ``Loader(..., seed=10, ratio=200)``. The
frames and the order are the JAX run's; the stroke masks are the port's
rasteriser's (F11: each stroke within IoU 0.9 of cv2's pixels, not the
same pixels), and with them the pasted regions. The JPEG draws
(``TianchiSampler``) and the weights come from ``--seed``. Every
``--eval-every`` steps and at the last the mean ``f1_best`` of
``--eval-batches`` (4) batches of ``--eval-batch`` (the train batch)
held-out forgeries (``SpliceForgeryDataset(size, 64, 10 + 7777)`` through
``Loader(..., seed=10 + 7777, ratio=200)``, a fresh epoch order each eval,
as the JAX runner's loop draws them).

``--task pami`` / ``--task imuge`` / ``--task clr`` train
``ImageImmunizationModel`` (the port's ``configs/pami.yaml``, or
``configs/clr.yaml`` for clr: the 4-channel INN in bf16, the localizer,
k = 6 attacks, clr's crop tamper and apex regressor; 512², b3 for pami and
clr, 256², b8 for imuge unless ``--size`` / ``--batch``, the JAX runner's
geometry; ``--reverse-k`` bounds the reverse
fan-out, 0 for all, as the JAX flag) on the JAX runner's images:
``SyntheticImageDataset(size, 2000, 10)`` through ``Loader(..., seed=10,
ratio=200)``, each with its host canny map (``data.edges``, bit-equal to
the JAX runner's ``cv2.Canny``; pami and clr: imuge embeds the previous
batch in gray), and stroke masks drawn per batch from ``default_rng((10,
batch index))`` (the JAX runner draws them per item from one generator
its loader's threads share, so its masks are not reproducible; the
port's rasteriser is F11's). The first batch only seeds the previous
batch. The tamper and fan-out draws (``ImageSampler``) and the weights
come from ``--seed``. Every ``--eval-every`` steps and at the last the
means over ``--eval-batches`` (4) held-out batches of ``--eval-batch``
(the train batch) of ``psnr_forward``, ``psnr_backward``,
``ssim_forward``, ``f1_best`` and ``f1_per_attack_mean``: a fresh epoch
of ``SyntheticImageDataset(size, 64, 10 + 7777)`` through ``Loader(...,
seed=10 + 7777, ratio=200)`` each eval, its first batch only seeding the
previous batch, the eval draws from a sampler seeded ``--seed`` + 7777.
An eval loader that yields a single batch (the JAX runner's fault at
``:134``, ADVICE.md) evaluates that batch against itself rolled by one
image, and the record says how many batches it took
(``eval_batches``).

The JSONL record is the JAX runner's, key for key: a config line (with the
device, its name and the seeds), at step 1 and every ``--log-every`` steps
the logs (MBRS: ``loss``, ``encoder_mse``, ``message_mse``,
``bitwise_error``; Tianchi: ``CE``, ``CE1``; the image family: ``loss``,
``lF``, ``lB``, ``l_mask``, ``PF``, ``PB``, ``NULL``; clr's also
``l_apex``, ``l_ce``) and ``wall`` (seconds
since the start), and at every ``--eval-every`` step and the last an eval
record. MBRS's is on 16 held-out images (``SyntheticImageDataset (size,
16, 10 + 7777)``, messages from ``default_rng(7777)``): the encoded PSNR
(``psnr255_int`` of the clipped encoding) and the bitwise error on it
(``bitwise_error_identity``) and after PIL's libjpeg at QF 50, 70 and 90
(``bitwise_error_jpeg{q}``, ``attacks.jpeg_real``); Tianchi's is
``f1_best``. A last line gives ``wall_s`` and ``ms_per_step`` (the run's
wall time over its steps, evals included).

``--resume`` restores the latest checkpoint of ``--ckpt-dir`` (parameters,
BatchNorm statistics, Adam moments and count), keeps ``--out`` up to that
step and continues with the batches, messages, draws and eval orders an
unbroken run would see (the loaders' orders, the message and draw
generators replayed to the step). ``--stop-at-step`` ends a segment with a
checkpoint. Only the latest checkpoint is kept. Runs on the CUDA card
unless ``--device cpu``; without a card it raises. KD-JPEG is not ported
yet: it raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

import argparse
import dataclasses
import itertools
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import CLR_CONFIG, PAMI_CONFIG, TIANCHI_CONFIG, load_config
from .attacks import jpeg_real
from .data import (CannyImages, Loader, SpliceForgeryDataset,
                   SyntheticImageDataset, stroke_masks)
from .metrics import bitwise_message_error, psnr255_int
from .models import ImageImmunizationModel, MBRSModel, TianchiModel
from .models.image_model import ImageBatch
from .models.mbrs_model import MBRSSampler
from .models.state import latest_step, restore_checkpoint
from .run_convergence import _keep_upto, _save
from .utils import setup_logger

__all__ = ["DATA_SEED", "EVAL_QUALITIES", "NOT_PORTED", "DEFAULTS",
           "MBRSStreams", "TianchiStreams", "ImageStreams", "image_eval",
           "image_eval_loader", "parse_args", "run", "main"]

DATA_SEED = 10  # the JAX runner's cfg.train.seed: data and messages
EVAL_QUALITIES = (50, 70, 90)
# (size, batch) unless --size / --batch: the JAX runner's geometry
DEFAULTS = {"mbrs": (128, 16), "tianchi": (512, 4), "pami": (512, 3),
            "imuge": (256, 8), "clr": (512, 3)}
IMAGE_TASKS = ("pami", "imuge", "clr")
NOT_PORTED = {"kdjpeg": "ROADMAP.md §1, its KD-JPEG item"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", required=True,
                    choices=(*DEFAULTS, *NOT_PORTED))
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--size", type=int, default=None,
                    help="image side (default: 128 mbrs, 512 tianchi)")
    ap.add_argument("--batch", type=int, default=None,
                    help="train batch (default: 16 mbrs, 4 tianchi)")
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: MBRS's 1e-3, the "
                         "tianchi config's)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the weights' and the noise draws' seed")
    ap.add_argument("--reverse-k", type=int, default=0,
                    help="pami / imuge / clr: attacked copies reversed (0: "
                         "all)")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--eval-batch", type=int, default=None,
                    help="held-out batch (default: 16 mbrs, the train "
                         "batch tianchi)")
    ap.add_argument("--eval-batches", type=int, default=4,
                    help="tianchi, pami, imuge, clr: held-out batches an "
                         "eval")
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
    size, batch = DEFAULTS.get(args.task, (128, 16))
    args.size = args.size or size
    args.batch = args.batch or batch
    if args.eval_batch is None:
        args.eval_batch = args.batch if args.task != "mbrs" else 16
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


class TianchiStreams:
    """The run's batches and JPEG draws from step ``start + 1`` on, as an
    unbroken run sees them."""

    def __init__(self, model: TianchiModel, batch: int, seed: int,
                 start: int = 0):
        ds = SpliceForgeryDataset(size=model.image_size, length=2000,
                                  seed=DATA_SEED)
        self.batches = Loader(ds, batch, seed=DATA_SEED,
                              ratio=200).stream(start)
        self.sampler = model.sampler(seed)
        for _ in range(start):
            self.sampler()

    def __next__(self):
        imgs, masks = next(self.batches)
        return imgs, masks, self.sampler()


def tianchi_eval_loader(size: int, batch: int, evals_done: int = 0
                        ) -> Loader:
    """The held-out forgeries' loader, its order generator moved past the
    epochs of ``evals_done`` earlier evals (each draws one)."""
    held = SpliceForgeryDataset(size=size, length=64,
                                seed=DATA_SEED + 7777)
    loader = Loader(held, batch, seed=DATA_SEED + 7777, ratio=200)
    for _ in range(evals_done):
        loader._order()
    return loader


def tianchi_eval(model: TianchiModel, loader: Loader, batches: int) -> dict:
    """Mean ``f1_best`` over the first ``batches`` batches of a fresh
    epoch of ``loader``."""
    f1s = [float(model.eval_step(img, mask)["f1_best"])
           for img, mask in itertools.islice(iter(loader), batches)]
    return {"f1_best": float(np.mean(f1s))}


class ImageStreams:
    """The image family's train steps from step ``start + 1`` on, as an
    unbroken run sees them: ``(ImageBatch, previous images, draws)``."""

    def __init__(self, model: ImageImmunizationModel, size: int, batch: int,
                 seed: int, start: int = 0):
        ds = CannyImages(SyntheticImageDataset(size=size, length=2000,
                                               seed=DATA_SEED),
                         with_canny=model.task != "imuge")
        self.batches = Loader(ds, batch, seed=DATA_SEED,
                              ratio=200).stream(start)
        self.index, self.size = start, size
        self.prev = self._next()[0]
        self.sampler = model.sampler(seed)
        for _ in range(start):
            self.sampler((batch, size, size))

    def _next(self) -> ImageBatch:
        item = next(self.batches)
        imgs, canny = item if isinstance(item, tuple) else (item, None)
        masks = stroke_masks((DATA_SEED, self.index), len(imgs),
                             (self.size, self.size))
        self.index += 1
        return ImageBatch(imgs, canny, masks)

    def __next__(self):
        batch, prev = self._next(), self.prev
        self.prev = batch.image
        return batch, prev, self.sampler(batch.image.shape)


def image_eval_loader(model: ImageImmunizationModel, size: int, batch: int,
                      evals_done: int = 0, length: int = 64,
                      ratio: int = 200) -> Loader:
    """The held-out images' loader, its order generator moved past the
    epochs of ``evals_done`` earlier evals (each draws one)."""
    held = CannyImages(SyntheticImageDataset(size=size, length=length,
                                             seed=DATA_SEED + 7777),
                       with_canny=model.task != "imuge")
    loader = Loader(held, batch, seed=DATA_SEED + 7777, ratio=ratio)
    for _ in range(evals_done):
        loader._order()
    return loader


def image_eval(model: ImageImmunizationModel, loader: Loader, batches: int,
               sampler, evals_done: int) -> dict:
    """The means of the eval metrics over ``batches`` batches of a fresh
    epoch of ``loader`` after the one that seeds the previous batch; a
    loader of one batch evaluates it against itself rolled by one image."""
    got = []
    for i, item in enumerate(itertools.islice(iter(loader), batches + 1)):
        imgs, canny = item if isinstance(item, tuple) else (item, None)
        size = imgs.shape[1:3]
        got.append(ImageBatch(imgs, canny, stroke_masks(
            (DATA_SEED + 7777, evals_done, i), len(imgs), size)))
    pairs = [(b, a.image) for a, b in zip(got, got[1:])] or \
        [(got[0], np.roll(got[0].image, 1, axis=0))]
    keys = ("psnr_forward", "psnr_backward", "ssim_forward", "f1_best")
    accs = []
    for batch, prev in pairs:
        o = model.eval_step(batch, prev, sampler(batch.image.shape))
        rec = {k: float(o[k]) for k in keys}
        rec["f1_per_attack_mean"] = float(o["f1_per_attack"].mean())
        accs.append(rec)
    out = {k: float(np.mean([a[k] for a in accs])) for k in accs[0]}
    out["eval_batches"] = len(accs)
    return out


def _emit(f, rec: dict) -> None:
    line = json.dumps(rec)
    f.write(line + "\n")
    f.flush()
    print(line, flush=True)


def _model(args):
    """The task's model, fresh from ``--seed``."""
    if args.task == "mbrs":
        model = MBRSModel(image_size=args.size, lr=args.lr or 1e-3,
                          device=args.device)
    elif args.task in IMAGE_TASKS:
        cfg = load_config(CLR_CONFIG if args.task == "clr" else PAMI_CONFIG)
        cfg = dataclasses.replace(
            cfg, task=args.task,
            data=dataclasses.replace(cfg.data, gt_size=args.size,
                                     batch_size=args.batch, synthetic=True),
            train=dataclasses.replace(cfg.train, lr=args.lr or cfg.train.lr))
        model = ImageImmunizationModel(cfg, task=args.task,
                                       reverse_k=args.reverse_k,
                                       device=args.device)
    else:
        cfg = load_config(TIANCHI_CONFIG)
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, gt_size=args.size,
                                          batch_size=args.batch,
                                          synthetic=True),
            train=dataclasses.replace(cfg.train, lr=args.lr or cfg.train.lr))
        model = TianchiModel(cfg, device=args.device)
    model.init_states(args.seed)
    return model


def run(args: argparse.Namespace,
        on_step: Optional[Callable] = None) -> str:
    """The run of ``args`` (``parse_args``); ``on_step(step, images,
    messages or masks, draws)``, if given, sees each train step's inputs.
    Returns ``"done"`` or ``"stopped"`` (a segment's end)."""
    if args.task in NOT_PORTED:
        raise NotImplementedError(f"--task {args.task} is not ported yet: "
                                  f"{NOT_PORTED[args.task]}")
    log = setup_logger("base")
    model = _model(args)
    out_path = args.out or os.path.join("build",
                                        f"conv_torch_{args.task}.jsonl")
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
                      "lr": (model.lr if args.task == "mbrs"
                             else model.cfg.train.lr),
                      **({"reverse_k": args.reverse_k}
                         if args.task in IMAGE_TASKS else {}),
                      "seed": args.seed,
                      "data_seed": DATA_SEED, "device": model.device.type,
                      "device_name": (torch.cuda.get_device_name(
                          model.device) if cuda else "cpu")})
    if args.task == "mbrs":
        streams = MBRSStreams(model, args.batch, args.seed, start)
        held = eval_set(args.size, args.eval_batch, model.message_length)

        def evaluate():
            return mbrs_eval(model, *held)
    elif args.task in IMAGE_TASKS:
        streams = ImageStreams(model, args.size, args.batch, args.seed,
                               start)
        evals = [start // args.eval_every]
        eval_sampler = model.sampler(args.seed + 7777)
        for _ in range(evals[0] * max(args.eval_batches, 1)):
            eval_sampler((args.eval_batch, args.size, args.size))

        def evaluate():
            loader = image_eval_loader(model, args.size, args.eval_batch,
                                       evals[0])
            out = image_eval(model, loader, args.eval_batches, eval_sampler,
                             evals[0])
            evals[0] += 1
            return out
    else:
        streams = TianchiStreams(model, args.batch, args.seed, start)
        held = tianchi_eval_loader(args.size, args.eval_batch,
                                   start // args.eval_every)

        def evaluate():
            return tianchi_eval(model, held, args.eval_batches)
    t0 = time.time()
    step = start
    with open(out_path, "a") as f:
        for step in range(start + 1, args.steps + 1):
            inputs = next(streams)
            if on_step is not None:
                on_step(step, *inputs)
            logs = model.train_step(*inputs)
            if step % args.log_every == 0 or step == 1:
                _emit(f, {"step": step, "wall": wall0 + time.time() - t0,
                          **{k: float(v) for k, v in logs.items()}})
            if step % args.eval_every == 0 or step == args.steps:
                _emit(f, {"step": step, "eval": True, **evaluate()})
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
