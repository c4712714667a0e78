"""Training and evaluation CLI of the port (counterpart of ``train.py --task
video|hidden|mbrs|tianchi|pami|imuge|clr [--root DIR | --synthetic] [--steps N
| --val] [--resume]``).

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

``--task hidden`` trains the HiDDeN family (``models/hidden_model.py``; the
JAX ``train.py``'s ``_message_loop``, :219-284), ``--task mbrs`` the MBRS
family (``models/mbrs_model.py``, the same loop), on synthetic images
(``--synthetic``: ``SyntheticImageDataset(seed=train.seed)``) or an image
folder (``--root``, read through OpenCV), with the JAX defaults of
``Config()`` unless ``--config`` (``--size`` and ``--batch`` override):
messages from ``default_rng(train.seed)``, the noise draws from the
task's sampler seeded ``train.seed``, a progress bar, the scalar log and a checkpoint every
``save_interval`` steps; it prints one JSON line (the last step's logs, ms
per step and images/s over the steps after the first). ``--val`` is the
video model's; HiDDeN's per-member eval is ``vwfd_tpu_torch.eval_hidden``,
MBRS's libjpeg eval ``vwfd_tpu_torch.run_family_convergence``.

    python -m vwfd_tpu_torch.train --task hidden --synthetic --steps 3 \
        --device cpu --batch 2 --size 32
    python -m vwfd_tpu_torch.train --task mbrs --synthetic --steps 3 \
        --device cpu --batch 2 --size 32

``--task tianchi`` trains the Tianchi forgery-segmentation family
(``models/tianchi_model.py``: SUNet, two AdamW updates a step; the JAX
``train.py``'s ``_tianchi_loop``, :339-412) with the port's
``configs/tianchi.yaml`` unless ``--config`` (``--size``, ``--batch``
override): on the composed splice forgeries (``--synthetic``:
``SpliceForgeryDataset(seed=train.seed)``) or on image and forgery-mask
folders (``--root`` and ``--mask-root``, or the config's ``data.root`` /
``data.mask_root``: each mask the image's base name under the mask
folder, read through OpenCV), the JPEG draws from ``TianchiSampler``
seeded ``train.seed``, a progress bar, the scalar log and a checkpoint
every ``save_interval`` steps; it prints one JSON line (the last step's
``CE`` and ``CE1``, ms per step and images/s over the steps after the
first). Its held-out F1 is ``vwfd_tpu_torch.run_family_convergence --task
tianchi``'s.

    python -m vwfd_tpu_torch.train --task tianchi --synthetic --steps 3 \
        --device cpu --batch 2 --size 64

``--task pami``, ``--task imuge`` and ``--task clr`` train the image
family (``models/image_model.py``; the JAX ``train.py``'s ``_image_loop``,
:101-201, :475) with the port's ``configs/pami.yaml`` (``configs/clr.yaml``
for clr) unless ``--config`` (``--size``, ``--batch`` override; the model
options ``--with-gan`` and ``--use-perceptual``, the latter PAMI and
ImugeV2 only, as in JAX): on synthetic images (``--synthetic``:
``SyntheticImageDataset(seed=train.seed)``) or an image folder (``--root``,
read through OpenCV), each with its host canny map (``data/edges.py``, the
JAX loop's ``cv2.Canny`` without OpenCV; pami and clr) and stroke masks drawn
per batch from ``default_rng((train.seed, batch index))`` (F11's
rasteriser); the first batch only seeds the previous batch; the tamper and
fan-out draws from ``ImageSampler`` seeded ``train.seed``; a progress bar,
the scalar log and a checkpoint every ``save_interval`` steps;
``--resume`` continues the latest one. It
prints one JSON line (the last step's logs, ms per step and images/s over
the steps after the first). ``--val`` runs ``eval_step`` on
``--val-batches`` batches after the one that seeds the previous batch and
prints the means of its scalars. The held-out protocol of the JAX
records is ``run_family_convergence --task pami|imuge|clr``'s.

    python -m vwfd_tpu_torch.train --task pami --synthetic --steps 3 \
        --device cpu --batch 2 --size 32
    python -m vwfd_tpu_torch.train --task clr --synthetic --steps 2 \
        --device cpu --batch 2 --size 32
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from . import (CLR_CONFIG, FLAGSHIP_CONFIG, PAMI_CONFIG, TIANCHI_CONFIG,
               Config, load_config)
from .data import (CannyImages, DavisVideoDataset, ImageFolderDataset,
                   Loader, SpliceForgeryDataset, SyntheticImageDataset,
                   SyntheticVideoDataset, cv2_mask_reader, cv2_readers,
                   stroke_masks)
from .models import (HiddenModel, ImageImmunizationModel, MBRSModel,
                     TianchiModel, VideoWatermarkModel)
from .models.image_model import ImageBatch
from .models.hidden_model import HiddenSampler
from .models.mbrs_model import MBRSSampler
from .models.state import latest_step, restore_checkpoint, save_checkpoint
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


class _ImagesOnly:
    """An image folder's items without their dict (``train.py:242-249``)."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        return self.base[i]["image"]


def _message(args, ap, logger):
    """``--task hidden`` or ``mbrs``: the message loop of the JAX
    ``train.py``."""
    if args.val:
        ap.error("--val is the video model's; HiDDeN's per-member eval is "
                 "python -m vwfd_tpu_torch.eval_hidden, MBRS's "
                 "python -m vwfd_tpu_torch.run_family_convergence")
    task = args.task
    cfg = load_config(args.config) if args.config else Config()
    data = dict(batch_size=args.batch or cfg.data.batch_size,
                gt_size=args.size or cfg.data.gt_size,
                root=args.root or cfg.data.root, synthetic=args.synthetic)
    cfg = dataclasses.replace(cfg, task=task,
                              data=dataclasses.replace(cfg.data, **data),
                              ckpt_dir=args.ckpt_dir or cfg.ckpt_dir)
    b, s = cfg.data.batch_size, cfg.data.gt_size
    if args.synthetic:
        dataset = SyntheticImageDataset(size=s, length=2000,
                                        seed=cfg.train.seed)
    elif cfg.data.root:
        try:
            read_image, _ = cv2_readers()
        except ImportError:
            ap.error("--root needs OpenCV (cv2) to read the images, and it "
                     "does not import here")
        dataset = _ImagesOnly(ImageFolderDataset(cfg.data.root, read_image,
                                                 size=s))
    else:
        ap.error("no data: pass --root (an image folder) or --synthetic")
    if task == "hidden":
        model = HiddenModel(image_size=s, device=args.device)
        sampler = HiddenSampler(cfg.train.seed, model.device)
    else:
        model = MBRSModel(image_size=s, device=args.device)
        sampler = MBRSSampler(cfg.train.seed)
    model.init_states(cfg.train.seed)
    step0 = latest_step(cfg.ckpt_dir) if args.resume else None
    if step0 is not None:
        logger.info("resuming %s from step %d", task, step0)
        restore_checkpoint(cfg.ckpt_dir, step0, model)
    loader = Loader(dataset, b, seed=cfg.train.seed, ratio=cfg.data.ratio)
    rng = np.random.default_rng(cfg.train.seed)
    scalar_logger = None if args.no_telemetry else ScalarLogger(
        args.logdir or os.path.join("runs", f"{cfg.name}_{task}"))
    pb = Progbar(args.steps, stateful_metrics=["bitwise_error"])
    cuda = model.device.type == "cuda"
    step, end, times, vals = step0 or 0, (step0 or 0) + args.steps, [], {}
    try:
        while step < end:
            for imgs in loader:
                if step >= end:
                    break
                msgs = (rng.random((imgs.shape[0], model.message_length))
                        > 0.5).astype(np.float32)
                t0 = time.perf_counter()
                logs = model.train_step(imgs, msgs, sampler(imgs.shape))
                vals = {k: float(v) for k, v in logs.items()}  # syncs
                times.append((time.perf_counter() - t0) * 1e3)
                step += 1
                pb.add(1, values=list(vals.items()))
                if scalar_logger is not None:
                    scalar_logger.log(step, **vals)
                if step % cfg.train.save_interval == 0:
                    save_checkpoint(cfg.ckpt_dir, step, model)
    finally:
        if scalar_logger is not None:
            scalar_logger.close()
    ms = float(np.median(times[1:] or times))
    logger.info("done: %s", vals)
    print(json.dumps({
        **vals, "steps": args.steps, "ms_per_step": ms,
        "images_per_s": b / ms * 1e3, "batch": b, "size": s,
        "data": "synthetic" if args.synthetic else "images",
        "resumed_step": step0, "device": str(model.device),
        "device_name": (torch.cuda.get_device_name(model.device) if cuda
                        else "cpu")}))


class _ImageMask:
    """An image folder's items as ``(image, mask)`` (``train.py:
    358-359``)."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        item = self.base[i]
        return item["image"], item["mask"]


def _tianchi(args, ap, logger):
    """``--task tianchi``: the JAX ``train.py``'s ``_tianchi_loop``."""
    if args.val:
        ap.error("--val is the video model's; Tianchi's held-out F1 is "
                 "python -m vwfd_tpu_torch.run_family_convergence --task "
                 "tianchi")
    cfg = load_config(args.config or TIANCHI_CONFIG)
    data = dict(batch_size=args.batch or cfg.data.batch_size,
                gt_size=args.size or cfg.data.gt_size,
                root=args.root or cfg.data.root,
                mask_root=args.mask_root or cfg.data.mask_root,
                synthetic=args.synthetic or (cfg.data.synthetic
                                             and not args.root))
    cfg = dataclasses.replace(cfg, task="tianchi",
                              data=dataclasses.replace(cfg.data, **data),
                              ckpt_dir=args.ckpt_dir or cfg.ckpt_dir)
    d = cfg.data
    if d.root and not d.synthetic:
        if not d.mask_root:
            ap.error("tianchi with --root needs --mask-root (the forgery "
                     "masks, tianchi_dataset.py:16-77)")
        try:
            read_image, _ = cv2_readers()
            read_mask = cv2_mask_reader()
        except ImportError:
            ap.error("--root needs OpenCV (cv2) to read the images and "
                     "masks, and it does not import here")
        dataset = _ImageMask(ImageFolderDataset(
            d.root, read_image, size=d.gt_size, augment=False,
            mask_root=d.mask_root, read_mask=read_mask))
    elif d.synthetic:
        dataset = SpliceForgeryDataset(size=d.gt_size, length=2000,
                                       seed=cfg.train.seed)
    else:
        ap.error("no data: pass --root and --mask-root or --synthetic")
    model = TianchiModel(cfg, device=args.device)
    model.init_states(cfg.train.seed)
    step0 = latest_step(cfg.ckpt_dir) if args.resume else None
    if step0 is not None:
        logger.info("resuming tianchi from step %d", step0)
        restore_checkpoint(cfg.ckpt_dir, step0, model)
    sampler = model.sampler(cfg.train.seed)
    loader = Loader(dataset, d.batch_size, seed=cfg.train.seed,
                    ratio=d.ratio)
    scalar_logger = None if args.no_telemetry else ScalarLogger(
        args.logdir or os.path.join("runs", f"{cfg.name}_tianchi"))
    pb = Progbar(args.steps)
    step, end, times, vals = step0 or 0, (step0 or 0) + args.steps, [], {}
    try:
        for imgs, masks in loader.stream():
            if step >= end:
                break
            t0 = time.perf_counter()
            logs = model.train_step(imgs, masks, sampler())
            vals = {k: float(v) for k, v in logs.items()}  # syncs
            times.append((time.perf_counter() - t0) * 1e3)
            step += 1
            pb.add(1, values=list(vals.items()))
            if scalar_logger is not None:
                scalar_logger.log(step, **vals)
            if step % cfg.train.save_interval == 0:
                save_checkpoint(cfg.ckpt_dir, step, model)
    finally:
        if scalar_logger is not None:
            scalar_logger.close()
    ms = float(np.median(times[1:] or times))
    logger.info("done: %s", vals)
    cuda = model.device.type == "cuda"
    print(json.dumps({
        **vals, "steps": args.steps, "ms_per_step": ms,
        "images_per_s": d.batch_size / ms * 1e3, "batch": d.batch_size,
        "size": d.gt_size, "data": "synthetic" if d.synthetic else "images",
        "resumed_step": step0, "device": str(model.device),
        "device_name": (torch.cuda.get_device_name(model.device) if cuda
                        else "cpu")}))


def _image(args, ap, logger):
    """``--task pami``, ``imuge`` or ``clr``: the JAX ``train.py``'s
    ``_image_loop``."""
    task = args.task
    cfg = load_config(args.config or (CLR_CONFIG if task == "clr"
                                      else PAMI_CONFIG))
    data = dict(batch_size=args.batch or cfg.data.batch_size,
                gt_size=args.size or cfg.data.gt_size,
                root=args.root or cfg.data.root,
                synthetic=args.synthetic or (cfg.data.synthetic
                                             and not args.root))
    cfg = dataclasses.replace(cfg, task=task,
                              data=dataclasses.replace(cfg.data, **data),
                              ckpt_dir=args.ckpt_dir or cfg.ckpt_dir)
    d, seed = cfg.data, cfg.train.seed
    pami = task != "imuge"  # the canny watermark
    if d.root and not d.synthetic:
        try:
            read_image, _ = cv2_readers()
        except ImportError:
            ap.error("--root needs OpenCV (cv2) to read the images, and it "
                     "does not import here")
        dataset = CannyImages(ImageFolderDataset(d.root, read_image,
                                                 size=d.gt_size), pami)
    elif d.synthetic:
        dataset = CannyImages(SyntheticImageDataset(
            size=d.gt_size, length=2000, seed=seed), pami)
    else:
        ap.error("no data: pass --root (an image folder) or --synthetic")
    model = ImageImmunizationModel(cfg, task=task, device=args.device,
                                   with_gan=args.with_gan,
                                   use_perceptual=args.use_perceptual)
    model.init_states(seed)
    step0 = latest_step(cfg.ckpt_dir) if args.resume else None
    if step0 is not None:
        logger.info("resuming %s from step %d", task, step0)
        restore_checkpoint(cfg.ckpt_dir, step0, model)
    start = step0 or 0
    sampler = model.sampler(seed)
    shape = (d.batch_size, d.gt_size, d.gt_size)
    for _ in range(start):
        sampler(shape)
    loader = Loader(dataset, d.batch_size, seed=seed, ratio=d.ratio)
    index = [start]

    def batches():
        for item in loader.stream(start):
            imgs, canny = item if pami else (item, None)
            yield ImageBatch(imgs, canny, stroke_masks(
                (seed, index[0]), len(imgs), (d.gt_size, d.gt_size)))
            index[0] += 1

    stream = batches()
    prev = next(stream).image
    cuda = model.device.type == "cuda"
    if args.val:
        outs, times = [], []
        for _ in range(args.val_batches):
            batch = next(stream)
            t0 = time.perf_counter()
            o = model.eval_step(batch, prev, sampler(batch.image.shape))
            outs.append({k: float(v) for k, v in o.items()
                         if v.dim() == 0})  # syncs
            times.append((time.perf_counter() - t0) * 1e3)
            prev = batch.image
        result = {k: float(np.mean([o[k] for o in outs])) for k in outs[0]}
        result.update(val_batches=args.val_batches,
                      ms_per_eval_step=float(np.median(times[1:] or times)))
        logger.info("eval: %s", result)
    else:
        scalar_logger = None if args.no_telemetry else ScalarLogger(
            args.logdir or os.path.join("runs", f"{cfg.name}_{task}"))
        pb = Progbar(args.steps, stateful_metrics=["PF", "PB"])
        step, times, vals = start, [], {}
        try:
            while step < start + args.steps:
                batch = next(stream)
                t0 = time.perf_counter()
                logs = model.train_step(batch, prev,
                                        sampler(batch.image.shape))
                vals = {k: float(v) for k, v in logs.items()}  # syncs
                times.append((time.perf_counter() - t0) * 1e3)
                prev = batch.image
                step += 1
                pb.add(1, values=list(vals.items()))
                if scalar_logger is not None:
                    scalar_logger.log(step, **vals)
                if step % cfg.train.save_interval == 0:
                    save_checkpoint(cfg.ckpt_dir, step, model)
        finally:
            if scalar_logger is not None:
                scalar_logger.close()
        ms = float(np.median(times[1:] or times))
        result = {**vals, "steps": args.steps, "ms_per_step": ms,
                  "images_per_s": d.batch_size / ms * 1e3}
        logger.info("done: %s", vals)
    print(json.dumps({
        **result, "batch": d.batch_size, "size": d.gt_size,
        "data": "synthetic" if d.synthetic else "images",
        "resumed_step": step0, "device": str(model.device),
        "device_name": (torch.cuda.get_device_name(model.device) if cuda
                        else "cpu")}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="video",
                    choices=("video", "hidden", "mbrs", "tianchi", "pami",
                             "imuge", "clr"),
                    help="video (default), hidden, mbrs, tianchi, pami, "
                         "imuge or clr")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset")
    ap.add_argument("--root", default=None,
                    help="a DAVIS tree (JPEGImages/480p, Annotations/480p); "
                         "with --task hidden, mbrs, tianchi, pami, imuge or "
                         "clr an image folder")
    ap.add_argument("--mask-root", default=None,
                    help="--task tianchi: the forgery-mask folder (each "
                         "mask the image's base name)")
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
    ap.add_argument("--with-gan", action="store_true",
                    help="pami, imuge, clr: the patch discriminator and its "
                         "nsgan terms")
    ap.add_argument("--use-perceptual", action="store_true",
                    help="pami, imuge: the VGG19 feature loss "
                         "(train.vgg_weights, else a seeded trunk)")
    args = ap.parse_args(argv)
    if min(args.steps, args.val_batches) < 1:
        ap.error("--steps and --val-batches take at least 1")
    if args.synthetic and args.root:
        ap.error("--synthetic and --root exclude each other")

    logger = setup_logger("base")
    if args.task in ("hidden", "mbrs"):
        return _message(args, ap, logger)
    if args.task == "tianchi":
        return _tianchi(args, ap, logger)
    if args.task in ("pami", "imuge", "clr"):
        return _image(args, ap, logger)
    if args.with_gan or args.use_perceptual:
        ap.error("--with-gan and --use-perceptual are image-family options")
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
