"""A real multi-process data-parallel dry run of the flagship (counterpart
of tools/dryrun_multiprocess.py).

    python -m vwfd_tpu_torch.dryrun_multiprocess --procs 2
    python -m vwfd_tpu_torch.dryrun_multiprocess --procs 2 --device cpu
    python -m vwfd_tpu_torch.dryrun_multiprocess --procs 2 --device cpu \
        --task mbrs

spawns ``--procs`` ranks of this module with ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (a free localhost
port) set, as ``torchrun`` does, and drives one flagship train step
through the production stack: ``parallel.maybe_init_distributed``, the
loader's per-rank rows of the global batch, ``replicate`` (each rank is
initialised from another seed first, so the broadcast has work to do),
``train_step`` with its all-reduces. Each rank checks that the replicas
are bit-equal after the step; the parent checks that every rank reports
the same loss, bit for bit, and prints one JSON line. Every child has a
wall-time limit (``--timeout``) and the group a collective timeout: a
child that fails or hangs kills the others, and the tool exits non-zero.

The ranks run on the cards unless ``--device cpu`` is given; without a
card and without it the tool exits non-zero before it starts a rank.
``configs/video.yaml``'s model at ``--batch`` (the global batch, default 2
clips a rank), ``--frames`` (2) and ``--size`` (32). On the cards: its
widths in bf16 through the kernels, rank r on ``cuda:r``, over NCCL. On
the CPU: float32 through the plain versions over gloo, at
the tests' narrow widths (``inn_down_num`` 2, trunk width 16, extractor
f 8), since broadcasting the full-width states and moments between CPU
processes takes seconds.

``--task`` drives another family's step instead (``hidden``, ``mbrs``,
``tianchi``, ``pami``, ``imuge``, ``clr``, ``kdjpeg``): its model as
``train --task`` builds it (the JAX defaults for HiDDeN and MBRS, the
packaged YAML of the others; on the CPU Tianchi's SUNet at the tests'
narrow widths), a seeded global batch of ``--batch`` images (KD-JPEG:
``--batch`` // 6 items, collated class-major, the flat rows split) with
the draws the one process would draw for it, each rank on its rows.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import (CLR_CONFIG, FLAGSHIP_CONFIG, KDJPEG_CONFIG, PAMI_CONFIG,
               TIANCHI_CONFIG, load_config)
from .data import Loader, SyntheticVideoDataset
from .device import resolve_device
from .models import (HiddenModel, ImageImmunizationModel, KDJpegModel,
                     MBRSModel, TianchiModel, VideoWatermarkModel)
from .models.hidden_model import HiddenSampler
from .models.image_model import ImageBatch
from .models.kdjpeg_model import QF_CLASSES
from .models.mbrs_model import MBRSSampler
from .parallel import (local_batch_slice, local_device, make_mesh,
                       maybe_init_distributed, replicas_equal, replicate)
from .parallel.spawn import LocalRanks

TASKS = ("video", "hidden", "mbrs", "tianchi", "pami", "imuge", "clr",
         "kdjpeg")

GROUP_TIMEOUT_S = 60.0  # a collective that waits longer raises


CPU_WIDTHS = dict(inn_down_num=2, inn_block_num=(1, 1), inn_width=16,
                  extractor_features=8)
# the SUNet of tests/test_torch_tianchi.py, for the CPU
SUNET_CPU = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2),
                 window_size=4)
SEED = 10  # the data's and the draws' seed


def _sized(path, b, s):
    cfg = load_config(path)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=b, gt_size=s))


def family_step(task, device, mesh, batch, size, seed):
    """The ``task`` model (weights from ``seed``) and a callable that runs
    one train step of this rank on its rows of a seeded global batch of
    ``batch`` images, with the draws the one process would draw."""
    b, s = batch, size
    rng = np.random.default_rng(SEED)
    imgs = rng.random((b, s, s, 3), dtype=np.float32)
    if task == "kdjpeg":
        model = KDJpegModel(_sized(KDJPEG_CONFIG, b, s), device=device,
                            mesh=mesh)
        items = max(1, b // model.qf_classes)
        flat, lab = KDJpegModel.collate(
            np.stack([imgs[:items]] * model.qf_classes, 1),
            np.tile(np.arange(model.qf_classes), (items, 1)),
            model.qf_classes)
        flat, lab, src = model.local_batch(flat, lab)
        model.init_states(seed)
        return model, lambda: model.train_step(flat, lab, sources=src)
    lo, hi = local_batch_slice(b, mesh)
    if task in ("hidden", "mbrs"):
        if task == "hidden":
            model = HiddenModel(image_size=s, device=device, mesh=mesh)
            draws = HiddenSampler(SEED, model.device)(
                (b, s, s, 3)).rows(mesh)
        else:
            model = MBRSModel(image_size=s, device=device, mesh=mesh)
            draws = MBRSSampler(SEED)()
        msgs = (rng.random((b, model.message_length)) > 0.5).astype(
            np.float32)
        model.init_states(seed)
        return model, lambda: model.train_step(imgs[lo:hi], msgs[lo:hi],
                                               draws)
    if task == "tianchi":
        kw = SUNET_CPU if torch.device(device).type == "cpu" else {}
        model = TianchiModel(_sized(TIANCHI_CONFIG, b, s), device=device,
                             mesh=mesh, **kw)
        masks = (rng.random((b, s, s, 1)) > 0.7).astype(np.float32)
        draws = model.sampler(SEED)()
        model.init_states(seed)
        return model, lambda: model.train_step(imgs[lo:hi], masks[lo:hi],
                                               draws)
    model = ImageImmunizationModel(
        _sized(CLR_CONFIG if task == "clr" else PAMI_CONFIG, b, s),
        task=task, device=device, mesh=mesh)
    canny = (rng.random((b, s, s, 1)) > 0.9).astype(np.float32)
    mask = np.zeros((b, s, s, 1), np.float32)
    mask[:, s // 4:s // 2, s // 4:s // 2] = 1.0
    prev = rng.random((b, s, s, 3), dtype=np.float32)
    draws = model.sampler(SEED)((b, s, s)).rows(mesh)
    batch_ = ImageBatch(imgs[lo:hi], canny[lo:hi], mask[lo:hi])
    model.init_states(seed)
    return model, lambda: model.train_step(batch_, prev[lo:hi], draws)


def _config(args):
    cfg = load_config(FLAGSHIP_CONFIG)
    data = dataclasses.replace(cfg.data, batch_size=args.batch,
                               frames=args.frames, gt_size=args.size)
    if args.device == "cuda":
        return dataclasses.replace(cfg, data=data)
    return dataclasses.replace(
        cfg, data=data, model=dataclasses.replace(cfg.model, **CPU_WIDTHS),
        train=dataclasses.replace(cfg.train, dtype="float32"))


def _video_step(args, device, mesh, seed):
    cfg = _config(args)
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    model = VideoWatermarkModel(cfg, device=device, mesh=mesh)
    model.init_states(seed)
    loader = Loader(SyntheticVideoDataset(size=s, frames=t, length=2 * b,
                                          seed=cfg.train.seed),
                    b, seed=cfg.train.seed, rows=local_batch_slice(b, mesh))
    (prev, _), (video, mask) = list(loader)[:2]
    return model, lambda: model.train_step(video, mask, prev)


def _child(args) -> None:
    """One rank: one train step on its rows; prints one JSON line."""
    torch.set_num_threads(1)
    device = local_device(args.device)
    rank = maybe_init_distributed(device, timeout_s=GROUP_TIMEOUT_S)
    try:
        mesh = make_mesh()
        seed = load_config(FLAGSHIP_CONFIG).train.seed + rank
        if args.task == "video":
            model, step = _video_step(args, device, mesh, seed)
        else:
            model, step = family_step(args.task, device, mesh, args.batch,
                                      args.size, seed)
        differed = not replicas_equal(model, mesh)
        replicate(model, mesh)
        rows = local_batch_slice(
            args.batch if args.task != "kdjpeg"
            else max(1, args.batch // QF_CLASSES) * QF_CLASSES, mesh)
        t0 = time.perf_counter()
        logs = {k: float(v) for k, v in step().items()}
        ms = (time.perf_counter() - t0) * 1e3
        loss = logs.get("loss", next(iter(logs.values())))
        print(json.dumps({
            "rank": rank, "world_size": mesh.size, "rows": list(rows),
            "task": args.task, "loss": loss, "loss_hex": loss.hex(),
            "logs_hex": {k: v.hex() for k, v in logs.items()},
            "logs": logs, "seeds_differed": differed,
            "replicas_equal": replicas_equal(model, mesh),
            "backend": dist.get_backend(), "device": str(device),
            "step_ms": ms}), flush=True)
    finally:
        dist.destroy_process_group()


def run(procs: int, device: Optional[str] = None, batch=None,
        frames: int = 2, size: int = 32, timeout_s: float = 300.0,
        task: str = "video") -> dict:
    """Spawn the ranks, wait for them (bounded), check them; returns the
    summary. ``device`` ``None`` is the card (``device.resolve_device``:
    raises without one, before any rank starts). Raises
    ``parallel.spawn.RankFailure`` when a rank fails or hangs,
    ``RuntimeError`` when the ranks disagree."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    device = resolve_device(device).type
    batch = batch or (6 * procs if task == "kdjpeg" else 2 * procs)
    cmd = [sys.executable, "-m", "vwfd_tpu_torch.dryrun_multiprocess",
           "--child", "--device", device, "--batch", str(batch), "--frames",
           str(frames), "--size", str(size), "--task", task]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    with LocalRanks(cmd, procs, env=env, cwd=root) as ranks:
        outs = ranks.wait(timeout_s)
    reports = sorted((json.loads(o.strip().splitlines()[-1]) for o in outs),
                     key=lambda r: r["rank"])
    failed = [msg for bad, msg in (
        ([r["rank"] for r in reports] != list(range(procs)),
         f"ranks reported {[r['rank'] for r in reports]}"),
        (any(r["logs_hex"] != reports[0]["logs_hex"] for r in reports),
         f"logs differ across ranks: {[r['logs'] for r in reports]}"),
        (not all(r["replicas_equal"] for r in reports), "replicas diverged"),
        (not all(r["seeds_differed"] for r in reports),
         "the ranks' differently seeded states were equal before "
         "replicate")) if bad]
    if failed:
        raise RuntimeError("; ".join(failed))
    return {"ok": True, "task": task, "procs": procs, "device": device,
            "backend": reports[0]["backend"], "batch": batch,
            "frames": frames, "size": size, "loss": reports[0]["loss"],
            "rows": [r["rows"] for r in reports],
            "step_ms": [r["step_ms"] for r in reports],
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="the ranks' device (default: the card; raises "
                         "without one)")
    ap.add_argument("--task", choices=TASKS, default="video",
                    help="the family whose step the ranks take")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch (default 2 clips or images a "
                         "rank; kdjpeg 6 images a rank)")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the ranks may take in all")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)
    if args.procs < 2:
        ap.error("--procs takes at least 2 ranks")
    try:
        device = resolve_device(args.device).type
    except RuntimeError as e:
        ap.error(f"{e} (here: --device cpu)")
    print(json.dumps(run(args.procs, device, args.batch, args.frames,
                         args.size, args.timeout, args.task)))


if __name__ == "__main__":
    main()
