"""A real multi-process data-parallel dry run of the flagship (counterpart
of tools/dryrun_multiprocess.py).

    python -m vwfd_tpu_torch.dryrun_multiprocess --procs 2 --device cpu
    python -m vwfd_tpu_torch.dryrun_multiprocess --procs 2 --device cuda

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

``configs/video.yaml``'s model at ``--batch`` (the global batch, default 2
clips a rank), ``--frames`` (2) and ``--size`` (32). On the cards: its
widths in bf16 through the kernels, rank r on ``cuda:r``, over NCCL. On
the CPU: float32 through the plain versions over gloo, at
the tests' narrow widths (``inn_down_num`` 2, trunk width 16, extractor
f 8), since broadcasting the full-width states and moments between CPU
processes takes seconds.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from . import FLAGSHIP_CONFIG, load_config
from .data import Loader, SyntheticVideoDataset
from .models import VideoWatermarkModel
from .parallel import (local_batch_slice, local_device, make_mesh,
                       maybe_init_distributed, replicas_equal, replicate)
from .parallel.spawn import LocalRanks

GROUP_TIMEOUT_S = 60.0  # a collective that waits longer raises


CPU_WIDTHS = dict(inn_down_num=2, inn_block_num=(1, 1), inn_width=16,
                  extractor_features=8)


def _config(args):
    cfg = load_config(FLAGSHIP_CONFIG)
    data = dataclasses.replace(cfg.data, batch_size=args.batch,
                               frames=args.frames, gt_size=args.size)
    if args.device == "cuda":
        return dataclasses.replace(cfg, data=data)
    return dataclasses.replace(
        cfg, data=data, model=dataclasses.replace(cfg.model, **CPU_WIDTHS),
        train=dataclasses.replace(cfg.train, dtype="float32"))


def _child(args) -> None:
    """One rank: one train step on its rows; prints one JSON line."""
    torch.set_num_threads(1)
    device = local_device(args.device)
    rank = maybe_init_distributed(device, timeout_s=GROUP_TIMEOUT_S)
    try:
        mesh = make_mesh()
        cfg = _config(args)
        b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
        model = VideoWatermarkModel(cfg, device=device, mesh=mesh)
        model.init_states(cfg.train.seed + rank)
        differed = not replicas_equal(model, mesh)
        replicate(model, mesh)
        rows = local_batch_slice(b, mesh)
        loader = Loader(SyntheticVideoDataset(size=s, frames=t, length=2 * b,
                                              seed=cfg.train.seed),
                        b, seed=cfg.train.seed, rows=rows)
        (prev, _), (video, mask) = list(loader)[:2]
        t0 = time.perf_counter()
        logs = {k: float(v) for k, v in
                model.train_step(video, mask, prev).items()}
        ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({
            "rank": rank, "world_size": mesh.size, "rows": list(rows),
            "loss": logs["loss"], "loss_hex": logs["loss"].hex(),
            "logs": logs, "seeds_differed": differed,
            "replicas_equal": replicas_equal(model, mesh),
            "backend": dist.get_backend(), "device": str(device),
            "step_ms": ms}), flush=True)
    finally:
        dist.destroy_process_group()


def run(procs: int, device: str = "cpu", batch=None, frames: int = 2,
        size: int = 32, timeout_s: float = 300.0) -> dict:
    """Spawn the ranks, wait for them (bounded), check them; returns the
    summary. Raises ``parallel.spawn.RankFailure`` when a rank fails or
    hangs, ``RuntimeError`` when the ranks disagree."""
    batch = batch or 2 * procs
    cmd = [sys.executable, "-m", "vwfd_tpu_torch.dryrun_multiprocess",
           "--child", "--device", device, "--batch", str(batch), "--frames",
           str(frames), "--size", str(size)]
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
        (len({r["loss_hex"] for r in reports}) != 1,
         f"losses differ across ranks: {[r['loss'] for r in reports]}"),
        (not all(r["replicas_equal"] for r in reports), "replicas diverged"),
        (not all(r["seeds_differed"] for r in reports),
         "the ranks' differently seeded states were equal before "
         "replicate")) if bad]
    if failed:
        raise RuntimeError("; ".join(failed))
    return {"ok": True, "procs": procs, "device": device,
            "backend": reports[0]["backend"], "batch": batch,
            "frames": frames, "size": size, "loss": reports[0]["loss"],
            "rows": [r["rows"] for r in reports],
            "step_ms": [r["step_ms"] for r in reports],
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch (default 2 clips a rank)")
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
    print(json.dumps(run(args.procs, args.device, args.batch, args.frames,
                         args.size, args.timeout)))


if __name__ == "__main__":
    main()
