"""What data parallelism costs and where a replica's half batch parts from
the whole batch, on the card.

    python port_tools/dp_diagnose.py [--steps 20] [--out FILE]

Needs one CUDA card. On ``configs/video.yaml``'s flagship (bf16, b16, T 4,
256², the seed-7 weights of ``chip_smoke.py``'s phase 4, its coupling heads
perturbed), it prints JSON lines, each with the card's name and power
limit, and appends them to ``--out``:

1. ``split``: the detect path's UNet (``body`` on K3's stem) on the 64
   frames at once and in halves (32) and quarters (16): for each
   convolution and transposed convolution in order, whether the halves'
   outputs are EQUAL to the whole batch's rows and their largest
   difference; then the logits with ``cudnn.deterministic`` and with
   ``cudnn.benchmark``; and whether the bf16 embed of 8 clips equals the
   whole batch's rows.
2. ``collectives``: one NCCL rank in this process (a ``FileStore`` under
   ``build/``): the host wall of ``parallel.all_reduce_grads`` over both
   nets' gradients, of a scalar ``global_mean`` forward and forward +
   backward, and of the int64 count sum (median of ``--steps``).
3. ``step``: the plain train step and the world-size-1 data-parallel step,
   interleaved, ``--steps`` each after 3 warm-up (p50, mean, min of the
   host wall ending in a synchronize); then 3 steps of each under
   ``torch.profiler`` (CPU + CUDA): the self CPU and self device time a
   step, the operators whose self CPU time differs most, and where each
   ``cudaStreamSynchronize`` was called from.

A measurement tool, not part of the package: nothing imports it.
"""

import argparse
import datetime
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config, parallel  # noqa: E402
from vwfd_tpu_torch.data import Loader, SyntheticVideoDataset  # noqa: E402
from vwfd_tpu_torch.models import VideoWatermarkModel  # noqa: E402
from vwfd_tpu_torch.nets import unet as unet_mod  # noqa: E402
from vwfd_tpu_torch.serving import WatermarkServer  # noqa: E402
from chip_smoke import card_line, perturbed_states  # noqa: E402

def split(cfg, states):
    srv = WatermarkServer(cfg, weights=states, modes=("embed", "detect"))
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    clip = np.random.default_rng(19).integers(0, 256, (b, t, s, s, 3),
                                              dtype=np.uint8)
    x = torch.from_numpy(clip).cuda()
    frames = x.reshape(b * t, s, s, 3)
    rec = []
    conv, up = unet_mod._conv, unet_mod._up_convt

    def rec_conv(z, c, dt, pad):
        y = conv(z, c, dt, pad)
        rec.append(("conv", list(z.shape), list(c.weight.shape), y))
        return y

    def rec_up(z, u, dt):
        y = up(z, u, dt)
        rec.append(("up", list(z.shape), list(u.weight.shape), y))
        return y

    def body(f):
        rec.clear()
        with torch.no_grad():
            out = srv.model.unet.body(srv.kernels.wire_to_s2d(
                f, srv.model.unet.s2d, srv.model.compute_dtype))
        torch.cuda.synchronize()
        return list(rec), out

    out = {"frames": b * t, "ops": {}}
    unet_mod._conv, unet_mod._up_convt = rec_conv, rec_up
    try:
        for n in (b * t // 2, b * t // 4):
            whole, logits = body(frames)
            parts = [body(frames[i:i + n].contiguous())
                     for i in range(0, b * t, n)]
            ops = []
            for i, (kind, shp, w, y) in enumerate(whole):
                d = max(float((y[j * n:(j + 1) * n].float()
                               - p[0][i][3].float()).abs().max())
                        for j, p in enumerate(parts))
                ops.append({"op": i, "kind": kind, "in": shp, "w": w,
                            "equal": d == 0.0, "max_diff": d})
            out["ops"][n] = ops
            out[f"logits_equal_{n}"] = all(
                torch.equal(logits[j * n:(j + 1) * n], p[1])
                for j, p in enumerate(parts))
        n = b * t // 2
        for name, flags in (("deterministic", dict(deterministic=True,
                                                   benchmark=False)),
                            ("benchmark", dict(deterministic=False,
                                               benchmark=True))):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                            **flags):
                _, logits = body(frames)
                halves = [body(frames[i:i + n].contiguous())[1]
                          for i in (0, n)]
            out[f"logits_equal_{n}_{name}"] = all(
                torch.equal(logits[j * n:(j + 1) * n], h)
                for j, h in enumerate(halves))
    finally:
        unet_mod._conv, unet_mod._up_convt = conv, up
    with torch.no_grad():
        e = srv._embed_u8(x)["watermarked"]
        halves = [srv._embed_u8(x[i:i + b // 2].contiguous())["watermarked"]
                  for i in (0, b // 2)]
    out["embed_equal_half"] = all(torch.equal(e[j * (b // 2):(j + 1) * (b // 2)],
                                              h) for j, h in enumerate(halves))
    return out


def median_ms(fn, n):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def collectives(model, mesh, n):
    grads = {k: [torch.randn_like(p) for p in net.parameters()]
             for k, net in model.nets().items()}
    s = torch.ones((), device="cuda")
    sg = torch.ones((), device="cuda", requires_grad=True)
    cnt = torch.ones(9, 3, dtype=torch.int64, device="cuda")

    def fwd_bwd():
        parallel.global_mean(sg * 2, mesh).backward()
    return {
        "all_reduce_grads_ms": median_ms(lambda: [
            parallel.all_reduce_grads(g, mesh) for g in grads.values()], n),
        "bytes": sum(4 * p.numel() for g in grads.values() for p in g),
        "global_mean_ms": median_ms(lambda: parallel.global_mean(s, mesh),
                                    n),
        "global_mean_fwd_bwd_ms": median_ms(fwd_bwd, n),
        "count_sum_ms": median_ms(lambda: parallel.global_sum(cnt, mesh), n)}


def step(cfg, states, mesh, n):
    from torch.profiler import ProfilerActivity, profile
    plain = VideoWatermarkModel(cfg)
    plain.load_states(states)
    dp = VideoWatermarkModel(cfg, mesh=mesh)
    dp.load_states(states)
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    loader = Loader(SyntheticVideoDataset(size=s, frames=t, length=4 * b,
                                          seed=cfg.train.seed), b,
                    seed=cfg.train.seed)
    batches = [plain.to_device(v, m) for v, m in loader]

    def one(model, i):
        p, (v, m) = batches[i % 3][0], batches[i % 3 + 1]
        model.train_step(v, m, p)
    for i in range(3):
        one(plain, i)
        one(dp, i)
    torch.cuda.synchronize()
    ts = {"plain": [], "dp": []}
    for i in range(n):
        for name, model in (("plain", plain), ("dp", dp)):
            t0 = time.perf_counter()
            one(model, i)
            torch.cuda.synchronize()
            ts[name].append((time.perf_counter() - t0) * 1e3)
    out = {k: {"p50_ms": float(np.percentile(v, 50)),
               "mean_ms": float(np.mean(v)), "min_ms": float(np.min(v))}
           for k, v in ts.items()}
    cpu, syncs = {}, {}
    for name, model in (("plain", plain), ("dp", dp)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            for i in range(3):
                one(model, i)
            torch.cuda.synchronize()
        for e in prof.events():
            if e.name == "cudaStreamSynchronize":
                where = " < ".join(f for f in (e.stack or [])
                                   if "vwfd_tpu_torch" in f
                                   or "torch/distributed" in f)[:600]
                key = f"{name}: {where}"
                syncs[key] = syncs.get(key, 0) + 1
        ka = prof.key_averages()
        cpu[name] = {e.key: e.self_cpu_time_total / 3e3 for e in ka}
        out[name]["self_cpu_ms"] = sum(cpu[name].values())
        out[name]["self_device_ms"] = sum(
            getattr(e, "self_device_time_total", 0) for e in ka) / 3e3
    keys = set(cpu["plain"]) | set(cpu["dp"])
    diff = sorted(((cpu["dp"].get(k, 0.0) - cpu["plain"].get(k, 0.0), k)
                   for k in keys), reverse=True)
    out["self_cpu_ms_more_in_dp"] = {k: d for d, k in diff[:12]}
    out["stream_synchronize_calls"] = syncs
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dp_diagnose: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg = load_config(FLAGSHIP_CONFIG)
    states = perturbed_states(cfg, 7)

    def emit(kind, rec):
        line = json.dumps({"kind": kind, **rec, "card": card})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    emit("split", split(cfg, states))
    store = ROOT / "build" / "dp_diagnose_store"
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = parallel.make_mesh()
        emit("collectives", collectives(VideoWatermarkModel(cfg), mesh,
                                        args.steps))
        emit("step", step(cfg, states, mesh, args.steps))
    finally:
        dist.destroy_process_group()
        if store.exists():
            os.remove(store)


if __name__ == "__main__":
    main()
