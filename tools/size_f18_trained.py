"""Size F18 on trained coupling heads: how many watermarked bytes the
PyTorch port's embed and the JAX package's put on different 8-bit levels,
on the same trained weights and clip, and where the two part.

    python tools/size_f18_trained.py --ckpt-dir NETS_DIR [--size 256] \\
        [--out FILE]

Reads netG from the latest ``NETS_DIR/<step>/state.pt`` (the port's
checkpoint layout, ``vwfd_tpu_torch/models/state.py``: a full checkpoint
or the runner's ``--nets-out``), converts it with
``vwfd_tpu_torch/convert.py``'s ``params_to_jax``, and on clean clips of
the convergence runner's family (``vwfd_tpu_torch/data/ondevice.py``,
made on the CPU from the runner's seed):

1. calibrates and quantizes the int8 embed with each package's
   ``inn_int8`` on one clip: the scales' largest relative difference, and
   the trees compared leaf for leaf (the port's built on JAX's scales, and
   on its own);
2. watermarks one ``--size``², T = 4 clip with each package's float embed
   (``VideoWatermarkModel.embed``) and int8 embed (``forward_int8``, then
   the clamp and the 8-bit quantizer), each with its transitions and
   affines in float32 and in bfloat16;
3. for each of the four paths reports the share of watermarked bytes one
   level apart, more than one level apart, the largest difference and the
   RMS difference in levels; for bfloat16 also each package's bytes
   against its own float32 embed;
4. walks the bfloat16 float embed (``inn_packed.forward``) of both
   packages side by side: per transition and coupling half, in the walk's
   order, the largest difference in bfloat16 ulps and the share of values
   more than one ulp apart, and the first such point; then the same walk
   and bytes with the port's coupling head rounding where the JAX graph
   rounds as XLA compiles it on the CPU (``xla_order_head``);
5. walks the float32 int8 embed of both packages the same way, in float32
   ulps.

Prints one JSON object (also written to ``--out``). Runs on the CPU with
both packages, as their parity tests do; the port runs its plain
versions.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

T = 4  # frames of a clip


def byte_diff(a, b):
    """Shares of watermarked bytes one level apart and more than one, the
    largest difference and the RMS difference in levels, of two embeds in
    [0, 1] on the 8-bit grid."""
    d = np.abs(np.rint(np.asarray(a, np.float64) * 255)
               - np.rint(np.asarray(b, np.float64) * 255))
    return {"one_level": float((d == 1).mean()),
            "more": float((d > 1).mean()), "max_levels": int(d.max()),
            "rms_levels": float(np.sqrt(np.mean(d ** 2)))}


def psnr255(clip, wm):
    """PSNR (dB) of a watermarked clip against its clip, both on the 8-bit
    grid (``metrics.psnr255_int``'s quantity)."""
    d = (np.trunc(np.asarray(clip, np.float64) * 255)
         - np.trunc(np.asarray(wm, np.float64) * 255))
    return float(10 * np.log10(255.0 ** 2 / np.mean(d ** 2)))


def ulps(a, b, bits=23):
    """Largest difference in ulps of a float with ``bits`` mantissa bits
    (23: float32, 7: bfloat16), and the share more than one ulp apart."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.spacing(np.maximum(np.abs(a), np.abs(b))) * 2.0 ** (23 - bits)
    u = np.abs(a.astype(np.float64) - b.astype(np.float64)) / gap
    return float(u.max()), float((u > 1).mean())


def walk_rows(ours, theirs, bits):
    rows = []
    for i, ((name, a), b) in enumerate(zip(ours, theirs)):
        u, share = ulps(a, b, bits)
        rows.append({"point": i, "what": name, "max_ulps": u,
                     "share_over_1_ulp": share})
    first = next((r for r in rows if r["max_ulps"] > 1), None)
    return {"points": len(rows), "points_jax": len(theirs),
            "first_point_over_1_ulp": first, "walk": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import torch

    from vwfd_tpu.config import load_config as jload_config
    from vwfd_tpu.models.state import NetState
    from vwfd_tpu.models.video_model import VideoWatermarkModel as JModel
    from vwfd_tpu.models.video_model import _to_channels as j_to_channels
    from vwfd_tpu.models.video_model import _to_frames as j_to_frames
    from vwfd_tpu.nets import inn as jinn
    from vwfd_tpu.nets import inn_int8 as jq
    from vwfd_tpu.nets import inn_packed as jpk
    from vwfd_tpu.ops.quantize import clamp_with_grad, ste_quantize_255
    from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config
    from vwfd_tpu_torch.convert import inn_int8_from_jax, params_to_jax
    from vwfd_tpu_torch.data import synthetic_clips
    from vwfd_tpu_torch.kernels import PLAIN
    from vwfd_tpu_torch.kernels.coupling import deinterleave_index
    from vwfd_tpu_torch.models import VideoWatermarkModel
    from vwfd_tpu_torch.models.state import latest_step, load_nets
    from vwfd_tpu_torch.models.video_model import _to_channels
    from vwfd_tpu_torch.nets import inn_int8, inn_packed
    from vwfd_tpu_torch.run_convergence import SEED

    torch.set_num_threads(1)
    step = latest_step(args.ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
    nets = load_nets(args.ckpt_dir, step)
    s = args.size

    def cfgs(dtype):
        def cut(c):
            return dataclasses.replace(
                c, data=dataclasses.replace(c.data, batch_size=1, gt_size=s,
                                            frames=T),
                train=dataclasses.replace(c.train, dtype=dtype))
        return (cut(load_config(FLAGSHIP_CONFIG)), cut(jload_config(
            os.path.join(_ROOT, "vwfd_tpu", "configs", "video.yaml"))))

    # the port's model on the trained netG, and the JAX states from it
    cfg32, _ = cfgs("float32")
    port = VideoWatermarkModel(cfg32, device="cpu", kernels=PLAIN)
    port.inn.load_state_dict(nets["netG"])
    params, _, _ = params_to_jax(nets["netG"], {})
    p = jax.tree_util.tree_map(jnp.asarray, params)

    def jstates(jm):
        return {"netG": NetState.create(jm.inn.apply, p, {}, jm.tx)}

    def clip(stream):
        return synthetic_clips("cpu", SEED, stream, 0, 1, T, s)[0]

    # 1. calibration and quantization, the same clean clip on both sides
    calib = [_to_channels(clip(321)).numpy()]
    j_scales = jq.calibrate(p, [jnp.asarray(c) for c in calib])
    p_scales = inn_int8.calibrate(port.inn, calib, kernels=PLAIN)
    rel = max(abs(p_scales[k][st][i] - j_scales[k][st][i])
              / j_scales[k][st][i] for k in j_scales for st in ("st1", "st2")
              for i in range(3))
    jq_tree = jq.quantize(p, j_scales)
    j_tree = inn_int8_from_jax(jq_tree)

    def leaves_differing(tree):
        return sum(not torch.equal(a, b) for blk in j_tree
                   for st in ("st1", "st2") for a, b in
                   zip(tree[blk][st].values(), j_tree[blk][st].values()))

    result = {
        "step": step, "ckpt_dir": args.ckpt_dir, "size": s, "frames": T,
        "scales_max_rel_diff": rel,
        "int8_tree_leaves": sum(len(v) for blk in j_tree.values()
                                for v in blk.values()),
        "int8_tree_leaves_differing_on_jax_scales": leaves_differing(
            inn_int8.quantize(port.inn, j_scales)),
        "int8_tree_leaves_differing_on_own_scales": leaves_differing(
            inn_int8.quantize(port.inn, p_scales))}

    # 2-3. watermarked bytes of each path: outs[(path, dtype)] = (port, jax)
    video = clip(999)
    jv = jnp.asarray(video.numpy())
    outs, port16 = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg, jcfg = cfgs(dtype)
        pm = VideoWatermarkModel(cfg, device="cpu", kernels=PLAIN)
        pm.inn.load_state_dict(nets["netG"])
        jm = JModel(jcfg)
        st = jstates(jm)
        jdt = None if dtype == "float32" else jnp.bfloat16
        tdt = None if dtype == "float32" else torch.bfloat16

        @jax.jit
        def jembed_i8(q, v, jdt=jdt):
            x = j_to_channels(v if jdt is None else v.astype(jdt))
            y = jq.forward_int8(q, x, channels=3 * T, dtype=jdt)
            return ste_quantize_255(clamp_with_grad(
                j_to_frames(y, T).astype(jnp.float32)))

        y = inn_int8.forward_int8(
            inn_int8.quantize(pm.inn, j_scales),
            _to_channels(video.to(tdt or torch.float32)), channels=3 * T,
            dtype=tdt, out_f32=False, kernels=PLAIN)
        outs["float", dtype] = (pm.embed(video).numpy(), np.asarray(
            jax.jit(lambda v, jm=jm, st=st: jm.embed(st, v))(jv)))
        outs["int8", dtype] = (PLAIN.splice(y, T).numpy(),
                               np.asarray(jembed_i8(jq_tree, jv)))
        port16 = pm
    for (path, dtype), (ours, theirs) in outs.items():
        row = {**byte_diff(ours, theirs),
               "pf_port": psnr255(video.numpy(), ours),
               "pf_jax": psnr255(video.numpy(), theirs)}
        if dtype == "bfloat16":
            row["port_vs_own_float32"] = byte_diff(
                ours, outs[path, "float32"][0])
            row["jax_vs_own_float32"] = byte_diff(
                theirs, outs[path, "float32"][1])
        result[f"{path}_{dtype}"] = row

    # 4. the bfloat16 float embeds walked side by side
    def port_walk(kernels, head_field, run):
        """``run(kernels)`` with the transitions and the coupling head
        ``head_field`` recorded: [(what, output as float32 numpy)]."""
        pts = []

        def transition(z, kind, transpose=False):
            out = kernels.transition(z, kind, transpose)
            pts.append((f"transition {kind}{' T' if transpose else ''}",
                        out.float().numpy().copy()))
            return out

        def head(*a, **kw):
            out = getattr(kernels, head_field)(*a, **kw)
            pts.append(("coupling half", out.float().numpy().copy()))
            return out
        with torch.no_grad():
            run(kernels._replace(transition=transition,
                                 **{head_field: head}))
        return pts

    def xla_order_head(xin, h, q, x, out=None, inverse=False):
        """K2's plain forward with every elementwise operation rounded to
        bfloat16 where XLA rounds the JAX package's bfloat16 coupling on
        the CPU (inn_packed.py:201-209, inn.py:176-179): s and t after the
        bias; exp(−s), 1 + ·, 1 / · (the sigmoid), 2σ − 1, exp, + 1e-4;
        e·x; + t."""
        def r(a):
            return a.to(torch.bfloat16).float()
        z = torch.cat([xin, h], -1)
        head = torch.matmul(z.reshape(-1, z.shape[-1]), q["wh"].t())
        back = torch.from_numpy(deinterleave_index(head.shape[-1]))
        st = r(head[:, back].float() + q["bh"][back]).reshape(
            *x.shape[:3], -1)
        c = x.shape[-1]
        sig = r(1.0 / r(1.0 + r(torch.exp(-st[..., :c]))))
        e = r(r(torch.exp(r(2.0 * sig - 1.0))) + 1e-4)
        return out.copy_(r(e * x.float()) + st[..., c:])

    x16 = _to_channels(video.to(torch.bfloat16))
    with torch.no_grad():
        packed16 = port16.inn.packed_params()
    walked = {}

    def run_float(kernels, name):
        walked[name] = inn_packed.forward(
            packed16, x16, channels=3 * T, down_num=port16.inn.down_num,
            dtype=torch.bfloat16, out_f32=False, kernels=kernels)

    ours = port_walk(PLAIN, "coupling_head", lambda k: run_float(k, "port"))
    ours_xla = port_walk(PLAIN._replace(coupling_head=xla_order_head),
                         "coupling_head", lambda k: run_float(k, "xla"))

    def jax_float_walk(params, x):
        pts = []
        down, up, coupling = (jpk._down_transition, jpk._up_transition,
                              jpk._coupling_fwd)

        def rec(fn):
            def wrapped(*a):
                out = fn(*a)
                pts.append(out)
                return out
            return wrapped

        def coupling_fwd(q, z, packed, dt):  # inn_packed.py:201-209
            half = z.shape[-1] // 2
            st = jpk._st_packed if packed else jpk._st_unpacked
            x1, x2 = z[..., :half], z[..., half:]
            s2, t2 = st(q["st2"], x2, dt)
            y1 = jinn._e(s2) * x1 + t2
            s1, t1 = st(q["st1"], y1, dt)
            y2 = jinn._e(s1) * x2 + t1
            pts.extend([y1, y2])
            return jnp.concatenate([y1, y2], -1)
        try:
            jpk._down_transition, jpk._up_transition = rec(down), rec(up)
            jpk._coupling_fwd = coupling_fwd
            y = jpk.forward(params, x, channels=3 * T, dtype=jnp.bfloat16,
                            out_f32=False)
        finally:
            jpk._down_transition, jpk._up_transition = down, up
            jpk._coupling_fwd = coupling
        return y, pts

    jx16 = jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16)
    jy, theirs = jax.jit(jax_float_walk)(p, jx16)
    plain = jax.jit(lambda q, x: jpk.forward(
        q, x, channels=3 * T, dtype=jnp.bfloat16, out_f32=False))(p, jx16)
    if not bool(jnp.array_equal(jy, plain)):
        raise AssertionError("recording changed the JAX walk's output")
    theirs = [np.asarray(t, np.float32) for t in theirs]
    walk = walk_rows(ours, theirs, bits=7)
    walk_xla = walk_rows(ours_xla, theirs, bits=7)
    first = walk["first_point_over_1_ulp"]
    walk["xla_order_head"] = {
        "at_first_point": walk_xla["walk"][first["point"]] if first
        else None,
        "last_point": walk_xla["walk"][-1]}
    result["walk_float_bfloat16"] = walk

    def frames(y):  # the embed's clamp and 8-bit quantizer
        return PLAIN.splice(y, T).numpy()

    if not np.array_equal(frames(walked["port"]),
                          outs["float", "bfloat16"][0]):
        raise AssertionError("recording changed the port's walk")
    result["xla_order_float_bfloat16"] = {
        **byte_diff(frames(walked["xla"]), outs["float", "bfloat16"][1]),
        "pf_port_xla_order": psnr255(video.numpy(), frames(walked["xla"]))}

    # 5. the float32 int8 walks side by side
    x = _to_channels(video).numpy()
    ours = port_walk(PLAIN, "qcoupling_head", lambda k: inn_int8.forward_int8(
        j_tree, torch.from_numpy(x), channels=3 * T, dtype=None, kernels=k))
    theirs = []

    def recording(fn):
        def wrapped(*a):
            out = fn(*a)
            theirs.append(np.asarray(out, np.float32))
            return out
        return wrapped

    saved = jq._down_transition, jq._up_transition, jq._walk

    def walk_halves(tree, z, st_apply, channels, down_num, dtype):
        stash = {}

        def st(c, name, xin, packed):
            if name == "st2":
                stash["x2"] = xin
                return st_apply(c, name, xin, packed)
            theirs.append(np.asarray(xin, np.float32))   # y1
            s1, t1 = st_apply(c, name, xin, packed)
            theirs.append(np.asarray(                    # y2
                (jinn._e(s1) * stash["x2"].astype(jnp.float32) + t1)
                .astype(xin.dtype), np.float32))
            return s1, t1
        return saved[2](tree, z, st, channels, down_num, dtype)

    try:
        jq._down_transition = recording(saved[0])
        jq._up_transition = recording(saved[1])
        jq._walk = walk_halves
        with jax.disable_jit():
            jq.forward_int8(jq_tree, jnp.asarray(x), channels=3 * T,
                            dtype=None)
    finally:
        jq._down_transition, jq._up_transition, jq._walk = saved
    result["walk_int8_float32"] = walk_rows(ours, theirs, bits=23)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
