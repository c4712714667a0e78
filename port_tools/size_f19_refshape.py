"""Size F19 on the trained reference-shaped model: how many watermarked
bytes the PyTorch port's embed and the JAX package's put on different 8-bit
levels, on the same trained netG and clip, in float32 and in bfloat16, and
where the two bfloat16 embeds first part.

    python port_tools/size_f19_refshape.py --ckpt-dir NETS_DIR \\
        [--size 256] [--out FILE]

Reads netG from the latest ``NETS_DIR/<step>/state.pt`` (the port's
checkpoint layout: a full checkpoint or the convergence runner's
``--nets-out``), converts it with ``vwfd_tpu_torch/convert.py``, and on one
clean clip of the convergence runner's family (``data/ondevice.py``, made
on the CPU from the runner's seed, stream 999, T = 4) at ``--size``²:

1. watermarks the clip with each package's ``VideoWatermarkModel.embed``
   of ``configs/refshape.yaml`` (the INN module path: res subnets, the
   lifting Haar), in float32 and in bfloat16, and reports for each dtype
   the share of bytes one level apart, more than one level apart, the
   largest and the RMS difference, and each embed's PSNR; for bfloat16
   also each package's bytes against its own float32 embed;
2. on the JAX embed's own bfloat16 tensors, the first Haar level and the
   first coupling half: the share of values more than one bfloat16 ulp
   apart between JAX's bfloat16 graph and the port's plain versions (K14
   and K15, float32 arithmetic rounded once), fed the same inputs.

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
    """Shares of bytes one level apart and more than one, the largest and
    the RMS difference in levels, of two embeds on the 8-bit grid."""
    d = np.abs(np.rint(np.asarray(a, np.float64) * 255)
               - np.rint(np.asarray(b, np.float64) * 255))
    return {"one_level": float((d == 1).mean()),
            "more": float((d > 1).mean()), "max_levels": int(d.max()),
            "rms_levels": float(np.sqrt(np.mean(d ** 2)))}


def psnr255(clip, wm):
    d = (np.trunc(np.asarray(clip, np.float64) * 255)
         - np.trunc(np.asarray(wm, np.float64) * 255))
    return float(10 * np.log10(255.0 ** 2 / np.mean(d ** 2)))


def over_one_ulp(a, b):
    """Share of bfloat16 values more than one ulp apart, and the largest
    difference in ulps."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.spacing(np.maximum(np.abs(a), np.abs(b))) * 2.0 ** 16
    u = np.abs(a.astype(np.float64) - b.astype(np.float64)) / gap
    return {"share_over_1_ulp": float((u > 1).mean()),
            "max_ulps": float(u.max())}


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
    from vwfd_tpu.nets import inn as jinn
    from vwfd_tpu.ops import haar as jhaar
    from vwfd_tpu_torch import REFSHAPE_CONFIG, load_config
    from vwfd_tpu_torch.convert import params_to_jax
    from vwfd_tpu_torch.data import synthetic_clips
    from vwfd_tpu_torch.kernels import PLAIN
    from vwfd_tpu_torch.models import VideoWatermarkModel
    from vwfd_tpu_torch.models.state import latest_step, load_nets
    from vwfd_tpu_torch.run_convergence import SEED

    torch.set_num_threads(os.cpu_count() or 1)
    step = latest_step(args.ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
    nets = load_nets(args.ckpt_dir, step)
    s = args.size

    def cut(c, dtype):
        return dataclasses.replace(
            c, data=dataclasses.replace(c.data, batch_size=1, gt_size=s,
                                        frames=T),
            train=dataclasses.replace(c.train, dtype=dtype))

    params, _, _ = params_to_jax(nets["netG"], {})
    p = jax.tree_util.tree_map(jnp.asarray, params)
    video = synthetic_clips("cpu", SEED, 999, 0, 1, T, s)[0]
    jv = jnp.asarray(video.numpy())
    clip = video.numpy()

    wm = {}
    for dtype in ("float32", "bfloat16"):
        pm = VideoWatermarkModel(cut(load_config(REFSHAPE_CONFIG), dtype),
                                 device="cpu", kernels=PLAIN)
        pm.inn.load_state_dict(nets["netG"])
        jm = JModel(cut(jload_config(REFSHAPE_CONFIG), dtype))
        st = {"netG": NetState.create(jm.inn.apply, p, {}, jm.tx)}
        wm[dtype] = (pm.embed(video).numpy(),
                     np.asarray(jax.jit(jm.embed)(st, jv)))
    result = {"step": step, "ckpt_dir": args.ckpt_dir, "size": s,
              "frames": T, "config": "vwfd_tpu_torch/configs/refshape.yaml"}
    for dtype, (ours, theirs) in wm.items():
        result[dtype] = {"port_vs_jax": byte_diff(ours, theirs),
                         "psnr_port": psnr255(clip, ours),
                         "psnr_jax": psnr255(clip, theirs)}
    result["bfloat16"]["port_vs_own_float32"] = byte_diff(
        wm["bfloat16"][0], wm["float32"][0])
    result["bfloat16"]["jax_vs_own_float32"] = byte_diff(
        wm["bfloat16"][1], wm["float32"][1])

    # 2. the first Haar level and the first coupling half, same inputs
    x = j_to_channels(jv.astype(jnp.bfloat16))
    z = jhaar.haar_downsample(x)
    z_port = PLAIN.haar(torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16))
    half = z.shape[-1] // 2
    x1, x2 = z[..., :half], z[..., half:]
    sub = jinn.ResSubnet(2 * half, dtype=jnp.bfloat16)
    head = sub.apply({"params": p["down_blocks_0_0"]["st2"]}, x2)
    s2, t2 = head[..., :half], head[..., half:]
    y1 = jinn._e(s2) * x1 + t2

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    y1_port = PLAIN.coupling_affine((t(s2), t(t2)), t(x1))
    result["bfloat16"]["first_haar_level"] = over_one_ulp(
        z_port.float().numpy(), z)
    result["bfloat16"]["first_coupling_half"] = over_one_ulp(
        y1_port.float().numpy(), y1)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
