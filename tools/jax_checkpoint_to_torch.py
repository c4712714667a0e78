"""Convert a flagship checkpoint of the JAX package into the PyTorch port's.

    python tools/jax_checkpoint_to_torch.py --ckpt-dir checkpoints \\
        --out checkpoints_torch [--step N] [--config PATH] [--npz-dir DIR]

Reads ``<ckpt-dir>/<step>`` (the latest step unless ``--step``), an orbax
checkpoint written by ``vwfd_tpu/models/state.py::save_checkpoint``, into
templates from ``vwfd_tpu``'s ``VideoWatermarkModel.init_states`` for the
config (default ``vwfd_tpu/configs/video.yaml``; the port reads the same
YAML). It writes the port's checkpoint, ``<out>/<step>/state.pt``
(``vwfd_tpu_torch/models/state.py::save_checkpoint``'s layout: both nets'
parameters and BatchNorm statistics, each net's AdamW moments and step
count, converted by ``vwfd_tpu_torch/convert.py``), which
``WatermarkServer(ckpt_dir=...)``, ``train --resume --ckpt-dir`` and
``restore_checkpoint`` read with no JAX. With ``--npz-dir`` it also writes
``netG.npz`` and ``generator.npz``, the npz pretrain trees that
``model.pretrain_path`` loads in either package. Prints one JSON line.

Imports both packages, as their parity tests do, so it runs where JAX,
flax, optax and orbax are installed; no accelerator is needed.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

DEFAULT_CONFIG = os.path.join(_ROOT, "vwfd_tpu", "configs", "video.yaml")


def _adam_state(opt_state):
    """The one optax ``ScaleByAdamState`` inside a net's chained state."""
    import optax
    found = []

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)
    visit(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one ScaleByAdamState, found {len(found)}")
    return found[0]


def convert(jax_cfg, port_cfg, ckpt_dir, out_dir, step=None, npz_dir=None):
    """Convert ``ckpt_dir/<step>`` (default: the latest) for the configs
    (``vwfd_tpu.config.Config`` and ``vwfd_tpu_torch.config.Config`` of the
    same model); returns ``(step, path of the port's checkpoint)``."""
    import jax
    from vwfd_tpu.models import VideoWatermarkModel as JaxModel
    from vwfd_tpu.models.state import latest_step, restore_checkpoint
    from vwfd_tpu_torch.convert import opt_state_from_jax, params_from_jax
    from vwfd_tpu_torch.models import VideoWatermarkModel
    from vwfd_tpu_torch.models.state import save_checkpoint, save_npz_tree

    at = step if step is not None else latest_step(ckpt_dir)
    if at is None:
        raise FileNotFoundError(f"no checkpoint steps under {ckpt_dir!r}")
    jm = JaxModel(jax_cfg)
    states = restore_checkpoint(ckpt_dir, at,
                                jm.init_states(jax.random.PRNGKey(0)))
    host = {name: jax.tree_util.tree_map(
        np.asarray, {"params": s.params, "variables": s.variables,
                     "opt_state": s.opt_state}) for name, s in states.items()}
    stats = host["generator"]["variables"].get("batch_stats", {})

    # the port's model only receives the converted tensors: no pretrain load
    port_cfg = dataclasses.replace(
        port_cfg, model=dataclasses.replace(port_cfg.model,
                                            pretrain_path=None))
    model = VideoWatermarkModel(port_cfg, device="cpu")
    netg, gen = params_from_jax(host["netG"]["params"],
                                host["generator"]["params"], stats)
    model.load_states({"netG": netg, "generator": gen})
    with torch.no_grad():
        for name, net in model.nets().items():
            adam = _adam_state(host[name]["opt_state"])
            mu, nu, count = opt_state_from_jax(net, adam.mu, adam.nu,
                                               adam.count)
            opt = model.optimizers[name]
            for dst, src in zip(opt.mu + opt.nu, mu + nu):
                dst.copy_(src)
            opt.count.copy_(count)
    path = save_checkpoint(out_dir, at, model)
    if npz_dir:
        os.makedirs(npz_dir, exist_ok=True)
        save_npz_tree(os.path.join(npz_dir, "netG.npz"),
                      {"params": host["netG"]["params"]})
        save_npz_tree(os.path.join(npz_dir, "generator.npz"),
                      {"params": host["generator"]["params"],
                       "batch_stats": stats})
    return at, path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True,
                    help="the JAX package's checkpoint directory")
    ap.add_argument("--out", required=True,
                    help="the port's checkpoint directory to write")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--npz-dir", default=None,
                    help="also write the npz pretrain trees here")
    args = ap.parse_args(argv)
    from vwfd_tpu.config import load_config as load_jax_config
    from vwfd_tpu_torch.config import load_config as load_port_config
    at, path = convert(load_jax_config(args.config),
                       load_port_config(args.config), args.ckpt_dir,
                       args.out, args.step, args.npz_dir)
    print(json.dumps({"step": at, "checkpoint": path,
                      "npz_dir": args.npz_dir}))


if __name__ == "__main__":
    main()
