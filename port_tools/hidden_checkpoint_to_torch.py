"""Convert a HiDDeN orbax checkpoint of the JAX package into the port's
checkpoint layout.

    JAX_PLATFORMS=cpu python port_tools/hidden_checkpoint_to_torch.py \\
        --ckpt-dir checkpoints_hidden --step 15000 \\
        --out checkpoints_hidden_torch
    JAX_PLATFORMS=cpu python port_tools/hidden_checkpoint_to_torch.py \\
        --ckpt-dir checkpoints_hidden_r5 --step 23000 \\
        --out checkpoints_hidden_r5_torch --nets-only

Restores step ``--step`` of ``--ckpt-dir`` through
``vwfd_tpu.models.state.restore_checkpoint`` into
``HiddenModel(image_size=128).init_states`` templates, maps each net's
params and BatchNorm statistics (and, unless ``--nets-only``, its Adam
``mu``, ``nu`` and ``count``) into ``vwfd_tpu_torch``'s ``HiddenModel``
(``convert.states_from_jax``), and writes ``<out>/<step>/state.pt``:
``models/state.py::save_checkpoint`` (what ``restore_checkpoint`` and
``continue_hidden --from-ckpt`` read) or, with ``--nets-only``,
``save_nets`` (what ``eval_hidden`` reads). Needs JAX and orbax, so it runs
where the JAX package does, not on the card machine. Prints one JSON line:
the tensors converted per net and the bytes written.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def trees_of(states):
    """A JAX ``HiddenModel``'s states per net as nested dicts of numpy
    arrays: ``params``, ``batch_stats``, ``mu``, ``nu``, ``count``."""
    import jax

    def np_tree(t):
        return jax.tree_util.tree_map(np.asarray, jax.device_get(t))

    out = {}
    for name, s in states.items():
        adam = s.opt_state[0]
        out[name] = {"params": np_tree(dict(s.params)),
                     "batch_stats": np_tree(dict(s.variables.get(
                         "batch_stats", {}))),
                     "mu": np_tree(dict(adam.mu)),
                     "nu": np_tree(dict(adam.nu)),
                     "count": np.asarray(adam.count)}
    return out


def jax_trees(ckpt_dir: str, step: int, size: int = 128):
    """The checkpoint's trees per net (``trees_of``), restored into
    ``HiddenModel(image_size=size).init_states`` templates."""
    import jax
    from vwfd_tpu.models.hidden_model import HiddenModel as JaxHidden
    from vwfd_tpu.models.state import restore_checkpoint

    states = JaxHidden(image_size=size).init_states(jax.random.PRNGKey(0))
    return trees_of(restore_checkpoint(ckpt_dir, step, states))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--step", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--nets-only", action="store_true",
                    help="params and BatchNorm statistics only")
    args = ap.parse_args(argv)

    from vwfd_tpu_torch.convert import states_from_jax
    from vwfd_tpu_torch.models.hidden_model import HiddenModel
    from vwfd_tpu_torch.models.state import save_checkpoint, save_nets

    trees = jax_trees(args.ckpt_dir, args.step, args.size)
    if args.nets_only:
        trees = {n: {k: t[k] for k in ("params", "batch_stats")}
                 for n, t in trees.items()}
    model = HiddenModel(image_size=args.size, device="cpu")
    states_from_jax(model, trees)
    write = save_nets if args.nets_only else save_checkpoint
    path = write(args.out, args.step, model)
    counts = {}
    for name, net in model.nets().items():
        c = {"params": len(list(net.parameters())),
             "buffers": sum(1 for k, _ in net.named_buffers()
                            if not k.endswith("num_batches_tracked"))}
        if not args.nets_only:
            c["adam"] = 2 * c["params"] + 1
        counts[name] = c
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    print(json.dumps({"from": os.path.join(args.ckpt_dir, str(args.step)),
                      "to": path, "nets_only": args.nets_only,
                      "tensors": counts, "bytes": nbytes}))


if __name__ == "__main__":
    main()
