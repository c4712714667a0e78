"""Per-member bitwise error of a trained HiDDeN model (counterpart of
``tools/eval_hidden.py``).

    python -m vwfd_tpu_torch.eval_hidden --ckpt-dir checkpoints_hidden_r5_torch \\
        --step 23000 --batches 32 --out runs/hidden_torch_r5_eval.json
    python -m vwfd_tpu_torch.eval_hidden --ckpt-dir DIR --batches 2 --size 64 \\
        --device cpu

The training log's ``bitwise_error`` is a per-batch value under whichever
member that step drew; this is the error per member, as the HiDDeN paper's
tables report the combined-noise model. The same images as the JAX tool
(``SyntheticImageDataset(seed=123)``), the same messages
(``default_rng(0)``), the same seven members (the pool's six and the
paper-geometry cropout, 30 % of the area) and the same JSON line: the
encoded images' PSNR (dB, mean over batches) and each member's mean
bitwise error. The members that draw noise draw it from the port's
sampler (seed 42, as the JAX tool's key), not JAX's bits. Reads the nets
of the port's checkpoint ``<ckpt-dir>/<step>/`` (the latest without
``--step``; ``port_tools/hidden_checkpoint_to_torch.py`` converts a JAX
one). Runs on the CUDA card unless ``--device cpu``.
"""

import argparse
import json
import os

import numpy as np

from .data import SyntheticImageDataset
from .metrics import bitwise_message_error
from .models.hidden_model import (EVAL_MEMBERS, HiddenModel, HiddenSampler,
                                  apply_noise)
from .models.state import latest_step, load_nets

__all__ = ["evaluate", "main"]

EVAL_SEED = 42  # the JAX tool's PRNGKey(42)


def evaluate(model: HiddenModel, batches: int, batch: int,
             sampler: HiddenSampler, with_mean: bool = False) -> dict:
    """The per-member record on ``batches`` batches of the eval images:
    ``encoded_psnr_db`` and ``bitwise_error`` per member (and with
    ``with_mean`` their mean), rounded as the JAX tool rounds them."""
    size = model.image_size
    ds = SyntheticImageDataset(size=size, length=batches * batch, seed=123)
    rng = np.random.default_rng(0)
    errs = {name: [] for name in EVAL_MEMBERS}
    psnrs = []
    for bi in range(batches):
        imgs = np.stack([ds[bi * batch + j] for j in range(batch)])
        msgs = (rng.random((batch, model.message_length)) > 0.5
                ).astype(np.float32)
        img_t, msg_t = model.to_device(imgs, msgs)
        enc = model.encode(img_t, msg_t)
        d = enc.cpu().numpy().astype(np.float32) - imgs
        psnrs.append(-10 * np.log10(np.mean(d * d) + 1e-12))
        for name in EVAL_MEMBERS:
            dec = model.decode(apply_noise(enc, img_t,
                                           sampler(imgs.shape, name),
                                           model.kernels))
            errs[name].append(float(bitwise_message_error(dec, msg_t)))
    rec = {"encoded_psnr_db": round(float(np.mean(psnrs)), 2),
           "bitwise_error": {n: round(float(np.mean(v)), 4)
                             for n, v in errs.items()}}
    if with_mean:  # the mean of the unrounded member means
        rec["bitwise_error"]["mean"] = round(float(np.mean(
            [np.mean(v) for v in errs.values()])), 4)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", default="checkpoints_hidden_r5_torch")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--batches", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    model = HiddenModel(image_size=args.size, device=args.device)
    step = args.step if args.step is not None else latest_step(args.ckpt_dir)
    if step is None:
        ap.error(f"no checkpoint under {args.ckpt_dir}")
    model.load_states(load_nets(args.ckpt_dir, step))
    sampler = HiddenSampler(EVAL_SEED, model.device, members=EVAL_MEMBERS)
    rec = {"step": int(step), "batches": args.batches,
           **evaluate(model, args.batches, args.batch, sampler,
                      with_mean=True)}
    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main()
