"""The JPEG-vs-adversarial-example study (port of
scripts/jpegadv_experiment.py; the reference's jpegadv/targeted_compress.py:
25-189 and untargeted_compress.py).

Attack a victim classifier (FGSM, IGSM, targeted IGSM or the JPEG-resistant
attack through DiffJPEG), then sweep real libjpeg (PIL) over a quality list
on both the clean and the adversarial image, recording accuracy, the
targeted hit, PSNR to the clean and to the adversarial image and the L2 per
quality::

    python -m vwfd_tpu_torch.jpegadv_experiment --victim A --attack igsm \\
        [--targeted] [--images DIR] [--n 16] [--out results.json] \\
        [--params victim.npz] [--device cuda]

It prints a line per image and the JAX script's summary line (a JSON
object: victim, attack, targeted, qualities, ``adv_fooled_rate``,
``adv_target_rate``); ``--out`` writes the summary with every row. Without
``--images`` the images are the JAX script's seeded synthetic ones
(``numpy.random.default_rng(0)``). ``--images`` reads a folder's files with
PIL (as ``jpeg_real``, the sweep's codec, needs it) and resizes them
with the port's cv2-style bilinear resize (``data/cvtransforms.py``; the JAX
script calls ``cv2.resize`` on the uint8 image); no cv2.

The victim's weights: ``--params`` takes a flax tree of the JAX victim as a
``/``-flattened .npz (``models/state.py::save_npz_tree`` of
``model.init(...)``'s tree, the ``params`` level or the whole dict), converted
by ``convert.victim_from_jax``; without it the weights are PyTorch's default
initialisation under ``torch.manual_seed(0)`` (the JAX script's
``jax.random.PRNGKey(0)`` draws cannot be replayed). The attacks run on
``--device`` (default ``cuda``; it raises without a card unless ``--device
cpu``): ``--attack jpeg_resistant`` launches K24 forward and backward on
every step there.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

__all__ = ["main", "run_study", "load_images", "build_victim"]


def load_images(folder: str, n: int, size: int) -> np.ndarray:
    """The first ``n`` readable files of ``folder`` (sorted), RGB, resized
    to ``size``², as float32 (N, size, size, 3) in [0, 1]."""
    from PIL import Image, UnidentifiedImageError
    from .data.cvtransforms import resize_plane
    imgs = []
    for f in sorted(os.listdir(folder))[:n]:
        try:
            with Image.open(os.path.join(folder, f)) as pil:
                im = np.asarray(pil.convert("RGB"))
        except (UnidentifiedImageError, IsADirectoryError):
            continue
        u8 = np.clip(np.rint(resize_plane(im.astype(np.float32),
                                          (size, size))), 0, 255)
        imgs.append(u8.astype(np.float32) / 255.0)
    if not imgs:
        raise ValueError(f"no readable image in {folder}")
    return np.stack(imgs)


def build_victim(name: str, classes: int, size: int, params=None,
                 device="cuda") -> torch.nn.Module:
    """The victim module on ``device`` in eval mode, from a flax tree
    (``params``, a nested dict of arrays) or default weights seeded 0."""
    from .adversarial import VICTIMS
    from .convert import victim_from_jax
    # A fixed seed, as the JAX script's fixed PRNGKey(0): its flax draws
    # cannot be replayed in torch, so the defaults differ but are stable.
    torch.manual_seed(0)
    model = VICTIMS[name](num_classes=classes, size=size)
    if params is not None:
        model.load_state_dict(victim_from_jax(params))
    return model.to(device).eval()


def run_study(model: torch.nn.Module, images: np.ndarray, attack: str,
              targeted: bool, epsilon: float, qualities, kernels=None,
              log=print):
    """The study's rows and summary rates for ``images`` (N, H, W, 3) float32
    on ``model``'s device (``kernels``: K24's kernel set for the
    JPEG-resistant attack, default ``kernels.KERNELS``)."""
    from . import adversarial as adv
    from .attacks.jpeg import jpeg_real
    from .metrics import psnr255_int

    dev = next(model.parameters()).device

    def logits(x):
        with torch.no_grad():
            return model(x).float()

    def argmax(x):
        return int(torch.argmax(logits(x)[0]))

    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    labels = torch.argmax(logits(imgs), 1).cpu().numpy()
    rows = []
    for i in range(imgs.shape[0]):
        img = imgs[i]
        label = int(labels[i])
        lg = logits(img[None])[0]
        target = int(torch.argmin(lg))  # targeted_compress.py: argmin logit
        if targeted:
            advpic = adv.igsm_targeted(adv.cross_entropy_of(model, target),
                                       img, epsilon=epsilon)
        elif attack == "fgsm":
            advpic = adv.fgsm(adv.cross_entropy_of(model, label), img,
                              epsilon=epsilon)
        elif attack == "jpeg_resistant":
            advpic = adv.jpeg_resistant_fgsm(
                adv.cross_entropy_of(model, label), img, epsilon=epsilon,
                kernels=kernels)
        else:
            advpic = adv.igsm(adv.cross_entropy_of(model, label), img,
                              epsilon=epsilon)
        adv_np = advpic.cpu().numpy()
        row = {"id": i, "label": label, "target": target,
               "adv_label": argmax(advpic[None]),
               "adv_psnr": float(psnr255_int(img[None], advpic[None])),
               "adv_l2": float(np.sqrt(np.mean((adv_np - images[i]) ** 2))),
               "sweep": {}}
        for variant, base in (("jpg_pic", images[i]), ("jpg_adv", adv_np)):
            per_q = []
            for q in qualities:
                jp = jpeg_real(base, q)
                jt = torch.from_numpy(jp).to(dev)
                pl = argmax(jt[None])
                per_q.append({
                    "q": q, "label": pl, "acc": int(pl == label),
                    "target_hit": int(pl == target),
                    "psnr_with_pic": float(psnr255_int(img[None], jt[None])),
                    "psnr_with_adv": float(psnr255_int(advpic[None],
                                                       jt[None])),
                    "l2_with_pic": float(np.sqrt(np.mean(
                        (jp - images[i]) ** 2))),
                })
            row["sweep"][variant] = per_q
        rows.append(row)
        log(f"[{i}] label={label} adv={row['adv_label']} "
            f"target={target} psnr={row['adv_psnr']:.1f}")
    return {
        "adv_fooled_rate": float(np.mean(
            [r["adv_label"] != r["label"] for r in rows])),
        "adv_target_rate": float(np.mean(
            [r["adv_label"] == r["target"] for r in rows])),
        "rows": rows,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--victim", default="A", choices=["A", "B", "C"])
    ap.add_argument("--attack", default="igsm",
                    choices=["fgsm", "igsm", "jpeg_resistant"])
    ap.add_argument("--targeted", action="store_true")
    ap.add_argument("--images", default=None)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--epsilon", type=float, default=0.03)
    ap.add_argument("--qualities", type=int, nargs="+",
                    default=[90, 70, 50, 30, 10])
    ap.add_argument("--out", default=None)
    ap.add_argument("--params", default=None,
                    help="the JAX victim's flax tree as a /-flattened .npz")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .device import resolve_device
    from .models.state import load_npz_tree

    dev = resolve_device(args.device)
    params = load_npz_tree(args.params) if args.params else None
    model = build_victim(args.victim, args.classes, args.size, params,
                         dev)
    if args.images:
        images = load_images(args.images, args.n, args.size)
    else:
        rng = np.random.default_rng(0)
        images = rng.random((args.n, args.size, args.size, 3)).astype(
            np.float32)
    res = run_study(model, images, args.attack, args.targeted, args.epsilon,
                    args.qualities)
    summary = {"victim": args.victim, "attack": args.attack,
               "targeted": args.targeted, "qualities": args.qualities,
               "adv_fooled_rate": res["adv_fooled_rate"],
               "adv_target_rate": res["adv_target_rate"],
               "rows": res["rows"]}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
        print("wrote", args.out)
    return summary


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
