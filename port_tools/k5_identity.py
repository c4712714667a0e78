"""K5 ``jpeg_pair`` outputs of one checkout, to hold two builds bit for bit.

    python port_tools/k5_identity.py --root CHECKOUT --out A.npz
    python port_tools/k5_identity.py --compare A.npz B.npz

``--root`` imports ``vwfd_tpu_torch`` from that checkout (its kernels built
there at first use) and writes K5's forward and input gradient on the
card for seeded frames at the flagship's train shape (64 frames of 256²,
8-bit levels) under each draw mode pair and at MBRS's shape (jpeg_basic's
weights (1, 0)); ``--compare`` prints whether every array is equal and
exits non-zero if one is not. Needs a CUDA card.
"""

import argparse
import sys

import numpy as np


def dump(root: str, out: str) -> None:
    sys.path.insert(0, root)
    import torch
    from vwfd_tpu_torch.attacks.jpeg import quant_tables
    from vwfd_tpu_torch.kernels import jpeg
    g = torch.Generator("cuda").manual_seed(27)
    res = {}
    cases = [((64, 256, 256, 3), m1, m2) for m1 in range(3)
             for m2 in range(3)] + [((16, 128, 128, 3), m, m)
                                    for m in (0, 1)]
    for k, (shape, m1, m2) in enumerate(cases):
        n = shape[0]
        x = (torch.randint(0, 256, shape, device="cuda", generator=g).float()
             / 255.0 if n == 64 else
             torch.rand(shape, device="cuda", generator=g))
        qi = torch.randint(0, 5, (n, 2), device="cuda", generator=g)
        qt = quant_tables(qi).contiguous()
        mode = torch.tensor([m1, m2], dtype=torch.int32,
                            device="cuda").expand(n, 2).contiguous()
        w = (torch.softmax(torch.randn(n, 2, device="cuda", generator=g), -1)
             if n == 64 else torch.tensor([[1.0, 0.0]], device="cuda")
             .expand(n, 2)).contiguous()
        cot = torch.randn(shape, device="cuda", generator=g)
        xg = x.clone().requires_grad_(True)
        y = jpeg.jpeg_pair(xg, qt, mode, w)
        (gx,) = torch.autograd.grad(y, xg, cot)
        res[f"y{k}"] = y.detach().cpu().numpy()
        res[f"g{k}"] = gx.cpu().numpy()
    np.savez(out, **res)
    print(f"wrote {len(cases)} cases to {out}")


def compare(a: str, b: str) -> int:
    with np.load(a) as fa, np.load(b) as fb:
        keys = sorted(fa.files)
        same = keys == sorted(fb.files) and all(
            np.array_equal(fa[k], fb[k], equal_nan=True) for k in keys)
    print(f"K5 outputs bit-identical: {same} ({len(keys)} arrays)")
    return 0 if same else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    dump(args.root, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
