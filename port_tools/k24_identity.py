"""K24 ``diffjpeg`` outputs and times of one checkout, to hold two builds bit
for bit.

    python port_tools/k24_identity.py --root CHECKOUT --out A.npz
    python port_tools/k24_identity.py --compare A.npz B.npz

``--root`` imports ``vwfd_tpu_torch`` from that checkout (its kernels built
there at first use) and writes K24's forward and input gradient on the
card for seeded images at the plan's shapes ((1, 16, 16, 3), the study's
(1, 32, 32, 3), (3, 48, 80, 3), (64, 256, 256, 3), (2, 64, 1040, 3)) at Q
50, 75 and 90, through ``kernels.diffjpeg.diffjpeg`` as a caller reaches
it (the card's plan). It prints one JSON line (and appends it to
``A.json`` beside the arrays) with the route of each shape (``first``
for a checkout without ``plan``), its forward and backward times at Q75
warm and with a cold L2 (CUDA events, the mean of 20 calls behind a
device sleep; cold: each call on another of enough input sets to pass
the 50 MB L2), and K24's device time inside one victim-A
``jpeg_resistant`` run of the study (``torch.profiler``, 320 launches),
with the card's name and power limit. ``--compare`` prints whether every
array is equal (NaN equal to NaN) and exits non-zero if one is not.
Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys

import numpy as np

SHAPES = ((1, 16, 16, 3), (1, 32, 32, 3), (3, 48, 80, 3),
          (64, 256, 256, 3), (2, 64, 1040, 3))
QUALITIES = (50, 75, 90)
REPS = 20
L2_BYTES = 50 * 2 ** 20


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()


def time_ms(fn, sets):
    """Mean ms of ``REPS`` calls, cycling through ``sets``."""
    import torch
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for i in range(REPS):
        fn(*sets[i % len(sets)])
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def study_ms(root_pkg):
    """K24's device ms and launches in one victim-A ``jpeg_resistant`` run
    (the study's defaults: 16 images of 32², 10 steps)."""
    import torch
    study = root_pkg.jpegadv_experiment
    model = study.build_victim("A", 10, 32)
    images = np.random.default_rng(0).random((16, 32, 32, 3)).astype(
        np.float32)

    def run():
        study.run_study(model, images, "jpeg_resistant", False, 0.03,
                        [90, 70, 50, 30, 10], log=lambda s: None)
    run()  # warm: the build, cuDNN's choices, the victim's first launches
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ms, launches = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "diffjpeg" in e.name:
            ms += e.time_range.elapsed_us() / 1e3
            launches += 1
    return ms, launches


def dump(root: str, out: str) -> None:
    sys.path.insert(0, root)
    import torch
    import vwfd_tpu_torch.jpegadv_experiment  # noqa: F401
    import vwfd_tpu_torch as pkg
    from vwfd_tpu_torch.kernels import _lib, diffjpeg
    from vwfd_tpu_torch.ops.quantize import quality_to_factor
    dev = torch.device("cuda")
    g = torch.Generator("cuda").manual_seed(28)
    fn = diffjpeg.diffjpeg

    def fwd_bwd(x, f, cot):
        xg = x.clone().requires_grad_(True)
        y = fn(xg, f)
        (gx,) = torch.autograd.grad(y, xg, cot)
        return y.detach(), gx

    res, rec = {}, {"card": card(), "root": root, "shapes": {}}
    for shape in SHAPES:
        n, h, w, _ = shape
        key = "x".join(map(str, shape))
        route = (diffjpeg.plan(n, h, w, _lib.sm_count(dev)).route
                 if hasattr(diffjpeg, "plan") else "first")
        for q in QUALITIES:
            x = torch.rand(shape, device=dev, generator=g)
            x[:, :16, :16] = 1.0  # a white macroblock: the clip's ties
            f = torch.full((n,), quality_to_factor(q), device=dev)
            cot = torch.randn(shape, device=dev, generator=g)
            y, gx = fwd_bwd(x, f, cot)
            res[f"y_{key}_Q{q}"] = y.cpu().numpy()
            res[f"g_{key}_Q{q}"] = gx.cpu().numpy()
        f = torch.full((n,), quality_to_factor(75), device=dev)
        cold = max(2, -(-3 * L2_BYTES // (4 * 4 * n * h * w * 3)))
        sets = [(torch.rand(shape, device=dev, generator=g),
                 torch.randn(shape, device=dev, generator=g))
                for _ in range(cold)]

        def fwd(x, cot):
            fn(x, f)

        def bwd(x, cot):
            xg = x.requires_grad_(True)
            torch.autograd.grad(fn(xg, f), xg, cot)
        t = {"route": route}
        for name, s in (("warm", sets[:1]), ("cold", sets)):
            t[f"fwd_{name}_ms"] = time_ms(fwd, s)
            # the backward's time alone: forward + backward less forward
            t[f"bwd_{name}_ms"] = time_ms(bwd, s) - t[f"fwd_{name}_ms"]
        rec["shapes"][key] = t
    rec["study_k24_ms"], rec["study_k24_launches"] = study_ms(pkg)
    np.savez(out, **res)
    line = json.dumps(rec)
    with open(out.rsplit(".", 1)[0] + ".json", "a") as fh:
        fh.write(line + "\n")
    print(line)
    print(f"wrote {len(res)} arrays to {out}")


def compare(a: str, b: str) -> int:
    with np.load(a) as fa, np.load(b) as fb:
        keys = sorted(fa.files)
        if keys != sorted(fb.files):
            print(f"K24 outputs: the arrays differ in name ({len(keys)} vs "
                  f"{len(fb.files)})")
            return 1
        apart = [k for k in keys
                 if not np.array_equal(fa[k], fb[k], equal_nan=True)]
    print(f"K24 outputs bit-identical: {not apart} ({len(keys)} arrays"
          f"{'; unequal: ' + ', '.join(apart) if apart else ''})")
    return 0 if not apart else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not args.root or not args.out:
        ap.error("--root and --out, or --compare A B")
    dump(args.root, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
