"""What each family's data-parallel train step sends through its
collectives, counted on the CPU.

    python port_tools/dp_families_count.py [--out FILE]

For every task but the flagship (hidden, mbrs, tianchi, pami, imuge, clr,
kdjpeg) it prints one JSON line, and appends it to ``--out``:

* ``grad_bytes``: the float32 bytes that ``parallel.all_reduce_grads``
  sums a step at the family's full width (``chip_smoke.py``'s phase 20
  models: the published widths, the packaged YAML of the image family
  and Tianchi; CLR with the GAN and the JPEG simulator, ImugeV2 with the
  VGG loss, whose trunk is frozen), each net's, and Tianchi's twice (two
  updates a step);
* ``params``: the parameters of each net;
* ``batchnorms``: the BatchNorm layers a train step normalises (the
  HiDDeN discriminator's twice), each one more all-reduce forward and one
  backward at a world size above 1;
* ``world1_calls`` and ``world1_bytes``: the ``all_reduce`` calls and
  their bytes in one step of ``dryrun_multiprocess.family_step`` at 32²
  (Tianchi 64², on the CPU at the tests' SUNet widths), batch 2 (KD-JPEG
  6), over a world-1 gloo group in this process: the number of
  collectives does not depend on the width, their bytes do (the
  ``grad_bytes`` above are the full width's).

A counting tool, not part of the package: nothing imports it. Nothing is
timed: these are counts for a prediction, the times come from the card.
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vwfd_tpu_torch import (CLR_CONFIG, KDJPEG_CONFIG, PAMI_CONFIG,  # noqa
                            TIANCHI_CONFIG, dryrun_multiprocess, load_config,
                            parallel)
from vwfd_tpu_torch.models import (HiddenModel, ImageImmunizationModel,  # noqa
                                   KDJpegModel, MBRSModel, TianchiModel)

TASKS = ("hidden", "mbrs", "tianchi", "pami", "imuge", "clr", "kdjpeg")


def full_width(task):
    """The task's model at phase 20's width, on the CPU."""
    if task == "hidden":
        return HiddenModel(image_size=128, device="cpu")
    if task == "mbrs":
        return MBRSModel(device="cpu")
    if task == "tianchi":
        return TianchiModel(load_config(TIANCHI_CONFIG), device="cpu")
    if task == "kdjpeg":
        return KDJpegModel(load_config(KDJPEG_CONFIG), device="cpu")
    if task == "clr":
        return ImageImmunizationModel(load_config(CLR_CONFIG), task="clr",
                                      with_gan=True,
                                      with_jpeg_simulator=True, device="cpu")
    return ImageImmunizationModel(load_config(PAMI_CONFIG), task=task,
                                  use_perceptual=task == "imuge",
                                  device="cpu")


def count_step(task):
    """(calls, bytes) of ``dist.all_reduce`` in one small step."""
    calls = []
    real = dist.all_reduce

    def counted(t, *a, **kw):
        calls.append(t.numel() * t.element_size())
        return real(t, *a, **kw)
    dist.all_reduce = counted
    try:
        mesh = parallel.make_mesh()
        size, batch = (64, 2) if task == "tianchi" else (32, 2)
        if task == "kdjpeg":
            batch = 6
        _, step = dryrun_multiprocess.family_step(task, "cpu", mesh, batch,
                                                  size, 0)
        step()
    finally:
        dist.all_reduce = real
    return len(calls), sum(calls)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="append the lines here")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            for task in TASKS:
                model = full_width(task)
                params = {name: sum(p.numel() for p in net.parameters())
                          for name, net in model.nets().items()}
                updates = 2 if task == "tianchi" else 1
                bns = sum(isinstance(m, torch.nn.BatchNorm2d)
                          for net in model.nets().values()
                          for m in net.modules())
                if task == "hidden":  # two train-mode discriminator calls
                    bns += sum(isinstance(m, torch.nn.BatchNorm2d)
                               for m in model.discriminator.modules())
                n, nbytes = count_step(task)
                line = {"task": task, "params": params,
                        "grad_bytes": 4 * updates * sum(params.values()),
                        "batchnorms": bns, "world1_calls": n,
                        "world1_bytes": nbytes}
                print(json.dumps(line), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(line) + "\n")
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
