"""The training CLI of every family loop under two gloo ranks on the CPU,
as ``torchrun`` starts it (``parallel.spawn.LocalRanks``), and the
multi-process dry run's ``--task``.

``train --task hidden`` (the message loop), ``tianchi``, ``pami
--with-gan --jpeg-simulator`` (the image loop with its options) and
``kdjpeg``: two steps on the global batch with a checkpoint at step 2
written by rank 0 alone, rank 0 alone printing the JSON line (world size 2,
the global batch and images/s), then ``--resume`` on both ranks from that
checkpoint (PAMI's as ``--val``). Each command's ranks are killed after
``RANKS_TIMEOUT_S``; the group's collectives time out on their own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from vwfd_tpu_torch import PAMI_CONFIG, TIANCHI_CONFIG
from vwfd_tpu_torch.parallel.spawn import LocalRanks

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
RANKS_TIMEOUT_S = 180.0


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _config(tmp_path, task):
    """The task's config with a checkpoint every 2 steps."""
    base = {"hidden": {"task": "hidden"},
            "tianchi": yaml.safe_load(open(TIANCHI_CONFIG)),
            "pami": yaml.safe_load(open(PAMI_CONFIG)),
            "kdjpeg": {"task": "kdjpeg"}}[task]
    base.setdefault("train", {})["save_interval"] = 2
    path = tmp_path / f"{task}.yaml"
    path.write_text(yaml.safe_dump(base))
    return str(path)


# task: (its options, the global batch, the size)
LOOPS = {"hidden": ([], 4, 32), "tianchi": ([], 2, 64),
         "pami": (["--with-gan", "--jpeg-simulator"], 2, 32),
         "kdjpeg": ([], 6, 32)}


def _ranks(cmd, cwd):
    with LocalRanks(cmd, WORLD, env=_env(), cwd=str(cwd)) as ranks:
        outs = ranks.wait(RANKS_TIMEOUT_S)
    assert not outs[1].strip()  # rank 1 prints nothing
    return json.loads(outs[0].strip().splitlines()[-1])


@pytest.mark.parametrize("task", sorted(LOOPS))
def test_train_loop_under_two_ranks(tmp_path, task):
    extra, b, s = LOOPS[task]
    ckpt = tmp_path / "ckpt"
    base = [sys.executable, "-m", "vwfd_tpu_torch.train", "--task", task,
            "--synthetic", "--device", "cpu", "--batch", str(b), "--size",
            str(s), "--config", _config(tmp_path, task), "--ckpt-dir",
            str(ckpt), "--no-telemetry", *extra]
    train = _ranks(base + ["--steps", "2"], tmp_path)
    assert train["world_size"] == WORLD and train["batch"] == b
    assert train["resumed_step"] is None and train["steps"] == 2
    assert train["images_per_s"] == pytest.approx(
        b / train["ms_per_step"] * 1e3)
    logs = {k: v for k, v in train.items() if k not in (
        "steps", "ms_per_step", "images_per_s", "batch", "size", "data",
        "resumed_step", "world_size", "device", "device_name")}
    assert len(logs) >= 2 and all(np.isfinite(v) for v in logs.values())
    assert sorted(os.listdir(ckpt)) == ["2"]
    more = (["--val", "--val-batches", "1"] if task == "pami"
            else ["--steps", "1"])
    resumed = _ranks(base + more + ["--resume"], tmp_path)
    assert resumed["world_size"] == WORLD and resumed["resumed_step"] == 2
    if task == "pami":
        assert 0 <= resumed["f1_best"] <= 1
        assert np.isfinite(resumed["psnr_forward"])
    assert sorted(os.listdir(ckpt)) == ["2"]


def test_dryrun_multiprocess_task_on_cpu():
    """``dryrun_multiprocess --task mbrs``: two gloo ranks take one MBRS
    step on their rows of the global batch, every log bit-equal across the
    ranks, the replicas equal after it."""
    proc = subprocess.run(
        [sys.executable, "-m", "vwfd_tpu_torch.dryrun_multiprocess",
         "--procs", "2", "--device", "cpu", "--task", "mbrs", "--batch",
         "4", "--timeout", str(RANKS_TIMEOUT_S)], capture_output=True,
        text=True, timeout=RANKS_TIMEOUT_S + 30, env=_env(), cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["task"] == "mbrs" and out["procs"] == 2
    assert out["backend"] == "gloo" and out["rows"] == [[0, 2], [2, 4]]
    assert np.isfinite(out["loss"])
