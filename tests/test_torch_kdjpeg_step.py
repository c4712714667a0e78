"""Parity of the port's KD-JPEG train step (``vwfd_tpu_torch/models/
kdjpeg_model.py``) with vwfd_tpu's, on the CPU in float64, at 32² with
narrow nets (FBCNN ``nc`` (8, 8, 16, 16), ``nb`` 2; the QF classifier at
the same ``nc``, ``nb`` 1; the discriminator ``dim`` 8), from the same
weights (the port's ``init_states`` carried to JAX's ``NetState`` by
``convert.py``) on a class-major batch of two LQ items (12 images), plus
the trainer and the runner on ``--device cpu``.

The JAX step is ``KDJpegModel.train_step.__wrapped__`` jitted without
``algsimp`` (F9; it donates its states). The port runs the generator
forward once (JAX twice, with the same parameters): the same values and
gradients.

Why float64: in float32 the step parts from JAX's through rounding flips
(one element of the QF classifier's first moment, ``body0.c1.bias``, 1.5 %
off JAX's, 2.1e-7 against a 4.4e-8 bound: a ReLU whose input sits within
rounding of 0 on one side only). Both sides run float64 (``jax.enable_x64``
and the port's nets ``.double()``), nothing of the JAX package patched: no
op on this path pins float32 but the PSNR of PSSIMU, which rounds to the
8-bit grid first. The non-finite guard runs in float32.

Tolerances: ``test_torch_image_model.py::_check_step``'s. The logs within
1e-5 relative, PSSIMU within 1e-3 dB; the parameters after AdamW within
2.1·lr; mu within 1e-3 and nu within 2e-3 of each tensor's max-abs; the
counts EQUAL; the discriminator's spectral vectors within 1e-5.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.config import Config as JConfig
from vwfd_tpu.config import DataConfig as JDataConfig
from vwfd_tpu.config import TrainConfig as JTrainConfig
from vwfd_tpu.models.kdjpeg_model import KDJpegModel as JKD
from vwfd_tpu.models.state import NetState
from vwfd_tpu_torch import Config, DataConfig, TrainConfig
from vwfd_tpu_torch import run_family_convergence as runner
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.convert import states_from_jax, states_to_jax
from vwfd_tpu_torch.data import LQJpegDataset
from vwfd_tpu_torch.kernels import PLAIN
from vwfd_tpu_torch.models.kdjpeg_model import KDJpegModel

S, ITEMS, LR = 32, 2, 1e-4
NETS = dict(nc=(8, 8, 16, 16), nb=2, disc_dim=8)
LOGS = ("lQF", "l_simul", "l_simul_bayar", "qfsimu", "FW_GAN", "dis_loss")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs():
    d, t = dict(gt_size=S, batch_size=6 * ITEMS), dict(lr=LR,
                                                       dtype="float32")
    return (Config(data=DataConfig(**d), train=TrainConfig(**t)),
            JConfig(data=JDataConfig(**d), train=JTrainConfig(**t)))


def _port():
    return KDJpegModel(_cfgs()[0], device="cpu", kernels=PLAIN, **NETS)


@pytest.fixture(scope="module")
def trees():
    port = _port()
    port.init_states(3)
    return states_to_jax(port)


@pytest.fixture(scope="module")
def batch():
    ds = LQJpegDataset(size=S, synthetic_length=8, seed=10)
    items = [ds[i] for i in (1, 6)]
    return KDJpegModel.collate(np.stack([v for v, _ in items]),
                               np.stack([lab for _, lab in items]))


_JMODEL = []


def _jmodel():
    if not _JMODEL:
        _JMODEL.append(JKD(_cfgs()[1], qf_classes=6, size=S, **NETS))
    return _JMODEL[0]


_STEP = []


def _jstep(*args):
    if not _STEP:
        fn = functools.partial(JKD.train_step.__wrapped__, _jmodel())
        _STEP.append(jax.jit(fn, compiler_options={
            "xla_disable_hlo_passes": "algsimp"}))
    return _STEP[0](*args)


def _jstates(trees):
    jm = _jmodel()
    f = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    applies = {"generator": jm.generator, "localizer": jm.localizer,
               "discriminator": jm.discriminator}
    return {name: NetState.create(
        applies[name].apply, f(trees[name]["params"]),
        {"spectral": f(trees[name]["spectral"])}
        if "spectral" in trees[name] else {}, jm.tx) for name in applies}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    with jax.enable_x64(True):
        yield
    torch.set_default_dtype(prev)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


@pytest.mark.parametrize("ramp", [0.0, 1.0])
def test_kdjpeg_step_matches_jax(trees, batch, ramp, f64):
    """Every log, every updated parameter, Adam moment and count of the
    three nets and the discriminator's spectral vectors, at ``aux_ramp`` 0
    (the pixel loss alone reaches the generator) and 1."""
    flat, lab = batch
    trees = _f64(trees)
    new, jlogs = _jstep(_jstates(trees), jnp.asarray(flat, jnp.float64),
                        jnp.asarray(lab), jax.random.PRNGKey(0),
                        np.float64(ramp))
    port = _port()
    for net in port.nets().values():
        net.double()
    port.optimizers = port._adamw()
    states_from_jax(port, trees)
    flat = flat.astype(np.float64)
    logs = port.train_step(flat, lab, aux_ramp=ramp)
    for k in LOGS:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(logs["PSSIMU"]), float(jlogs["PSSIMU"]),
                               rtol=0, atol=1e-3)
    got = states_to_jax(port)
    for net in ("generator", "localizer", "discriminator"):
        adam = new[net].opt_state[1][0]
        assert int(got[net]["count"]) == int(adam.count) == 1
        for what, want_tree, tol in (("params", new[net].params, None),
                                     ("mu", adam.mu, 1e-3),
                                     ("nu", adam.nu, 2e-3)):
            want, have = _leaves(want_tree), _leaves(got[net][what])
            assert set(want) == set(have)
            for path, w in want.items():
                atol = 2.1 * LR if tol is None else tol * float(
                    np.abs(w).max())
                np.testing.assert_allclose(have[path], w, rtol=0, atol=atol,
                                           err_msg=f"{net} {what} {path}")
    want = _leaves(new["discriminator"].variables["spectral"])
    have = _leaves(got["discriminator"]["spectral"])
    assert set(want) == set(have) and want
    for path, w in want.items():
        np.testing.assert_allclose(have[path], w, rtol=0, atol=1e-5,
                                   err_msg=f"u {path}")


def test_kdjpeg_guard_keeps_all_three_nets_on_an_inf_pixel(trees, batch):
    """An Inf pixel in ``real_jpeg`` makes the losses non-finite and leaves
    every parameter, moment, count and spectral vector of the three nets
    as it was, on both packages."""
    flat, lab = batch
    flat = flat.copy()
    flat[7, 3, 5, 1] = np.inf
    before = _jstates(trees)
    ref = jax.tree_util.tree_map(np.asarray, before)
    new, jlogs = _jstep(before, jnp.asarray(flat), jnp.asarray(lab),
                        jax.random.PRNGKey(0), np.float32(1.0))
    assert not np.isfinite(float(jlogs["lQF"]))
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), b)
    port = _port()
    states_from_jax(port, trees)
    old = [t.clone() for t in port._tensors()]
    logs = port.train_step(flat, lab)
    assert not np.isfinite(float(logs["lQF"]))
    assert all(torch.equal(a, b) for a, b in zip(old, port._tensors()))


def test_kdjpeg_collate_refusal_reaches_the_step():
    """A batch not divisible into the six classes raises."""
    port = _port()
    with pytest.raises(ValueError, match="qf_classes"):
        port.train_step(np.zeros((5, S, S, 3), np.float32), np.zeros(5))


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_train_cli_kdjpeg_synthetic_on_cpu(tmp_path, capsys):
    """``train --task kdjpeg --synthetic --steps 2`` on the CPU at 32²: the
    seven logs finite, a checkpoint of the three nets that ``--resume``
    continues from."""
    cfg = tmp_path / "kd.yaml"
    cfg.write_text("task: kdjpeg\ndata:\n  gt_size: 32\n  batch_size: 6\n"
                   "train:\n  save_interval: 2\n")
    ckpt = tmp_path / "ck"
    args = ["--task", "kdjpeg", "--synthetic", "--device", "cpu",
            "--no-telemetry", "--ckpt-dir", str(ckpt), "--config", str(cfg)]
    train_cli.main(args + ["--steps", "2"])
    out = _last_json(capsys.readouterr().out)
    assert out["resumed_step"] is None and out["steps"] == 2
    assert all(np.isfinite(out[k]) for k in LOGS + ("PSSIMU",))
    assert out["batch"] == 6 and out["size"] == 32
    train_cli.main(args + ["--steps", "1", "--resume"])
    assert _last_json(capsys.readouterr().out)["resumed_step"] == 2


# tools/run_family_convergence.py:205-259: the JAX runner's record keys
JAX_EVAL_KEYS = ({f"psnr_sim_q{q}" for q in (10, 30, 50, 70, 90)}
                 | {f"psnr_identity_q{q}" for q in (10, 30, 50, 70, 90)}
                 | {"psnr_sim_conditioned", "psnr_sim_fixed_qf",
                    "psnr_identity", "qf_classifier_acc"})


def test_family_runner_kdjpeg_on_cpu(tmp_path, monkeypatch):
    """``run_family_convergence --task kdjpeg`` on the CPU for two steps at
    32² with narrow nets: train records with the JAX runner's log keys and
    an eval record with its eval keys, key for key."""
    monkeypatch.setattr(runner, "KDJpegModel",
                        functools.partial(KDJpegModel, **NETS))
    out = tmp_path / "kd.jsonl"
    args = runner.parse_args([
        "--task", "kdjpeg", "--steps", "2", "--eval-every", "2",
        "--log-every", "1", "--size", "32", "--eval-batch", "2",
        "--device", "cpu", "--out", str(out)])
    assert args.batch == 6
    assert runner.run(args) == "done"
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    train = [r for r in recs if "lQF" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert set(train[0]) == {"step", "wall", *LOGS, "PSSIMU"}
    ev = [r for r in recs if r.get("eval")]
    assert len(ev) == 1 and set(ev[0]) == {"step", "eval"} | JAX_EVAL_KEYS
    assert all(np.isfinite(ev[0][k]) for k in JAX_EVAL_KEYS)
    assert 0.0 <= ev[0]["qf_classifier_acc"] <= 1.0
