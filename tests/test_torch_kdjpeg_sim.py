"""Parity of the image model's ``with_jpeg_simulator`` (``vwfd_tpu_torch/
models/image_model.py``) with vwfd_tpu's, on the CPU in float32, with
``test_torch_image_model``'s harness (its sizes, its JAX jit without
``algsimp`` (F9), its exact-border canny (F24), its draws from the JAX key
and ``_check_step``'s rules), extended to the simulator: its quality from
the JAX key (``image_model.py:256-258``: ``k_q, _ = split(k_crop)``,
``randint(k_q, (), 0, 5)`` into (50, …, 90)), its net ``jpeg_sim``
(FBCNN (16, 24, 32, 48), ``nb`` 1, K23's plain version) in the states,
its loss ``l_sim`` in the logs and the extra fan-out branch (k + 1 = 7
copies into the localizer and the reverse).

Both targets: the batch's real pair (PIL's ``jpeg_real`` of the clean
images at one quality, 4:4:4, with ``q/100`` per image, the JAX
``train.py``'s) and, without one, the hard-round ``jpeg_basic`` of the
detached tamper. PAMI runs its mixed tamper on a key that draws the
splice, ImugeV2 its splice.

Tolerances: ``_check_step``'s (loss terms 1e-5 relative, PF and PB 1e-3
dB, parameters 2.1·lr, mu 1e-3 and nu 2e-3 of each tensor's max, counts
EQUAL, spectral vectors 1e-5), for every net of the step, ``jpeg_sim``'s
too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_image_model as base
from test_torch_image_model import LR, _adam_of, _batch, _jax, _leaves
from vwfd_tpu.attacks.jpeg import jpeg_real as jjpeg_real
from vwfd_tpu.models.image_model import ImageBatch as JBatch
from vwfd_tpu.models.image_model import ImageImmunizationModel as JImage
from vwfd_tpu.models.state import NetState
from vwfd_tpu_torch.convert import states_from_jax, states_to_jax
from vwfd_tpu_torch.kernels import PLAIN
from vwfd_tpu_torch.models.image_model import (ImageBatch, ImageDraws,
                                               ImageImmunizationModel)

_one_thread = base._one_thread
TASKS = ("pami", "imuge")
NETS = ("netG", "localizer", "jpeg_sim")
PAIR_Q = 70  # the real pair's quality


def _port(task):
    return ImageImmunizationModel(base._cfgs()[0], task=task, device="cpu",
                                  kernels=PLAIN, with_jpeg_simulator=True)


_JMODELS = {}


def _jmodel(task):
    if task not in _JMODELS:
        _JMODELS[task] = JImage(base._cfgs()[1], task=task,
                                with_jpeg_simulator=True)
    return _JMODELS[task]


@pytest.fixture(scope="module")
def trees():
    """The port's fresh state (seed 3) with the simulator, the INN heads
    perturbed as the base harness's, as numpy trees, per task."""
    out = {}
    for task in TASKS:
        port = _port(task)
        port.init_states(3)
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for name, p in port.netG.named_parameters():
                if name.endswith("Conv_4.weight") or name.endswith(
                        "Conv_4.bias"):
                    p.add_(base.HEAD_PERTURB * torch.randn(p.shape,
                                                           generator=gen))
        out[task] = states_to_jax(port)
    return out


def _jstates(jmodel, trees):
    f = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    applies = {"netG": jmodel.netG.apply, "localizer": jmodel.localizer.apply,
               "jpeg_sim": jmodel.jpeg_sim.apply}
    return {name: NetState.create(
        fn, f(trees[name]["params"]),
        {"spectral": f(trees[name]["spectral"])}
        if "spectral" in trees[name] else {}, jmodel.tx)
        for name, fn in applies.items()}


def train_draws(key) -> ImageDraws:
    """The base harness's draws and the simulator's quality index."""
    d = base.train_draws(key)
    _, k_crop = jax.random.split(key)
    k_q, _ = jax.random.split(k_crop)
    return d._replace(sim_q=int(jax.random.randint(k_q, (), 0, 5)))


def _splice_key(start):
    for i in range(200):
        key = jax.random.PRNGKey(start + i)
        if not base.train_draws(key).use_cm:
            return key
    raise AssertionError("no key")


def _pair(x):
    return (jjpeg_real(x, PAIR_Q),
            np.full((x.shape[0],), PAIR_Q / 100.0, np.float32))


def _check(task, key, trees, data_seed, with_pair, x=None):
    jmodel = _jmodel(task)
    x0, canny, mask, prev = _batch(data_seed)
    x = x0 if x is None else x
    pair = _pair(x) if with_pair else None
    jpair = None if pair is None else tuple(jnp.asarray(a) for a in pair)
    new, jlogs = _jax("train_step", jmodel, _jstates(jmodel, trees),
                      JBatch(jnp.asarray(x), jnp.asarray(canny),
                             jnp.asarray(mask)), jnp.asarray(prev), key,
                      jpair)
    port = _port(task)
    states_from_jax(port, trees)
    draws = train_draws(key)
    assert draws.sim_q is not None and not draws.use_cm
    logs = port.train_step(ImageBatch(x, canny, mask), prev, draws,
                           jpeg_pair=pair)
    return new, jlogs, port, logs


@pytest.mark.parametrize("with_pair", [False, True],
                         ids=["jpeg_basic", "real_pair"])
@pytest.mark.parametrize("task", TASKS)
def test_simulator_step_matches_jax(trees, task, with_pair):
    """One step with the simulator on each target: the loss terms and
    ``l_sim``, every updated parameter, moment and count of netG, the
    localizer and ``jpeg_sim``, the localizer's spectral vectors."""
    key = _splice_key({"pami": 60, "imuge": 70}[task] + 10 * with_pair)
    new, jlogs, port, logs = _check(task, key, trees[task],
                                    41 + 2 * with_pair, with_pair)
    for k in ("loss", "lF", "lB", "l_mask", "NULL", "l_sim"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("PF", "PB"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=0, atol=1e-3, err_msg=k)
    got = states_to_jax(port)
    assert set(got) == set(new) == set(NETS)
    for net in NETS:
        adam = _adam_of(new[net])
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
    want = _leaves(new["localizer"].variables["spectral"])
    have = _leaves(got["localizer"]["spectral"])
    assert set(want) == set(have) and want
    for path, w in want.items():
        np.testing.assert_allclose(have[path], w, rtol=0, atol=1e-5,
                                   err_msg=f"u {path}")


def test_simulator_guard_keeps_every_state_on_an_inf_pixel_f21(trees):
    """F21 at this caller: an Inf pixel reaches the simulator's
    ``jpeg_basic`` target (NaN on its 8×8 block in the port, the image in
    JAX) and the extra branch; the loss is not finite and every state,
    ``jpeg_sim``'s too, keeps its value on both packages."""
    x, _, _, _ = _batch(45)
    x[0, 9, 17, 1] = np.inf
    key = _splice_key(80)
    jmodel = _jmodel("pami")
    ref = jax.tree_util.tree_map(np.asarray,
                                 _jstates(jmodel, trees["pami"]))
    port = _port("pami")
    states_from_jax(port, trees["pami"])
    old = [t.clone() for t in port._tensors()]
    new, jlogs, port, logs = _check("pami", key, trees["pami"], 45, False,
                                    x=x)
    assert not np.isfinite(float(jlogs["loss"]))
    assert not np.isfinite(float(jlogs["l_sim"]))
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert not np.isfinite(float(logs["loss"]))
    assert not np.isfinite(float(logs["l_sim"]))
    assert all(torch.equal(a, b) for a, b in zip(old, port._tensors()))


def test_simulator_draw_keeps_the_other_streams():
    """The sampler draws the simulator's quality last in a step and only
    with the option: without it ``sim_q`` is None and the stream is the
    one before the option existed; with it a seed's first step draws the
    same tamper and branches, then its quality."""
    plain = ImageImmunizationModel(base._cfgs()[0], task="pami",
                                   device="cpu").sampler(5)
    a, b = plain((2, 32, 32, 3)), _port("pami").sampler(5)((2, 32, 32, 3))
    assert a.sim_q is None and b.sim_q in range(5)
    assert a.shift == b.shift and a.use_cm == b.use_cm
    assert a.branch == b.branch


def test_train_cli_pami_with_the_jpeg_simulator_on_cpu(tmp_path, capsys):
    """``train --task pami --jpeg-simulator --synthetic`` on the CPU: the
    real pairs of each batch (PIL's ``jpeg_real`` at a drawn quality), a
    finite ``l_sim``, and a checkpoint holding ``jpeg_sim`` that
    ``--resume`` continues from."""
    import json
    from pathlib import Path

    from vwfd_tpu_torch import PAMI_CONFIG
    from vwfd_tpu_torch import train as train_cli
    cfg = tmp_path / "pami.yaml"
    cfg.write_text(Path(PAMI_CONFIG).read_text()
                   + "train:\n  save_interval: 2\n")
    args = ["--task", "pami", "--jpeg-simulator", "--synthetic", "--device",
            "cpu", "--batch", "2", "--size", "32", "--no-telemetry",
            "--ckpt-dir", str(tmp_path / "ck"), "--config", str(cfg)]
    train_cli.main(args + ["--steps", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["l_sim"])
    assert np.isfinite(out["loss"])
    train_cli.main(args + ["--steps", "1", "--resume"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["resumed_step"] == 2 and np.isfinite(out["l_sim"])
