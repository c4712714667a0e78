"""Parity of the port's CLR steps and the image family's options with
vwfd_tpu's, on the CPU in float32 (F7), with ``test_torch_image_model``'s
harness (its sizes, its JAX jit without ``algsimp`` (F9), its exact-border
canny (F24), its draws from the JAX key and ``_check_step``'s rules),
extended to the nets CLR and the options add: the apex regressor (``l_apex``,
``l_ce``, its params and moments) and the discriminator (``g_adv``,
``d_loss``, its params, moments and spectral vectors).

CLR's draws from the JAX key (``image_model.py:215, 229``): ``k_atk,
k_crop = split(key)``, the window's four uniforms from ``split(k_crop,
4)``, the branches from ``split(k_atk, 6)``; the eval step's
(``:533``): ``k_apex, key = split(key)``, the window from ``k_apex``, the
branches from the second key. ``use_perceptual`` runs on JAX's seeded
VGG19 fallback carried into the port (the port's own fallback is another
seed's).

Tolerances: ``_check_step``'s (loss terms 1e-5 relative, PF and PB 1e-3
dB, parameters 2.1·lr, mu 1e-3 and nu 2e-3 of each tensor's max, counts
EQUAL, spectral vectors 1e-5), for every net of the step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_image_model as base
from test_torch_image_model import (B, K, LR, S, _adam_of, _batch,
                                    _branch_draws, _jax, _leaves)
from vwfd_tpu.metrics import perceptual as jperc
from vwfd_tpu.models.image_model import ImageBatch as JBatch
from vwfd_tpu.models.image_model import ImageImmunizationModel as JImage
from vwfd_tpu.models.state import NetState
from vwfd_tpu_torch import CLR_CONFIG, load_config
from vwfd_tpu_torch import run_family_convergence as runner
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.convert import (state_dict_from_jax, states_from_jax,
                                    states_to_jax)
from vwfd_tpu_torch.kernels import PLAIN
from vwfd_tpu_torch.models.image_model import (ImageBatch, ImageDraws,
                                               ImageImmunizationModel)

_one_thread = base._one_thread
OPTIONS = {"clr": dict(task="clr"),
           "gan": dict(task="pami", tamper_mode="splice", with_gan=True),
           "perceptual": dict(task="imuge", use_perceptual=True)}
NETS = {"clr": ("netG", "localizer", "apex"),
        "gan": ("netG", "localizer", "discriminator"),
        "perceptual": ("netG", "localizer")}
SN = {"localizer", "discriminator"}


def _port(case, kernels=PLAIN):
    port = ImageImmunizationModel(base._cfgs()[0], device="cpu",
                                  kernels=kernels, **OPTIONS[case])
    if case == "perceptual":
        port.vgg.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, jperc._default_params(3)["params"])))
    return port


_JMODELS = {}


def _jmodel(case):
    if case not in _JMODELS:
        _JMODELS[case] = JImage(base._cfgs()[1], **OPTIONS[case])
    return _JMODELS[case]


@pytest.fixture(scope="module")
def trees():
    """The port's fresh state (seed 3) of every net any case uses, the INN
    heads perturbed as the base harness's, as numpy trees."""
    out = {}
    for case in OPTIONS:
        port = _port(case)
        port.init_states(3)
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for name, p in port.netG.named_parameters():
                if name.endswith("Conv_4.weight") or name.endswith(
                        "Conv_4.bias"):
                    p.add_(base.HEAD_PERTURB * torch.randn(p.shape,
                                                           generator=gen))
        out[case] = states_to_jax(port)
    return out


def _jstates(jmodel, trees):
    f = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    applies = {"netG": jmodel.netG.apply,
               "localizer": jmodel.localizer.apply,
               "apex": getattr(jmodel, "apex_net", None),
               "discriminator": getattr(jmodel, "discriminator", None)}
    out = {}
    for name, t in trees.items():
        fn = applies[name]
        fn = fn if name in ("netG", "localizer") else fn.apply
        variables = {"spectral": f(t["spectral"])} if "spectral" in t else {}
        out[name] = NetState.create(fn, f(t["params"]), variables, jmodel.tx)
    return out


def _uniforms(key):
    return np.array([float(jax.random.uniform(k, ()))
                     for k in jax.random.split(key, 4)], np.float32)


def train_draws(key, case):
    if case != "clr":
        return base.train_draws(key)
    k_atk, k_crop = jax.random.split(key)
    return ImageDraws((0, 0), False, _branch_draws(k_atk), _uniforms(k_crop))


def eval_draws(key, case):
    if case != "clr":
        return ImageDraws((0, 0), False, _branch_draws(key))
    k_apex, key = jax.random.split(key)
    return ImageDraws((0, 0), False, _branch_draws(key), _uniforms(k_apex))


def _check_step(case, key, trees, data_seed):
    jmodel = _jmodel(case)
    x, canny, mask, prev = _batch(data_seed)
    new, jlogs = _jax("train_step", jmodel, _jstates(jmodel, trees),
                      JBatch(jnp.asarray(x), jnp.asarray(canny),
                             jnp.asarray(mask)), jnp.asarray(prev), key)
    port = _port(case)
    states_from_jax(port, trees)
    logs = port.train_step(ImageBatch(x, canny, mask), prev,
                           train_draws(key, case))
    keys = ["loss", "lF", "lB", "l_mask", "NULL"] + {
        "clr": ["l_apex", "l_ce"], "gan": ["g_adv", "d_loss"]}.get(case, [])
    assert set(keys) <= set(logs)
    for k in keys:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("PF", "PB"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=0, atol=1e-3, err_msg=k)
    got = states_to_jax(port)
    assert set(got) == set(new) == set(NETS[case])
    for net in NETS[case]:
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
        if net in SN:
            want = _leaves(new[net].variables["spectral"])
            have = _leaves(got[net]["spectral"])
            assert set(want) == set(have) and want
            for path, w in want.items():
                np.testing.assert_allclose(have[path], w, rtol=0, atol=1e-5,
                                           err_msg=f"{net} u {path}")
    return logs


@pytest.mark.parametrize("seed", [7, 8])
def test_clr_step_matches_jax(trees, seed):
    """CLR's train step on two keys (two windows): the crop tamper, the
    apex regressor's two terms, the rectified reverse, the SSIM term; every
    updated parameter, moment and count of netG, the localizer and the
    apex regressor, the localizer's spectral vectors."""
    _check_step("clr", jax.random.PRNGKey(seed), trees["clr"], 20 + seed)


def test_gan_step_matches_jax(trees):
    """``with_gan`` on PAMI's splice: ``g_adv`` and ``d_loss``, the
    discriminator's parameters, moments and the spectral vectors after its
    three calls."""
    _check_step("gan", jax.random.PRNGKey(9), trees["gan"], 31)


def test_perceptual_step_matches_jax(trees):
    """``use_perceptual`` on ImugeV2 with JAX's fallback VGG19."""
    _check_step("perceptual", jax.random.PRNGKey(10), trees["perceptual"],
                32)


def test_clr_eval_step_matches_jax(trees):
    """CLR's eval step (the crop, the fan-out on the second key, the
    localizer, the rectified reverse of every copy): base's tolerances."""
    jmodel = _jmodel("clr")
    x, canny, mask, prev = _batch(33)
    key = jax.random.PRNGKey(22)
    jout = _jax("eval_step", jmodel, _jstates(jmodel, trees["clr"]),
                JBatch(jnp.asarray(x), jnp.asarray(canny),
                       jnp.asarray(mask)), jnp.asarray(prev), key)
    port = _port("clr")
    states_from_jax(port, trees["clr"])
    out = port.eval_step(ImageBatch(x, canny, mask), prev,
                         eval_draws(key, "clr"))
    for k, atol in (("psnr_forward", 1e-4), ("psnr_backward", 1e-4),
                    ("psnr_backward_per_attack", 1e-4),
                    ("ssim_forward", 5e-5), ("f1_best", 2e-3),
                    ("f1_sweep", 2e-3), ("f1_per_attack", 2e-3),
                    ("recovered", 1e-4), ("predicted_mask", 1e-5)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=atol, err_msg=k)


def test_clr_guard_keeps_every_state_on_an_inf_pixel(trees):
    """F21 at CLR's caller: an Inf pixel through the crop and the JPEG
    branches leaves the loss non-finite and every state of all three nets
    as it was, on both packages."""
    jmodel = _jmodel("clr")
    x, canny, mask, prev = _batch(34)
    x[1, 12, 15, 2] = np.inf
    key = jax.random.PRNGKey(7)
    before = _jstates(jmodel, trees["clr"])
    ref = jax.tree_util.tree_map(np.asarray, before)
    new, jlogs = _jax("train_step", jmodel, before,
                      JBatch(jnp.asarray(x), jnp.asarray(canny),
                             jnp.asarray(mask)), jnp.asarray(prev), key)
    assert not np.isfinite(float(jlogs["loss"]))
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), b)
    port = _port("clr")
    states_from_jax(port, trees["clr"])
    old = [t.clone() for t in port._tensors()]
    logs = port.train_step(ImageBatch(x, canny, mask), prev,
                           train_draws(key, "clr"))
    assert not np.isfinite(float(logs["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(old, port._tensors()))


def test_gan_guard_keeps_the_discriminator(trees):
    """A NaN pixel with the GAN on: the discriminator's parameters,
    moments, count and spectral vectors (written between its calls) come
    back to their values before the step."""
    port = _port("gan")
    states_from_jax(port, trees["gan"])
    x, canny, mask, prev = _batch(35)
    x[0, 3, 4, 1] = np.nan
    old = [t.clone() for t in port._tensors()]
    logs = port.train_step(ImageBatch(x, canny, mask), prev,
                           base.train_draws(jax.random.PRNGKey(9)))
    assert not np.isfinite(float(logs["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(old, port._tensors()))


def test_clr_states_round_trip_through_jax_trees(trees):
    port = _port("clr")
    states_from_jax(port, trees["clr"])
    back = states_to_jax(port)
    for net in NETS["clr"]:
        for what in ("params", "mu", "nu"):
            a, b = _leaves(trees["clr"][net][what]), _leaves(back[net][what])
            assert set(a) == set(b)
            assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("task", ["pami", "imuge", "clr"])
def test_apex_regressor_is_built_for_clr_alone(task):
    """The regressor, its AdamW and its tree exist for ``clr`` and no other
    task: JAX's rectification and target read the crop's window."""
    port = ImageImmunizationModel(base._cfgs()[0], task=task, device="cpu")
    clr = task == "clr"
    assert (port.apex_net is not None) == clr
    assert ("apex" in port.nets()) == clr == ("apex" in port.optimizers)


def test_clr_config_is_the_jax_files_copy():
    """The port's ``configs/clr.yaml`` holds the JAX file's keys and values
    (the port's ModelConfig defaults are JAX's)."""
    import yaml
    from pathlib import Path
    mine = yaml.safe_load(Path(CLR_CONFIG).read_text())
    jax_file = Path(base.__file__).resolve().parents[1] / "vwfd_tpu" / \
        "configs" / "clr.yaml"
    assert mine == yaml.safe_load(jax_file.read_text())
    cfg = load_config(CLR_CONFIG)
    assert (cfg.task, cfg.data.gt_size, cfg.data.batch_size,
            cfg.model.inn_haar, cfg.model.n_attacks) == ("clr", 256, 8,
                                                         "mixed", 6)


def test_train_cli_clr_synthetic_on_cpu(tmp_path, capsys):
    """``train --task clr --synthetic --steps 2`` on the CPU: finite logs
    with the apex terms; ``--with-gan`` adds the GAN's."""
    args = ["--task", "clr", "--synthetic", "--device", "cpu", "--batch",
            "2", "--size", "32", "--no-telemetry", "--ckpt-dir",
            str(tmp_path / "ck"), "--steps", "2"]
    train_cli.main(args)
    out = base._last_json(capsys.readouterr().out)
    assert out["steps"] == 2
    assert all(np.isfinite(out[k]) for k in ("loss", "l_apex", "l_ce", "PF"))
    train_cli.main(args[:-1] + ["1", "--with-gan"])
    out = base._last_json(capsys.readouterr().out)
    assert all(np.isfinite(out[k]) for k in ("loss", "g_adv", "d_loss"))


def test_family_runner_clr_with_a_one_batch_eval_loader(tmp_path,
                                                        monkeypatch):
    """``run_family_convergence --task clr`` on the CPU (the runner's
    one-batch eval loader, as PAMI's test): the train keys with ``l_apex``
    and ``l_ce``, the eval keys of the JAX runner."""
    import json
    real = runner.image_eval_loader
    monkeypatch.setattr(runner, "image_eval_loader", lambda m, s, b, e: real(
        m, s, b, e, length=b, ratio=1))
    out = tmp_path / "clr.jsonl"
    args = runner.parse_args([
        "--task", "clr", "--steps", "2", "--eval-every", "2",
        "--log-every", "1", "--size", "32", "--batch", "2", "--reverse-k",
        "1", "--device", "cpu", "--out", str(out)])
    assert runner.run(args) == "done"
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs[0]["task"] == "clr" and recs[0]["reverse_k"] == 1
    logs = [r for r in recs if "loss" in r]
    assert [r["step"] for r in logs] == [1, 2]
    assert all(np.isfinite(r[k]) for r in logs for k in ("l_apex", "l_ce"))
    ev = [r for r in recs if r.get("eval")]
    assert len(ev) == 1 and all(np.isfinite(ev[0][k]) for k in (
        "psnr_forward", "psnr_backward", "ssim_forward", "f1_best",
        "f1_per_attack_mean"))


def test_clr_model_runs_on_the_card_by_default():
    """Without ``device`` the CLR model resolves to the CUDA card, and
    without one it raises, naming the CPU opt-in."""
    cfg = base._cfgs()[0]
    if torch.cuda.is_available():
        assert ImageImmunizationModel(cfg, task="clr").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ImageImmunizationModel(cfg, task="clr")
