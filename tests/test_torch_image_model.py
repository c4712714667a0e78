"""Parity of the port's image family (``vwfd_tpu_torch/models/
image_model.py``) with vwfd_tpu's, on the CPU in float32 (F7), at 32²,
batch 2, ``inn_down_num`` 2, ``localizer_residual_blocks`` 1, k = 6 (every
pool member but the noise runs), resize ratios (0.5, 1, 1.5), from the same
weights (the port's ``init_states`` carried to JAX's ``NetState`` by
``convert.py``, the INN's zero-init heads perturbed so that the reverse
pass and every coupling take gradients).

A step's draws come from the JAX key with the JAX code's split sequence
(``image_model.py:215``, ``:237``, ``:188``): ``k_atk, k_crop =
split(key)``; the copy-move shift from ``split(split(fold_in(k_crop,
7))[0])`` and the mixed mode's choice from its second half; each branch's
member draw from ``split(k_atk, 6)``. The eval step draws from its key
unsplit.

The images lie a quarter level above the 8-bit grid and the heads move
pixels by less than a quarter level, so the embed's quantizer rounds every
pixel alike on both sides. The JAX reference is compiled without
``algsimp`` (F9). Its ``canny_soft`` and the port's are both the exact
border form (F24: the JAX form's gradient within a few pixels of an image
corner is rounding noise of ~1e9 terms cancelling, which two sides whose
inputs differ in the last bit do not share): JAX's through a patched
``canny_soft`` (``stop_gradient`` on gx of the first and last columns and
gy of the first and last rows, the values unchanged), the port's through
``kernels.PLAIN``.

Tolerances: the loss terms within 1e-5 relative; PF and PB within 1e-3 dB
(PB's integer truncation of the recovered image flips a few pixels where
the two reverse passes part in the last bits: up to 2.0e-4 dB measured);
every gradient tensor within 1e-3 of its own max-abs (test_torch_train.py's
rule: float32 sums in another order); the parameters after AdamW within
2.1·lr (AdamW's first step moves an entry by about lr·sign(g), an entry
whose gradient is near zero may move the other way); mu within 1e-3 and nu
within 2e-3 of each tensor's max-abs; the count EQUAL; the spectral
vectors within 1e-5.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vwfd_tpu.models.image_model as jimage_mod
from vwfd_tpu.config import Config as JConfig
from vwfd_tpu.config import DataConfig as JDataConfig
from vwfd_tpu.config import ModelConfig as JModelConfig
from vwfd_tpu.config import TrainConfig as JTrainConfig
from vwfd_tpu.models.image_model import ImageBatch as JBatch
from vwfd_tpu.models.image_model import ImageImmunizationModel as JImage
from vwfd_tpu.models.state import NetState
from vwfd_tpu.ops import canny as jcanny
from vwfd_tpu.ops import haar as jhaar
from vwfd_tpu_torch import (PAMI_CONFIG, Config, DataConfig, ModelConfig,
                            TrainConfig)
from vwfd_tpu_torch import run_family_convergence as runner
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.attacks import copy_move_shift
from vwfd_tpu_torch.convert import states_from_jax, states_to_jax
from vwfd_tpu_torch.kernels import PLAIN
from vwfd_tpu_torch.models.image_model import (ImageBatch, ImageDraws,
                                               ImageImmunizationModel)

S, B, K = 32, 2, 6
RATIOS = (0.5, 1.0, 1.5)
LR = 1e-4
MODEL = dict(inn_down_num=2, inn_block_num=(1, 1), inn_haar="mixed",
             localizer_residual_blocks=1, n_attacks=K, attack_ratios=RATIOS)
HEAD_PERTURB = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs():
    d, m, t = (dict(gt_size=S, batch_size=B), MODEL,
               dict(lr=LR, dtype="float32"))
    return (Config(data=DataConfig(**d), model=ModelConfig(**m),
                   train=TrainConfig(**t)),
            JConfig(data=JDataConfig(**d), model=JModelConfig(**m),
                    train=JTrainConfig(**t)))


def _port(task="pami", tamper_mode=None, kernels=PLAIN):
    return ImageImmunizationModel(_cfgs()[0], task=task,
                                  tamper_mode=tamper_mode, device="cpu",
                                  kernels=kernels)


@pytest.fixture(scope="module")
def trees():
    """The port's fresh state (seed 3), its INN heads perturbed, as numpy
    trees (params, spectral, mu, nu, count per net)."""
    port = _port()
    port.init_states(3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in port.netG.named_parameters():
            if name.endswith("Conv_4.weight") or name.endswith("Conv_4.bias"):
                p.add_(HEAD_PERTURB * torch.randn(p.shape, generator=gen))
    return states_to_jax(port)


def _jstates(jmodel, trees):
    f = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    return {
        "netG": NetState.create(jmodel.netG.apply, f(trees["netG"]["params"]),
                                {}, jmodel.tx),
        "localizer": NetState.create(
            jmodel.localizer.apply, f(trees["localizer"]["params"]),
            {"spectral": f(trees["localizer"]["spectral"])}, jmodel.tx)}


def _exact_border_canny(img, sigma=1.0, low=0.1, high=0.2, sharpness=20.0):
    """JAX's ``canny_soft`` with the Sobel's structural zeros taking no
    gradient (F24); the same values."""
    real = jcanny.sobel_edges

    def sobel(smooth):
        gx, gy = real(smooth)
        w, h = gx.shape[-2], gx.shape[-3]
        cols = (jnp.arange(w) == 0) | (jnp.arange(w) == w - 1)
        rows = (jnp.arange(h) == 0) | (jnp.arange(h) == h - 1)
        gx = jnp.where(cols[:, None], jax.lax.stop_gradient(gx), gx)
        gy = jnp.where(rows[:, None, None], jax.lax.stop_gradient(gy), gy)
        return gx, gy

    jcanny.sobel_edges = sobel
    try:
        return _ORIG_CANNY(img, sigma, low, high, sharpness)
    finally:
        jcanny.sobel_edges = real


_ORIG_CANNY = jcanny.canny_soft
_COMPILED = {}


def _jax(method, jmodel, *args):
    """JAX's ``train_step`` / ``eval_step`` jitted without ``algsimp``
    (F9), once per model and method, traced with the exact-border canny.
    Keyed by the model object itself: two models of one task and tamper
    mode (``test_torch_clr.py``'s ``use_perceptual`` ImugeV2 beside this
    file's plain one, in one worker) must not share a compiled step."""
    key = (method, jmodel)
    first = key not in _COMPILED
    if first:
        fn = functools.partial(getattr(JImage, method).__wrapped__, jmodel)
        _COMPILED[key] = jax.jit(fn, compiler_options={
            "xla_disable_hlo_passes": "algsimp"})
    prev = jimage_mod.canny_soft
    jimage_mod.canny_soft = _exact_border_canny
    try:
        return _COMPILED[key](*args)
    finally:
        jimage_mod.canny_soft = prev
        # a trace leaves tracers in the conv Haar's kernel cache
        jhaar._haar_kernel.cache_clear()


_JMODELS = {}


def _jmodel(task, tamper_mode=None):
    """One JAX model per task and tamper mode (its compiled steps are
    keyed by its optimizer and apply functions)."""
    key = (task, tamper_mode)
    if key not in _JMODELS:
        _JMODELS[key] = JImage(_cfgs()[1], task=task, tamper_mode=tamper_mode)
    return _JMODELS[key]


def _batch(seed, task="pami"):
    """Images and the previous batch a quarter level above the 8-bit grid,
    a host canny map, a stroke-like mask of 0/1 rectangles."""
    rng = np.random.default_rng(seed)

    def img():
        return ((rng.integers(0, 255, (B, S, S, 3)) + 0.25) / 255.0
                ).astype(np.float32)

    x, prev = img(), img()
    canny = (rng.random((B, S, S, 1)) > 0.85).astype(np.float32)
    mask = np.zeros((B, S, S, 1), np.float32)
    mask[0, 4:20, 6:26] = 1.0
    mask[1, 10:30, 2:14] = 1.0
    return x, canny, mask, prev


def _branch_draws(k_atk):
    ks = jax.random.split(k_atk, K)
    out = []
    for i in range(K):
        kind = i % 7
        if kind in (1, 5):
            k1, k2 = jax.random.split(ks[i])
            out.append((int(jax.random.randint(k1, (), 0, 5)),
                        int(jax.random.randint(k2, (), 0, 3))))
        elif kind == 2:
            out.append(int(jax.random.randint(ks[i], (), 0, len(RATIOS))))
        else:
            out.append(None)
    return tuple(out)


def train_draws(key) -> ImageDraws:
    """The draws JAX's ``_loss`` takes from ``key``."""
    k_atk, k_crop = jax.random.split(key)
    k_cm, k_sel = jax.random.split(jax.random.fold_in(k_crop, 7))
    kx, ky = jax.random.split(k_cm)
    shift = copy_move_shift(float(jax.random.uniform(kx, ())),
                            float(jax.random.uniform(ky, ())), (S, S))
    use_cm = bool(jax.random.bernoulli(k_sel, 1.0 / 3.0))
    return ImageDraws(shift, use_cm, _branch_draws(k_atk))


def _key_with(use_cm):
    for i in range(200):
        key = jax.random.PRNGKey(40 + i)
        if train_draws(key).use_cm == use_cm:
            return key
    raise AssertionError("no key")


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _adam_of(state):
    return state.opt_state[1][0]


def _check_step(task, tamper_mode, key, trees, data_seed):
    jmodel = _jmodel(task, tamper_mode)
    x, canny, mask, prev = _batch(data_seed, task)
    new, jlogs = _jax("train_step", jmodel, _jstates(jmodel, trees),
                      JBatch(jnp.asarray(x), jnp.asarray(canny),
                             jnp.asarray(mask)), jnp.asarray(prev), key)
    port = _port(task, tamper_mode)
    states_from_jax(port, trees)
    grads = {}
    logs = port.train_step(ImageBatch(x, canny, mask), prev,
                           train_draws(key), grads)
    for k in ("loss", "lF", "lB", "l_mask", "NULL"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("PF", "PB"):
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=0, atol=1e-3, err_msg=k)
    got = states_to_jax(port)
    for net in ("netG", "localizer"):
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
    return logs, grads


@pytest.mark.parametrize("use_cm", [False, True], ids=["splice", "copymove"])
def test_pami_mixed_step_matches_jax(trees, use_cm):
    """PAMI's mixed tamper on a key that draws the splice and on one that
    draws the copy-move: loss terms, every updated parameter, the AdamW
    moments and count, the spectral vectors."""
    _check_step("pami", "mixed", _key_with(use_cm), trees, 11)


def test_imuge_step_matches_jax(trees):
    """ImugeV2: the previous batch in gray as the watermark, splice."""
    _check_step("imuge", None, jax.random.PRNGKey(7), trees, 12)


def test_eval_step_matches_jax(trees):
    """The eval step on draws from the unsplit key: PSNRs within 1e-4 dB;
    SSIM within 5e-5 (the embed is 50 dB from the image: its windowed
    variances cancel to a few ulps of E[x²], and float32 sums in another
    order show; 2.3e-5 measured); the F1s within 2e-3 (a prediction within
    float32 rounding of a threshold level counts on one side or the
    other)."""
    jmodel = _jmodel("pami")
    x, canny, mask, prev = _batch(13)
    key = jax.random.PRNGKey(21)
    jout = _jax("eval_step", jmodel, _jstates(jmodel, trees),
                JBatch(jnp.asarray(x), jnp.asarray(canny), jnp.asarray(mask)),
                jnp.asarray(prev), key)
    port = _port()
    states_from_jax(port, trees)
    draws = ImageDraws((0, 0), False, _branch_draws(key))
    out = port.eval_step(ImageBatch(x, canny, mask), prev, draws)
    for k, atol in (("psnr_forward", 1e-4), ("psnr_backward", 1e-4),
                    ("psnr_backward_per_attack", 1e-4),
                    ("ssim_forward", 5e-5), ("f1_best", 2e-3),
                    ("f1_sweep", 2e-3), ("f1_per_attack", 2e-3),
                    ("recovered", 1e-4), ("predicted_mask", 1e-5)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=atol, err_msg=k)


def test_states_round_trip_through_jax_trees(trees):
    """``states_to_jax`` ∘ ``states_from_jax`` is the identity on every
    parameter, spectral vector, Adam moment and count of both nets."""
    port = _port()
    states_from_jax(port, trees)
    back = states_to_jax(port)
    for net in ("netG", "localizer"):
        for what in ("params", "mu", "nu"):
            a, b = _leaves(trees[net][what]), _leaves(back[net][what])
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    a = _leaves(trees["localizer"]["spectral"])
    b = _leaves(back["localizer"]["spectral"])
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def test_guard_keeps_every_state_on_an_inf_pixel_f21(trees):
    """F21 at the caller: an Inf pixel through the fan-out's JPEG branches
    (NaN on its 8×8 block in the port, on the whole image in JAX) leaves
    the loss non-finite and every state as it was, on both packages."""
    jmodel = _jmodel("imuge")
    x, canny, mask, prev = _batch(14)
    x[1, 5, 9, 2] = np.inf
    key = jax.random.PRNGKey(7)
    before = _jstates(jmodel, trees)
    ref = jax.tree_util.tree_map(np.asarray, before)
    new, jlogs = _jax("train_step", jmodel, before,
                      JBatch(jnp.asarray(x), jnp.asarray(canny),
                             jnp.asarray(mask)), jnp.asarray(prev), key)
    assert not np.isfinite(float(jlogs["loss"]))
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), b)
    port = _port("imuge")
    states_from_jax(port, trees)
    old = [t.clone() for t in port._tensors()]
    logs = port.train_step(ImageBatch(x, canny, mask), prev,
                           train_draws(key))
    assert not np.isfinite(float(logs["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(old, port._tensors()))


def test_unported_options_raise():
    """Every option of the JAX model is ported (CLR, ``with_gan`` and
    ``use_perceptual``: tests/test_torch_clr.py; ``with_jpeg_simulator``:
    tests/test_torch_kdjpeg_sim.py): the simulator builds its FBCNN
    ``jpeg_sim`` with its own optimizer; what the JAX model does not know,
    a task or a tamper mode, raises."""
    cfg = _cfgs()[0]
    model = ImageImmunizationModel(cfg, device="cpu",
                                   with_jpeg_simulator=True)
    assert set(model.nets()) == {"netG", "localizer", "jpeg_sim"}
    assert set(model.optimizers) == set(model.nets())
    with pytest.raises(ValueError, match="task"):
        ImageImmunizationModel(cfg, task="kdjpeg", device="cpu")
    with pytest.raises(ValueError, match="tamper_mode"):
        ImageImmunizationModel(cfg, tamper_mode="crop", device="cpu")


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_train_cli_pami_synthetic_on_cpu(tmp_path, capsys):
    """``train --task pami --synthetic --steps 2`` on the CPU (the port's
    pami.yaml with ``save_interval`` 2): finite logs, a checkpoint that
    ``--resume`` continues from."""
    cfg = tmp_path / "pami.yaml"
    cfg.write_text(Path(PAMI_CONFIG).read_text()
                   + "train:\n  save_interval: 2\n")
    ckpt = tmp_path / "ck"
    args = ["--task", "pami", "--synthetic", "--device", "cpu", "--batch",
            "2", "--size", "32", "--no-telemetry", "--ckpt-dir", str(ckpt),
            "--config", str(cfg)]
    train_cli.main(args + ["--steps", "2"])
    out = _last_json(capsys.readouterr().out)
    assert out["resumed_step"] is None and out["steps"] == 2
    assert all(np.isfinite(out[k]) for k in ("loss", "lF", "lB", "PF"))
    train_cli.main(args + ["--steps", "1", "--resume"])
    assert _last_json(capsys.readouterr().out)["resumed_step"] == 2


def test_family_runner_imuge_with_a_one_batch_eval_loader(tmp_path,
                                                          monkeypatch):
    """``run_family_convergence --task imuge`` on the CPU with an eval
    loader that yields one batch: the JAX runner indexes an empty list
    there (ADVICE.md, tools/run_family_convergence.py:134); the port
    evaluates the batch against itself rolled by one image."""
    real = runner.image_eval_loader
    monkeypatch.setattr(runner, "image_eval_loader", lambda m, s, b, e: real(
        m, s, b, e, length=b, ratio=1))
    out = tmp_path / "imuge.jsonl"
    args = runner.parse_args([
        "--task", "imuge", "--steps", "2", "--eval-every", "2",
        "--log-every", "1", "--size", "32", "--batch", "2", "--device",
        "cpu", "--out", str(out)])
    assert runner.run(args) == "done"
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    ev = [r for r in recs if r.get("eval")]
    assert len(ev) == 1 and ev[0]["eval_batches"] == 1
    assert all(np.isfinite(ev[0][k]) for k in (
        "psnr_forward", "psnr_backward", "ssim_forward", "f1_best",
        "f1_per_attack_mean"))
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
