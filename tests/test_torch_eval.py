"""Parity of the port's eval path with vwfd_tpu's, on the CPU in f32, and
the port's checkpoints and ``--val`` / ``--resume`` CLI.

The model, weights and batch are those of ``test_torch_train.py``: a small
flagship-shaped model (packed ``res_tpu2`` INN, down_num 2, trunk width 16;
``unet_tpu`` with f = 8; 32², B = 2, T = 2), its zero-init heads perturbed
by 5e-6·N(0,1) and converted to flax trees. The clip lies three quarters
of a level above the 8-bit grid: the embed's quantizer rounds every pixel
to the same level on both sides (the INN moves none by more than 0.15 of a
level), the level above the clip's, so the int-truncated PSNR is finite.

The attack draws come from the UNSPLIT key: JAX's ``eval_step`` hands its
key to ``attack_pool_video`` directly (``video_model.py:263``), where
``_loss`` first takes ``split(key)[0]`` (``:195``), so the draws here are
``jax_draws(key, ...)``, not ``jax_draws(split(key)[0], ...)`` as for a
train step. The JAX step is compiled without XLA's algebraic simplifier,
which would turn ``x / 255`` into ``x·(1/255)`` inside the attack pool (F9).

Tolerances: PSNR within 1e-3 dB (the same quantized clip; float32 sums in
another order). SSIM within 1e-5: the port takes the map's mean in double,
JAX in float32, whose running sum of values near 1 drifts (on this batch
the float64 mean is 0.99999779, the port's 0.99999774, JAX's 0.99999994 —
F12). The F1 sweep: the eval step has no quantizer after the attack, so
the UNet sees inputs that differ by float32 rounding (~1e-7) and its
probabilities differ by ~1e-6. A pixel flips at a level only where
``p·255`` lies within that of the level's boundary; each flip moves tp, fp
or fn by one. So at each level the F1s agree within ``4·n / (2·tp + fp +
fn)``, where ``n`` counts the port's pixels within 1e-5 of that level's
boundary, and exactly where there are none (on this batch 3 pixels lie
near the 0.5 and 0.6 boundaries, and all nine F1s are equal).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (RATIOS, _batch, _cfg, _port_model, jax_draws)
from vwfd_tpu import config as jconfig
from vwfd_tpu.attacks.jpeg import jpeg_real
from vwfd_tpu.models import VideoBatch
from vwfd_tpu.models import VideoWatermarkModel as JModel
from vwfd_tpu.models.state import NetState
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.attacks import AttackDraws
from vwfd_tpu_torch.convert import params_to_jax
from vwfd_tpu_torch.data import Loader, SyntheticVideoDataset
from vwfd_tpu_torch.metrics import DEFAULT_THRESHOLDS, threshold_level
from vwfd_tpu_torch.models import VideoWatermarkModel
from vwfd_tpu_torch.models.state import (latest_step, restore_checkpoint,
                                         save_checkpoint)

B, T = 2, 2
LEVELS = [threshold_level(t) for t in np.float32(DEFAULT_THRESHOLDS)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ev():
    """The port model, the JAX model and states from its weights, a batch
    and the JAX eval step's metrics on it."""
    model = _port_model(perturb=5e-6)
    jm = JModel(_cfg(jconfig))
    netg, gen, stats = params_to_jax(*(net.state_dict() for net in
                                       model.nets().values()))
    j = jax.tree_util.tree_map(jnp.asarray, (netg, gen, stats))
    states = {"netG": NetState.create(jm.inn.apply, j[0], {}, jm.tx),
              "generator": NetState.create(jm.unet.apply, j[1],
                                           {"batch_stats": j[2]}, jm.tx)}
    video, mask, prev = _batch(1)
    video = (video + np.float32(0.5 / 255)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    batch = VideoBatch(jnp.asarray(video), jnp.asarray(mask))
    # the squeeze kernels' cache must hold arrays, not a trace's tracers
    jsq.space_to_depth_conv(jnp.zeros((1, 2, 2, 3)), 2)
    jsq.depth_to_space_conv(jnp.zeros((1, 1, 1, 4)), 2)
    args = (jm, states, batch, jnp.asarray(prev), key)
    ref = JModel.eval_step.lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args[1:])
    ref = {k: np.asarray(v) for k, v in ref.items()}
    draws = jax_draws(key, B, T, len(RATIOS))  # the unsplit key
    return model, jm, states, (video, mask, prev, draws), ref


def _f1_bound(model, attacked, mask):
    """Per level, ``4·n / (2·tp + fp + fn)`` with ``n`` the port's pixels
    whose probability lies within 1e-5 of the level's boundary (0 where
    none do); also the number of such pixels."""
    pred = model.predict_mask(torch.as_tensor(attacked)).reshape(-1).double()
    gt = torch.as_tensor(mask).reshape(-1) > 0.5
    bound, near = [], 0
    for t in LEVELS:
        n = int(((pred - (t + 1) / 255.0).abs() < 1e-5).sum())
        on = pred * 255.0 >= t + 1
        denom = int((on & gt).sum()) * 2 + int((on ^ gt).sum())
        bound.append(4.0 * n / max(denom, 1))
        near += n
    return np.array(bound), near


def test_eval_step_matches_jax(ev):
    model, _, _, (video, mask, prev, draws), ref = ev
    out = model.eval_step(video, mask, prev, draws)
    assert set(out) == {"psnr_forward", "ssim_forward", "f1_best",
                        "f1_sweep"}
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in out.values())
    assert out["f1_sweep"].shape == (9,)
    assert abs(float(out["psnr_forward"]) - float(ref["psnr_forward"])) \
        <= 1e-3
    assert abs(float(out["ssim_forward"]) - float(ref["ssim_forward"])) \
        <= 1e-5
    # the attacked clip the UNet saw, rebuilt from the same draws
    from vwfd_tpu_torch.attacks import attack_pool_video
    v, m, p = model.to_device(video, mask, prev)
    fwd = model.embed(v)
    attacked = attack_pool_video(fwd * (1 - m) + p * m, draws,
                                 model.attack_ratios, model.kernels)
    bound, near = _f1_bound(model, attacked.clamp(0, 1), mask)
    diff = np.abs(out["f1_sweep"].numpy() - ref["f1_sweep"])
    assert (diff <= bound).all(), (diff, bound, near)
    assert float(out["f1_best"]) == float(out["f1_sweep"].max())
    assert abs(float(out["f1_best"]) - float(ref["f1_best"])) <= bound.max()
    assert 0.0 < float(out["f1_best"]) <= 1.0
    assert 40.0 < float(out["psnr_forward"]) < 60.0


def test_extract_f1_matches_jax(ev):
    model, jm, states, (video, mask, _, _), _ = ev
    rng = np.random.default_rng(6)
    attacked = np.clip(video + 0.02 * rng.standard_normal(video.shape),
                       0, 1).astype(np.float32)
    got = float(model.extract_f1(attacked, mask))
    want = float(jm.extract_f1(states, jnp.asarray(attacked),
                               jnp.asarray(mask)))
    bound, _ = _f1_bound(model, attacked, mask)
    assert abs(got - want) <= bound.max(), (got, want, bound)


def test_eval_real_jpeg_matches_jax(ev):
    """The host codec is an argument; the test passes the JAX package's
    PIL-backed ``jpeg_real`` to both (only the tests import PIL)."""
    model, jm, states, (video, mask, prev, _), _ = ev
    got = model.eval_real_jpeg(video, mask, prev, jpeg_real)
    want = jm.eval_real_jpeg(
        states, VideoBatch(jnp.asarray(video), jnp.asarray(mask)),
        jnp.asarray(prev))
    assert list(got) == list(want) == ["none", "qf50", "qf70", "qf90"]
    v, m, p = (torch.as_tensor(a) for a in (video, mask, prev))
    tampered = torch.clamp(model.embed(v) * (1 - m) + p * m, 0, 1)
    frames = tampered.reshape(B * T, *tampered.shape[2:]).numpy()
    for name, q in (("none", None), ("qf50", 50), ("qf70", 70),
                    ("qf90", 90)):
        att = frames if q is None else jpeg_real(frames, q)
        bound, _ = _f1_bound(model, att.reshape(tampered.shape), mask)
        assert abs(got[name] - want[name]) <= bound.max(), (name, got, want)


def _snapshot(model):
    out = [t.clone() for net in model.nets().values()
           for t in list(net.parameters()) + list(net.buffers())]
    for opt in model.optimizers.values():
        out += [t.clone() for t in opt.mu + opt.nu + [opt.count]]
    return out


def _draws(seed):
    g = torch.Generator().manual_seed(seed)
    n = B * T
    return AttackDraws(torch.randint(0, len(RATIOS), (n,), generator=g),
                       torch.randint(0, 5, (n, 2), generator=g),
                       torch.randint(0, 3, (n, 2), generator=g),
                       torch.softmax(torch.randn(n, 5, generator=g), -1))


def test_checkpoint_round_trip_continues_bit_for_bit(tmp_path):
    """Every parameter, BatchNorm statistic, AdamW moment and step count
    equals the saved model's after a restore, and the next step equals the
    step the saved model takes."""
    model = _port_model(3)
    video, mask, prev = _batch(4)
    model.train_step(video, mask, prev, _draws(0))
    model.train_step(prev, mask, video, _draws(1))
    path = save_checkpoint(str(tmp_path), 2, model)
    assert path.endswith("/2")
    restored = _port_model(8)
    assert not all(torch.equal(a, b) for a, b in
                   zip(_snapshot(restored), _snapshot(model)))
    restore_checkpoint(str(tmp_path), 2, restored)
    before = _snapshot(model)
    assert len(before) > 50
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(restored), before))
    assert all(int(o.count) == 2 for o in restored.optimizers.values())
    model.train_step(video, mask, prev, _draws(2))
    restored.train_step(video, mask, prev, _draws(2))
    after = _snapshot(model)
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(restored), after))
    assert not all(torch.equal(a, b) for a, b in zip(after, before))
    # the newest digit-named directory is the latest step
    save_checkpoint(str(tmp_path), 10, model)
    (tmp_path / "not-a-step").mkdir()
    assert latest_step(str(tmp_path)) == 10
    assert latest_step(str(tmp_path / "missing")) is None


def _cli_cfg(save_interval=1):
    cfg = load_config(FLAGSHIP_CONFIG)
    import dataclasses
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=B, gt_size=32,
                                      frames=T, synthetic=True),
        train=dataclasses.replace(cfg.train, save_interval=save_interval))


def test_val_resume_cli_evaluates_a_fit_checkpoint(tmp_path, capsys):
    """``fit`` writes a checkpoint every ``save_interval`` steps; ``train
    --val --resume`` restores the latest one and prints the mean metrics,
    equal to those of the restored model's own eval steps on the same
    batches."""
    cfg = _cli_cfg()
    model = VideoWatermarkModel(cfg, device="cpu")
    model.init_states(cfg.train.seed)
    data = SyntheticVideoDataset(size=32, frames=T, length=8)
    model.fit(Loader(data, B, seed=0), 2, ckpt_dir=str(tmp_path))
    assert latest_step(str(tmp_path)) == 2 and (tmp_path / "1").is_dir()
    train_cli.main(["--synthetic", "--val", "--val-batches", "2", "--resume",
                    "--ckpt-dir", str(tmp_path), "--device", "cpu",
                    "--batch", str(B), "--size", "32", "--frames", str(T)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["resumed_step"] == 2 and out["device"] == "cpu"
    assert out["val_batches"] == 2
    for k in ("psnr_forward", "ssim_forward", "f1_best", "ms_per_eval_step",
              "frames_per_s"):
        assert np.isfinite(out[k]), k
    assert out["frames_per_s"] == pytest.approx(
        B * T / out["ms_per_eval_step"] * 1e3)
    # the same eval on a model restored here, batches in the CLI's order
    check = VideoWatermarkModel(cfg, device="cpu")
    check.init_states(cfg.train.seed)
    restore_checkpoint(str(tmp_path), 2, check)
    loader = Loader(SyntheticVideoDataset(size=32, frames=T, length=2000,
                                          seed=cfg.train.seed), B,
                    seed=cfg.train.seed)
    it = iter(loader)
    clips = [next(it) for _ in range(3)]
    outs = [check.eval_step(v, m, clips[i][0])
            for i, (v, m) in enumerate(clips[1:])]
    for k in ("psnr_forward", "ssim_forward", "f1_best"):
        want = float(np.mean([float(o[k]) for o in outs]))
        assert out[k] == pytest.approx(want, rel=1e-6, abs=1e-7), k
    fresh = copy.deepcopy(check)
    fresh.init_states(cfg.train.seed)
    assert not all(torch.equal(a, b) for a, b in
                   zip(_snapshot(fresh), _snapshot(check)))


def test_val_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--synthetic", "--val"])
