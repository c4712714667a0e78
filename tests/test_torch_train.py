"""Parity of the port's training step with vwfd_tpu's, on the CPU in f32.

A small flagship-shaped model (packed ``res_tpu2`` INN, down_num 2, trunk
width 16; ``unet_tpu`` with f = 8, enc_convs (2,2,1,1,1); 32², B = 2,
T = 2; resize ratios (0.5, 1, 1.5)) is initialised in the port, its
zero-init coupling heads perturbed, and converted to flax trees
(``convert.params_to_jax``), so both sides start from the same weights.
One step on the same batch, previous batch and attack draws (derived from
the JAX key with the JAX code's split sequence) is compared.

The clip lies a quarter level above the 8-bit grid and the heads are
perturbed by 5e-6·N(0,1), so the INN moves no pixel by more than 0.15 of a
level: the embed's 8-bit quantizer rounds every pixel to the same level on
both sides. (With a larger perturbation, one pixel within float32 rounding
of a .5 level flips between the two sides — or between JAX with and
without ``jit`` — and moves the UNet's smallest, most cancelled gradient
tensors by several percent.)

Tolerances and why:

* ``loss``, ``lF``, ``lB`` within 1e-4 relative and ``PF`` within 1e-3 dB
  (float32 sums in another order);
* every gradient tensor within 1e-3 of its own max-abs (the gradients of
  convolutions in front of a BatchNorm cancel to a few 1e-4 of their
  terms, so float32 sums in another order show at ~1e-5 of max-abs);
* updated parameters within 2.1·lr: AdamW's first step moves each entry by
  about lr·sign(g), so an entry whose gradient is near zero may move the
  other way; BatchNorm running statistics within 1e-5.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu import config as jconfig
from vwfd_tpu.data import masks as jmasks
from vwfd_tpu.data import synthetic as jsynthetic
from vwfd_tpu.data.loader import Loader as JLoader
from vwfd_tpu.models import VideoBatch
from vwfd_tpu.models import VideoWatermarkModel as JModel
from vwfd_tpu.models.state import NetState
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu_torch import config as tconfig
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.attacks import AttackDraws
from vwfd_tpu_torch.convert import params_to_jax
from vwfd_tpu_torch.data import (Loader, SyntheticVideoDataset,
                                 free_form_stroke_mask, masks,
                                 random_rect_mask)
from vwfd_tpu_torch.models import VideoWatermarkModel

RATIOS = (0.5, 1.0, 1.5)
B, T, S = 2, 2, 32
MODEL = dict(inn_down_num=2, inn_block_num=(1, 1), inn_subnet="res_tpu2",
             inn_haar="conv", inn_packed=True, inn_width=16,
             extractor="unet_tpu", extractor_features=8,
             extractor_enc_convs=(2, 2, 1, 1, 1), attack_ratios=RATIOS)
DATA = dict(gt_size=S, batch_size=B, frames=T)


def _cfg(mod):
    return mod.Config(data=mod.DataConfig(**DATA),
                      model=mod.ModelConfig(**MODEL),
                      train=mod.TrainConfig(dtype="float32"))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


def _jpeg_draw(key):
    k1, k2 = jax.random.split(key)
    return (int(jax.random.randint(k1, (), 0, 5)),
            int(jax.random.randint(k2, (), 0, 3)))


def jax_draws(key, b, t, n_ratios):
    """The per-frame draws of ``attack_pool_video(key, ...)``: split(key,
    B·T), then split(k, 4) per frame (combined.py:41-57); each JPEG key
    splits into a quality key and a mode key (jpeg.py:205-209)."""
    ratio, q, mode, alpha = [], [], [], []
    for k in jax.random.split(key, b * t):
        ks = jax.random.split(k, 4)
        ratio.append(int(jax.random.randint(ks[0], (), 0, n_ratios)))
        d1, d2 = _jpeg_draw(ks[1]), _jpeg_draw(ks[2])
        q.append([d1[0], d2[0]])
        mode.append([d1[1], d2[1]])
        alpha.append(np.asarray(jax.nn.softmax(
            jax.random.normal(ks[3], (5,)))))
    return AttackDraws(torch.tensor(ratio), torch.tensor(q),
                       torch.tensor(mode), torch.from_numpy(np.stack(alpha)))


def _port_model(seed=0, perturb=0.05):
    model = VideoWatermarkModel(_cfg(tconfig), device="cpu")
    model.init_states(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.inn.named_parameters():
            if ".Conv_2." in name:  # the zero-init heads: no identity INN
                p.add_(perturb * torch.randn(p.shape, generator=gen))
    return model


def _batch(seed):
    """(video, mask, prev); the video a quarter level above the 8-bit
    grid."""
    rng = np.random.default_rng(seed)
    video = ((rng.integers(0, 255, (B, T, S, S, 3)) + 0.25) / 255).astype(
        np.float32)
    prev = rng.random((B, T, S, S, 3), dtype=np.float32)
    mask = np.stack([random_rect_mask(rng, (S, S), 0.2, 0.5)
                     for _ in range(B)])[:, None, :, :, None]
    return video, np.repeat(mask, T, 1).astype(np.float32), prev


def _tree(model, per_net):
    """Port tensors per parameter (``per_net[name]``, in parameter order)
    → flax-layout trees (BatchNorm marked by the module's buffers)."""
    sds = []
    for name, net in model.nets().items():
        sd = dict(zip([n for n, _ in net.named_parameters()], per_net[name]))
        sd.update(dict(net.named_buffers()))
        sds.append(sd)
    netg, gen, _ = params_to_jax(*sds)
    return {"netG": netg, "generator": gen}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def step():
    """One JAX step (value_and_grad of ``_loss`` + the two optax updates
    + the new batch stats) from the port model's weights."""
    model = _port_model(perturb=5e-6)
    jm = JModel(_cfg(jconfig))
    netg, gen, stats = params_to_jax(*(net.state_dict() for net in
                                       model.nets().values()))
    j = jax.tree_util.tree_map(jnp.asarray, (netg, gen, stats))
    states = {"netG": NetState.create(jm.inn.apply, j[0], {}, jm.tx),
              "generator": NetState.create(jm.unet.apply, j[1],
                                           {"batch_stats": j[2]}, jm.tx)}
    video, mask, prev = _batch(1)
    key = jax.random.PRNGKey(5)
    params = {k: s.params for k, s in states.items()}
    args = (params, states, VideoBatch(jnp.asarray(video), jnp.asarray(mask)),
            jnp.asarray(prev), key)
    # the squeeze kernels' cache must hold arrays, not a trace's tracers
    jsq.space_to_depth_conv(jnp.zeros((1, 2, 2, 3)), 2)
    jsq.depth_to_space_conv(jnp.zeros((1, 1, 1, 4)), 2)
    # XLA's algebraic simplifier turns x / 255 into x·(1/255), one ulp off
    # the op-by-op (IEEE) result that the port reproduces bit for bit; off,
    # the compiled step keeps JAX's own division semantics
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        jm._loss, has_aux=True)).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args)
    new = {"netG": states["netG"].apply_gradients(grads["netG"]),
           "generator": states["generator"].apply_gradients(
               grads["generator"])}
    draws = jax_draws(jax.random.split(key)[0], B, T, len(RATIOS))
    ref = {"loss": float(loss), "lF": float(aux["lF"]),
           "lB": float(aux["lB"]), "PF": float(aux["PF"]), "grads": grads,
           "params": {k: s.params for k, s in new.items()},
           "stats": aux["unet_vars"]["batch_stats"]}
    return model, (video, mask, prev, draws), ref


def test_train_step_losses_and_gradients_match_jax(step):
    model, (video, mask, prev, draws), ref = step
    loss, aux, grads, _ = model.loss_and_grads(video, mask, prev, draws)
    got = {"loss": float(loss), "lF": float(aux["lF"]),
           "lB": float(aux["lB"])}
    for k, v in got.items():
        assert abs(v - ref[k]) <= 1e-4 * abs(ref[k]), (k, v, ref[k])
    assert abs(float(aux["PF"]) - ref["PF"]) <= 1e-3
    ours = _leaves(_tree(model, grads))
    want = _leaves(ref["grads"])
    assert ours.keys() == want.keys() and len(want) > 50
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(ours[name] - w).max())
        assert err <= 1e-3 * scale, (name, err, scale)
    # the heads, the INN entry and the UNet stem all receive gradient
    assert np.abs(want["['netG']['down_blocks_0_0']['st1']['Conv_2']"
                       "['kernel']"]).max() > 0


def test_train_step_updates_match_jax(step):
    model, (video, mask, prev, draws), ref = step
    model = copy.deepcopy(model)
    before = {k: [p.clone() for p in net.parameters()]
              for k, net in model.nets().items()}
    logs = model.train_step(video, mask, prev, draws)
    assert set(logs) == {"loss", "lF", "lB", "PF"}
    params = {k: list(net.parameters()) for k, net in model.nets().items()}
    ours = _leaves(_tree(model, params))
    want = _leaves(ref["params"])
    lr = model.cfg.train.lr
    moved = 0
    for name, w in want.items():
        np.testing.assert_allclose(ours[name], w, rtol=0, atol=2.1 * lr,
                                   err_msg=name)
    for k, ps in params.items():
        moved += sum(int((p != b).sum()) for p, b in zip(ps, before[k]))
    assert moved > 0
    _, _, stats = params_to_jax({}, model.unet.state_dict())
    for name, w in _leaves(ref["stats"]).items():
        np.testing.assert_allclose(_leaves(stats)[name], w, rtol=0,
                                   atol=1e-5, err_msg=name)
    assert all(int(o.count) == 1 for o in model.optimizers.values())


def _snapshot(model):
    out = [t.clone() for net in model.nets().values()
           for t in list(net.parameters()) + list(net.buffers())]
    for opt in model.optimizers.values():
        out += [t.clone() for t in opt.mu + opt.nu + [opt.count]]
    return out


def test_nonfinite_guard_keeps_every_state():
    """A batch with a NaN pixel: the loss is NaN and every parameter,
    moment, step count and BatchNorm running statistic keeps its value
    (F6); the next good batch trains."""
    model = _port_model(3)
    video, mask, prev = _batch(4)
    model.train_step(video, mask, prev)
    before = _snapshot(model)
    bad = video.copy()
    bad[0, 0, 3, 5, 1] = np.nan
    logs = model.train_step(bad, mask, prev)
    assert not np.isfinite(float(logs["loss"]))
    after = _snapshot(model)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    logs = model.train_step(video, mask, prev)
    assert np.isfinite(float(logs["loss"]))
    assert not all(torch.equal(a, b)
                   for a, b in zip(_snapshot(model), before))


def test_fit_seeds_the_previous_batch_buffer(monkeypatch):
    """``fit``: the first batch only seeds the buffer; each step splices
    the batch before it; three steps stay finite and start near the
    identity INN (PF > 45 dB)."""
    model = VideoWatermarkModel(_cfg(tconfig), device="cpu")
    model.init_states(0)
    data = SyntheticVideoDataset(size=S, frames=T, length=8)
    loader = Loader(data, B, seed=0)
    batches = [torch.from_numpy(v) for v, _ in Loader(data, B, seed=0)]
    seen = []
    step = model.train_step

    def spy(video, mask, prev, draws=None):
        seen.append((video.clone(), prev.clone()))
        return step(video, mask, prev, draws)

    monkeypatch.setattr(model, "train_step", spy)
    _, logs = model.fit(loader, 3)
    assert len(seen) == 3
    for i, (video, prev) in enumerate(seen):
        assert torch.equal(video, batches[i + 1])
        assert torch.equal(prev, batches[i])
    assert all(np.isfinite(v) for v in logs.values())
    assert logs["PF"] > 45.0


def test_train_cli_on_cpu(capsys):
    # no scalar log or montages: they would land under the working
    # directory (test_torch_trainer.py drives them into tmp_path)
    train_cli.main(["--synthetic", "--steps", "2", "--device", "cpu",
                    "--batch", "2", "--size", "32", "--frames", "2",
                    "--no-telemetry"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("loss", "lF", "lB", "PF", "ms_per_step", "frames_per_s"):
        assert np.isfinite(out[k]), k
    assert out["PF"] > 45.0 and out["device"] == "cpu"
    assert out["frames_per_s"] == pytest.approx(
        2 * 2 / out["ms_per_step"] * 1e3)


def test_train_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--synthetic", "--steps", "1"])


def test_synthetic_data_matches_jax():
    """Frames and rectangle masks equal the JAX package's; a stroke makes
    the same draws (the rng ends in the same state) and overlaps cv2's
    (IoU > 0.9); a stroke mask reaches its target coverage; the loader's
    batches come in the JAX loader's order."""
    ours = SyntheticVideoDataset(size=S, frames=T, length=6, mask_kind="rect")
    ref = jsynthetic.SyntheticVideoDataset(size=S, frames=T, length=6,
                                           mask_kind="rect")
    for i in range(6):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    stroke = SyntheticVideoDataset(size=S, frames=T, length=2)[1][0]
    np.testing.assert_array_equal(
        stroke, jsynthetic.SyntheticVideoDataset(size=S, frames=T,
                                                 length=2)[1][0])
    for seed in range(4):
        # one stroke from equal rng states: the same draws, the same pixels
        # up to the rasteriser's edges
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        a = masks._one_stroke(r1, 128, 128, 4, 25, 25)
        b = jmasks._one_stroke(r2, 128, 128, 4, 25, 25)
        assert r1.random() == r2.random()
        assert (a * b).sum() / np.maximum(a, b).sum() > 0.9
        # a whole mask reaches its target coverage (the stroke count may
        # differ from cv2's where a stroke lands at the target)
        target = 0.05 + 0.15 * np.random.default_rng(seed).random()
        m = free_form_stroke_mask(np.random.default_rng(seed), (128, 128),
                                  percent_range=(0.05, 0.2))
        assert m.mean() >= target and set(np.unique(m)) <= {0.0, 1.0}
    got = [v for v, _ in Loader(ours, 2, seed=3)]
    want = [v for v, _ in JLoader(ref, 2, seed=3)]
    assert len(got) == len(want) == 3
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
