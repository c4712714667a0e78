"""Data parallelism of the port (``vwfd_tpu_torch.parallel``) against the
one-process port and the JAX package's 8-device mesh, on the CPU.

The tiny flagship of ``tests/test_torch_train.py`` (packed ``res_tpu2``
INN, ``unet_tpu``) at 8 clips, T 2, 32², float32. Two gloo ranks run in
child processes of this file (``python tests/test_torch_parallel.py
ranks DIR``), each on its 4 clips of the global batch; the parent runs
the port's one-process step on the whole batch and JAX's
``VideoWatermarkModel`` over conftest's 8-device mesh on the same weights,
batch, previous batch and draws, while the ranks run.

Tolerances and why:

* against JAX: ``tests/test_torch_train.py``'s (loss terms within 1e-4
  relative, PF within 1e-3 dB, every gradient tensor, read from the first
  moment ``mu = 0.1·g``, within 1e-3 of its max-abs, parameters within
  2.1·lr, BatchNorm statistics within 1e-5), for the same reasons;
* against the one-process port: loss terms within 1e-6 relative;
  parameters within 2.1·lr (the first AdamW step moves each entry by about
  lr·sign(g), and a gradient that cancels to ~1e-7 may change its sign
  with the summation order, as in ``test_torch_train.py``); BatchNorm
  statistics within 1e-6; counts EQUAL. The one process normalises
  through ``F.batch_norm``, whose batch variance is not flax's ``E[x²] −
  E[x]²`` that the global path (and JAX) takes: pixels within rounding of
  0 then fall on the other side of the next ReLU, and a gradient parts by
  up to 1 % of its tensor's max (the UNet stem's, which cancels to ~1e-3
  of its terms, by 5.3e-3; the ranks' are within 1e-3 of JAX's). So the
  moments are held to the one-process step with flax's variance in its
  train-mode BatchNorm, the global path's formula on one process's rows:
  within 1e-4 of each tensor's max-abs (the same sums in another
  order);
  BatchNorm statistics within 1e-6; counts EQUAL;
* the ranks against each other: EQUAL (every rank computes the same
  update from the same all-reduced gradients);
* BatchNorm alone (``_bn``): outputs and gradients within 1e-6 of the
  tensor's max-abs;
* evaluation: the F1 sweep EQUAL (int64 counts summed over the ranks of
  bit-equal predictions), PSNR and SSIM within 1e-6.

No test can hang: the group's collectives time out after
``GROUP_TIMEOUT_S``, the children are killed after ``RANKS_TIMEOUT_S``
(``parallel.spawn.LocalRanks``), and the ``with`` block reaps them
whatever happens.
"""

import dataclasses
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config
from vwfd_tpu_torch import config as tconfig
from vwfd_tpu_torch import parallel
from vwfd_tpu_torch.attacks import AttackDraws
from vwfd_tpu_torch.data import Loader, SyntheticVideoDataset
from vwfd_tpu_torch.metrics import l1_loss, psnr255_int
from vwfd_tpu_torch.models import VideoWatermarkModel
from vwfd_tpu_torch.models.video_model import _to_channels
from vwfd_tpu_torch.nets import unet as unet_mod
from vwfd_tpu_torch.nets.unet import BatchStats, _bn
from vwfd_tpu_torch.parallel import Mesh
from vwfd_tpu_torch.parallel.spawn import LocalRanks, RankFailure
from vwfd_tpu_torch.serving import WatermarkServer

RATIOS = (0.5, 1.0, 1.5)
B, T, S = 8, 2, 32
WORLD = 2
MODEL = dict(inn_down_num=2, inn_block_num=(1, 1), inn_subnet="res_tpu2",
             inn_haar="conv", inn_packed=True, inn_width=16,
             extractor="unet_tpu", extractor_features=8,
             extractor_enc_convs=(2, 2, 1, 1, 1), attack_ratios=RATIOS)
GROUP_TIMEOUT_S = 30.0
RANKS_TIMEOUT_S = 120.0
BN_C = 6  # channels of the BatchNorm-alone case
_PLAIN_BN = _bn


def _cfg(mod):
    return mod.Config(data=mod.DataConfig(gt_size=S, batch_size=B, frames=T),
                      model=mod.ModelConfig(**MODEL),
                      train=mod.TrainConfig(dtype="float32"))


def _port_model(seed, mesh=None):
    """``test_torch_train.py``'s model: seeded weights, the zero-init
    heads perturbed by 5e-6·N(0,1) (no pixel crosses a level between the
    two packages)."""
    model = VideoWatermarkModel(_cfg(tconfig), device="cpu", mesh=mesh)
    model.init_states(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.inn.named_parameters():
            if ".Conv_2." in name:
                p.add_(5e-6 * torch.randn(p.shape, generator=gen))
    return model


def _state(model):
    """Every state tensor by name: parameters, buffers, AdamW moments and
    counts."""
    out = {}
    for net_name, net in model.nets().items():
        for k, v in list(net.named_parameters()) + list(net.named_buffers()):
            out[f"{net_name}.{k}"] = v.detach().clone()
    for net_name, opt in model.optimizers.items():
        names = [k for k, _ in model.nets()[net_name].named_parameters()]
        for key in ("mu", "nu"):
            for k, v in zip(names, getattr(opt, key)):
                out[f"{net_name}.{key}.{k}"] = v.clone()
        out[f"{net_name}.count"] = opt.count.clone()
    return out


def _inputs():
    """The global batches, drawn with numpy from fixed seeds: a clip a
    quarter level above the 8-bit grid, its mask and previous clip; a
    second clip for the guard; an eval batch; a ``_bn`` input and
    cotangent."""
    rng = np.random.default_rng(1)

    def clip():
        return torch.from_numpy(((rng.integers(0, 255, (B, T, S, S, 3))
                                  + 0.25) / 255).astype(np.float32))
    video, video2, video3 = clip(), clip(), clip()
    prev = torch.from_numpy(rng.random((B, T, S, S, 3), dtype=np.float32))
    mask = torch.zeros(B, T, S, S, 1)
    for i in range(B):
        y, x = rng.integers(0, S // 2, 2)
        mask[i, :, y:y + S // 2, x:x + S // 3] = 1.0
    bn_x = torch.from_numpy(
        (rng.standard_normal((B, 5, 7, BN_C)) * 2 + 0.5).astype(np.float32))
    bn_cot = torch.from_numpy(
        rng.standard_normal((B, 5, 7, BN_C)).astype(np.float32))
    return dict(video=video, video2=video2, video3=video3, prev=prev,
                mask=mask, bn_x=bn_x, bn_cot=bn_cot)


def _gate_shift(video):
    """The INN replaced by ``clip + shift`` for the gate test: the first
    half of the batch moved by three levels at a few pixels (PSNR far
    above the gate), the second half by 20 levels everywhere (far
    below)."""
    shift = torch.zeros_like(video)
    shift[: B // 2, :, ::7, ::5] = 3.0 / 255
    shift[B // 2:] = 20.0 / 255
    return shift


def _with_gate_inn(model, shift):
    """``model`` with its INN forward replaced by ``video + shift``
    (``shift``: this process's rows)."""
    model._inn = lambda video: _to_channels(video + shift)
    return model


def _bn_case(x, cot, mesh):
    """``_bn`` of a BatchNorm with seeded γ, β and running statistics on
    ``x`` (this process's rows), the loss ``Σ y·cot`` over the global
    batch; returns y, the input gradient, γ's and β's gradients (summed
    over the ranks and divided by their number, as ``all_reduce_grads``)
    and the running statistics."""
    bn = torch.nn.BatchNorm2d(BN_C, eps=1e-5)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(BN_C, generator=g))
        bn.bias.copy_(0.2 * torch.randn(BN_C, generator=g))
        bn.running_mean.copy_(torch.randn(BN_C, generator=g))
        bn.running_var.copy_(1 + torch.rand(BN_C, generator=g))
    x = x.clone().requires_grad_(True)
    stats = BatchStats(mesh)
    y = _bn(x, bn, stats)
    loss = parallel.global_sum((y * cot).sum(), mesh)
    gx, gw, gb = torch.autograd.grad(loss, [x, bn.weight, bn.bias])
    gw, gb = parallel.all_reduce_grads([gw, gb], mesh)
    return {"y": y.detach(), "gx": gx, "gw": gw, "gb": gb,
            "mean": stats[bn][0], "var": stats[bn][1]}


def _run_scenarios(model, inp, draws, mesh=None):
    """What the ranks and the one-process reference both run, in this
    order, from ``model`` (replicated): an eval step, the PSNR gate's
    loss terms, a train step, a train step on a batch with an Inf pixel
    in the last clip, the BatchNorm case."""
    rows = lambda x: parallel.local_rows(x, mesh)  # noqa: E731
    video, mask, prev = rows(inp["video"]), rows(inp["mask"]), \
        rows(inp["prev"])
    d = rows(draws)
    out = {"state0": _state(model)}
    ev = model.eval_step(rows(inp["video3"]), mask, prev, d)
    out["eval"] = {k: v.clone() for k, v in ev.items()}
    inn = model._inn
    _with_gate_inn(model, rows(_gate_shift(inp["video"])))
    _, aux, _, _ = model.loss_and_grads(video, mask, prev, d)
    out["gate"] = {k: float(v) for k, v in aux.items()}
    fwd = model.embed(video)  # this process's rows alone
    out["gate_local"] = {"l1": float(l1_loss(fwd, video)),
                         "PF": float(psnr255_int(video, fwd))}
    model._inn = inn
    logs = model.train_step(video, mask, prev, d)
    out["logs"] = {k: float(v) for k, v in logs.items()}
    out["state1"] = _state(model)
    bad = inp["video2"].clone()
    bad[B - 1, 0, 3, 5, 1] = float("inf")  # the last rank's rows
    logs = model.train_step(rows(bad), mask, rows(inp["video"]), d)
    out["guard_loss"] = float(logs["loss"])
    after = _state(model)
    out["guard_kept"] = all(torch.equal(after[k], v)
                            for k, v in out["state1"].items())
    out["bn"] = _bn_case(rows(inp["bn_x"]), rows(inp["bn_cot"]), mesh)
    return out


def _ranks_child(out_dir):
    """One rank (run by ``LocalRanks``): differently seeded weights, then
    ``replicate``; the scenarios on its rows; everything to
    ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    rank = parallel.maybe_init_distributed("cpu",
                                           timeout_s=GROUP_TIMEOUT_S)
    mesh = parallel.make_mesh()
    inp = torch.load(os.path.join(out_dir, "inputs.pt"))
    model = _port_model(rank, mesh)
    equal_before = parallel.replicas_equal(model, mesh)
    parallel.replicate(model, mesh)
    out = _run_scenarios(model, inp, AttackDraws(*inp["draws"]), mesh)
    out.update(rank=rank, equal_before=equal_before,
               equal_after=parallel.replicas_equal(model, mesh))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _ranks_env():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


# ------------------------------------------------------------- the JAX side


def _jax_draws(key):
    """``test_torch_train.py``'s per-frame draws of ``attack_pool_video``
    for the global batch."""
    import jax

    def jpeg(k):
        k1, k2 = jax.random.split(k)
        return (int(jax.random.randint(k1, (), 0, 5)),
                int(jax.random.randint(k2, (), 0, 3)))
    ratio, q, mode, alpha = [], [], [], []
    for k in jax.random.split(key, B * T):
        ks = jax.random.split(k, 4)
        ratio.append(int(jax.random.randint(ks[0], (), 0, len(RATIOS))))
        d1, d2 = jpeg(ks[1]), jpeg(ks[2])
        q.append([d1[0], d2[0]])
        mode.append([d1[1], d2[1]])
        alpha.append(np.asarray(jax.nn.softmax(jax.random.normal(ks[3],
                                                                 (5,)))))
    return AttackDraws(torch.tensor(ratio), torch.tensor(q),
                       torch.tensor(mode), torch.from_numpy(np.stack(alpha)))


def _jax_mesh_step(model, inp, key):
    """JAX's train step over conftest's 8-device mesh (the batch sharded,
    the states replicated, XLA's all-reduces) from ``model``'s weights:
    value_and_grad of ``_loss`` + the two optax updates, compiled without
    ``algsimp`` as in ``test_torch_train.py``."""
    import jax
    import jax.numpy as jnp

    from vwfd_tpu import config as jconfig
    from vwfd_tpu.models import VideoBatch
    from vwfd_tpu.models import VideoWatermarkModel as JModel
    from vwfd_tpu.models.state import NetState
    from vwfd_tpu.ops import squeeze as jsq
    from vwfd_tpu.parallel import make_mesh, replicate, shard_batch
    from vwfd_tpu_torch.convert import params_to_jax

    mesh = make_mesh(8)
    jm = JModel(_cfg(jconfig), mesh=mesh)
    netg, gen, stats = params_to_jax(*(net.state_dict() for net in
                                       model.nets().values()))
    j = jax.tree_util.tree_map(jnp.asarray, (netg, gen, stats))
    states = replicate(
        {"netG": NetState.create(jm.inn.apply, j[0], {}, jm.tx),
         "generator": NetState.create(jm.unet.apply, j[1],
                                      {"batch_stats": j[2]}, jm.tx)}, mesh)
    video, mask, prev = shard_batch(
        tuple(inp[k].numpy() for k in ("video", "mask", "prev")), mesh)
    params = {k: s.params for k, s in states.items()}
    args = (params, states, VideoBatch(video, mask), prev, key)
    jsq.space_to_depth_conv(jnp.zeros((1, 2, 2, 3)), 2)
    jsq.depth_to_space_conv(jnp.zeros((1, 1, 1, 4)), 2)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        jm._loss, has_aux=True)).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args)
    new = {"netG": states["netG"].apply_gradients(grads["netG"]),
           "generator": states["generator"].apply_gradients(
               grads["generator"])}
    return {"loss": float(loss), "lF": float(aux["lF"]),
            "lB": float(aux["lB"]), "PF": float(aux["PF"]), "grads": grads,
            "params": {k: s.params for k, s in new.items()},
            "stats": aux["unet_vars"]["batch_stats"]}


def _leaves(tree):
    import jax
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_tree(model, state, prefix=""):
    """A rank's parameters (``state``; with ``prefix`` ``"mu."``, their
    first moments) as flax-layout trees."""
    from vwfd_tpu_torch.convert import params_to_jax
    sds = []
    for name, net in model.nets().items():
        sd = {k: state[f"{name}.{prefix}{k}"]
              for k, _ in net.named_parameters()}
        sd.update({k: state[f"{name}.{k}"] for k, _ in net.named_buffers()})
        sds.append(sd)
    netg, gen, stats = params_to_jax(*sds)
    return {"netG": netg, "generator": gen}, stats


# ------------------------------------------------------------------ tests


def _flax_form_bn(x, bn, stats=None):
    """``_bn`` with flax's batch variance in train mode (the global path's
    formula on this process's rows: the extractor's ``BatchStats(None)``
    takes this process's means)."""
    if stats is None:
        return _PLAIN_BN(x, bn)
    return unet_mod._bn_global(x, bn, stats)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results, the one-process port's and JAX's mesh
    step's, from the same weights, batches and draws."""
    import jax
    torch.set_num_threads(1)
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    inp = _inputs()
    key = jax.random.PRNGKey(5)
    draws = _jax_draws(jax.random.split(key)[0])
    torch.save({**inp, "draws": tuple(draws)},
               os.path.join(out_dir, "inputs.pt"))
    cmd = [sys.executable, os.path.abspath(__file__), "ranks", out_dir]
    with LocalRanks(cmd, WORLD, env=_ranks_env()) as ranks:
        # the references run while the ranks do
        model = _port_model(0)
        one = _run_scenarios(model, inp, draws)
        with mock.patch.object(unet_mod, "_bn", _flax_form_bn):
            one["flax_form"] = _run_scenarios(_port_model(0), inp, draws)
        ref = _jax_mesh_step(_port_model(0), inp, key)
        ranks.wait(RANKS_TIMEOUT_S)
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
           for r in range(WORLD)]
    return got, one, ref, model


def test_replicate_makes_differently_seeded_ranks_equal(world):
    got, one, _, _ = world
    assert not any(g["equal_before"] for g in got)
    for g in got:
        assert g["state0"].keys() == one["state0"].keys()
        for k, v in one["state0"].items():
            assert torch.equal(g["state0"][k], v), k  # rank 0's seed 0


def test_ranks_are_bit_equal_after_a_step(world):
    got, _, _, _ = world
    assert all(g["equal_after"] for g in got)
    assert got[0]["logs"] == got[1]["logs"]
    for k, v in got[0]["state1"].items():
        assert torch.equal(got[1]["state1"][k], v), k


def test_step_matches_the_one_process_step(world):
    got, one, _, model = world
    lr = model.cfg.train.lr
    for g in got:
        for k, v in one["logs"].items():
            assert abs(g["logs"][k] - v) <= 1e-6 * abs(v), (k, g["logs"], v)
        for k, v in one["state1"].items():
            w = g["state1"][k]
            if k.endswith(".count"):
                assert torch.equal(w, v) and int(v) == 1, k
            elif ".mu." in k or ".nu." in k:
                v = one["flax_form"]["state1"][k]
                scale = float(v.abs().max()) or 1.0
                assert float((w - v).abs().max()) <= 1e-4 * scale, k
            elif "running_" in k or "num_batches" in k:
                assert float((w - v).abs().max()) <= 1e-6, k
            else:
                assert float((w - v).abs().max()) <= 2.1 * lr, k
    # the step moved the parameters
    assert not torch.equal(one["state1"]["netG." + next(
        k for k, _ in model.inn.named_parameters())],
        one["state0"]["netG." + next(k for k, _ in
                                     model.inn.named_parameters())])


def test_step_matches_jax_mesh_step(world):
    got, _, ref, model = world
    lr, b1 = model.cfg.train.lr, model.cfg.train.beta1
    want = _leaves(ref["params"])
    want_stats = _leaves(ref["stats"])
    want_grads = _leaves(ref["grads"])
    assert len(want) > 50
    for g in got:
        for k in ("loss", "lF", "lB"):
            assert abs(g["logs"][k] - ref[k]) <= 1e-4 * abs(ref[k]), k
        assert abs(g["logs"]["PF"] - ref["PF"]) <= 1e-3
        ours = _leaves(_port_tree(model, g["state1"], "mu.")[0])
        for name, w in want_grads.items():
            scale = max(float(np.abs(w).max()), 1e-12)
            err = float(np.abs(ours[name] / (1 - b1) - w).max())
            assert err <= 1e-3 * scale, (name, err, scale)
        params, stats = _port_tree(model, g["state1"])
        ours = _leaves(params)
        assert ours.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(ours[name], w, rtol=0, atol=2.1 * lr,
                                       err_msg=name)
        ours = _leaves(stats)
        for name, w in want_stats.items():
            np.testing.assert_allclose(ours[name], w, rtol=0, atol=1e-5,
                                       err_msg=name)


def test_psnr_gate_is_global(world):
    """The first half of the batch lies far above the gate and the second
    far below: both ranks take the global PSNR's weight, as the one
    process does."""
    got, one, _, model = world
    tc = model.cfg.train
    assert tc.loss_weight_low != tc.loss_weight_high
    assert got[0]["gate_local"]["PF"] > tc.psnr_gate
    assert 0 < got[1]["gate_local"]["PF"] < tc.psnr_gate
    assert got[0]["gate"]["PF"] == got[1]["gate"]["PF"] < tc.psnr_gate
    for g in got:
        for k, v in one["gate"].items():
            assert abs(g["gate"][k] - v) <= 1e-6 * abs(v), (k, g["gate"], v)
        # lF = w_low · (the mean of the two ranks' local L1 means)
        l1 = (got[0]["gate_local"]["l1"] + got[1]["gate_local"]["l1"]) / 2
        assert abs(g["gate"]["lF"] - tc.loss_weight_low * l1) <= 1e-6 * l1


def test_inf_pixel_on_one_rank_keeps_every_state_on_both(world):
    got, _, _, _ = world
    for g in got:
        assert not np.isfinite(g["guard_loss"])
        assert g["guard_kept"]


def test_eval_step_counts_and_metrics_are_global(world):
    got, one, _, _ = world
    for g in got:
        assert torch.equal(g["eval"]["f1_sweep"], one["eval"]["f1_sweep"])
        assert torch.equal(g["eval"]["f1_best"], one["eval"]["f1_best"])
        for k in ("psnr_forward", "ssim_forward"):
            assert abs(float(g["eval"][k]) - float(one["eval"][k])) <= 1e-6, k


def test_global_batchnorm_matches_one_process_and_flax(world):
    """Two ranks' ``_bn`` (moments all-reduced differentiably) against the
    one-process ``F.batch_norm`` path on the concatenated rows and flax's
    ``BatchNorm`` on the global batch: outputs, input gradients (each
    rank's divided by the world size: the global loss's backward sums the
    ranks' cotangents once, not twice), γ's and β's gradients and the
    running statistics."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    got, one, _, _ = world
    ref = one["bn"]
    y = torch.cat([g["bn"]["y"] for g in got])
    gx = torch.cat([g["bn"]["gx"] for g in got]) / WORLD
    for name, a, b in (("y", y, ref["y"]), ("gx", gx, ref["gx"]),
                       ("gw", got[0]["bn"]["gw"], ref["gw"]),
                       ("gb", got[0]["bn"]["gb"], ref["gb"]),
                       ("mean", got[0]["bn"]["mean"], ref["mean"]),
                       ("var", got[0]["bn"]["var"], ref["var"])):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * max(scale, 1.0), name
    for k in ("gw", "gb", "mean", "var"):
        assert torch.equal(got[0]["bn"][k], got[1]["bn"][k]), k

    inp = _inputs()
    bn = torch.nn.BatchNorm2d(BN_C, eps=1e-5)
    g = torch.Generator().manual_seed(3)
    w = 1 + 0.3 * torch.randn(BN_C, generator=g)
    b = 0.2 * torch.randn(BN_C, generator=g)
    rm = torch.randn(BN_C, generator=g)
    rv = 1 + torch.rand(BN_C, generator=g)
    del bn
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                          epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(w.numpy()),
                            "bias": jnp.asarray(b.numpy())},
                 "batch_stats": {"mean": jnp.asarray(rm.numpy()),
                                 "var": jnp.asarray(rv.numpy())}}
    x = jnp.asarray(inp["bn_x"].numpy())
    cot = jnp.asarray(inp["bn_cot"].numpy())

    def f(params, x):
        out, upd = layer.apply({**variables, "params": params}, x,
                               mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd)
    (_, (jy, upd)), (jg, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], x)
    for name, a, want in (
            ("y", y, jy), ("gx", gx, jgx), ("gw", got[0]["bn"]["gw"],
                                            jg["scale"]),
            ("gb", got[0]["bn"]["gb"], jg["bias"]),
            ("mean", got[0]["bn"]["mean"], upd["batch_stats"]["mean"]),
            ("var", got[0]["bn"]["var"], upd["batch_stats"]["var"])):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(a.numpy() - want).max()) <= 1e-5 * scale, name


def test_loader_rows_are_jax_blocks_and_resume(monkeypatch):
    """Each rank's batches are JAX's ``local_batch_slice`` blocks of the
    JAX loader's global order, and ``stream(start)`` gives a resumed rank
    the batches an unbroken one sees."""
    import jax
    from vwfd_tpu import parallel as jpar
    from vwfd_tpu.data import synthetic as jsynthetic
    from vwfd_tpu.data.loader import Loader as JLoader

    ours = SyntheticVideoDataset(size=16, frames=T, length=24,
                                 mask_kind="rect")
    ref = jsynthetic.SyntheticVideoDataset(size=16, frames=T, length=24,
                                           mask_kind="rect")
    glob = [v for v, _ in JLoader(ref, B, seed=3)]
    assert len(glob) == 3
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    for r in range(WORLD):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        lo, hi = jpar.local_batch_slice(B)
        rows = parallel.local_batch_slice(B, Mesh(None, r, WORLD))
        assert rows == (lo, hi)
        got = [v for v, _ in Loader(ours, B, seed=3, rows=rows)]
        assert len(got) == len(glob)
        assert all(np.array_equal(a, g[lo:hi]) for a, g in zip(got, glob))
        unbroken = Loader(ours, B, seed=3, rows=rows).stream()
        want = [next(unbroken)[0] for _ in range(5)]
        resumed = Loader(ours, B, seed=3, rows=rows).stream(2)
        assert all(np.array_equal(next(resumed)[0], w) for w in want[2:])


def test_local_batch_slice_refuses_an_indivisible_batch():
    assert parallel.local_batch_slice(9, Mesh(None, 2, 3)) == (6, 9)
    with pytest.raises(ValueError, match="divide"):
        parallel.local_batch_slice(8, Mesh(None, 0, 3))
    with pytest.raises(ValueError):
        Loader(SyntheticVideoDataset(size=16, frames=T, length=8), 4,
               rows=(2, 6))
    # without a group: the whole batch, and the collectives are identities
    assert parallel.local_batch_slice(8) == (0, 8)
    x = torch.arange(4.0)
    assert parallel.global_mean(x, None) is x
    assert parallel.all_reduce_grads([x], None)[0] is x
    with pytest.raises(RuntimeError, match="maybe_init_distributed"):
        parallel.make_mesh()


def test_maybe_init_distributed_is_a_no_op_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.maybe_init_distributed("cpu") == 0
    assert not torch.distributed.is_initialized()
    assert parallel.process_count() == 1 and parallel.is_main_process()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert parallel.local_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("int8", [False, True])
def test_two_replica_server_equals_one_device(int8):
    """``WatermarkServer(devices=("cpu", "cpu"))``: each replica serves
    its half of every request; embed, detect and roundtrip are EQUAL to
    the one-device server on the same weights (the int8 trees too, copied
    from the first replica), a short request's padding included."""
    torch.set_num_threads(1)
    base = load_config(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, batch_size=4, frames=2,
                                       gt_size=32),
        train=dataclasses.replace(base.train, dtype="float32"))
    rng = np.random.default_rng(4)
    clip = rng.integers(0, 256, (4, 2, 32, 32, 3), dtype=np.uint8)
    kw = dict(modes=("embed", "detect", "roundtrip"))
    if int8:
        kw.update(int8_extract=True, int8_embed=True, int8_calib=clip)
    one = WatermarkServer(cfg, device="cpu", **kw)
    two = WatermarkServer(cfg, devices=("cpu", "cpu"),
                          weights=one.model.states(), **kw)
    assert len(two._replicas) == 2
    for mode in ("embed", "detect", "roundtrip"):
        for req in (clip, clip[:3]):
            a, b = one.serve(req, mode), two.serve(req, mode)
            assert a.keys() == b.keys()
            for k in a.keys():
                np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                              err_msg=f"{mode} {k}")
            if mode != "embed":
                np.testing.assert_array_equal(b.mask, a.mask)
    with pytest.raises(ValueError, match="divide"):
        WatermarkServer(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, batch_size=3)),
            devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="not both"):
        WatermarkServer(cfg, device="cpu", devices=("cpu",))


def test_dryrun_multiprocess_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "vwfd_tpu_torch.dryrun_multiprocess",
         "--procs", "2", "--device", "cpu", "--batch", "2", "--timeout",
         str(RANKS_TIMEOUT_S)], capture_output=True, text=True,
        timeout=RANKS_TIMEOUT_S + 30, env=_ranks_env(),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["procs"] == 2 and out["backend"] == "gloo"
    assert out["rows"] == [[0, 1], [1, 2]] and np.isfinite(out["loss"])


def test_dryrun_multiprocess_defaults_to_the_card():
    """Without ``--device`` the dry run takes the card (as every entry
    point does): with none here it exits non-zero naming ``--device cpu``
    and starts no rank; ``run()`` raises the same before spawning."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    from vwfd_tpu_torch import dryrun_multiprocess
    proc = subprocess.run(
        [sys.executable, "-m", "vwfd_tpu_torch.dryrun_multiprocess",
         "--procs", "2"], capture_output=True, text=True, timeout=120,
        env=_ranks_env(),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "--device cpu" in proc.stderr and "CUDA" in proc.stderr
    with mock.patch.object(dryrun_multiprocess, "LocalRanks") as ranks:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun_multiprocess.run(2)
    ranks.assert_not_called()


def test_train_cli_under_two_ranks(tmp_path):
    """``train --task video`` as ``torchrun`` starts it, two gloo ranks on
    the CPU: two steps on the global batch of 4 with a checkpoint at step 2
    written by rank 0 alone, rank 0 alone printing the JSON line (world
    size 2, the global frames/s); then ``--val --resume`` on both ranks
    from that checkpoint. (The other tasks' loops under two ranks:
    ``tests/test_torch_parallel_cli.py``.)"""
    import json

    import yaml
    cfg = yaml.safe_load(open(FLAGSHIP_CONFIG))
    cfg["model"].update(inn_down_num=2, inn_block_num=[1, 1], inn_width=16,
                        extractor_features=8)
    cfg["train"].update(dtype="float32", save_interval=2)
    (tmp_path / "small.yaml").write_text(yaml.safe_dump(cfg))
    base = [sys.executable, "-m", "vwfd_tpu_torch.train", "--synthetic",
            "--device", "cpu", "--batch", "4", "--size", "32", "--frames",
            "2", "--config", str(tmp_path / "small.yaml"), "--ckpt-dir",
            str(tmp_path / "ckpt"), "--no-telemetry"]
    outs = {}
    for name, extra in (("train", ["--steps", "2"]),
                        ("val", ["--val", "--val-batches", "2",
                                 "--resume"])):
        with LocalRanks(base + extra, WORLD, env=_ranks_env(),
                        cwd=str(tmp_path)) as ranks:
            outs[name] = ranks.wait(RANKS_TIMEOUT_S)
        assert not outs[name][1].strip()  # rank 1 prints nothing
        outs[name] = json.loads(outs[name][0].strip().splitlines()[-1])
        assert outs[name]["world_size"] == WORLD
    train, val = outs["train"], outs["val"]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2"]
    assert np.isfinite(train["loss"]) and train["batch"] == 4
    assert train["frames_per_s"] == pytest.approx(
        4 * 2 / train["ms_per_step"] * 1e3)
    assert val["resumed_step"] == 2 and 0 <= val["f1_best"] <= 1


@pytest.mark.parametrize("how", ["fails", "hangs"])
def test_a_failing_or_hanging_rank_fails_fast(how):
    """Rank 1 exits non-zero before the first collective, or never reaches
    it: the wait raises (at once, or at its own limit, well before the
    group's timeout), the other rank is killed, not left waiting, and no
    child outlives the ``with`` block."""
    cmd = [sys.executable, os.path.abspath(__file__), how]
    t0 = time.monotonic()
    with LocalRanks(cmd, WORLD, env=_ranks_env()) as ranks:
        with pytest.raises(RankFailure, match="exited 3" if how == "fails"
                           else "not done"):
            ranks.wait(20.0 if how == "fails" else 3.0)
        procs = ranks.procs
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S
    assert all(p.poll() is not None for p in procs)


def _misbehave(how):
    """Rank 1 fails or hangs; rank 0 waits in a collective."""
    rank = int(os.environ["RANK"])
    if rank == 1:
        if how == "fails":
            sys.exit(3)
        time.sleep(600)
    parallel.maybe_init_distributed("cpu", timeout_s=GROUP_TIMEOUT_S)
    parallel.barrier(parallel.make_mesh())


if __name__ == "__main__":
    if sys.argv[1] == "ranks":
        _ranks_child(sys.argv[2])
    else:
        _misbehave(sys.argv[1])
