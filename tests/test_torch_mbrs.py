"""Parity of the port's MBRS family with vwfd_tpu's, on the CPU, at a small
size: 32², 8 channels, 2 SE blocks, diffusion length 16 (a 4×4 message
map), batch 2, message 30.

Both sides start from the same weights: the JAX package's
``MBRSModel.init_states`` converted by ``convert.states_from_jax``. A
step's noise draws come from the JAX key with ``_mbrs_noise``'s split
sequence (``vwfd_tpu/models/mbrs_model.py:26-33``; the train step passes
its key to the noise unsplit).

Tolerances and why:

* the nets: outputs and BatchNorm statistics within 3e-5 of the output's
  max-abs in float32 (convolutions and reductions sum in another order;
  flax's variance is E[x²] − E[x]², PyTorch's two-pass; the decoder's
  strided SE trunk ends on a 4×4 map, where that difference reaches
  1.5e-5 of the max); the converters EQUAL both ways;
* ``jpeg_basic`` in float32: within 1e-4 outside the 8×8 blocks where a
  coefficient within rounding of a .5 boundary rounds the other way (at
  most one block a case; JAX's dense einsum DCT and the port's blockwise
  one sum in another order), the soft round's gradient within 1e-4 of its
  max;
* the draws, a train step, ``infer`` and the guard:
  ``tests/test_torch_mbrs_step.py``, in float64;
* the runner's data and messages: EQUAL to the JAX runner's.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.attacks.jpeg import jpeg_basic as jjpeg_basic
from vwfd_tpu.data import Loader as JLoader
from vwfd_tpu.data import SyntheticImageDataset as JImages
from vwfd_tpu.models.mbrs_model import MBRSModel as JMBRS
from vwfd_tpu.nets import mbrs as jnets
from vwfd_tpu_torch import run_family_convergence as runner
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.attacks import jpeg_basic
from vwfd_tpu_torch.attacks.jpeg import QUALITIES
from vwfd_tpu_torch.convert import (state_dict_from_jax, states_from_jax,
                                    states_to_jax)
from vwfd_tpu_torch.models.mbrs_model import (QUALITY_INDICES, MBRSDraws,
                                              MBRSModel, MBRSSampler)
from vwfd_tpu_torch.models.state import latest_step, restore_checkpoint
from vwfd_tpu_torch.nets import mbrs as nets

ROOT = Path(__file__).resolve().parents[1]
S, C, BL, D, L, B = 32, 8, 2, 16, 30, 2
KW = dict(image_size=S, channels=C, blocks=BL, diffusion_length=D)
LR = 1e-3


def _tool():
    spec = importlib.util.spec_from_file_location(
        "hidden_checkpoint_to_torch",
        ROOT / "port_tools" / "hidden_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()  # trees_of: a JAX model's states as numpy trees


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


def _images(seed, n=B, size=S):
    return np.stack([JImages(size=size, length=64, seed=seed)[i]
                     for i in range(n)])


def _messages(seed, n=B):
    return (np.random.default_rng(seed).random((n, L)) > 0.5).astype(
        np.float32)


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def jmodel():
    return JMBRS(**KW)


@pytest.fixture(scope="module")
def jstates(jmodel):
    return jmodel.init_states(jax.random.PRNGKey(3))


def _port(trees, **kw):
    model = MBRSModel(device="cpu", **KW, **kw)
    states_from_jax(model, trees)
    return model


# ------------------------------------------------------------------ nets

NET_RTOL = 3e-5


def _net_cases():
    """(name, flax module, port module, flax inputs)."""
    x3 = _images(1)
    x8 = np.random.default_rng(2).standard_normal((B, 8, 8, C)).astype(
        np.float32)
    msg = _messages(1)
    return {
        "se_identity": (jnets.SEBottleneck(C), nets.SEBottleneck(C, C),
                        (x8,)),
        "se_strided": (jnets.SEBottleneck(2 * C, stride=2),
                       nets.SEBottleneck(C, 2 * C, stride=2), (x8,)),
        "senet": (jnets.SENet(C, BL), nets.SENet(C, C, BL), (x8,)),
        "senet_decoder": (jnets.SENetDecoder(C, 3),
                          nets.SENetDecoder(C, C, 3), (x8,)),
        "expand": (jnets.ExpandNet(C, 2), nets.ExpandNet(C, C, 2), (x8,)),
        "encoder": (jnets.MBRSEncoder(S, L, C, BL, D),
                    nets.MBRSEncoder(S, L, C, BL, D), (x3, msg)),
        "decoder": (jnets.MBRSDecoder(S, L, C, D),
                    nets.MBRSDecoder(S, L, C, D), (x3,)),
        "plain_decoder": (jnets.MBRSPlainDecoder(4, C),
                          nets.MBRSPlainDecoder(4, C), (x3,)),
    }


_NET_CASES = _net_cases()


def _perturbed(stats, rng):
    """Running statistics other than the identity."""
    return jax.tree_util.tree_map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32)
        if a.ndim else a, jax.tree_util.tree_map(np.asarray, stats))


def _load(port, v):
    sd = state_dict_from_jax(v["params"], v.get("batch_stats"))
    own = port.state_dict()
    sd.update({k: t for k, t in own.items()
               if k.endswith("num_batches_tracked")})
    port.load_state_dict(sd)


def _stats_by_path(port, stats):
    """A train-mode forward's statistics as flax's flat paths."""
    names = {id(m): n for n, m in port.named_modules()}
    return {names[id(bn)]: v for bn, v in stats.items()}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(_NET_CASES))
def test_nets_match_flax(name, train):
    """Each MBRS module forward in eval mode (on perturbed running
    statistics) and in train mode (outputs and the updated running
    statistics), on the same weights."""
    jnet, port, args = _NET_CASES[name]
    v = jax.tree_util.tree_map(np.asarray,
                               jnet.init(jax.random.PRNGKey(4), *args))
    v = {"params": v["params"],
         "batch_stats": _perturbed(v["batch_stats"],
                                   np.random.default_rng(5))}
    _load(port, v)
    targs = [torch.from_numpy(a) for a in args]
    if not train:
        want = jnet.apply(v, *args, train=False)
        got = port(*targs) if isinstance(port, nets.FlaxNet) else port(
            *targs, None)
        _close(_np(got), want, NET_RTOL, f"{name} eval")
        return
    want, new = jnet.apply(v, *args, train=True, mutable=["batch_stats"])
    if isinstance(port, nets.FlaxNet):
        got, stats = port(*targs, train=True)
    else:
        stats = {}
        got = port(*targs, stats)
    _close(_np(got), want, NET_RTOL, f"{name} train")
    flat = {jax.tree_util.keystr(p[:-1]).replace("']['", ".").strip("[']"):
            None for p, _ in jax.tree_util.tree_leaves_with_path(
                new["batch_stats"])}
    got_stats = _stats_by_path(port, stats)
    assert set(got_stats) == set(flat)
    for path, (mean, var) in got_stats.items():
        node = new["batch_stats"]
        for k in path.split("."):
            node = node[k]
        _close(_np(mean), node["mean"], NET_RTOL, f"{name} {path} mean")
        _close(_np(var), node["var"], NET_RTOL, f"{name} {path} var")


@pytest.mark.parametrize("name", ["prep", "hiding", "reveal"])
def test_baluja_nets_match_flax(name):
    """The Baluja trio, 3×3 / 4×4 / 5×5 'SAME' branches (the 4×4 padded 1
    before and 2 after), at 4 features."""
    rng = np.random.default_rng(6)
    jnet, port, cin = {
        "prep": (jnets.BalujaPrep(4), nets.BalujaPrep(3, 4), 3),
        "hiding": (jnets.BalujaHiding(4), nets.BalujaHiding(15, 4), 15),
        "reveal": (jnets.BalujaReveal(4), nets.BalujaReveal(3, 4), 3)}[name]
    x = rng.random((B, 16, 16, cin)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray,
                               jnet.init(jax.random.PRNGKey(7), x))
    _load(port, v)
    _close(_np(port(torch.from_numpy(x))), jnet.apply(v, x), NET_RTOL, name)


def test_init_params_draws_flax_distributions():
    """``init_params``: zero biases, identity BatchNorm, and each weight's
    spread that of flax's initialiser (kaiming inside ConvBNRelu, lecun
    elsewhere, fan-in of a transposed conv its Cin·k²) within 15 %."""
    enc = nets.MBRSEncoder(128, L, 64, 4, 256)
    enc.init_params(torch.Generator().manual_seed(0))
    for name, t in (("image_pre.Conv_0.weight", 2 / 27),
                    ("image_first.block0.Conv_1.weight", 1 / 576),
                    ("message_expand.up1.weight", 1 / 256),
                    ("message_duplicate.weight", 1 / 30),
                    ("final.weight", 1 / 67)):
        w = enc.get_parameter(name)
        assert abs(float(w.detach().std()) ** 2 / t - 1) < 0.15, name
    for n, p in enc.named_parameters():
        if n.endswith("bias"):
            assert not bool(p.any()), n
    assert all(float(b.running_var.min()) == 1.0 for b in enc.modules()
               if isinstance(b, torch.nn.BatchNorm2d))


# --------------------------------------------------------- the converters

def test_converters_round_trip_and_convtranspose_flip(jstates):
    """JAX trees → the port → JAX trees is EQUAL (params, batch stats, Adam
    state); the ExpandNet's ``message_expand.up{i}`` take flax's spatial
    flip (F3: ``convert._CONVT`` matches their names)."""
    trees = TOOL.trees_of(jstates)
    port = _port(trees)
    back = states_to_jax(port)
    for name in trees:
        for key in ("params", "batch_stats", "mu", "nu"):
            a = jax.tree_util.tree_leaves_with_path(trees[name][key])
            b = jax.tree_util.tree_leaves_with_path(back[name][key])
            assert [p for p, _ in a] == [p for p, _ in b], (name, key)
            for (p, x), (_, y) in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f"{name}{p}")
        assert int(back[name]["count"]) == int(trees[name]["count"])
    for i in range(3):
        k = trees["encoder"]["params"]["message_expand"][f"up{i}"]["kernel"]
        w = _np(port.encoder.message_expand.get_parameter(f"up{i}.weight"))
        np.testing.assert_array_equal(w, k[::-1, ::-1].transpose(2, 3, 0, 1))
        assert not np.array_equal(w, k.transpose(2, 3, 0, 1))
    fresh = MBRSModel(device="cpu", **KW)
    fresh.init_states(9)
    states_from_jax(fresh, back)
    for a, b in zip([t for n in port.nets() for t in port._tensors(n)],
                    [t for n in fresh.nets() for t in fresh._tensors(n)]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- jpeg_basic

def _flipped_blocks(got, want, atol):
    n, h, w, c = got.shape
    d = np.abs(got - want).reshape(n, h // 8, 8, w // 8, 8, c)
    return int((d.max(axis=(2, 4, 5)) > atol).sum())


def _jax_scale(q):
    """``_mbrs_noise``'s float32 table scale of quality ``q``."""
    q = jnp.float32(q)
    return jnp.where(q >= 50, 2.0 - q * 0.02, 50.0 / q)


@pytest.mark.parametrize("q_idx", QUALITY_INDICES)
@pytest.mark.parametrize("rounding", ["round", "ss"])
def test_jpeg_basic_matches_jax(rounding, q_idx):
    """Each rounding at each of MBRS's qualities in float32, and for the
    soft round its input gradient."""
    x = np.random.default_rng(8 + q_idx).random((B, S, S, 3)).astype(
        np.float32)
    scale = _jax_scale(QUALITIES[q_idx])
    want = np.asarray(jjpeg_basic(jnp.asarray(x), scale_factor=scale,
                                  rounding=rounding))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = jpeg_basic(xt, torch.tensor(q_idx), rounding)
    assert _flipped_blocks(_np(got), want, 1e-4) <= 1
    assert np.abs(_np(got) - want).max() <= 1.0
    if rounding == "ss":
        cot = np.random.default_rng(9).standard_normal(x.shape).astype(
            np.float32)
        _, vjp = jax.vjp(lambda v: jjpeg_basic(v, scale_factor=scale,
                                               rounding="ss"),
                         jnp.asarray(x))
        gw = np.asarray(vjp(jnp.asarray(cot))[0])
        gg = _np(torch.autograd.grad(got, xt, torch.from_numpy(cot))[0])
        assert _flipped_blocks(gg, gw, 1e-4 * np.abs(gw).max()) <= 1


def test_jpeg_basic_refuses_what_is_not_ported():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="subsample"):  # 4:2:0 is ported
        jpeg_basic(x, 0, subsample=1)
    with pytest.raises(ValueError):
        jpeg_basic(x, 0, "floor")


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_jpeg_basic_nonfinite_footprint_f21(bad):
    """F21 for ``jpeg_basic``: a NaN or Inf value in image 0 makes the
    port's output NaN on exactly its 8×8 block × 3 channels (blockwise DCT,
    as K5) and JAX's on the whole image (dense block-diagonal
    ``dct8x8``); image 1 agrees with JAX as above."""
    x = np.random.default_rng(10).random((B, 16, 24, 3)).astype(np.float32)
    x[0, 3, 9, 2] = bad
    got = _np(jpeg_basic(torch.from_numpy(x), torch.tensor(2), "ss"))
    want = np.asarray(jjpeg_basic(jnp.asarray(x), scale_factor=_jax_scale(70),
                                  rounding="ss"))
    block = np.zeros(x.shape, bool)
    block[0, 0:8, 8:16] = True
    np.testing.assert_array_equal(np.isnan(got), block)
    assert np.isnan(want[0]).all() and np.isfinite(want[1]).all()
    assert _flipped_blocks(got[1:], want[1:], 1e-4) <= 1


# ------------------------------------------------------------ the sampler

def test_sampler_draws_every_pair_and_replays():
    """``MBRSSampler`` is seeded, covers the 9 (mode, quality) pairs
    uniformly (each within 40 % of 1/9 over 900 draws) and only at
    MBRS's qualities."""
    a, b, c = MBRSSampler(3), MBRSSampler(3), MBRSSampler(4)
    a = [a() for _ in range(900)]
    assert a == [b() for _ in range(900)]
    assert a != [c() for _ in range(900)]
    counts = {}
    for d in a:
        counts[d] = counts.get(d, 0) + 1
    assert set(counts) == {MBRSDraws(m, q) for m in range(3)
                           for q in QUALITY_INDICES}
    assert all(abs(c / 100 - 1) < 0.4 for c in counts.values())


# ----------------------------------------------------- runner and trainer

def test_runner_data_and_messages_are_jax_runners():
    """The runner's first three batches and messages EQUAL the JAX
    runner's (``SyntheticImageDataset(size, 2000, 10)``, ``Loader(...,
    seed=10, ratio=200)``, ``default_rng(10)``), and so are its held-out
    images and messages."""
    model = MBRSModel(device="cpu", **KW)
    streams = runner.MBRSStreams(model, B, 0)
    jl = iter(JLoader(JImages(size=S, length=2000, seed=10), B, seed=10,
                      ratio=200))
    rng = np.random.default_rng(10)
    for _ in range(3):
        imgs, msgs, _ = next(streams)
        np.testing.assert_array_equal(imgs, next(jl))
        np.testing.assert_array_equal(
            msgs, (rng.random((B, L)) > 0.5).astype(np.float32))
    held = JImages(size=S, length=16, seed=10 + 7777)
    imgs, msgs = runner.eval_set(S, 16, L)
    np.testing.assert_array_equal(imgs, np.stack([held[i]
                                                  for i in range(16)]))
    np.testing.assert_array_equal(msgs, (np.random.default_rng(7777).random(
        (16, L)) > 0.5).astype(np.float32))


def _run(tmp_path, *extra, on_step=None):
    args = runner.parse_args([
        "--task", "mbrs", "--steps", "4", "--eval-every", "2",
        "--log-every", "1", "--size", str(S), "--batch", str(B),
        "--eval-batch", "2", "--device", "cpu",
        "--out", str(tmp_path / "run.jsonl"),
        "--ckpt-dir", str(tmp_path / "ckpt"), *extra])
    return runner.run(args, on_step)


def test_runner_resumed_is_the_unbroken_run(tmp_path, monkeypatch):
    """4 steps unbroken and 2 + 2 with ``--resume``: each step's images,
    messages and draws EQUAL, the final states EQUAL, the records finite
    (libjpeg through a stand-in codec: PIL is not needed here)."""
    monkeypatch.setattr(runner, "jpeg_real", lambda x, q: x * 0.5 + 0.25)
    monkeypatch.setattr(runner, "MBRSModel", functools.partial(
        MBRSModel, channels=C, blocks=BL, diffusion_length=D))
    seen = {}

    def log(tag):
        return lambda step, i, m, d: seen.setdefault(tag, {}).__setitem__(
            step, (i, m, d))
    a, b = tmp_path / "a", tmp_path / "b"
    assert _run(a, on_step=log("a")) == "done"
    assert _run(b, "--stop-at-step", "2", on_step=log("b")) == "stopped"
    assert _run(b, "--resume", on_step=log("b")) == "done"
    assert sorted(seen["b"]) == [1, 2, 3, 4]
    for s in range(1, 5):
        (ia, ma, da), (ib, mb, db) = seen["a"][s], seen["b"][s]
        assert np.array_equal(ia, ib) and np.array_equal(ma, mb) and da == db
    recs = [json.loads(x) for x in open(b / "run.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    evals = [r for r in recs if r.get("eval")]
    assert [r["step"] for r in evals] == [2, 4]
    assert all(np.isfinite(v) for r in recs for v in r.values()
               if isinstance(v, float))
    assert recs[0]["lr"] == LR and recs[-1]["done"]
    ma, mb = (MBRSModel(device="cpu", **KW) for _ in range(2))
    for m, d in ((ma, a), (mb, b)):
        restore_checkpoint(str(d / "ckpt"), latest_step(str(d / "ckpt")), m)
    for x, y in zip([t for n in ma.nets() for t in ma._tensors(n)],
                    [t for n in mb.nets() for t in mb._tensors(n)]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("task", ["kdjpeg"])
def test_runner_other_tasks_name_their_roadmap_item(task, tmp_path):
    """The runner's last unported task, KD-JPEG, is ported: every task of
    the JAX runner parses, at its geometry (KD-JPEG 256², b6, 8 held-out
    images); tests/test_torch_kdjpeg_step.py runs it."""
    args = runner.parse_args(["--task", task, "--device", "cpu"])
    assert (args.size, args.batch, args.eval_batch) == (256, 6, 8)
    assert set(runner.DEFAULTS) == {"pami", "clr", "imuge", "kdjpeg",
                                    "tianchi", "mbrs"}


def test_train_cli_task_mbrs(tmp_path, capsys, monkeypatch):
    """``train --task mbrs --synthetic`` on the CPU: one JSON line with
    finite logs."""
    monkeypatch.setattr(train_cli, "MBRSModel", functools.partial(
        MBRSModel, channels=C, blocks=BL, diffusion_length=D))
    train_cli.main(["--task", "mbrs", "--synthetic", "--steps", "2",
                    "--device", "cpu", "--batch", str(B), "--size", str(S),
                    "--no-telemetry", "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and out["device"] == "cpu"
    for k in ("loss", "encoder_mse", "message_mse", "bitwise_error",
              "ms_per_step", "images_per_s"):
        assert np.isfinite(out[k]), k
