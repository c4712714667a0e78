"""Parity of the port's HiDDeN family with vwfd_tpu's, on the CPU in float32,
at the published widths (message 30, 64 channels, 4 / 7 / 3 blocks) and
small images (32², b2; 64² for the trained checkpoint).

Both sides start from the same weights: the JAX package's
``HiddenModel.init_states`` (or a committed orbax checkpoint), converted
by ``convert.states_from_jax``. A train step's noise draws are derived
from the JAX key with the JAX code's split sequence
(``vwfd_tpu/models/hidden_model.py:57-64`` and each member's own), for keys
whose JAX draw selects each member.

Tolerances and why:

* ConvBNRelu and the three nets: outputs and BatchNorm statistics within
  2e-5 of the output's max-abs (float32 convolutions and reductions sum in
  another order; flax's variance is E[x²] − E[x]², PyTorch's two-pass);
* the converters: EQUAL both ways; Adam: bit-equal to ``optax.adam``;
* a train step: both sides in float64 (the port's nets ``.double()``,
  the JAX package's ``train_step`` under ``jax.enable_x64`` with the
  member's float32 draws bound), because the step is ill-conditioned in
  float32 at these sizes: a 1e-6 relative change of the decoder's input
  moves the decoder's gradients by up to 0.65 % of their max (measured in
  float64), so two float32 implementations part by about 1 % (JAX's own
  float32 gradients are that far from its float64 ones). Then
  ``tests/test_torch_train.py``'s tolerances: loss terms within 1e-4
  relative (``bitwise_error``: the same count of wrong bits); every gradient tensor within 1e-3 of
  its own max-abs (JAX's gradient read from its first Adam moment,
  ``0.1·g``), a conv bias in front of a BatchNorm, whose gradient is 0 but
  for rounding, within 1e-6 of its net's largest; updated parameters
  within 2.1·lr (Adam's first step moves each entry by about lr·sign(g));
  BatchNorm statistics within 1e-5; second moments within 1e-3 of their
  max;
* ``infer`` on the trained step-23,000 checkpoint at 64²: encoded within
  1e-5, decoded logits within 1e-4, decoded bits EQUAL.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vwfd_tpu.attacks import hidden_jpeg_mask_compression as jjpeg
from vwfd_tpu.attacks import spatial as jspatial
from vwfd_tpu.data import SyntheticImageDataset as JImages
from vwfd_tpu.data.images import ImageFolderDataset as JFolder
from vwfd_tpu.metrics import bitwise_message_error as jbitwise
from vwfd_tpu.models.hidden_model import HiddenModel as JHidden
from vwfd_tpu.nets.hidden import HiddenEncoderDecoder as JEncDec
from vwfd_tpu.nets.blocks import ConvBNRelu as JConvBNRelu
from vwfd_tpu.ops import resize as jresize
from vwfd_tpu_torch import continue_hidden, eval_hidden
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.convert import (opt_state_to_jax, state_dict_from_jax,
                                    states_from_jax, states_to_jax)
from vwfd_tpu_torch.data import (ImageFolderDataset, SyntheticImageDataset,
                                 cv2_readers)
from vwfd_tpu_torch.kernels import PLAIN
from vwfd_tpu_torch.kernels.zigzag import zigzag_jpeg_plain
from vwfd_tpu_torch.metrics import bitwise_message_error
from vwfd_tpu_torch.models.hidden_model import (NOISE_POOL, HiddenDraws,
                                                HiddenModel, HiddenSampler,
                                                apply_noise)
from vwfd_tpu_torch.models.state import (AdamW, load_nets, restore_checkpoint,
                                         save_checkpoint)
from vwfd_tpu_torch.nets import ConvBNRelu, HiddenEncoderDecoder

ROOT = Path(__file__).resolve().parents[1]
B, S, L = 2, 32, 30
LR = 1e-3


def _tool():
    spec = importlib.util.spec_from_file_location(
        "hidden_checkpoint_to_torch",
        ROOT / "port_tools" / "hidden_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


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
    return JHidden(image_size=S)


@pytest.fixture(scope="module")
def jstates(jmodel):
    return jmodel.init_states(jax.random.PRNGKey(3))


def _port(trees, size=S, **kw):
    model = HiddenModel(image_size=size, device="cpu", **kw)
    states_from_jax(model, trees)
    return model


@pytest.mark.parametrize("train", [False, True])
def test_conv_bn_relu_matches_flax(train):
    x = _images(1)
    block = JConvBNRelu(64)
    v = block.init(jax.random.PRNGKey(0), x)
    stats = {"BatchNorm_0": {"mean": np.linspace(-.2, .2, 64, dtype=np.float32),
                             "var": np.linspace(.5, 2, 64, dtype=np.float32)}}
    jv = {"params": v["params"], "batch_stats": stats}
    port = ConvBNRelu(3, 64)
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"]), stats),
        strict=False)
    if train:
        want, new = block.apply(jv, x, True, mutable=["batch_stats"])
        got_stats = {}
        got = port(torch.from_numpy(x), got_stats)
        (mean, var), = got_stats.values()
        _close(_np(mean), new["batch_stats"]["BatchNorm_0"]["mean"], 2e-5,
               "mean")
        _close(_np(var), new["batch_stats"]["BatchNorm_0"]["var"], 2e-5,
               "var")
    else:
        want = block.apply(jv, x, False)
        got = port(torch.from_numpy(x))
    _close(_np(got), want, 2e-5, "output")


def _apply(jmodel, jstates, name, train, *args):
    net = {"encoder": jmodel.encoder, "decoder": jmodel.decoder,
           "discriminator": jmodel.discriminator}[name]
    s = jstates[name]
    return net.apply({"params": s.params, **s.variables}, *args, train=train,
                     mutable=["batch_stats"] if train else False)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["encoder", "decoder", "discriminator"])
def test_hidden_nets_match_flax(jmodel, jstates, name, train):
    """Each net in train mode (outputs and the new running statistics) and
    in eval mode (on perturbed running statistics)."""
    trees = TOOL.trees_of(jstates)
    rng = np.random.default_rng(4)
    for bn in trees[name]["batch_stats"].values():  # not the identity
        st = bn["BatchNorm_0"]
        st["mean"] = (0.1 * rng.standard_normal(st["mean"].shape)).astype(
            np.float32)
        st["var"] = (0.5 + rng.random(st["var"].shape)).astype(np.float32)
    js = dict(jstates)
    js[name] = js[name].replace(variables={"batch_stats": trees[name][
        "batch_stats"]})
    port = _port(trees)
    x, msg = _images(5), _messages(5)
    args = (x, msg) if name == "encoder" else (x,)
    targs = [torch.from_numpy(a) for a in args]
    net = port.nets()[name]
    if train:
        want, new = _apply(jmodel, js, name, True, *args)
        got, stats = net(*targs, train=True)
        net.load_stats(stats)
        _, got_stats = states_to_jax(port, optimizer=False)[name].values()
        for (path, w), g in zip(
                jax.tree_util.tree_leaves_with_path(new["batch_stats"]),
                jax.tree_util.tree_leaves(got_stats)):
            _close(g, w, 2e-5, f"{name} {path}")
    else:
        want = _apply(jmodel, js, name, False, *args)
        got = net(*targs)
    _close(_np(got), want, 2e-5, f"{name} train={train}")


def test_encoder_decoder_pipeline_matches_flax():
    """``HiddenEncoderDecoder`` (encode → noise → decode) in eval mode with
    the zig-zag JPEG as its noiser, against flax's on the same tree."""
    x, msg = _images(6), _messages(6)
    jnet = JEncDec()
    v = jnet.init(jax.random.PRNGKey(2), x, msg)
    v = jax.tree_util.tree_map(np.asarray, v)
    port = HiddenEncoderDecoder()
    port.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    want = jnet.apply(v, x, msg, lambda k, e, c: jjpeg(e), train=False)
    got = port(torch.from_numpy(x), torch.from_numpy(msg),
               lambda e, c: zigzag_jpeg_plain(e))
    for g, w, what in zip(got, want, ("encoded", "noised", "decoded")):
        _close(_np(g), w, 2e-5, what)


def test_converters_round_trip(jstates):
    """JAX trees → the port → JAX trees is EQUAL, params, batch stats and
    Adam state, and so is the port → JAX → a fresh port."""
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
    fresh = HiddenModel(image_size=S, device="cpu")
    fresh.init_states(9)
    states_from_jax(fresh, back)
    for a, b in zip([t for n in port.nets() for t in port._tensors(n)],
                    [t for n in fresh.nets() for t in fresh._tensors(n)]):
        assert torch.equal(a, b)


def test_adam_is_bit_equal_to_optax():
    """``AdamW(clip=None, weight_decay=0)`` and ``optax.adam(1e-3)`` from
    the same parameters and gradients, three steps: EQUAL."""
    rng = np.random.default_rng(6)
    shapes = [(64, 3, 3, 3), (64,), (30, 30)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = optax.adam(LR)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = AdamW(tp, LR, weight_decay=0.0, clip=None)
    for _ in range(3):
        gs = [(0.1 * rng.standard_normal(s)).astype(np.float32)
              for s in shapes]
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g) for g in gs])
    for ours, ref in zip(tp + opt.mu + opt.nu,
                         list(jp) + list(st[0].mu) + list(st[0].nu)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int(opt.count) == int(st[0].count) == 3


def _member_keys():
    """For each member, a key whose JAX train step draws it: ``k_noise, _
    = split(key)``, ``k_sel, k = split(k_noise)``, ``randint(k_sel, (), 0,
    6)`` (the uniform pool)."""
    found = {}
    i = 0
    while len(found) < len(NOISE_POOL):
        key = jax.random.PRNGKey(1000 + i)
        k_noise, _ = jax.random.split(key)
        k_sel, k = jax.random.split(k_noise)
        idx = int(jax.random.randint(k_sel, (), 0, len(NOISE_POOL)))
        found.setdefault(NOISE_POOL[idx], (key, k))
        i += 1
    return found


def _t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def jax_member_draws(member, k, shape):
    """The draws the JAX member takes from its key ``k``."""
    if member == "crop":  # sample_crop_apex: split(k, 4)
        return HiddenDraws(member, _t32([np.asarray(jax.random.uniform(kk))
                                         for kk in jax.random.split(k, 4)]))
    if member == "cropout":  # k and fold_in(k, 1)
        return HiddenDraws(member, _t32([
            np.asarray(jax.random.uniform(k)),
            np.asarray(jax.random.uniform(jax.random.fold_in(k, 1)))]))
    if member == "dropout":  # k1, k2 = split(k)
        k1, k2 = jax.random.split(k)
        return HiddenDraws(member, _t32(np.asarray(jax.random.uniform(k1))),
                           _t32(np.asarray(jax.random.uniform(
                               k2, shape[1:3]))))
    if member == "gaussian":
        return HiddenDraws(member, None, _t32(np.asarray(
            jax.random.normal(k, shape, jnp.float32))))
    return HiddenDraws(member)


def jax_noiser(member, k, shape):
    """The JAX member as a ``(key, encoded, cover)`` noiser with its float32
    draws from ``k`` bound (under ``jax.enable_x64`` a key draws other,
    64-bit numbers): the JAX package's own functions where they take the
    draws, their three lines where only the key goes in."""
    hw = shape[1:3]
    if member == "identity":
        return lambda _, e, c: e
    if member == "jpeg_mask":
        return lambda _, e, c: jnp.clip(jjpeg(e), 0.0, 1.0)
    if member == "crop":
        apex = [np.float64(a) for a in jspatial.sample_crop_apex(
            k, hw, 0.55, 1.0)]
        return lambda _, e, c: jresize.crop_resize(e, apex)
    d = jax_member_draws(member, k, shape)
    if member == "cropout":  # spatial.py:89-98
        h0 = np.floor(np.float32(d.u[0]) * np.float32(hw[0] * 0.5))
        w0 = np.floor(np.float32(d.u[1]) * np.float32(hw[1] * 0.5))
        m = np.asarray(jspatial.rect_mask(hw, (h0, h0 + hw[0] * 0.5, w0,
                                               w0 + hw[1] * 0.5)))[..., None]
    elif member == "dropout":  # spatial.py:101-108
        keep = np.maximum(np.float32(0.5), np.float32(d.u) * np.float32(0.5)
                          + np.float32(0.5))
        m = (d.field.numpy() < keep).astype(np.float64)[..., None]
    else:  # gaussian, noise.py:14-17
        noise = d.field.numpy().astype(np.float64)
        return lambda _, e, c: jnp.clip(e + 0.0 + 0.05 * noise, 0.0, 1.0)
    m = m.astype(np.float64)
    return lambda _, e, c: e * m + c * (1 - m)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


_KEYS = _member_keys()
_LOG_TERMS = ("loss", "encoder_mse", "dec_mse", "adversarial_bce",
              "discr_cover_bce", "discr_encod_bce")


# train step, both sides in float64
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
PARAM_ATOL = 2.1 * LR
STATS_ATOL = 1e-5


def _grad_close(got, want, net_max, what):
    """Within ``GRAD_REL`` of the tensor's max-abs; a conv bias in front of
    a BatchNorm has no gradient (the batch mean takes it out), so its
    rounding noise is held to ``GRAD_REL``·1e-3 of the net's largest."""
    scale = max(float(np.abs(want).max()), 1e-3 * net_max)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * scale,
                               err_msg=what)


@pytest.fixture
def f64_default():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _port64(trees):
    """The port's model in float64, from ``trees``."""
    model = _port(trees)
    for net in model.nets().values():
        net.double()
    model.optimizers = model._adam()
    states_from_jax(model, trees)
    return model


@pytest.mark.parametrize("member", NOISE_POOL)
def test_train_step_matches_jax(jstates, member, f64_default):
    """One train step per member, both sides in float64 from the same
    weights and draws: loss terms, every gradient, the updated params,
    BatchNorm statistics and Adam moments of the three nets."""
    key, k = _KEYS[member]
    images, msgs = _images(7), _messages(7)
    trees = TOOL.trees_of(jstates)
    jm = JHidden(image_size=S, noiser=jax_noiser(member, k, images.shape))
    with jax.enable_x64(True):
        new, jlogs = jm.train_step(_f64(jstates), jnp.asarray(images, float),
                                   jnp.asarray(msgs, float), key)
        want = TOOL.trees_of(new)
        jlogs = {t: float(v) for t, v in jlogs.items()}
    port = _port64(trees)
    grads = {}
    logs = port.train_step(images, msgs,
                           jax_member_draws(member, k, images.shape), grads)
    for term in _LOG_TERMS:
        np.testing.assert_allclose(float(logs[term]), jlogs[term],
                                   rtol=LOSS_RTOL, err_msg=term)
    assert round(float(logs["bitwise_error"]) * B * L) == round(
        jlogs["bitwise_error"] * B * L)  # the same bits wrong
    got = states_to_jax(port)
    for name in want:
        # JAX's gradient from its first moment: mu = 0.1·g from mu = 0
        g_tree = opt_state_to_jax(port.nets()[name], grads[name],
                                  grads[name], 0)[0]
        mus = jax.tree_util.tree_leaves_with_path(want[name]["mu"])
        assert len(mus) == len(grads[name])
        net_max = max(float(np.abs(w).max()) for _, w in mus)
        for (path, w), g, m, p, wp in zip(
                mus, jax.tree_util.tree_leaves(g_tree),
                jax.tree_util.tree_leaves(got[name]["mu"]),
                jax.tree_util.tree_leaves(got[name]["params"]),
                jax.tree_util.tree_leaves(want[name]["params"])):
            what = f"{member} {name}{jax.tree_util.keystr(path)}"
            _grad_close(0.1 * g, w, net_max, f"gradient {what}")
            _grad_close(m, w, net_max, f"mu {what}")
            np.testing.assert_allclose(p, wp, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"param {what}")
        nus = jax.tree_util.tree_leaves(want[name]["nu"])
        nu_max = max(float(np.abs(w).max()) for w in nus)
        for w, g in zip(nus, jax.tree_util.tree_leaves(got[name]["nu"])):
            # ν ~ g²: the conv biases' floor squared
            scale = max(float(np.abs(w).max()), 1e-6 * nu_max)
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * scale,
                                       err_msg=f"{member} {name} nu")
        for w, g in zip(jax.tree_util.tree_leaves(want[name]["batch_stats"]),
                        jax.tree_util.tree_leaves(got[name]["batch_stats"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL,
                                       err_msg=f"{member} {name} stats")
        assert int(got[name]["count"]) == int(want[name]["count"]) == 1


def test_guard_keeps_every_tensor_on_a_nan_batch(jmodel, jstates):
    """A NaN pixel: every parameter, BatchNorm statistic, Adam moment and
    count of the three nets keeps its value, as in JAX."""
    images, msgs = _images(8), _messages(8)
    images[1, 3, 4, 2] = np.nan
    port = _port(TOOL.trees_of(jstates))
    before = [t.clone() for n in port.nets() for t in port._tensors(n)]
    logs = port.train_step(images, msgs, HiddenDraws("identity"))
    assert not np.isfinite(float(logs["loss"]))
    after = [t for n in port.nets() for t in port._tensors(n)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    key, _ = _KEYS["identity"]
    new, _ = jmodel.train_step(jax.tree_util.tree_map(jnp.array, jstates),
                               jnp.asarray(images), jnp.asarray(msgs), key)
    for a, b in zip(jax.tree_util.tree_leaves(TOOL.trees_of(new)),
                    jax.tree_util.tree_leaves(TOOL.trees_of(jstates))):
        np.testing.assert_array_equal(a, b)


def test_guard_keeps_every_tensor_on_an_inf_pixel_through_jpeg_mask(
        jmodel, jstates):
    """F21 at the caller: one Inf pixel in one image on the jpeg_mask
    member, whose NaN footprint is the pixel's 8×8 block in the port and
    the whole image in JAX. Both report a non-finite loss and keep every
    parameter, BatchNorm statistic, Adam moment and count of the three
    nets: no caller sees the difference."""
    images, msgs = _images(9), _messages(9)
    images[0, 5, 6, 1] = np.inf
    port = _port(TOOL.trees_of(jstates))
    before = [t.clone() for n in port.nets() for t in port._tensors(n)]
    logs = port.train_step(images, msgs, HiddenDraws("jpeg_mask"))
    assert not np.isfinite(float(logs["loss"]))
    after = [t for n in port.nets() for t in port._tensors(n)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    key, _ = _KEYS["jpeg_mask"]
    new, jlogs = jmodel.train_step(
        jax.tree_util.tree_map(jnp.array, jstates), jnp.asarray(images),
        jnp.asarray(msgs), key)
    assert not np.isfinite(float(jlogs["loss"]))
    for a, b in zip(jax.tree_util.tree_leaves(TOOL.trees_of(new)),
                    jax.tree_util.tree_leaves(TOOL.trees_of(jstates))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def trained():
    """The committed step-23,000 orbax checkpoint, converted in-test."""
    return TOOL.jax_trees(str(ROOT / "checkpoints_hidden_r5"), 23000)


def test_infer_on_the_trained_checkpoint_matches_jax(trained):
    """64², 2 images of the eval set: encoded within 1e-5, decoded logits
    within 1e-4 and bits EQUAL, for the members that draw nothing."""
    size = 64
    jm = JHidden(image_size=size)
    js = jm.init_states(jax.random.PRNGKey(0))
    js = {n: s.replace(params=trained[n]["params"],
                       variables={"batch_stats": trained[n]["batch_stats"]})
          for n, s in js.items()}
    port = _port({n: {k: t[k] for k in ("params", "batch_stats")}
                  for n, t in trained.items()}, size=size)
    imgs = _images(123, 2, size)
    msgs = _messages(0, 2)
    enc = jax.jit(lambda i, m: jm.encoder.apply(
        {"params": js["encoder"].params, **js["encoder"].variables}, i, m,
        train=False))(imgs, msgs)
    dec_fn = jax.jit(lambda x: jm.decoder.apply(
        {"params": js["decoder"].params, **js["decoder"].variables}, x,
        train=False))
    noisers = {"identity": lambda e: e,
               "jpeg_mask": lambda e: jnp.clip(jjpeg(e), 0.0, 1.0)}
    for member, noise in noisers.items():
        want = np.asarray(dec_fn(jax.jit(noise)(enc)))
        penc, _, pdec = port.infer(imgs, msgs, HiddenDraws(member))
        np.testing.assert_allclose(_np(penc), np.asarray(enc), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(pdec), want, rtol=0, atol=1e-4,
                                   err_msg=member)
        np.testing.assert_array_equal(np.round(np.clip(_np(pdec), 0, 1)),
                                      np.round(np.clip(want, 0, 1)))
        assert float(bitwise_message_error(pdec, torch.from_numpy(msgs))) \
            == pytest.approx(float(jbitwise(want, msgs)))


def test_committed_conversions_equal_the_orbax_steps(trained):
    """``checkpoints_hidden_r5_torch/23000`` holds the nets of the orbax
    step 23,000; ``checkpoints_hidden_torch/15000`` the whole state of step
    15,000, Adam included (``port_tools/hidden_checkpoint_to_torch.py``)."""
    model = HiddenModel(image_size=128, device="cpu")
    model.load_states(load_nets(str(ROOT / "checkpoints_hidden_r5_torch"),
                                23000))
    got = states_to_jax(model, optimizer=False)
    for n in trained:
        for k in ("params", "batch_stats"):
            for a, b in zip(jax.tree_util.tree_leaves(got[n][k]),
                            jax.tree_util.tree_leaves(trained[n][k])):
                np.testing.assert_array_equal(a, b)
    want = TOOL.jax_trees(str(ROOT / "checkpoints_hidden"), 15000)
    restore_checkpoint(str(ROOT / "checkpoints_hidden_torch"), 15000, model)
    got = states_to_jax(model)
    for n in want:
        for k in ("params", "batch_stats", "mu", "nu"):
            for a, b in zip(jax.tree_util.tree_leaves(got[n][k]),
                            jax.tree_util.tree_leaves(want[n][k])):
                np.testing.assert_array_equal(a, b)
        assert int(got[n]["count"]) == int(want[n]["count"]) == 15000


def test_sampler_draws_each_member_on_its_own_stream():
    """Seeded draws repeat; the weighted pool only draws members of
    positive weight; each member's draws have the member's shapes."""
    a = HiddenSampler(3, "cpu", [0, 1, 0, 1, 0, 0])
    b = HiddenSampler(3, "cpu", [0, 1, 0, 1, 0, 0])
    shape = (B, S, S, 3)
    for _ in range(8):
        da, db = a(shape), b(shape)
        assert da.member == db.member and da.member in ("crop", "dropout")
        for x, y in zip(da[1:], db[1:]):
            assert (x is None and y is None) or torch.equal(x, y)
    d = HiddenSampler(0, "cpu")(shape, "gaussian")
    assert d.u is None and tuple(d.field.shape) == shape
    d = HiddenSampler(0, "cpu")(shape, "dropout")
    assert d.u.dim() == 0 and tuple(d.field.shape) == (S, S)
    x = torch.rand(shape)
    for m in NOISE_POOL + ("cropout_paper_p30",):
        y = apply_noise(x, x, HiddenSampler(1, "cpu")(shape, m), PLAIN)
        assert y.shape == x.shape and torch.isfinite(y).all()
    with pytest.raises(ValueError):
        HiddenSampler(0, "cpu", [1, 1])


def test_synthetic_images_equal_jax():
    for i in (0, 7):
        np.testing.assert_array_equal(
            SyntheticImageDataset(size=S, seed=123)[i],
            JImages(size=S, seed=123)[i])


def test_image_folder_equals_jax(tmp_path):
    """The same files, sizes and augmentation draws as the JAX dataset;
    with ``with_canny`` the same canny maps (the port's host canny, bit-equal
    to the JAX dataset's ``cv2.Canny``)."""
    import cv2
    rng = np.random.default_rng(9)
    for i in range(3):
        img = (rng.random((20 + i, 24, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"im{i}.png"), img)
    read_image, _ = cv2_readers()
    port = ImageFolderDataset(str(tmp_path), read_image, size=16, seed=4)
    ref = JFolder(str(tmp_path), size=16, seed=4)
    assert len(port) == len(ref) == 3
    for i in range(5):
        np.testing.assert_array_equal(port[i]["image"], ref[i]["image"])
    port = ImageFolderDataset(str(tmp_path), read_image, size=16, seed=4,
                              with_canny=True)
    ref = JFolder(str(tmp_path), size=16, seed=4, with_canny=True)
    for i in range(5):
        np.testing.assert_array_equal(port[i]["image"], ref[i]["image"])
        np.testing.assert_array_equal(port[i]["canny"], ref[i]["canny"])


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_train_cli_hidden_runs_and_resumes(tmp_path, capsys):
    ckpt = tmp_path / "ck"
    args = ["--task", "hidden", "--synthetic", "--device", "cpu", "--batch",
            "2", "--size", "32", "--no-telemetry", "--ckpt-dir", str(ckpt)]
    train_cli.main(args + ["--steps", "2"])
    res = _last_json(capsys.readouterr().out)
    assert res["resumed_step"] is None and np.isfinite(res["loss"])
    save = HiddenModel(image_size=32, device="cpu")
    save.init_states(0)
    save_checkpoint(str(ckpt), 5, save)
    train_cli.main(args + ["--steps", "1", "--resume"])
    assert _last_json(capsys.readouterr().out)["resumed_step"] == 5
    # the same message loop trains MBRS (ported since; its own tests are
    # tests/test_torch_mbrs*.py)
    train_cli.main(["--task", "mbrs", "--synthetic", "--device", "cpu",
                    "--batch", "2", "--size", "32", "--steps", "1",
                    "--no-telemetry", "--ckpt-dir", str(tmp_path / "mb")])
    res = _last_json(capsys.readouterr().out)
    assert res["resumed_step"] is None and np.isfinite(res["loss"])


def test_eval_hidden_writes_the_jax_tools_record(tmp_path, capsys):
    out = tmp_path / "eval.json"
    rec = eval_hidden.main(["--ckpt-dir",
                            str(ROOT / "checkpoints_hidden_r5_torch"),
                            "--batches", "1", "--batch", "2", "--size", "64",
                            "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == rec
    assert rec["step"] == 23000 and set(rec["bitwise_error"]) == {
        "identity", "crop", "cropout", "cropout_paper_p30", "dropout",
        "gaussian", "jpeg_mask", "mean"}
    assert 15 < rec["encoded_psnr_db"] < 40


def test_continue_hidden_writes_records_and_a_checkpoint(tmp_path, capsys):
    out = tmp_path / "r.jsonl"
    continue_hidden.main([
        "--from-ckpt", str(ROOT / "checkpoints_hidden_torch"),
        "--from-step", "15000", "--steps", "2", "--size", "32", "--batch",
        "2", "--log-every", "1", "--eval-every", "2", "--eval-batches", "1",
        "--ckpt-dir", str(tmp_path / "ck"), "--out", str(out),
        "--device", "cpu"])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs[0]["config"] and recs[0]["weights"] == [0.5, 2, 3, 1, 0.5, 1]
    assert [r["step"] for r in recs[1:]] == [15001, 15002, 15002, 15002]
    assert recs[3]["eval"] and "cropout_paper_p30" in recs[3][
        "bitwise_error"]
    model = HiddenModel(image_size=32, device="cpu")
    restore_checkpoint(str(tmp_path / "ck"), 15002, model)
    assert int(model.optimizers["encoder"].count) == 15002
