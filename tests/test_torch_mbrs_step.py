"""Parity of the port's MBRS step with vwfd_tpu's, on the CPU in float64,
at ``tests/test_torch_mbrs.py``'s small size (32², 8 channels, 2 SE
blocks, diffusion length 16, batch 2), from the same weights (the JAX
package's ``init_states``, converted): the noise draws derived from a JAX
key, one train step per noise mode, ``infer``, and the non-finite guard
(F21 at the caller, in float32).

Why float64: the step is ill-conditioned in float32 at these sizes (in
float32 a hard step's worst gradient tensor parts from JAX's by 4 %
through rounding flips, a soft step's through the soft round's x³ kink at
½). JAX's ``dct8x8`` pins its output to float32
(``preferred_element_type``), so under ``jax.enable_x64`` its JPEG would
stay float32: the tests lift that pin (its ``einsum`` then takes the
input's dtype) and leave every other line of the JAX package as it is.
The JAX step and ``infer`` are compiled without XLA's ``algsimp`` (F9).
Both sides then agree to about 1e-12. Tolerances: the noise, values and
gradients, within 1e-10; loss terms within 1e-9 relative, the same count
of wrong bits; every gradient within 1e-7 of its tensor's max-abs (a conv
bias in front of a BatchNorm, whose gradient is 0 but for rounding,
within 1e-10 of its net's largest); updated parameters within 1e-6 (1e-3
of Adam's first step, lr); Adam's second moments within 1e-7 of their
max; BatchNorm statistics within 1e-10; ``infer``'s three outputs within
1e-10 of their max.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vwfd_tpu.ops.dct as jdct
from vwfd_tpu.models.mbrs_model import MBRSModel as JMBRS
from vwfd_tpu.models.mbrs_model import _mbrs_noise
from vwfd_tpu_torch.attacks.jpeg import QUALITIES
from vwfd_tpu_torch.convert import (opt_state_to_jax, states_from_jax,
                                    states_to_jax)
from vwfd_tpu_torch.models.mbrs_model import (MODES, QUALITY_INDICES,
                                              MBRSDraws, mbrs_noise)

from test_torch_mbrs import (B, KW, L, LR, TOOL, _close, _images,
                             _messages, _np, _one_thread, _perturbed, _port)

assert _one_thread  # the autouse fixture: one thread a test


@pytest.fixture(scope="module")
def jmodel():
    return JMBRS(**KW)


@pytest.fixture(scope="module")
def jstates(jmodel):
    return jmodel.init_states(jax.random.PRNGKey(3))


class _UnpinnedJnp:
    """``jax.numpy`` whose ``einsum`` ignores ``preferred_element_type``:
    JAX's ``dct8x8`` then runs in its input's dtype."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kw):
        return jnp.einsum(*args, **kw)


@pytest.fixture
def f64(monkeypatch):
    """Both packages in float64: torch's default dtype, ``jax.enable_x64``
    and JAX's DCT unpinned."""
    monkeypatch.setattr(jdct, "jnp", _UnpinnedJnp())
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    with jax.enable_x64(True):
        yield
    torch.set_default_dtype(prev)


def jax_mbrs_draws(key) -> MBRSDraws:
    """The draws ``_mbrs_noise(key, ...)`` takes: ``k1, k2 = split(key)``,
    the quality from ``randint(k1, (), 0, 3)``, the mode from ``k2``."""
    k1, k2 = jax.random.split(key)
    return MBRSDraws(int(jax.random.randint(k2, (), 0, 3)),
                     QUALITY_INDICES[int(jax.random.randint(k1, (), 0, 3))])


def _keys(pairs):
    """For each wanted (mode, q_idx), a key whose draws are it (the draws
    of a key differ under x64: call where they will be used)."""
    found, i = {}, 0
    while len(found) < len(pairs):
        key = jax.random.PRNGKey(500 + i)
        d = jax_mbrs_draws(key)
        if (d.mode, d.q_idx) in pairs:
            found.setdefault((d.mode, d.q_idx), key)
        i += 1
    return found


def _f64_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def test_noise_draws_follow_the_jax_key(f64):
    """For every (mode, quality) pair, ``mbrs_noise`` on the draws derived
    from a key equals JAX's ``_mbrs_noise(key, clip(enc))``, values and
    input gradient, with values outside [0, 1] (the clip's ends)."""
    pairs = {(m, q) for m in range(3) for q in QUALITY_INDICES}
    enc = np.random.default_rng(11).random((B, 16, 16, 3)) * 1.2 - 0.1
    cot = np.random.default_rng(12).standard_normal(enc.shape)
    for (mode, q), key in sorted(_keys(pairs).items()):
        want, vjp = jax.vjp(lambda e: _mbrs_noise(key, jnp.clip(e, 0., 1.)),
                            jnp.asarray(enc))
        gw = np.asarray(vjp(jnp.asarray(cot))[0])
        et = torch.from_numpy(enc).requires_grad_(True)
        got = mbrs_noise(et, MBRSDraws(mode, q))
        gg = _np(torch.autograd.grad(got, et, torch.from_numpy(cot))[0])
        what = f"{MODES[mode]} Q{QUALITIES[q]}"
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-10, err_msg=what)
        np.testing.assert_allclose(gg, gw, rtol=0, atol=1e-10, err_msg=what)


# train step, both sides in float64
LOSS_RTOL = 1e-9
GRAD_REL = 1e-7
PARAM_ATOL = 1e-3 * LR
STATS_ATOL = 1e-10
_STEP_KEYS = {"identity": (0, 0), "hard": (1, 4), "soft": (2, 0)}


def _grad_close(got, want, net_max, what):
    """Within ``GRAD_REL`` of the tensor's max-abs; a conv bias in front of
    a BatchNorm has no gradient but rounding noise, held to ``GRAD_REL``·
    1e-3 of the net's largest."""
    scale = max(float(np.abs(want).max()), 1e-3 * net_max)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * scale,
                               err_msg=what)


def _port64(trees):
    model = _port(trees)
    for net in model.nets().values():
        net.double()
    model.optimizers = model._adam()
    states_from_jax(model, trees)
    return model


_COMPILED = {}


def _jax(method, jmodel, *args):
    """JAX's ``MBRSModel.train_step`` or ``infer`` jitted and compiled
    without ``algsimp`` (F9), once a test process (the key is an argument:
    one executable serves every mode)."""
    if method not in _COMPILED:
        fn = functools.partial(getattr(JMBRS, method).__wrapped__, jmodel)
        _COMPILED[method] = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return _COMPILED[method](*args)


@pytest.mark.parametrize("mode", sorted(_STEP_KEYS))
def test_train_step_matches_jax(jmodel, jstates, mode, f64):
    """One train step per noise mode from the same weights and draws: loss
    terms, every gradient, updated parameter, Adam moment and count and
    BatchNorm statistic of both nets."""
    key = _keys({_STEP_KEYS[mode]})[_STEP_KEYS[mode]]
    images, msgs = _images(13), _messages(13)
    trees = TOOL.trees_of(jstates)
    new, jlogs = _jax("train_step", jmodel, _f64_tree(jstates),
                      jnp.asarray(images, float), jnp.asarray(msgs, float),
                      key)
    want = TOOL.trees_of(new)
    port = _port64(trees)
    grads = {}
    logs = port.train_step(images, msgs, jax_mbrs_draws(key), grads)
    for term in ("loss", "encoder_mse", "message_mse"):
        np.testing.assert_allclose(float(logs[term]), float(jlogs[term]),
                                   rtol=LOSS_RTOL, err_msg=term)
    assert round(float(logs["bitwise_error"]) * B * L) == round(
        float(jlogs["bitwise_error"]) * B * L)
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
            what = f"{mode} {name}{jax.tree_util.keystr(path)}"
            _grad_close(0.1 * g, w, net_max, f"gradient {what}")
            _grad_close(m, w, net_max, f"mu {what}")
            np.testing.assert_allclose(p, wp, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"param {what}")
        nus = jax.tree_util.tree_leaves(want[name]["nu"])
        nu_max = max(float(np.abs(w).max()) for w in nus)
        for w, g in zip(nus, jax.tree_util.tree_leaves(got[name]["nu"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * nu_max,
                                       err_msg=f"{mode} {name} nu")
        for w, g in zip(jax.tree_util.tree_leaves(want[name]["batch_stats"]),
                        jax.tree_util.tree_leaves(got[name]["batch_stats"])):
            np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL,
                                       err_msg=f"{mode} {name} stats")
        assert int(got[name]["count"]) == int(want[name]["count"]) == 1


def test_infer_matches_jax(jmodel, jstates, f64):
    """``infer`` (eval mode) on perturbed running statistics, each mode:
    encoded, noised and decoded within 1e-10 of their max."""
    trees = TOOL.trees_of(jstates)
    rng = np.random.default_rng(14)
    for name in trees:
        trees[name]["batch_stats"] = _perturbed(trees[name]["batch_stats"],
                                                rng)
    st = {n: s.replace(variables={"batch_stats": trees[n]["batch_stats"]})
          for n, s in jstates.items()}
    port = _port64(trees)
    images, msgs = _images(15), _messages(15)
    for mode, pair in sorted(_STEP_KEYS.items()):
        key = _keys({pair})[pair]
        want = _jax("infer", jmodel, _f64_tree(st),
                    jnp.asarray(images, float), jnp.asarray(msgs, float), key)
        got = port.infer(images, msgs, jax_mbrs_draws(key))
        for g, w, what in zip(got, want, ("encoded", "noised", "decoded")):
            _close(_np(g), w, 1e-10, f"{mode} {what}")


# ------------------------------------------------------------ the guard

@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_guard_keeps_every_state_on_an_inf_pixel_f21(jmodel, jstates, mode):
    """F21 at the caller: one Inf pixel in one image on a JPEG mode, whose
    NaN footprint is the pixel's 8×8 block in the port and the whole image
    in JAX. Both report a non-finite loss and keep every parameter,
    BatchNorm statistic, Adam moment and count of both nets: no caller
    sees the difference."""
    pair = _STEP_KEYS[mode]
    key = _keys({pair})[pair]
    images, msgs = _images(16), _messages(16)
    images[0, 5, 6, 1] = np.inf
    port = _port(TOOL.trees_of(jstates))
    before = [t.clone() for n in port.nets() for t in port._tensors(n)]
    logs = port.train_step(images, msgs, jax_mbrs_draws(key))
    assert not np.isfinite(float(logs["loss"]))
    after = [t for n in port.nets() for t in port._tensors(n)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    new, jlogs = jmodel.train_step(
        jax.tree_util.tree_map(jnp.array, jstates), jnp.asarray(images),
        jnp.asarray(msgs), key)
    assert not np.isfinite(float(jlogs["loss"]))
    for a, b in zip(jax.tree_util.tree_leaves(TOOL.trees_of(new)),
                    jax.tree_util.tree_leaves(TOOL.trees_of(jstates))):
        np.testing.assert_array_equal(a, b)


