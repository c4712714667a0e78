"""Parity of the port's library ops, attacks and losses with the JAX package,
float32 on the CPU: the DiffJPEG colour pair and BT.601 Y, ``avg_pool_2x2``,
``quality_to_factor``, the k = 5 median, Lanczos and antialiased resizes,
``dwt``/``iwt``, the morphology, ``flow_warp`` in its four modes,
StegaStamp's distortions on JAX's draws, ``gf_attack``, ``combined_switch``
and every loss the port adds.

Tolerances and why:

* EQUAL where both sides compute the same float32 operations in the same
  order on exact data: ``dwt``'s halvings and sums,
  the morphology's max/min, the median's values and its gradient routing
  (a stable sort on both sides), ``quality_to_factor``, the resize
  matrices (numpy on both sides), ``combined_switch``'s pick;
* 1e-5 of the output's scale (1e-5 of the gradient's max for VJPs) where
  XLA may fuse or reorder a sum: colours, resizes (two einsums), the
  warps, the blurs, the losses;
* the perspective warp 1e-4: its 8×8 homography is solved by LU in both
  packages with other pivoting arithmetic;
* ``gradient_penalty`` 1e-5 relative, and its gradient in the
  discriminator's weights 1e-4 of the largest (a second-order gradient
  through GELU in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.attacks import blur as jblur
from vwfd_tpu.attacks import combined as jcomb
from vwfd_tpu.attacks import jpeg as jjpeg
from vwfd_tpu.attacks import stegastamp as jsteg
from vwfd_tpu.metrics import losses as jl
from vwfd_tpu.nets.discriminator import Discriminator as JDisc
from vwfd_tpu.ops import color as jcolor
from vwfd_tpu.ops import dwt as jdwt
from vwfd_tpu.ops import filters as jfilters
from vwfd_tpu.ops import morphology as jmorph
from vwfd_tpu.ops import quantize as jq
from vwfd_tpu.ops import resize as jresize
from vwfd_tpu.ops import warp as jwarp
from vwfd_tpu_torch.attacks import (combined_switch, gf_attack, jpeg_mask,
                                    sample_switch_index)
from vwfd_tpu_torch.attacks import stegastamp as steg
from vwfd_tpu_torch.convert import state_dict_from_jax
from vwfd_tpu_torch.metrics import losses as tl
from vwfd_tpu_torch.nets.discriminator import Discriminator
from vwfd_tpu_torch.ops import color, dwt, filters, morphology, quantize
from vwfd_tpu_torch.ops import resize, warp


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


def _img(seed, shape, lo=0.0, hi=1.0):
    r = np.random.default_rng(seed).random(shape)
    return (lo + (hi - lo) * r).astype(np.float32)


def _vjp_torch(fn, xs, cot):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    y = fn(*ts)
    gs = torch.autograd.grad(y, ts, torch.from_numpy(np.asarray(cot)))
    return _np(y), [_np(g) for g in gs]


def _vjp_jax(fn, xs, cot):
    y, pull = jax.vjp(fn, *[jnp.asarray(x) for x in xs])
    return np.asarray(y), [np.asarray(g) for g in pull(jnp.asarray(cot))]


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _both(tfn, jfn, xs, seed, rel=1e-5):
    """Forward and VJP in every input of the port's function against
    JAX's."""
    want = np.asarray(jfn(*[jnp.asarray(x) for x in xs]))
    cot = _img(seed, want.shape, -1, 1)
    y, gs = _vjp_torch(tfn, xs, cot)
    yj, gjs = _vjp_jax(jfn, xs, cot)
    _close(y, yj, rel)
    for g, gj in zip(gs, gjs):
        _close(g, gj, rel)


# ------------------------------------------------------------ ops

@pytest.mark.parametrize("name", ["rgb_to_ycbcr_diffjpeg",
                                  "ycbcr_to_rgb_diffjpeg", "rgb_to_y_bt601"])
def test_colour_matches_jax(name):
    hi = 1.0 if name == "rgb_to_y_bt601" else 255.0
    _both(getattr(color, name), getattr(jcolor, name),
          [_img(1, (2, 5, 7, 3), 0, hi)], 2)


def test_avg_pool_2x2_matches_jax():
    x = _img(3, (2, 6, 8, 3), -2, 2)
    _both(filters.avg_pool_2x2, jfilters.avg_pool_2x2, [x], 4)


def test_quality_to_factor_matches_jax():
    for q in (1, 10, 49, 50, 51, 75, 90, 100):
        assert quantize.quality_to_factor(q) == jq.quality_to_factor(q)
    q = np.array([10, 37, 60, 70, 80, 90, 99], np.float32)
    want = np.asarray(jnp.where(q < 50, 5000.0 / q, 200.0 - q * 2.0) / 100.0)
    np.testing.assert_array_equal(
        _np(quantize.quality_to_factor(torch.from_numpy(q))), want)


@pytest.mark.parametrize("levels", [False, True])
def test_median_5_matches_jax(levels):
    """k = 5: values EQUAL, the gradient routed to the same view (ties
    among 8-bit levels too: a stable sort on both sides)."""
    x = _img(5, (2, 9, 10, 3))
    if levels:
        x = np.round(x * 8) / 8
    cot = np.round(_img(6, x.shape, -8, 8)) / 4
    y, (g,) = _vjp_torch(lambda v: filters.median_blur(v, 5), [x], cot)
    yj, (gj,) = _vjp_jax(lambda v: jfilters.median_blur(v, 5), [x], cot)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(g, gj)


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos"])
@pytest.mark.parametrize("antialias", [False, True])
def test_resize_matrices_and_resizes_match_jax(method, antialias):
    for n_in, n_out in ((32, 13), (13, 32), (24, 24), (40, 7)):
        np.testing.assert_array_equal(
            resize.resize_matrix(n_in, n_out, method, antialias),
            jresize.resize_matrix(n_in, n_out, method, antialias))
    x = _img(7, (2, 32, 24, 3))
    _both(lambda v: resize.resize(v, (9, 17), method, antialias),
          lambda v: jresize._resize(v, (9, 17), method, antialias), [x], 8)
    if method != "lanczos":
        fn = getattr(resize, f"resize_{method}")
        jfn = getattr(jresize, f"resize_{method}")
        _both(lambda v: fn(v, (9, 17), antialias=antialias),
              lambda v: jfn(v, (9, 17), antialias=antialias), [x], 9)


def test_dwt_and_iwt_match_jax():
    x = _img(10, (2, 8, 12, 3), -1, 1)
    np.testing.assert_array_equal(_np(dwt.dwt(torch.from_numpy(x))),
                                  np.asarray(jdwt.dwt(x)))
    y = _img(11, (2, 4, 6, 12), -1, 1)
    np.testing.assert_array_equal(_np(dwt.iwt(torch.from_numpy(y))),
                                  np.asarray(jdwt.iwt(y)))
    _both(dwt.dwt, jdwt.dwt, [x], 12)
    _both(dwt.iwt, jdwt.iwt, [y], 13)
    np.testing.assert_allclose(_np(dwt.iwt(dwt.dwt(torch.from_numpy(x)))),
                               x, atol=1e-6)


@pytest.mark.parametrize("fn", ["dilate", "erode", "closing", "opening"])
@pytest.mark.parametrize("channel", [False, True])
def test_morphology_matches_jax(fn, channel):
    m = (_img(14, (2, 11, 13)) > 0.6).astype(np.float32)
    if channel:
        m = m[..., None]
    for it in (1, 2, 3):
        np.testing.assert_array_equal(
            _np(getattr(morphology, fn)(torch.from_numpy(m), it)),
            np.asarray(getattr(jmorph, fn)(jnp.asarray(m), it)))


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_flow_warp_matches_jax(interp, padding):
    x = _img(15, (2, 9, 11, 3))
    flow = _img(16, (2, 9, 11, 2), -3, 3)
    flow[0, 0, 0] = (0.5, -0.5)  # a nearest-rounding tie and an edge
    if interp == "nearest":  # not differentiable in the flow
        _both(lambda v: warp.flow_warp(v, torch.from_numpy(flow), interp,
                                       padding),
              lambda v: jwarp.flow_warp(v, jnp.asarray(flow), interp,
                                        padding), [x], 17)
    else:
        _both(lambda v, f: warp.flow_warp(v, f, interp, padding),
              lambda v, f: jwarp.flow_warp(v, f, interp, padding),
              [x, flow], 17)


# ------------------------------------------------------------ attacks

def _uniforms(key, n, shape=()):
    ks = jax.random.split(key, n)
    return np.stack([np.asarray(jax.random.uniform(k, shape)) for k in ks])


def test_random_blur_kernel_matches_jax_on_every_branch():
    branches = set()
    for seed in range(24):
        key = jax.random.PRNGKey(seed)
        u = _uniforms(key, 5)
        branches.add(0 if u[4] < 0.25 else 1 if u[4] < 0.5 else 2)
        got = _np(steg.random_blur_kernel(torch.from_numpy(u)))
        want = np.asarray(jsteg.random_blur_kernel(key))
        _close(got, want)
    assert branches == {0, 1, 2}


def test_apply_blur_kernel_and_gf_attack_match_jax():
    x = _img(18, (2, 12, 10, 3))
    k = np.asarray(jsteg.random_blur_kernel(jax.random.PRNGKey(3)))
    _both(lambda v: steg.apply_blur_kernel(v, torch.from_numpy(k)),
          lambda v: jsteg.apply_blur_kernel(v, jnp.asarray(k)), [x], 19)
    _both(gf_attack, lambda v: jblur.gf_attack(None, v), [x], 20)
    _both(lambda v: gf_attack(v, 2.0, 5),
          lambda v: jblur.gf_attack(None, v, 2.0, 5), [x], 21)


def test_random_perspective_matches_jax():
    x = _img(22, (2, 16, 20, 3))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(key, (4, 2)))
        _both(lambda v: steg.random_perspective(v, torch.from_numpy(u)),
              lambda v: jsteg.random_perspective(key, v), [x], 23, rel=1e-4)


def test_random_brightness_hue_matches_jax():
    x = _img(24, (3, 6, 7, 3))
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    uh = np.asarray(jax.random.uniform(k1, (3, 1, 1, 3)))
    ub = np.asarray(jax.random.uniform(k2, (3, 1, 1, 1)))
    _both(lambda v: steg.random_brightness_hue(v, torch.from_numpy(uh),
                                               torch.from_numpy(ub)),
          lambda v: jsteg.random_brightness_hue(key, v), [x], 25)


def test_stegastamp_sampler_is_seeded():
    a = steg.sample_uniforms(torch.Generator().manual_seed(1), (5,))
    b = steg.sample_uniforms(torch.Generator().manual_seed(1), (5,))
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())


def test_combined_switch_takes_jax_members():
    x = _img(26, (1, 16, 16, 3))
    members_t = [gf_attack, lambda v: filters.median_blur(v, 5), jpeg_mask]
    members_j = [lambda k, v: jblur.gf_attack(k, v),
                 lambda k, v: jfilters.median_blur(v, 5),
                 lambda k, v: jjpeg.jpeg_mask(v)]
    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        k_sel, _ = jax.random.split(key)
        idx = int(jax.random.randint(k_sel, (), 0, 3))  # the JAX draw
        seen.add(idx)
        got = _np(combined_switch(torch.from_numpy(x), members_t, idx))
        want = np.asarray(jcomb.combined_switch(key, jnp.asarray(x),
                                                members_j))
        _close(got, want, 1e-4)
    assert seen == {0, 1, 2}
    draws = {sample_switch_index(torch.Generator().manual_seed(s), 3)
             for s in range(30)}
    assert draws == {0, 1, 2}


# ------------------------------------------------------------ losses

def _loss_case(name):
    a = _img(30, (2, 8, 16, 3))
    b = _img(31, (2, 8, 16, 3))
    m = (_img(32, (2, 8, 16, 1)) > 0.5).astype(np.float32)
    b[0, 0, 0] = a[0, 0, 0]  # an exact zero difference (|·|'s gradient)
    return {
        "smooth_l1": ([a, b * 2], {}),
        "reconstruction_loss": ([a, b], {}),
        "ssim_loss_map": ([a, b], {}),
        "exclusion_loss": ([a, b], {}),
        "gradient_loss": ([a], {}),
        "grayscale_loss": ([a, b], {}),
        "extended_l1_loss": ([a, b, m], {}),
        "non_blurry_loss": ([a], {}),
        "std_loss": ([a], {}),
        "dice_loss": ([a, (b > 0.5).astype(np.float32)], {}),
    }[name]


@pytest.mark.parametrize("name", [
    "smooth_l1", "reconstruction_loss", "ssim_loss_map", "exclusion_loss",
    "gradient_loss", "grayscale_loss", "extended_l1_loss",
    "non_blurry_loss", "std_loss", "dice_loss"])
def test_loss_matches_jax(name):
    xs, kw = _loss_case(name)
    _both(lambda *v: getattr(tl, name)(*v, **kw),
          jax.jit(lambda *v: getattr(jl, name)(*v, **kw)), xs, 33)


@pytest.mark.parametrize("kind", ["l2", "l_char", "l1"])
def test_reconstruction_loss_types_match_jax(kind):
    a, b = _img(34, (2, 5, 6, 3)), _img(35, (2, 5, 6, 3))
    _both(lambda x, y: tl.reconstruction_loss(x, y, kind),
          lambda x, y: jl.reconstruction_loss(x, y, kind), [a, b], 36)
    with pytest.raises(ValueError):
        tl.reconstruction_loss(torch.zeros(1, 2), torch.zeros(1, 2), "l3")


@pytest.mark.parametrize("targeted", [False, True])
def test_cw_loss_matches_jax(targeted):
    logits = _img(37, (4, 10), -3, 3)
    logits[0, 2] = logits[0, 5]  # a tie in the max
    target = np.array([5, 0, 9, 3])
    _both(lambda v: tl.cw_loss(v, torch.from_numpy(target), targeted, 10,
                               0.5),
          lambda v: jl.cw_loss(v, jnp.asarray(target), targeted, 10, 0.5),
          [logits], 38)


def test_gradient_penalty_matches_jax_on_a_converted_discriminator():
    """A small flax discriminator (dim 4, no spectral norm) converted through
    ``convert.py``; ε from the JAX key as the JAX function draws it; the
    penalty and its gradient in the weights (``create_graph``)."""
    jd = JDisc(dim=4, use_sigmoid=False, use_spectral_norm=False)
    real, fake = _img(40, (2, 32, 32, 3)), _img(41, (2, 32, 32, 3))
    variables = jd.init(jax.random.PRNGKey(0), jnp.asarray(real))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    net = Discriminator(dim=4, use_sigmoid=False, use_spectral_norm=False)
    net.load_state_dict(state_dict_from_jax(params))
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))

    def jpen(p):
        return jl.gradient_penalty(lambda x: jd.apply({"params": p}, x), key,
                                   jnp.asarray(real), jnp.asarray(fake))

    want, jgrad = jax.jit(jax.value_and_grad(jpen))(variables["params"])
    got = tl.gradient_penalty(net, torch.from_numpy(eps),
                              torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    grads = torch.autograd.grad(got, list(net.parameters()))
    want_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrad))
    names = [n for n, _ in net.named_parameters()]
    top = max(float(v.abs().max()) for v in want_sd.values())
    for n, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), want_sd[n].numpy(), rtol=0,
                                   atol=1e-4 * top, err_msg=n)
