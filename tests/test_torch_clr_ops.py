"""Parity of the port's CLR pieces with vwfd_tpu's, on the CPU in float32:
the bicubic crop (K20's plain version), the crop geometry (``paste_resize``,
``cropped_out``, ``rectify_crop_pad``: K21's plain version), the SSIM's
gradient (K22's plain version, and ``metrics.ssim`` under autograd), the
apex regressor (``QFPredictor``, both heads), the discriminator of the
``with_gan`` option and the VGG19 feature loss of ``use_perceptual``.

Inputs come from numpy with a seed; weights go from the port's own
initialisation through ``convert.py`` into flax trees (the VGG19's the other
way: JAX's seeded fallback into the port). The JAX references are compiled
without ``algsimp`` where a coordinate divides (F9).

Tolerances and why:

* the bicubic crop forward and the geometry's values within 1e-6 absolute
  (values of order 1; XLA may fuse a weight's products), their gradients
  within 1e-6 of the JAX gradient's max (scatter-adds in another order);
  NaN and ±Inf at the same places;
* the SSIM gradient within 1e-5 of its max (the same 121-term window sums;
  the mean's 1/N in double on the port's side); on a flat patch, where
  σ² = E[x²] − μ² cancels to rounding, in float64 on both sides within
  1e-10;
* the nets' outputs within 1e-5 relative to their max (float32 convolutions
  summed in another order), and with perturbed parameters in float64
  within 1e-9; the VGG19 loss within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.attacks import spatial as jspatial
from vwfd_tpu.metrics import losses as jlosses
from vwfd_tpu.metrics import metrics as jmetrics
from vwfd_tpu.metrics import perceptual as jperc
from vwfd_tpu.nets.discriminator import Discriminator as JDisc
from vwfd_tpu.nets.fbcnn import QFPredictor as JQF
from vwfd_tpu.ops import resize as jresize
from vwfd_tpu_torch.attacks import spatial
from vwfd_tpu_torch.convert import (spectral_to_jax, state_dict_from_jax,
                                    state_dict_to_jax)
from vwfd_tpu_torch.kernels import (PLAIN, crop_cubic, launch_counts,
                                    rectify, ssim as kssim, ssim_grad)
from vwfd_tpu_torch.metrics import adversarial_loss, gan_loss, ssim
from vwfd_tpu_torch.metrics import perceptual
from vwfd_tpu_torch.nets import Discriminator, QFPredictor
from vwfd_tpu_torch.ops import resize

_NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _image(seed, shape=(2, 32, 32, 3), lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(shape)).astype(np.float32)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_NO_ALGSIMP)(
        *args)


def _close_nonfinite(got, want, scale):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isinf(got)], want[np.isinf(want)])
    fin = np.isfinite(want)
    atol = 1e-6 * (np.abs(want[fin]).max() if scale else 1.0)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


# windows: inside, on the image's edges, one pixel, one row, the image
APEXES = [(3.0, 27.0, 5.0, 30.0), (0.0, 20.0, 12.0, 32.0),
          (9.0, 10.0, 4.0, 5.0), (7.0, 8.0, 0.0, 32.0),
          (0.0, 32.0, 0.0, 32.0), (19.0, 32.0, 0.0, 13.0)]


@pytest.mark.parametrize("apex", APEXES)
@pytest.mark.parametrize("out_hw", [None, (24, 40)])
def test_crop_cubic_plain_matches_jax(apex, out_hw):
    """Forward within 1e-6, the VJP within 1e-6 of its max; the wrapper on
    a CPU tensor is the plain version and launches nothing."""
    x = _image(1, lo=-0.1, hi=1.1)
    oshape = x.shape if out_hw is None else (2, *out_hw, 3)
    cot = np.random.default_rng(2).standard_normal(oshape).astype(np.float32)
    a = jnp.asarray(apex, jnp.float32)

    def ref(v, a):
        return jresize.crop_resize(v, a, out_hw, method="bicubic")
    want = np.asarray(_jit(ref, x, a))
    gwant = np.asarray(_jit(jax.grad(lambda v, a, c: jnp.sum(ref(v, a) * c)),
                            x, a, cot))
    before = launch_counts()
    xt = _t(x).requires_grad_(True)
    y = crop_cubic.crop_cubic(xt, torch.tensor(apex), out_hw)
    (y * _t(cot)).sum().backward()
    assert launch_counts() == before
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), gwant, rtol=0,
                               atol=1e-6 * np.abs(gwant).max())
    assert torch.equal(y.detach(), PLAIN.crop_cubic(_t(x),
                                                    torch.tensor(apex),
                                                    out_hw))


@pytest.mark.parametrize("apex", [APEXES[0], APEXES[4]])
def test_crop_cubic_nonfinite_matches_jax(apex):
    """A NaN and an Inf pixel in the window and a NaN in the cotangent:
    NaN and ±Inf where JAX's are (every tap multiplies, a weight of 0
    too), within 1e-6 elsewhere."""
    x = _image(3)
    x[0, 7, 9, 1] = np.nan
    x[1, 12, 20, 0] = np.inf
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    cot[1, 5, 6, 2] = np.nan
    a = jnp.asarray(apex, jnp.float32)

    def ref(v, a):
        return jresize.crop_resize(v, a, method="bicubic")
    want = np.asarray(_jit(ref, x, a))
    gwant = np.asarray(_jit(jax.grad(lambda v, a, c: jnp.sum(ref(v, a) * c)),
                            x, a, cot))
    xt = _t(x).requires_grad_(True)
    y = crop_cubic.crop_cubic(xt, torch.tensor(apex))
    (y * _t(cot)).sum().backward()
    assert np.isnan(want).any() and np.isnan(gwant).any()
    _close_nonfinite(y.detach().numpy(), want, False)
    _close_nonfinite(xt.grad.numpy(), gwant, True)


def test_resize_bicubic_matches_jax():
    x = _image(5, (2, 4, 6, 1))
    want = np.asarray(jresize.resize_bicubic(x, (32, 24)))
    np.testing.assert_allclose(resize.resize_bicubic(_t(x), (32, 24)).numpy(),
                               want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("apex", APEXES)
def test_crop_geometry_matches_jax(apex):
    """``paste_resize``, ``cropped_out`` and ``rectify_crop_pad`` (copies
    tiled over a clean batch): values within 1e-6, the gradient into the
    clean image within 1e-6 of its max, none into the attacked copies."""
    att = _image(6, (4, 32, 32, 3), lo=-0.1, hi=1.1)
    clean = _image(7)
    a = jnp.asarray(apex, jnp.float32)
    at = torch.tensor(apex)
    np.testing.assert_allclose(
        spatial.paste_resize(_t(att), at).numpy(),
        np.asarray(_jit(jspatial.paste_resize, att, a)), rtol=0, atol=1e-6)
    for got, want in zip(spatial.cropped_out(_t(clean), at),
                         _jit(jspatial.cropped_out, clean, a)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    cot = np.random.default_rng(8).standard_normal(att.shape).astype(
        np.float32)

    def jrect(v, c, a):
        return jspatial.rectify_crop_pad(v, jnp.tile(c, (2, 1, 1, 1)), a)
    want = np.asarray(_jit(jrect, att, clean, a))
    gwant = _jit(jax.grad(lambda v, c, a, g: jnp.sum(jrect(v, c, a) * g),
                          argnums=(0, 1)), att, clean, a, cot)
    at_, ct = _t(att).requires_grad_(True), _t(clean).requires_grad_(True)
    before = launch_counts()
    y = rectify.rectify(at_, ct, at)
    (y * _t(cot)).sum().backward()
    assert launch_counts() == before
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=1e-6)
    assert at_.grad is None and not np.asarray(gwant[0]).any()
    g1 = np.asarray(gwant[1])
    np.testing.assert_allclose(ct.grad.numpy(), g1, rtol=0,
                               atol=1e-6 * np.abs(g1).max())
    assert torch.equal(y.detach(), PLAIN.rectify(_t(att), _t(clean), at))


def test_rectify_nonfinite_matches_jax():
    """An Inf and a NaN attacked pixel, one outside the window: the NaN
    footprint of JAX's products and sums (outside the window too)."""
    apex = APEXES[0]
    att = _image(9, (2, 32, 32, 3))
    att[0, 1, 1, 0] = np.inf       # outside the window
    att[1, 15, 15, 2] = np.nan     # inside
    clean = _image(10)
    a = jnp.asarray(apex, jnp.float32)
    want = np.asarray(_jit(jspatial.rectify_crop_pad, att, clean, a))
    got = rectify.rectify(_t(att), _t(clean), torch.tensor(apex)).numpy()
    assert np.isnan(want).any()
    _close_nonfinite(got, want, False)


def test_rectify_refuses_copies_that_do_not_tile():
    with pytest.raises(ValueError, match="tile"):
        rectify.rectify(_t(_image(1, (3, 8, 8, 3))), _t(_image(2, (2, 8, 8,
                                                                   3))),
                        torch.tensor(APEXES[2]))


def test_ssim_gradient_matches_jax():
    """``jax.grad`` of ``ssim`` against the port's autograd through
    ``metrics.ssim`` (a gradient, not none) and against K22's plain
    version with the mean's scale, within 1e-5 of its max."""
    x1 = _image(11, (2, 24, 28, 3))
    x2 = np.clip(x1 + 0.05 * np.random.default_rng(12).standard_normal(
        x1.shape), 0, 1).astype(np.float32)
    gwant = np.asarray(jax.jit(jax.grad(jmetrics.ssim))(x1, x2))
    xt = _t(x1).requires_grad_(True)
    s = ssim(xt, _t(x2))
    gx, = torch.autograd.grad(s, xt)
    np.testing.assert_allclose(float(s.detach()),
                               float(jmetrics.ssim(x1, x2)), rtol=1e-6)
    scale = np.abs(gwant).max()
    np.testing.assert_allclose(gx.numpy(), gwant, rtol=0, atol=1e-5 * scale)
    sc = ssim_grad.scale_of(torch.zeros(2), torch.ones(()), x1.shape)
    np.testing.assert_allclose(
        ssim_grad.ssim_grad(_t(x1), _t(x2), sc).numpy(), gwant, rtol=0,
        atol=1e-5 * scale)


def test_ssim_gradient_on_a_flat_patch_matches_jax_in_float64():
    """A flat patch, where σ² = E[x²] − μ² cancels to rounding in
    float32 (the two sides then part by 2e-5 of the max: XLA contracts the window
    sums into FMAs): in float64 on both sides the gradients agree within
    1e-10 of the max."""
    x1 = _image(11, (2, 24, 28, 3)).astype(np.float64)
    x2 = np.clip(x1 + 0.05 * np.random.default_rng(12).standard_normal(
        x1.shape), 0, 1)
    x1[:, 4:16, 6:20] = 0.5
    x2[:, 4:16, 6:20] = 0.5
    with jax.enable_x64(True):
        gwant = np.asarray(jax.jit(jax.grad(jmetrics.ssim))(
            jnp.asarray(x1), jnp.asarray(x2)))
    assert gwant.dtype == np.float64
    xt = torch.from_numpy(x1).requires_grad_(True)
    gx, = torch.autograd.grad(kssim.ssim_map(xt, torch.from_numpy(x2))
                              .mean(), xt)
    np.testing.assert_allclose(gx.numpy(), gwant, rtol=0,
                               atol=1e-10 * np.abs(gwant).max())


def test_ssim_per_image_cotangent():
    """The per-image means' cotangents reach each image: K22's plain
    version with ``scale_of`` equals autograd through ``ssim_plain``."""
    x1, x2 = _image(13, (3, 16, 16, 3)), _image(14, (3, 16, 16, 3))
    xt = _t(x1).requires_grad_(True)
    means, mean = kssim.ssim_plain(xt, _t(x2))
    gm, g = _t([0.3, -1.0, 2.0]), _t(0.7)
    want, = torch.autograd.grad((means * gm).sum() + mean * g, xt)
    got = ssim_grad.ssim_grad(_t(x1), _t(x2),
                              ssim_grad.scale_of(gm, g, x1.shape))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def _flax(sd):
    params, _ = state_dict_to_jax({k: v for k, v in sd.items()
                                   if not k.endswith(".u")})
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.mark.parametrize("crop_pred", [True, False])
def test_qf_predictor_matches_jax(crop_pred):
    """CLR's apex regressor (nc (16, 24, 32, 48), nb 1, 4 outputs, the mask
    head resized to 32) and the classifier tail (nb 2, an odd side), with
    the port's weights converted. In float32 both outputs within 1e-5 of
    their max where nothing is perturbed (the port's own initialisation);
    with every parameter perturbed (biases too) in float64 on both sides:
    the outputs within 1e-9 of their max (the JAX mask head's resize pins
    float32: 1e-6 there); the tree round trip is the identity."""
    kw = (dict(nc=(16, 24, 32, 48), nb=1, classes=4, crop_pred=True,
               out_size=32) if crop_pred
          else dict(nc=(8, 8, 16, 16), nb=2, classes=5))
    net = QFPredictor(**kw)
    net.init_params(torch.Generator().manual_seed(5))
    x = _image(15, (2, 32, 36, 3) if crop_pred else (2, 27, 30, 3))
    params = _flax(net.state_dict())
    for g, w in zip(net(_t(x)), JQF(**kw).apply({"params": params}, x)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    with torch.no_grad():
        for p in net.parameters():  # zero biases take no part otherwise
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    params = _flax(net.state_dict())
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        want = JQF(**kw).apply({"params": p64}, jnp.asarray(x, jnp.float64))
        want = [np.asarray(w) for w in want]
    got = net.double()(torch.from_numpy(x.astype(np.float64)))
    for g, w, rtol in zip(got, want, (1e-6 if crop_pred else 1e-9, 1e-9)):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=rtol * np.abs(w).max())
    net.float()
    back = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert back.keys() == net.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in net.state_dict().items())


def test_discriminator_matches_jax():
    """The ``with_gan`` discriminator (dim 8) with converted weights and
    spectral vectors: the probabilities within 1e-5 and each new vector
    within 1e-6 (``update_sn=True``)."""
    net = Discriminator(dim=8)
    net.init_params(torch.Generator().manual_seed(6))
    x = _image(16, (2, 64, 64, 3))
    sd = net.state_dict()
    variables = {"params": _flax(sd), "spectral": jax.tree_util.tree_map(
        jnp.asarray, spectral_to_jax(sd))}
    want, new = JDisc(dim=8).apply(variables, x, update_sn=True,
                                   mutable=["spectral"])
    sn = {}
    got = net(_t(x), sn=sn)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    net.load_u(sn)
    jnew = spectral_to_jax(net.state_dict())
    for name, v in new["spectral"].items():
        np.testing.assert_allclose(jnew[name]["u"], np.asarray(v["u"]),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_gan_losses_match_jax():
    p = _image(17, (2, 4, 4, 1), lo=0.01, hi=0.99)
    logits = _image(18, (2, 4, 4, 1), lo=-3, hi=3)
    mask = _image(19, (2, 16, 16, 1))
    for real in (True, False):
        for disc in (True, False):
            for kind in ("nsgan", "lsgan", "hinge"):
                np.testing.assert_allclose(
                    float(adversarial_loss(_t(p), real, disc, kind)),
                    float(jlosses.adversarial_loss(p, real, disc, kind)),
                    rtol=1e-6)
        np.testing.assert_allclose(
            float(adversarial_loss(_t(p), False, True, "nsgan", _t(mask))),
            float(jlosses.adversarial_loss(p, False, True, "nsgan", mask)),
            rtol=1e-5)
        for kind in ("gan", "lsgan", "wgan-gp"):
            np.testing.assert_allclose(float(gan_loss(_t(logits), real,
                                                      kind)),
                                       float(jlosses.gan_loss(logits, real,
                                                              kind)),
                                       rtol=1e-6)


def _jax_vgg():
    net = perceptual.VGG19Features()
    net.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jperc._default_params(3)["params"])))
    return net.requires_grad_(False)


def test_perceptual_loss_matches_jax(tmp_path):
    """The VGG19 loss on JAX's seeded fallback weights carried into the
    port: value within 1e-5 relative, the gradient in x within 1e-5 of its
    max; the npz loader (``tools/convert_vgg19.py``'s layout) gives the
    same trunk."""
    x, y = _image(20, (1, 32, 32, 3)), _image(21, (1, 32, 32, 3))
    net = _jax_vgg()
    want = float(jperc.perceptual_loss(x, y))
    gwant = np.asarray(jax.grad(jperc.perceptual_loss)(x, y))
    xt = _t(x).requires_grad_(True)
    got = perceptual.perceptual_loss(xt, _t(y), net)
    gx, = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), gwant, rtol=0,
                               atol=1e-5 * np.abs(gwant).max())
    params = jperc._default_params(3)["params"]
    npz = tmp_path / "vgg.npz"
    np.savez(npz, **{f"{n}.{leaf}": np.asarray(v[leaf])
                     for n, v in params.items() for leaf in ("kernel",
                                                             "bias")})
    loaded = perceptual.load_vgg_npz(npz)
    assert all(torch.equal(a, b) for a, b in zip(
        loaded.state_dict().values(), net.state_dict().values()))
    assert not any(p.requires_grad for p in loaded.parameters())
