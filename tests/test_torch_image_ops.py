"""Parity of the image family's ops with vwfd_tpu's, on the CPU in float32.

* ``symm_pad``, ``srm_conv``, ``bayar_constrain`` (with its gradient):
  within 1e-6 (the SRM bank is one ``F.conv2d`` where JAX sums 25 views);
* ``sobel_edges`` EQUAL; ``canny_soft``'s plain version (K19's) forward
  within 2e-6 (XLA's logistic and ``torch.sigmoid`` part by one ulp on
  0.4 % of inputs, and the threshold's slope 20 amplifies it: 98 % of the
  maps are EQUAL, the largest difference measured 1.01e-6) and its input
  gradient within 1e-5 of the gradient's max, on
  continuous, 8-bit, blocky and flat images (a flat image ties every pixel
  at the max: both gradients 0);
* F24: the JAX form's gradient within a few pixels of each image corner is
  rounding noise (the Sobel's structural zeros); measured against the
  float64 exact gradient, and the port's ``exact_border`` variant (K19's
  semantics) within 1e-5 of it;
* ``rect_mask``, ``shift_zero_pad`` and ``copy_move_tamper`` (shifts from
  the JAX key by its own formula) EQUAL, the tamper's gradient too;
* the host canny (``data/edges.py``) EQUAL to ``cv2`` on synthetic, noise
  and flat images at 32² and 256².
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.attacks import spatial as jspatial
from vwfd_tpu.ops import canny as jcanny
from vwfd_tpu.ops import filters as jfilters
from vwfd_tpu.ops.pad import symm_pad as jsymm_pad
from vwfd_tpu_torch.attacks import (copy_move_shift, copy_move_tamper,
                                    rect_mask, shift_zero_pad)
from vwfd_tpu_torch.data import (SyntheticImageDataset, canny_map, canny_u8,
                                 rgb_to_gray_u8)
from vwfd_tpu_torch.kernels.canny import canny_soft, canny_soft_plain
from vwfd_tpu_torch.ops.canny import sobel_edges
from vwfd_tpu_torch.ops.filters import bayar_constrain, srm_conv
from vwfd_tpu_torch.ops.pad import symm_pad

FWD_ATOL, GRAD_RTOL = 1e-6, 1e-5
CANNY_FWD_ATOL = 2e-6


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _images(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    n, h, w, _ = shape
    if kind == "rand":
        x = rng.random(shape)
    elif kind == "levels":
        x = rng.integers(0, 256, shape) / 255.0
    elif kind == "flat":
        x = np.full(shape, 0.3)
    else:  # blocky: 8×8 blocks plus 5 % noise, the synthetic set's form
        b = rng.random((n, h // 8, w // 8, 3))
        x = np.clip(np.repeat(np.repeat(b, 8, 1), 8, 2)
                    + 0.05 * rng.random(shape), 0, 1)
    return x.astype(np.float32)


@pytest.mark.parametrize("pad", [(2, 2, 2, 2), (1, 3, 0, 2), (5, 0, 4, 1)])
def test_symm_pad_matches_jax(pad):
    x = np.random.default_rng(1).random((2, 7, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(symm_pad(_t(x), pad).numpy(),
                                  np.asarray(jsymm_pad(jnp.asarray(x), pad)))


def test_srm_conv_matches_jax():
    x = np.random.default_rng(2).random((2, 20, 18, 3)).astype(np.float32)
    np.testing.assert_allclose(srm_conv(_t(x)).numpy(),
                               np.asarray(jfilters.srm_conv(jnp.asarray(x))),
                               rtol=0, atol=FWD_ATOL)


def test_bayar_constrain_and_gradient_match_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 5, 3, 3)).astype(np.float32)
    cot = rng.standard_normal(w.shape).astype(np.float32)
    want, vjp = jax.vjp(jfilters.bayar_constrain, jnp.asarray(w))
    wt = _t(w, True)
    got = bayar_constrain(wt)
    (g,) = torch.autograd.grad(got, wt, _t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=FWD_ATOL)
    gw = np.asarray(vjp(jnp.asarray(cot))[0])
    np.testing.assert_allclose(g.numpy(), gw, rtol=0,
                               atol=GRAD_RTOL * np.abs(gw).max())
    assert np.all(got.detach().numpy()[2, 2] == -1.0)


def test_sobel_edges_match_jax():
    x = np.random.default_rng(4).random((2, 9, 12, 1)).astype(np.float32)
    gx, gy = sobel_edges(_t(x))
    jx, jy = jcanny.sobel_edges(jnp.asarray(x))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))


def _canny_both(fn, x, cot):
    xt = _t(x, True)
    y = fn(xt)
    (g,) = torch.autograd.grad(y, xt, _t(cot))
    return y.detach().numpy(), g.numpy()


def _jax_canny(x, cot):
    y, vjp = jax.vjp(jcanny.canny_soft, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("kind,shape", [("rand", (3, 32, 40, 3)),
                                        ("levels", (2, 32, 32, 3)),
                                        ("blocky", (2, 32, 32, 3)),
                                        ("flat", (2, 16, 24, 3))])
def test_canny_soft_matches_jax(kind, shape):
    """The plain version against JAX, forward and input gradient. A flat
    image ties every pixel at the max (``jnp.max``'s gradient shares it
    evenly, ``amax`` does the same) and has c = s = 0 (the +1 neighbours
    picked, |·|'s gradient +1 there): both gradients are exactly 0."""
    x = _images(kind, shape)
    cot = np.random.default_rng(5).standard_normal(
        shape[:3] + (1,)).astype(np.float32)
    yj, gj = _jax_canny(x, cot)
    yp, gp = _canny_both(canny_soft, x, cot)
    np.testing.assert_allclose(yp, yj, rtol=0, atol=CANNY_FWD_ATOL)
    np.testing.assert_allclose(gp, gj, rtol=0,
                               atol=GRAD_RTOL * max(np.abs(gj).max(), 1e-30))
    if kind == "flat":
        assert not gj.any() and not gp.any()


def _exact_canny_grad(x, cot):
    """The float64 gradient of the JAX form with the Sobel's structural
    zeros exact (``exact_border``): the reference F24 is measured against."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        from vwfd_tpu_torch.kernels import canny as kc
        xt = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
        # the float32 plain version's steps, in float64
        g = xt[..., 0] * 0.299 + xt[..., 1] * 0.587 + xt[..., 2] * 0.114
        h, w = g.shape[-2:]
        gp = kc._reflect(g, 2)
        k = kc.gaussian_kernel_2d(5, 1.0)
        sm = torch.zeros_like(g)
        for dy in range(5):
            for dx in range(5):
                sm = sm + float(k[dy, dx]) * gp[:, dy:dy + h, dx:dx + w]
        gx, gy = kc._sobel(sm)
        cols = torch.zeros(w, dtype=torch.bool)
        rows = torch.zeros(h, 1, dtype=torch.bool)
        cols[0] = cols[-1] = rows[0] = rows[-1] = True
        gx = torch.where(cols, torch.zeros(()), gx)
        gy = torch.where(rows, torch.zeros(()), gy)
        y = kc._nms_threshold(gx, gy)[..., None]
        (gr,) = torch.autograd.grad(y, xt, torch.from_numpy(
            cot.astype(np.float64)))
        return gr.numpy()
    finally:
        torch.set_default_dtype(prev)


def test_canny_soft_corner_gradient_noise_f24():
    """F24 pinned. On these 8-bit images JAX's float32 gradient parts from
    the float64 exact one by more than 1e-3 of its max within 4 pixels of
    an image corner (measured 2.4e-2) and by less than ``F32_RTOL``
    elsewhere (float32 against float64); the plain version (the same
    operations in the same order) has the same noise (within 1e-5 of
    JAX's); the ``exact_border`` variant, K19's semantics, is within
    ``F32_RTOL`` of the exact gradient everywhere, and its forward is the
    plain one's, EQUAL."""
    F32_RTOL = 5e-5
    rng = np.random.default_rng(0)
    rng.random((4, 64, 64, 3))
    x = (np.round(rng.random((4, 64, 64, 3)) * 255) / 255).astype(np.float32)
    cot = rng.standard_normal((4, 64, 64, 1)).astype(np.float32)
    exact = _exact_canny_grad(x, cot)
    scale = np.abs(exact).max()
    _, gj = _jax_canny(x, cot)
    yp, gp = _canny_both(canny_soft_plain, x, cot)
    ye, ge = _canny_both(lambda t: canny_soft_plain(t, exact_border=True),
                         x, cot)
    noise = np.abs(gj - exact).max(-1) / scale
    corner = np.zeros((64, 64), bool)
    for r in (slice(0, 4), slice(60, 64)):
        for c in (slice(0, 4), slice(60, 64)):
            corner[r, c] = True
    assert noise[:, corner].max() > 1e-3
    assert noise[:, ~corner].max() < F32_RTOL
    np.testing.assert_allclose(gp, gj, rtol=0, atol=GRAD_RTOL * scale)
    np.testing.assert_allclose(ge, exact, rtol=0, atol=F32_RTOL * scale)
    np.testing.assert_array_equal(ye, yp)


def test_canny_soft_takes_nhwc_float32_rgb():
    with pytest.raises(TypeError):
        canny_soft(torch.zeros(1, 8, 8, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        canny_soft(torch.zeros(1, 2, 8, 3))
    with pytest.raises(ValueError):
        canny_soft(torch.zeros(1, 8, 8, 4))


def test_rect_mask_matches_jax():
    apex = (3.0, 20.0, 5.0, 31.0)
    np.testing.assert_array_equal(
        rect_mask((24, 32), torch.tensor(apex).unbind()).numpy(),
        np.asarray(jspatial.rect_mask((24, 32), apex)))


@pytest.mark.parametrize("shift", [(0, 0), (5, -7), (-16, 15), (16, -16)])
def test_shift_zero_pad_matches_jax(shift):
    x = np.random.default_rng(7).random((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        shift_zero_pad(_t(x), *shift).numpy(),
        np.asarray(jspatial.shift_zero_pad(jnp.asarray(x), *shift)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copy_move_tamper_matches_jax(seed):
    """At the shift JAX draws from its key: the tampered image, the shifted
    mask and the image's gradient (the pasted source takes none)."""
    rng = np.random.default_rng(8 + seed)
    img = rng.random((2, 32, 32, 3)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 1)) > 0.6).astype(np.float32)
    cot = rng.standard_normal(img.shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    kx, ky = jax.random.split(key)
    shift = copy_move_shift(float(jax.random.uniform(kx, ())),
                            float(jax.random.uniform(ky, ())), (32, 32))
    (jt, jm), vjp = jax.vjp(
        lambda a: jspatial.copy_move_tamper(key, a, jnp.asarray(mask)),
        jnp.asarray(img))
    jg = np.asarray(vjp((jnp.asarray(cot), jnp.zeros_like(jm)))[0])
    it = _t(img, True)
    tt, tm = copy_move_tamper(it, _t(mask), shift)
    (tg,) = torch.autograd.grad(tt, it, _t(cot))
    np.testing.assert_array_equal(tt.detach().numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tg.numpy(), jg)


def _canny_images():
    rng = np.random.default_rng(9)
    out = []
    for s in (32, 256):
        ds = SyntheticImageDataset(size=s, length=4, seed=10)
        out += [(f"synthetic{s}_{i}", ds[i]) for i in range(4)]
        out.append((f"noise{s}", rng.random((s, s, 3)).astype(np.float32)))
        out.append((f"flat{s}", np.full((s, s, 3), 0.4, np.float32)))
    return out


@pytest.mark.parametrize("name,img", _canny_images(),
                         ids=[n for n, _ in _canny_images()])
def test_host_canny_equals_cv2(name, img):
    """The gray image EQUAL to ``cv2.cvtColor`` (OpenCV 5's 15-bit luma) and
    the map EQUAL to ``cv2.Canny(gray, 100, 200)``, as the JAX package's
    data compute it."""
    u8 = (img * 255).astype(np.uint8)
    gray = cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(rgb_to_gray_u8(u8), gray)
    want = cv2.Canny(gray, 100, 200)
    np.testing.assert_array_equal(canny_u8(gray), want)
    np.testing.assert_array_equal(
        canny_map(img), (want.astype(np.float32) / 255.0)[..., None])
