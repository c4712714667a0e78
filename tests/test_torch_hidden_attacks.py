"""Parity of the port's HiDDeN noise members with vwfd_tpu's, on the CPU in
float32: the analog colour pair, the zig-zag JPEG mask compression (K16's
plain version) with and without its clip, ``crop_resize`` (K17's plain
version), the crop window, cropout, dropout and the pixel-noise members.

The JAX members draw from a key; the port's take the draws as tensors.
Each test derives the draws from the JAX key with the JAX code's split
sequence (``vwfd_tpu/attacks/spatial.py:53-108``, ``noise.py:7-29``) and
hands them to the port, so both sides compute on the same numbers.

Tolerances and why:

* the colour pair within 2.5e-7 absolute on values below 2 (one float32
  ulp: XLA's dot sums the three products in its own order); the crop
  window EQUAL (the same float32 operations in the same order);
* ``zigzag_jpeg`` forward within 2e-6 absolute (values of order 1: the
  JAX package's block-diagonal products sum the DCT in another order than
  the port's 8×8 products), its input gradient within 1e-6 of the JAX
  gradient's max; on an 8×8 block of zeros z is exactly 0 on both sides,
  and each side's gradient there is exactly ½ of its unclipped one
  (``jnp.clip``'s tie), on a block of 2s exactly 0;
* ``crop_resize`` forward within 1e-6 absolute (XLA may fuse the tap
  products) and its gradient within 1e-6 of the JAX gradient's max
  (scatter-adds in another order); with NaN and Inf pixels the same, and
  NaN and ±Inf at the same places;
* F21: a NaN or Inf pixel makes ``zigzag_jpeg``'s 8×8 block NaN in the
  port and the whole image NaN in JAX (dense block-diagonal products):
  both footprints are pinned;
* cropout, dropout and the pixel-noise members: EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.attacks import jpeg as jjpeg
from vwfd_tpu.attacks import noise as jnoise
from vwfd_tpu.attacks import spatial as jspatial
from vwfd_tpu.ops import color as jcolor
from vwfd_tpu.ops import resize as jresize
from vwfd_tpu_torch.attacks import (crop_attack, cropout, dropout_mix,
                                    dropout_pixelwise, gaussian_noise,
                                    hidden_jpeg_mask_compression, identity,
                                    salt_pepper, sample_crop_apex,
                                    zigzag_keep_mask)
from vwfd_tpu_torch.kernels import PLAIN, crop_resize, launch_counts, zigzag
from vwfd_tpu_torch.ops import color

_JIT_JPEG = jax.jit(jjpeg.hidden_jpeg_mask_compression)
_JIT_JPEG_CLIP = jax.jit(lambda x: jnp.clip(
    jjpeg.hidden_jpeg_mask_compression(x), 0.0, 1.0))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _image(seed, shape=(2, 32, 32, 3), lo=-0.1, hi=1.1):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(shape)).astype(np.float32)


def test_analog_colour_pair_equals_jax():
    """The reference's analog constants bit for bit (not each other's
    inverse), and both maps within one ulp of JAX's on the same pixels."""
    np.testing.assert_array_equal(color.RGB2YUV_ANALOG,
                                  np.asarray(jcolor._M_RGB2YUV_ANALOG))
    np.testing.assert_array_equal(color.YUV2RGB_ANALOG,
                                  np.asarray(jcolor._M_YUV2RGB_ANALOG))
    prod = color.YUV2RGB_ANALOG.astype(np.float64) @ color.RGB2YUV_ANALOG
    assert np.abs(prod - np.eye(3)).max() > 1e-5  # not an inverse pair
    x = _image(0)
    for port, ref in ((color.rgb_to_yuv_analog, jcolor.rgb_to_yuv_analog),
                      (color.yuv_to_rgb_analog, jcolor.yuv_to_rgb_analog)):
        np.testing.assert_allclose(port(_t(x)).numpy(), np.asarray(ref(x)),
                                   rtol=0, atol=2.5e-7)


@pytest.mark.parametrize("keep", [0, 1, 9, 10, 25, 64])
def test_zigzag_keep_mask_equals_jax(keep):
    np.testing.assert_array_equal(zigzag_keep_mask(8, keep, 24, 16),
                                  jjpeg.zigzag_keep_mask(8, keep, 24, 16))


def test_keep_bits_are_the_block_masks():
    """K16 takes each channel's mask as 64 bits, bit 8k + l."""
    for bits, m in zip(zigzag.keep_bits(), zigzag.keep_blocks()):
        got = np.array([(bits >> i) & 1 for i in range(64)], np.float32)
        np.testing.assert_array_equal(got.reshape(8, 8), m)
    assert [int(m.sum()) for m in zigzag.keep_blocks()] == [25, 9, 9]


@pytest.mark.parametrize("clip", [False, True])
def test_zigzag_jpeg_plain_matches_jax(clip):
    """Forward and input gradient of K16's plain version against
    ``hidden_jpeg_mask_compression`` (and ``jnp.clip``)."""
    x = _image(1)
    x[0, :8, :8] = 0.0       # z = 0 exactly: the clip's tie
    x[1, 8:16, :8] = 2.0     # z far above 1: the clip's zero gradient
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)
    ref = _JIT_JPEG_CLIP if clip else _JIT_JPEG
    want = np.asarray(ref(x))
    gwant = np.asarray(jax.grad(lambda v: jnp.sum(ref(v) * cot))(x))
    xt = _t(x).requires_grad_(True)
    y = hidden_jpeg_mask_compression(xt, clip=clip)
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(xt.grad.numpy(), gwant, rtol=0,
                               atol=1e-6 * np.abs(gwant).max())
    if clip:
        # the tie block: z exactly 0 on both sides, so the gradient there is
        # exactly ½ of the unclipped one on each side (the block's map is
        # linear and a factor of ½ rounds nothing); the block of 2s has none
        assert not want[0, :8, :8].any() and not y[0, :8, :8].any()
        g_free = np.asarray(jax.grad(lambda v: jnp.sum(_JIT_JPEG(v) * cot))(
            x))
        xf = _t(x).requires_grad_(True)
        (hidden_jpeg_mask_compression(xf) * _t(cot)).sum().backward()
        np.testing.assert_array_equal(gwant[0, :8, :8],
                                      0.5 * g_free[0, :8, :8])
        np.testing.assert_array_equal(xt.grad.numpy()[0, :8, :8],
                                      0.5 * xf.grad.numpy()[0, :8, :8])
        assert not gwant[1, 8:16, :8].any() and not xt.grad[1, 8:16, :8].any()


def test_clip01_gradient_is_jnp_clip_s():
    """½ at 0 and at 1, 1 inside, 0 outside, NaN passes: ``jnp.clip``."""
    v = np.array([0.0, 1.0, 0.5, -1.0, 2.0, -0.0], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0)))(v))
    t = _t(v).requires_grad_(True)
    zigzag.clip01(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.5, 0.5, 1.0, 0.0, 0.0, 0.5])
    assert torch.isnan(zigzag.clip01(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_zigzag_jpeg_nonfinite_footprint_f21(bad):
    """F21, pinned both ways: a NaN or Inf value in image 0 makes the
    port's ``zigzag_jpeg(clip=True)`` (K16's plain version, blockwise like
    K16) NaN on exactly its 8×8 block × 3 channels, forward and in the
    gradient of a squared error, and JAX's (dense block-diagonal ``dct8x8``,
    whose zeros multiply the NaN) NaN on the whole image; image 1 agrees
    with JAX within the tolerances above."""
    x = _image(6)
    x[0, 10, 13, 1] = bad
    target = np.random.default_rng(7).random(x.shape).astype(np.float32)
    want = np.asarray(_JIT_JPEG_CLIP(x))
    gwant = np.asarray(jax.grad(lambda v: jnp.sum(
        (_JIT_JPEG_CLIP(v) - target) ** 2))(x))
    xt = _t(x).requires_grad_(True)
    y = hidden_jpeg_mask_compression(xt, clip=True)
    ((y - _t(target)) ** 2).sum().backward()
    block = np.zeros(x.shape, bool)
    block[0, 8:16, 8:16] = True
    np.testing.assert_array_equal(np.isnan(y.detach().numpy()), block)
    np.testing.assert_array_equal(np.isnan(xt.grad.numpy()), block)
    assert np.isnan(want[0]).all() and np.isnan(gwant[0]).all()
    assert np.isfinite(want[1]).all() and np.isfinite(gwant[1]).all()
    np.testing.assert_allclose(y.detach().numpy()[1], want[1], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(xt.grad.numpy()[1], gwant[1], rtol=0,
                               atol=1e-6 * np.abs(gwant[1]).max())


def test_zigzag_wrapper_takes_the_plain_version_on_the_cpu():
    x = _t(_image(3, (1, 16, 8, 3)))
    before = launch_counts()
    got = zigzag.zigzag_jpeg(x, clip=True)
    assert launch_counts() == before
    assert torch.equal(got, zigzag.zigzag_jpeg_plain(x, clip=True))
    assert torch.equal(PLAIN.zigzag_jpeg(x, (25, 9, 9), True), got)
    with pytest.raises(ValueError):
        zigzag.zigzag_jpeg(torch.zeros(1, 12, 8, 3))   # H not a multiple of 8
    with pytest.raises(TypeError):
        zigzag.zigzag_jpeg(torch.zeros(1, 8, 8, 3, dtype=torch.int32))


# windows (h0, h1, w0, w1): inside, the whole image, at each edge, one
# pixel, a row, and HiDDeN's smallest crop
_APEXES = [(3.0, 20.0, 5.0, 29.0), (0.0, 32.0, 0.0, 32.0),
           (14.0, 32.0, 0.0, 17.0), (0.0, 9.0, 23.0, 32.0),
           (7.0, 8.0, 11.0, 12.0), (5.0, 6.0, 0.0, 32.0),
           (2.0, 19.0, 6.0, 23.0)]


@pytest.mark.parametrize("apex", _APEXES)
def test_crop_resize_matches_jax(apex):
    x = _image(4, lo=0.0, hi=1.0)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    ref = jax.jit(lambda v, a: jresize.crop_resize(v, a))
    a = jnp.asarray(apex, jnp.float32)
    want = np.asarray(ref(x, a))
    gwant = np.asarray(jax.grad(lambda v: jnp.sum(ref(v, a) * cot))(x))
    xt = _t(x).requires_grad_(True)
    y = crop_attack(xt, torch.tensor(apex))
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), gwant, rtol=0,
                               atol=1e-6 * np.abs(gwant).max())
    assert torch.equal(crop_resize.crop_resize(_t(x), apex),
                       crop_resize.crop_resize_plain(_t(x),
                                                     torch.tensor(apex)))


# XLA's algsimp turns the division by an output side into a product with
# its reciprocal (one ulp off the coordinates); the plain version divides
_NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}


@pytest.mark.parametrize("apex,out_hw", [((3.0, 20.0, 5.0, 29.0), None),
                                         ((3.0, 20.0, 5.0, 29.0), (24, 40)),
                                         ((0.0, 32.0, 0.0, 32.0), (40, 16))])
def test_crop_resize_nonfinite_matches_jax(apex, out_hw):
    """A NaN and an Inf pixel inside the window and a NaN in the
    cotangent, also to another output size: K17's plain version is NaN
    (and ±Inf) exactly where JAX's is, forward and gradient (each tap
    multiplies, a weight of 0 too), and within 1e-6 elsewhere."""
    x = _image(8, lo=0.0, hi=1.0)
    x[0, 7, 9, 1] = np.nan
    x[1, 12, 20, 0] = np.inf
    oshape = x.shape if out_hw is None else (2, *out_hw, 3)
    cot = np.random.default_rng(9).standard_normal(oshape).astype(np.float32)
    cot[1, 5, 6, 2] = np.nan
    a = jnp.asarray(apex, jnp.float32)

    def ref(v, a):
        return jresize.crop_resize(v, a, out_hw)
    want = np.asarray(jax.jit(ref).lower(x, a).compile(
        compiler_options=_NO_ALGSIMP)(x, a))
    grad = jax.grad(lambda v, a, c: jnp.sum(ref(v, a) * c))
    gwant = np.asarray(jax.jit(grad).lower(x, a, cot).compile(
        compiler_options=_NO_ALGSIMP)(x, a, cot))
    xt = _t(x).requires_grad_(True)
    y = crop_resize.crop_resize(xt, torch.tensor(apex), out_hw)
    (y * _t(cot)).sum().backward()
    for got, ref_, scale in ((y.detach().numpy(), want, False),
                             (xt.grad.numpy(), gwant, True)):
        assert np.isnan(ref_).any()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref_))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref_))
        fin = np.isfinite(ref_)
        np.testing.assert_array_equal(got[np.isinf(got)],
                                      ref_[np.isinf(ref_)])
        atol = 1e-6 * (np.abs(ref_[fin]).max() if scale else 1.0)
        np.testing.assert_allclose(got[fin], ref_[fin], rtol=0, atol=atol)


def _uniforms(keys, shape=()):
    return _t([np.asarray(jax.random.uniform(k, shape)) for k in keys])


@pytest.mark.parametrize("seed", range(6))
def test_sample_crop_apex_equals_jax(seed):
    """The crop window from the four U[0, 1) draws of the JAX key's
    ``split(key, 4)``, at HiDDeN's rates and the JAX defaults."""
    key = jax.random.PRNGKey(seed)
    u = _uniforms(jax.random.split(key, 4))
    for rates in ((0.55, 1.0), (0.5, 1.0)):
        want = np.array([float(v) for v in jspatial.sample_crop_apex(
            key, (128, 96), *rates)], np.float32)
        np.testing.assert_array_equal(
            sample_crop_apex(u, (128, 96), *rates).numpy(), want)


@pytest.mark.parametrize("ratio", [0.5, 0.5477])
@pytest.mark.parametrize("seed", range(3))
def test_cropout_equals_jax(seed, ratio):
    key = jax.random.PRNGKey(10 + seed)
    e, c = _image(6, lo=0, hi=1), _image(7, lo=0, hi=1)
    u = _uniforms([key, jax.random.fold_in(key, 1)])
    want = np.asarray(jspatial.cropout(key, e, c, ratio, ratio))
    np.testing.assert_array_equal(
        cropout(_t(e), _t(c), u, ratio, ratio).numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_dropout_mix_equals_jax(seed):
    """One keep ratio and one (H, W) mask shared by the batch."""
    key = jax.random.PRNGKey(20 + seed)
    e, c = _image(8, lo=0, hi=1), _image(9, lo=0, hi=1)
    k1, k2 = jax.random.split(key)
    keep_u = _t(np.asarray(jax.random.uniform(k1, ())))
    mask_u = _t(np.asarray(jax.random.uniform(k2, e.shape[-3:-1])))
    want = np.asarray(jspatial.dropout_mix(key, e, c))
    np.testing.assert_array_equal(dropout_mix(_t(e), _t(c), keep_u,
                                              mask_u).numpy(), want)


def test_pixel_noise_members_equal_jax():
    key = jax.random.PRNGKey(30)
    e, c = _image(10, lo=0, hi=1), _image(11, lo=0, hi=1)
    noise = _t(np.asarray(jax.random.normal(key, e.shape, jnp.float32)))
    rdn = _t(np.asarray(jax.random.uniform(key, e.shape)))
    np.testing.assert_array_equal(identity(_t(e)).numpy(),
                                  np.asarray(jnoise.identity(key, e)))
    np.testing.assert_array_equal(
        gaussian_noise(_t(e), noise).numpy(),
        np.asarray(jnoise.gaussian_noise(key, e)))
    np.testing.assert_array_equal(
        gaussian_noise(_t(e), noise, clip=False).numpy(),
        np.asarray(jnoise.gaussian_noise(key, e, clip=False)))
    np.testing.assert_array_equal(
        salt_pepper(_t(e), rdn, 0.2).numpy(),
        np.asarray(jnoise.salt_pepper(key, e, 0.2)))
    np.testing.assert_array_equal(
        dropout_pixelwise(_t(e), _t(c), rdn).numpy(),
        np.asarray(jnoise.dropout_pixelwise(key, e, c)))


@pytest.mark.parametrize("shape", [(128, 128), (8, 2 * 2639), (2160, 3840),
                                   (8, 2640)])
def test_crop_resize_tiles_cover_any_width(shape):
    """K17's column tiles (F22), picked on the host: whole rows (one tile a
    row, the whole-row kernels) where they fit, as at HiDDeN's 128²; past
    ``max_width`` the widest tile whose CTA fits two an SM, the tiles of
    even width covering the row; only a pixel of too many channels is
    refused."""
    h, w = shape
    tw, tq = crop_resize.tiles(h, w, 3, h, w)
    fwd, bwd = crop_resize.smem_bytes(h, w, 3, h, w)
    assert (tw == w) == (fwd <= crop_resize.SMEM_CTA)
    assert (tq == w) == (bwd <= crop_resize.SMEM_CTA)
    assert (tw, tq) == (w, w) or w > crop_resize.max_width(h, 3, h)
    for t, smem_of in ((tw, lambda t: crop_resize._fwd_tiled_smem(
            h, w, 3, h, w, t)), (tq, lambda t: crop_resize._bwd_tiled_smem(
            3, h, w, t))):
        if t < w:
            n = -(-w // t)
            assert smem_of(t) <= crop_resize.SMEM_PAIR
            assert n * t >= w and (n - 1) * t < w
            assert smem_of(-(-w // (n - 1))) > crop_resize.SMEM_PAIR
    with pytest.raises(ValueError, match="too many channels"):
        crop_resize.tiles(h, w, 7000, h, w)
