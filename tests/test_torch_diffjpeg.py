"""Parity of the port's DiffJPEG (K24's plain version), DiffJPEG pool,
4:2:0 ``jpeg_basic`` (K5's 4:2:0 mode, plain) and ``jpeg_mask`` with the
JAX package, forward values and input gradients, float32 on the CPU (the
kernel wrappers take their plain versions for CPU tensors).

Tolerances and why:

* DiffJPEG forward 1e-5 absolute (outputs in [0, 1]) and its VJP 1e-5 of the
  gradient's max: the port transforms each 8×8 block where JAX contracts
  whole rows with ``I ⊗ C8``, so the sums run in another order. The soft
  round jumps at |c/t| = ½ (x³ = 0.125 against 0.5); a coefficient within
  rounding of it may land on the other side, moving its 16×16 macroblock:
  such macroblocks are counted, at most one a case;
* ``jpeg_basic`` and ``jpeg_mask``: 1e-4 absolute outside 8×8 blocks whose
  rint or soft round flipped (at most one), as tests/test_torch_mbrs.py;
* the clip's tie: at a pixel whose pre-clip value is exactly 0 or 255 JAX's
  ``jnp.clip`` passes half the gradient. White blocks at some qualities
  land exactly on 255 in both packages (the test asserts that they do);
  there the VJPs agree and differ from ``torch.clamp``'s rule;
* F21: a NaN or Inf pixel is NaN on its 16×16 macroblock (DiffJPEG: the
  chroma's 8×8 block covers it) or its 8×8 block (K5's modes) in the port,
  on the whole image in JAX's dense transforms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.attacks import jpeg as jjpeg
from vwfd_tpu.ops import color as jcolor
from vwfd_tpu.ops import dct as jdct
from vwfd_tpu.ops.filters import avg_pool_2x2 as javg
from vwfd_tpu.ops.quantize import round_only_at_0 as jr0
from vwfd_tpu_torch.attacks import (diffjpeg, diffjpeg_pool, jpeg_basic,
                                    jpeg_mask, sample_diffjpeg_index)
from vwfd_tpu_torch.attacks.jpeg import QUALITIES
from vwfd_tpu_torch.kernels import diffjpeg as kdj
from vwfd_tpu_torch.kernels import KERNELS, PLAIN, launch_counts
from vwfd_tpu_torch.ops.quantize import clip_ties_half


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


def _vjp_torch(fn, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(cot))
    return _np(y), _np(g)


def _vjp_jax(fn, x, cot):
    y, pull = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(pull(jnp.asarray(cot))[0])


def _parted(got, want, atol, m):
    """m×m blocks of (N, H, W, 3) where |got − want| exceeds atol."""
    d = np.abs(got - want).max(-1)
    n, h, w = d.shape
    return int((d.reshape(n, h // m, m, w // m, m).max((2, 4)) > atol).sum())


def _factor(q):
    return (5000.0 / q if q < 50 else 200.0 - q * 2.0) / 100.0


def _image(seed, shape=(2, 32, 48, 3)):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    x[0, :16, :16] = 1.0   # a saturated macroblock (the clip's upper end)
    x[1, 16:, 32:] = 0.0   # and a black one
    return x


# ------------------------------------------------------------ DiffJPEG

@pytest.mark.parametrize("q", [90, 75, 50, 10])
def test_diffjpeg_matches_jax(q):
    x = _image(q)
    cot = np.random.default_rng(q + 1).standard_normal(x.shape).astype(
        np.float32)
    y, g = _vjp_torch(lambda v: diffjpeg(v, q), x, cot)
    yj, gj = _vjp_jax(lambda v: jjpeg.diffjpeg(v, q), x, cot)
    scale = np.abs(gj).max()
    assert _parted(y, yj, 1e-5, 16) <= 1
    assert _parted(g, gj, 1e-5 * scale, 16) <= 1
    assert np.abs(y - yj).max() <= 0.5 and np.abs(g - gj).max() <= scale


def _jax_preclip(img, factor):
    """JAX's ``diffjpeg`` up to its clip (the JAX package's own ops)."""
    x = img * 255.0
    ycc = jcolor.rgb_to_ycbcr_diffjpeg(x)
    planes = [ycc[..., 0], javg(ycc[..., 1:2])[..., 0],
              javg(ycc[..., 2:3])[..., 0]]
    out = []
    for i, chan in enumerate(planes):
        tbl = jjpeg._Y_TABLE_T if i == 0 else jjpeg._C_TABLE_T
        c = jdct.dct8x8(chan, center=True)
        t = jjpeg._tile_table(tbl, chan.shape[-2], chan.shape[-1]) * factor
        p = jdct.idct8x8(jr0(c / t) * t, center=True)
        if i:
            p = jnp.repeat(jnp.repeat(p, 2, axis=-2), 2, axis=-1)
        out.append(p)
    return jcolor.ycbcr_to_rgb_diffjpeg(jnp.stack(out, -1))


def test_clip_ties_half_is_jnp_clip():
    # (at a NaN JAX's gradient is 0 and autograd's 1: F21's territory)
    x = np.array([0.0, 255.0, 100.0, -1.0, 300.0], np.float32)
    y, g = _vjp_torch(lambda v: clip_ties_half(v, 0.0, 255.0), x,
                      np.ones_like(x))
    yj, gj = _vjp_jax(lambda v: jnp.clip(v, 0.0, 255.0), x, np.ones_like(x))
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(g, gj)
    np.testing.assert_array_equal(g, [0.5, 0.5, 1.0, 0.0, 0.0])


@pytest.mark.parametrize("q", [68, 77])
def test_diffjpeg_vjp_at_the_clip_bounds(q):
    """White blocks come back exactly on 255 at these qualities in both
    packages; there the gradient is JAX's ½, not ``torch.clamp``'s 1."""
    x = np.concatenate([np.ones((1, 32, 32, 3), np.float32),
                        _image(q, (2, 32, 32, 3))[1:]])
    ties = np.asarray(_jax_preclip(jnp.asarray(x), _factor(q))) == 255.0
    assert ties[0].all() and ties.sum() >= 3 * 32 * 32
    cot = np.random.default_rng(q).standard_normal(x.shape).astype(
        np.float32)
    y, g = _vjp_torch(lambda v: diffjpeg(v, q), x, cot)
    yj, gj = _vjp_jax(lambda v: jjpeg.diffjpeg(v, q), x, cot)
    np.testing.assert_array_equal(y[0], 1.0)
    np.testing.assert_allclose(g[0], gj[0], rtol=0,
                               atol=1e-5 * np.abs(gj).max())
    assert _parted(g, gj, 1e-5 * np.abs(gj).max(), 16) <= 1
    orig = kdj.clip_ties_half
    try:  # torch.clamp's rule at the ties: another gradient
        kdj.clip_ties_half = lambda v, lo, hi: torch.clamp(v, lo, hi)
        _, g_clamp = _vjp_torch(lambda v: diffjpeg(v, q), x, cot)
    finally:
        kdj.clip_ties_half = orig
    assert np.abs(g_clamp[0] - gj[0]).max() > 0.1 * np.abs(gj[0]).max()


def test_diffjpeg_pool_matches_jax():
    x = _image(3)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        idx = int(jax.random.randint(key, (), 0, 4))  # diffjpeg_pool's draw
        y, g = _vjp_torch(lambda v: diffjpeg_pool(v, idx), x, cot)
        yj, gj = _vjp_jax(lambda v: jjpeg.diffjpeg_pool(key, v), x, cot)
        assert _parted(y, yj, 1e-5, 16) <= 1
        assert _parted(g, gj, 1e-5 * np.abs(gj).max(), 16) <= 1


def test_diffjpeg_takes_a_single_image_and_per_frame_factors():
    x = _image(5)
    one = _np(diffjpeg(torch.from_numpy(x[1]), 75))
    both = _np(diffjpeg(torch.from_numpy(x), 75))
    np.testing.assert_array_equal(one, both[1])
    mixed = _np(diffjpeg(torch.from_numpy(x), factor=torch.tensor(
        [_factor(75), _factor(30)])))
    np.testing.assert_array_equal(mixed[0], both[0])
    np.testing.assert_array_equal(
        mixed[1], _np(diffjpeg(torch.from_numpy(x[1]), 30)))


def test_sample_diffjpeg_index_is_seeded_and_covers_the_pool():
    draws = [int(sample_diffjpeg_index(torch.Generator().manual_seed(s)))
             for s in range(64)]
    assert set(draws) == {0, 1, 2, 3}
    assert draws == [int(sample_diffjpeg_index(
        torch.Generator().manual_seed(s))) for s in range(64)]


def test_diffjpeg_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_image(6))
    f = torch.full((2,), 0.5)
    before = launch_counts()
    out = KERNELS.diffjpeg(x, f)
    assert launch_counts() == before
    assert torch.equal(out, PLAIN.diffjpeg(x, f))
    with pytest.raises(ValueError):
        kdj.diffjpeg(x[:, :24], f)  # H not a multiple of 16
    with pytest.raises(ValueError):
        kdj.diffjpeg(x, f[:1])
    with pytest.raises(TypeError):
        kdj.diffjpeg(x.to(torch.float16), f)


@pytest.mark.parametrize("q", [90, 50, 10])
def test_tie_macroblocks_cover_float32_noise(q):
    """``tie_macroblocks``' tolerances are at least four times the plain
    version's own float32-to-float64 distance of the coefficients and the
    pre-clip values; the float32 plain version parts from the float64 one
    only on the macroblocks it names (``chip_smoke.py`` and the card tests
    hold K24 to the same rule), and the saturated macroblock is a clip
    tie."""
    x = torch.from_numpy(_image(q, (2, 64, 64, 3)))
    f = torch.full((2,), _factor(q))
    c32, c64 = [], []
    r32 = kdj._plain_rgb(x, f, c32)
    r64 = kdj._plain_rgb(x.double(), f.double(), c64)
    dc = max(float((a.double() - b).abs().max())
             for (a, _), (b, _) in zip(c32, c64))
    assert 4 * dc <= kdj.JUMP_TOL
    assert 4 * float((r32.double() - r64).abs().max()) <= kdj.CLIP_TOL
    jump, grad = kdj.tie_macroblocks(x, f)
    assert bool(grad[0, 0, 0]) and bool(jump.logical_not().any())
    cot = torch.from_numpy(np.random.default_rng(q).standard_normal(
        x.shape).astype(np.float32))
    y, g = _vjp_torch(lambda v: kdj.diffjpeg_plain(v, f), _np(x), _np(cot))
    y64, g64 = _vjp_torch(lambda v: kdj.diffjpeg_plain(v, f.double()),
                          _np(x).astype(np.float64), _np(cot).astype(
                              np.float64))

    def parted(a, b, atol):
        d = np.abs(a - b).max(-1).reshape(2, 4, 16, 4, 16).max((2, 4))
        return torch.from_numpy(d > atol)
    assert not (parted(y, y64, 1e-6) & ~jump).any()
    assert not (parted(g, g64, 1e-6 * np.abs(g64).max()) & ~grad).any()


# ------------------------------------------------------------ 4:2:0 and mask

@pytest.mark.parametrize("rounding", ["round", "ss"])
@pytest.mark.parametrize("q_idx", [0, 2, 4])
def test_jpeg_basic_420_matches_jax(rounding, q_idx):
    x = np.random.default_rng(q_idx).random((2, 16, 24, 3)).astype(
        np.float32)
    q = QUALITIES[q_idx]
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)
    y, g = _vjp_torch(lambda v: jpeg_basic(v, torch.tensor(q_idx), rounding,
                                           subsample=2), x, cot)
    yj, gj = _vjp_jax(lambda v: jjpeg.jpeg_basic(v, q, rounding=rounding,
                                                 subsample=2), x, cot)
    assert _parted(y, yj, 1e-4, 8) <= 1
    assert np.abs(y - yj).max() <= 1.0
    assert _parted(g, gj, 1e-4 * np.abs(gj).max(), 8) <= 1
    # the chroma really is 4:2:0: not the 4:4:4 result
    y444 = _np(jpeg_basic(torch.from_numpy(x), torch.tensor(q_idx),
                          rounding))
    assert np.abs(y444 - y).max() > 1e-3


def test_jpeg_mask_matches_jax():
    x = np.random.default_rng(11).random((2, 16, 24, 3)).astype(np.float32)
    cot = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32)
    y, g = _vjp_torch(lambda v: jpeg_mask(v, 70), x, cot)
    yj, gj = _vjp_jax(lambda v: jjpeg.jpeg_mask(v, 70), x, cot)
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(g, gj, rtol=0, atol=1e-5 * np.abs(gj).max())


# ------------------------------------------------------------ F21

def _with_bad(bad, shape, at):
    x = np.random.default_rng(13).random(shape).astype(np.float32)
    x[at] = bad
    return x


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_diffjpeg_nonfinite_footprint_f21(bad):
    """F21 for DiffJPEG and its pool: a non-finite pixel of image 0 makes
    the port's output NaN on its 16×16 macroblock × 3 channels and nowhere
    else (its chroma block covers the macroblock; an Inf may leave a value
    that the IDCT sums to ±Inf, which the clip takes to 0 or 1), JAX's on
    the whole image; image 1 agrees."""
    x = _with_bad(bad, (2, 32, 48, 3), (0, 19, 37, 1))
    mb = np.zeros(x.shape, bool)
    mb[0, 16:32, 32:48] = True
    for got, want in (
            (_np(diffjpeg(torch.from_numpy(x), 75)),
             np.asarray(jjpeg.diffjpeg(jnp.asarray(x), 75))),
            (_np(diffjpeg_pool(torch.from_numpy(x), 1)),
             np.asarray(jjpeg.diffjpeg(jnp.asarray(x), 70)))):
        nan = np.isnan(got)
        assert not nan[~mb].any() and nan[mb].mean() > 0.99
        assert np.isnan(want[0]).all() and np.isfinite(want[1]).all()
        assert _parted(got[1:], want[1:], 1e-5, 16) <= 1


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("which", ["basic420", "mask"])
def test_jpeg_420_and_mask_nonfinite_footprint_f21(bad, which):
    """F21 for ``jpeg_basic(subsample=2)`` and ``jpeg_mask``: the port's NaN
    is the pixel's 8×8 block × 3 channels (a bad pixel on an even row and
    column is the source of its 2×2's chroma, inside the block), JAX's the
    whole image."""
    x = _with_bad(bad, (2, 16, 24, 3), (0, 4, 10, 2))
    xt = torch.from_numpy(x)
    if which == "mask":
        got = _np(jpeg_mask(xt))
        want = np.asarray(jjpeg.jpeg_mask(jnp.asarray(x)))
    else:
        got = _np(jpeg_basic(xt, torch.tensor(2), "ss", subsample=2))
        want = np.asarray(jjpeg.jpeg_basic(jnp.asarray(x), 70, rounding="ss",
                                           subsample=2))
    block = np.zeros(x.shape, bool)
    block[0, 0:8, 8:16] = True
    np.testing.assert_array_equal(np.isnan(got), block)
    assert np.isnan(want[0]).all() and np.isfinite(want[1]).all()
    assert _parted(got[1:], want[1:], 1e-4, 8) <= 1
