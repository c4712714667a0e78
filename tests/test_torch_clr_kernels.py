"""K21's backward and the host-side plans of K21 and K22, on the CPU.

``rectify_backward_plain`` (the PyTorch ops that are K21's backward's plain
version, what CPU tensors take) against ``jax.grad`` of
``vwfd_tpu/attacks/spatial.py::rectify_crop_pad`` over clean images tiled
as the image model tiles them, a NaN cotangent outside the window too;
``kernels/rectify.py::plan`` (every output row of a copy taken by exactly
one CTA, shared memory within a CTA's) and
``kernels/ssim_grad.py::plan`` (every output pixel written by exactly one
CTA, shared memory within a CTA's, the rows a segment stages and the α
rows it forms reaching the window's halo), at both CLR step shapes and
down to 1×1 and 11×5; and the plans' constants and the C interface's
argument counts against ``csrc/rectify.cu`` and ``csrc/ssim_grad.cu``.
The kernels themselves run on the card only (``tests/test_torch_gpu.py``).

Tolerance: the backward within 1e-6 of the JAX gradient's max (the same
products, summed over the copies in another order), NaN at JAX's places.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.attacks import spatial as jspatial
from vwfd_tpu_torch.kernels import _lib, launch_counts, rectify, ssim_grad
from vwfd_tpu_torch.kernels._lib import CSRC

_NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}
SMEM_CTA = 227 * 1024
SMS = 132  # the H100's SMs; the plans take the card's count as an argument

# windows: inside, on the bottom and right edges, one pixel high, the image
APEXES = [(3.0, 27.0, 5.0, 30.0), (19.0, 32.0, 12.0, 32.0),
          (9.0, 10.0, 4.0, 29.0), (0.0, 32.0, 0.0, 32.0)]


def _image(seed, shape, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(shape)).astype(np.float32)


@pytest.mark.parametrize("apex", APEXES)
@pytest.mark.parametrize("nan_cot", [False, True])
def test_rectify_backward_plain_matches_jax(apex, nan_cot):
    """The gradient into the clean images of ``rectify_crop_pad`` on 3
    copies tiled over 2 clean images: within 1e-6 of JAX's max; a NaN
    cotangent outside the window gives NaN where JAX's ``g·inside`` does
    (NaN·0); the wrapper on CPU tensors launches nothing."""
    reps, b = 3, 2
    att = _image(21, (reps * b, 32, 32, 3), -0.1, 1.1)
    clean = _image(22, (b, 32, 32, 3))
    cot = np.random.default_rng(23).standard_normal(att.shape).astype(
        np.float32)
    if nan_cot:
        cot[4, 31, 0, 1] = np.nan  # outside every window but the image's
        cot[1, 0, 31, 2] = np.nan
    a = jnp.asarray(apex, jnp.float32)

    def loss(c, v, a, g):
        return jnp.sum(jspatial.rectify_crop_pad(
            v, jnp.tile(c, (reps, 1, 1, 1)), a) * g)
    fn = jax.jit(jax.grad(loss)).lower(clean, att, a, cot).compile(
        compiler_options=_NO_ALGSIMP)
    want = np.asarray(fn(clean, att, a, cot))
    before = launch_counts()
    got = rectify.rectify_backward(torch.from_numpy(cot),
                                   torch.tensor(apex), reps).numpy()
    assert launch_counts() == before
    assert got.shape == clean.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() == nan_cot
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=1e-6 * np.abs(want[fin]).max())
    np.testing.assert_array_equal(
        got, rectify.rectify_backward_plain(torch.from_numpy(cot),
                                            torch.tensor(apex), reps).numpy())


# (copies, clean images, H, W): the train step's and the 512² record's, and
# edge shapes down to one pixel
RECT_SHAPES = [(48, 8, 256, 256), (9, 3, 512, 512), (6, 2, 40, 70),
               (1, 1, 1, 1), (3, 3, 11, 5), (2, 1, 9, 300), (7, 7, 33, 2)]


@pytest.mark.parametrize("shape", RECT_SHAPES)
def test_rectify_plan_takes_each_row_once(shape):
    m, _, h, w = shape
    band, bands, smem = rectify.plan(m, h, w, 3, SMS)
    seen = np.zeros(h, np.int32)
    for x in range(bands):
        rows = slice(band * x, min(h, band * x + band))
        assert rows.start < rows.stop  # no CTA without a row
        seen[rows] += 1
    assert (seen == 1).all()
    assert smem == 32 * band + 2 * 16 * (-(-(w * 3) // 4)) <= SMEM_CTA


# (images, H, W): the train step's and the 512² record's; one past a strip
# (64 columns) and past a segment in each dimension; down to 1×1 and 11×5
SSIM_SHAPES = [(8, 256, 256), (3, 512, 512), (1, 1, 1), (1, 11, 5),
               (2, 5, 300), (3, 37, 45), (1, 69, 65), (2, 129, 129),
               (1, 300, 7)]


@pytest.mark.parametrize("shape", SSIM_SHAPES)
def test_ssim_grad_plan_covers_each_output_once(shape):
    """Each output pixel is written by one CTA; a CTA's shared memory fits;
    its segment stages x rows [r0 − 10, ≥ r1 + 10) and forms α rows [r0 −
    5, ≥ r1 + 5) (the window's halo twice and once)."""
    n, h, w = shape
    strips, segments, rows = ssim_grad.plan(n, h, w, SMS)
    assert strips == -(-w // 64) and (rows + 10) % 13 == 0 and rows > 0
    assert segments <= 65535
    seen = np.zeros((h, w), np.int32)
    for s in range(segments):
        (r0, r1), (x_lo, x_hi), (a_lo, a_hi) = ssim_grad.segment_walk(
            h, rows, s)
        assert r0 < r1  # no segment without a row
        assert x_lo == r0 - 10 and x_hi >= r1 + 10
        assert a_lo == r0 - 5 and a_hi >= r1 + 5
        assert x_hi - x_lo == a_hi - a_lo + 10  # V1 runs 5 rows ahead of H1
        for x in range(strips):
            seen[r0:r1, 64 * x:min(w, 64 * x + 64)] += 1
    assert (seen == 1).all()
    assert ssim_grad.SMEM_BYTES <= SMEM_CTA


def _constant(src, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m, name
    return int(m.group(1))


def test_plans_match_the_kernel_sources():
    """The plans' geometry is the kernels' (``csrc/*.cu`` constants), the
    x and α spans (the strip ± 10 and ± 5 pixels, three channels) fit a
    CTA's threads, and each C entry takes as many arguments as ``_lib``
    declares."""
    sg = (CSRC / "ssim_grad.cu").read_text()
    tw, rc, block = (_constant(sg, k) for k in ("kTW", "kRC", "kBlock"))
    assert (tw, rc, block) == (ssim_grad._TW, ssim_grad._RC,
                               ssim_grad._BLOCK)
    assert 3 * (tw + 20) <= block and 3 * (tw + 10) <= block
    rc_src = (CSRC / "rectify.cu").read_text()
    assert _constant(rc_src, "kMinBlocks") == rectify._CTAS_PER_SM
    for name, src in (("vwfd_rectify", rc_src), ("vwfd_rectify_bwd", rc_src),
                      ("vwfd_ssim_grad", sg)):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        assert len(m.group(1).split(",")) == len(_lib._SIGNATURES[name])
