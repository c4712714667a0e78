"""K14 ``haar``'s plain version (``vwfd_tpu_torch/ops/haar.py``, the CPU
path of ``kernels/haar.py``) against the JAX package's Haar squeeze
(``vwfd_tpu/ops/haar.py``): the lifting form and the conv forms, forward
and VJP, on the CPU in f32.

Tolerance 1e-6 (max abs, inputs in [-1, 1]): the lifting forms run the
same four-term sums in the same order and agree exactly; the conv forms sum
in the convolution's order, a float32 rounding apart. The inputs cover the
refshape levels' channel counts, a channel count that is not a multiple of
4 or 8, and 3072 channels (``down_num`` 4's last level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.ops import haar as jhaar
from vwfd_tpu_torch.kernels import KERNELS, PLAIN, haar, launch_counts
from vwfd_tpu_torch.ops import haar as ops_haar

ATOL = 1e-6
# full-resolution side (N, H, W, C)
SHAPES = [(2, 8, 8, 12), (1, 4, 4, 48), (3, 6, 10, 5), (1, 4, 4, 768)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_haar_plain_matches_jax_lift_and_conv(shape):
    x = _x(shape, 0)
    n, h, w, c = shape
    y = _x((n, h // 2, w // 2, 4 * c), 1)
    ref_down = np.asarray(jhaar.haar_downsample(jnp.asarray(x)))
    ref_up = np.asarray(jhaar.haar_upsample(jnp.asarray(y)))
    before = launch_counts()
    for k in (KERNELS, PLAIN):  # CPU tensors: the plain version
        down = k.haar(torch.from_numpy(x)).numpy()
        up = k.haar(torch.from_numpy(y), transpose=True).numpy()
        np.testing.assert_array_equal(down, ref_down)
        np.testing.assert_array_equal(up, ref_up)
    assert launch_counts() == before
    for jfn, tfn, v, ref in (
            (jhaar.haar_downsample_conv, ops_haar.haar_downsample_conv, x,
             ref_down),
            (jhaar.haar_upsample_conv, ops_haar.haar_upsample_conv, y,
             ref_up)):
        conv_ref = np.asarray(jfn(jnp.asarray(v)))
        np.testing.assert_allclose(conv_ref, ref, rtol=0, atol=ATOL)
        np.testing.assert_allclose(tfn(torch.from_numpy(v)).numpy(),
                                   conv_ref, rtol=0, atol=ATOL)
    back = haar.haar_plain(torch.from_numpy(ref_down.copy()),
                           transpose=True)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=ATOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_haar_vjp_matches_jax(transpose):
    n, h, w, c = 2, 8, 8, 12
    shape = (n, h // 2, w // 2, 4 * c) if transpose else (n, h, w, c)
    x = _x(shape, 2)
    fn = jhaar.haar_upsample if transpose else jhaar.haar_downsample
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    g = _x(y.shape, 3)
    (ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = haar.haar(xt, transpose)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    # the map is its own transpose: the VJP of down is up, and the reverse
    # (the kernel's backward); autograd sums in another order
    np.testing.assert_allclose(
        got.numpy(), haar.haar_plain(torch.from_numpy(g),
                                     not transpose).numpy(), rtol=0,
        atol=ATOL)


def test_haar_plain_rounds_once_in_bf16():
    """bf16 in, bf16 out: the float32 sums of the bf16 values rounded
    once, as the kernel computes."""
    x = torch.from_numpy(_x((1, 4, 4, 8), 4)).to(torch.bfloat16)
    want = ops_haar.haar_downsample(x.float()).to(torch.bfloat16)
    got = haar.haar_plain(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_haar_checks_shapes():
    with pytest.raises(ValueError, match="does not fit"):
        haar.haar(torch.zeros(1, 3, 4, 2))
    with pytest.raises(ValueError, match="does not fit"):
        haar.haar(torch.zeros(1, 2, 2, 6), transpose=True)
    with pytest.raises(TypeError):
        haar.haar(torch.zeros(1, 2, 2, 4, dtype=torch.float64))
    assert haar.out_shape((2, 8, 6, 3)) == (2, 4, 3, 12)
    assert haar.out_shape((2, 4, 3, 12), transpose=True) == (2, 8, 6, 3)
