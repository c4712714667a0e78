"""K12 ``qconv_t``'s plain version against the JAX package's int8 upsample,
on the CPU: ``lax.conv_transpose(..., preferred_element_type=int32)`` and the
signed requant, built as ``vwfd_tpu/nets/unet_int8.py:257-260`` builds them,
on JAX's HWIO weights; the port gets the same weights through
``convert.unet_int8_from_jax`` (flipped once, F3). Shapes: the four decoder
levels' Cin / Cout ratios (f = 8 for the flagship's 64) at small N and h, a
ragged Cout (24) and odd h, w (5 × 7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from vwfd_tpu_torch.convert import unet_int8_from_jax
from vwfd_tpu_torch.kernels import launch_counts, qconv_t

_DN = ("NHWC", "HWIO", "NHWC")  # vwfd_tpu/nets/unet_int8.py:50

# (name, N, h, w, Cin, Cout): up4 .. up1 at f = 8, then the ragged shapes
_CASES = [("up4", 2, 2, 2, 128, 64), ("up3", 2, 4, 4, 64, 32),
          ("up2", 2, 8, 8, 32, 16), ("up1", 2, 16, 16, 16, 8),
          ("ragged_cout", 3, 4, 4, 40, 24), ("odd_hw", 3, 5, 7, 16, 8)]


def _jax_upsample(zi, up_w, up_m, up_b):
    """``apply_int8``'s decoder upsample (unet_int8.py:257-260)."""
    u = lax.conv_transpose(zi, up_w, (2, 2), "SAME", dimension_numbers=_DN,
                           preferred_element_type=jnp.int32)
    y = u.astype(jnp.float32) * up_m[None, None, None, :] + up_b
    return jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8)


def _inputs(case, seed):
    _, n, h, w, cin, cout = case
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, w, cin), dtype=np.int8)
    up_w = rng.integers(-127, 128, (2, 2, cin, cout), dtype=np.int8)  # HWIO
    # float(acc)·m spread past ±127, so that both clip bounds are reached
    m = (80.0 / (5376.0 * cin ** 0.5)
         * (0.5 + rng.random(cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, up_w, m, b


def _port_tree(up_w, up_m, up_b):
    """The port's decoder leaves of a one-level JAX tree."""
    head = {"w": np.zeros((1, 1, 1, 1), np.int8),
            "m": np.ones(1, np.float32), "b": np.zeros(1, np.float32)}
    cout = up_w.shape[3]
    dec = {"up_w": up_w, "up_m": up_m, "up_b": up_b,
           "w_up": np.zeros((3, 3, cout, cout), np.int8),
           "w_skip": np.zeros((3, 3, cout, cout), np.int8),
           "m_up": np.ones(cout, np.float32),
           "m_skip": np.ones(cout, np.float32),
           "b": np.zeros(cout, np.float32)}
    tree = unet_int8_from_jax({"enc": [], "dec": [dec], "head": head})
    return tree["dec"][0]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c[0])
def test_qconv_t_plain_equals_jax(case):
    x, up_w, m, b = _inputs(case, seed=60)
    want = np.asarray(_jax_upsample(jnp.asarray(x), jnp.asarray(up_w),
                                    jnp.asarray(m), jnp.asarray(b)))
    d = _port_tree(up_w, m, b)
    assert d["up_w"].shape == (2, 2, up_w.shape[3], up_w.shape[2])
    before = launch_counts()["qconv_t"]
    got = qconv_t.qconv_t(torch.from_numpy(x), d["up_w"], d["up_m"],
                          d["up_b"])
    assert launch_counts()["qconv_t"] == before  # CPU: the plain version
    n, h, w, _ = x.shape
    assert got.dtype == torch.int8 and got.shape == (n, 2 * h, 2 * w,
                                                     up_w.shape[3])
    assert np.array_equal(got.numpy(), want)
    assert want.max() == 127 and want.min() == -127  # both clips reached
