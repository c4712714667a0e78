"""K2 ``coupling_head`` on the CPU: its plain version against the JAX
package's coupling head and affine, the s/t column interleave of
``pack_params``, and the wrapper's refusals.

The same seeded numpy inputs go through ``vwfd_tpu/nets/inn_packed.py::
_st_packed`` / ``_st_unpacked`` followed by ``inn.py::_e``'s affine, and
through the port's trunk (``nets/inn_packed.py::_st``) and
``coupling_head_plain``, with the flagship INN's weights (12 channels,
down_num 3, 32² inputs: couplings at levels 48 and 192 packed, 768
unpacked) converted from flax. f32, within 1e-5 of scale: the same sums in
another order, one rounding. The CUDA kernel itself is held to this plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.nets import InvertibleNet as JInvertibleNet
from vwfd_tpu.nets import inn as jinn
from vwfd_tpu.nets import inn_packed as jpk
from vwfd_tpu_torch.convert import params_from_jax
from vwfd_tpu_torch.kernels import _lib, coupling, launch_counts
from vwfd_tpu_torch.nets import InvertibleNet
from vwfd_tpu_torch.nets import inn_packed

# coupling → (spatial size at a 32² input, channels of z, packed?)
_LEVELS = {"down_blocks_0_0": (8, 192, True), "down_blocks_1_0": (4, 768, True),
           "down_blocks_2_0": (4, 768, False)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    """(JAX params with perturbed heads, the port's packed executor params
    converted from them)."""
    rng = np.random.default_rng(5)
    jnet = JInvertibleNet(channels=12, down_num=3, block_num=(1, 1, 1),
                          subnet="res_tpu2", fused_st=True, haar="conv")
    v = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 12)))

    def perturb(path, a):
        if any(getattr(k, "key", "") == "Conv_2" for k in path):
            return a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                   jnp.float32)
        return a

    p = jax.tree_util.tree_map_with_path(perturb, v["params"])
    net = InvertibleNet(channels=12, down_num=3, block_num=(1, 1, 1))
    sd, _ = params_from_jax(jax.tree_util.tree_map(np.asarray, p), {}, {})
    net.load_state_dict(sd)
    with torch.no_grad():
        return p, inn_packed.pack_params(net)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("name", list(_LEVELS))
def test_coupling_head_plain_matches_jax(nets, name, inverse):
    """One coupling half (st2: input x2, affine on x1) through the JAX
    head + ``_e`` and through the port's trunk + ``coupling_head_plain``,
    writing into a channel slice of the coupling's output."""
    jp, tp = nets
    hw, cz, packed = _LEVELS[name]
    half = cz // 2
    z = np.random.default_rng(6).standard_normal((2, hw, hw, cz)).astype(
        np.float32)
    st = jpk._st_packed if packed else jpk._st_unpacked
    s, t = st(jp[name]["st2"], jnp.asarray(z[..., half:]), None)
    x = jnp.asarray(z[..., :half])
    ref = np.asarray((x - t) / jinn._e(s) if inverse
                     else jinn._e(s) * x + t)

    zt = torch.from_numpy(z)
    p = tp[name]["st2"]
    out = torch.zeros_like(zt)
    before = launch_counts()
    with torch.no_grad():
        h = inn_packed._st(p, zt[..., half:])
        got = coupling.coupling_head(zt[..., half:], h, p, zt[..., :half],
                                     out=out[..., :half], inverse=inverse)
    assert launch_counts() == before  # CPU tensors: the plain version only
    assert got.data_ptr() == out.data_ptr()
    assert np.abs(ref - z[..., :half]).max() > 1e-3  # the head is no zero
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out[..., :half].numpy(), ref, rtol=1e-5,
                               atol=tol)
    np.testing.assert_array_equal(out[..., half:].numpy(), 0.0)


@pytest.mark.parametrize("name", list(_LEVELS))
def test_interleave_round_trips_to_jax_column_order(nets, name):
    """``pack_params``' head, its columns put back by
    ``deinterleave_index``, is exactly the head the JAX executor builds (the
    c-major row/column permutations for a packed subnet, the raw kernel for
    an unpacked one), bias included."""
    jp, tp = nets
    _, cz, packed = _LEVELS[name]
    conv = jp[name]["st1"]["Conv_2"]
    wh = np.asarray(conv["kernel"])[0, 0]
    bh = np.asarray(conv["bias"])
    if packed:
        ci4 = cz // 2
        perm = jpk._cmajor_to_gmajor(ci4)
        wh = np.concatenate([wh[perm], wh[ci4:]], 0)
        colperm = jpk._head_colperm(wh.shape[1])
        wh, bh = wh[:, colperm], bh[colperm]
    p = tp[name]["st1"]
    back = coupling.deinterleave_index(wh.shape[1])
    np.testing.assert_array_equal(p["wh"].numpy().T[:, back], wh)
    np.testing.assert_array_equal(p["bh"].numpy()[back], bh)
    idx = coupling.interleave_index(wh.shape[1])
    np.testing.assert_array_equal(idx[back], np.arange(wh.shape[1]))
    # the first blocks: s of channels 0..7, then t of the same channels
    c = wh.shape[1] // 2
    np.testing.assert_array_equal(idx[:16], np.r_[0:8, c:c + 8])


def _args(c=16, kx=16, f=32, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    z = torch.randn(1, 2, 2, 2 * c, generator=g).to(dtype)
    xin = torch.randn(1, 2, 2, kx, generator=g).to(dtype)
    h = torch.randn(1, 2, 2, f, generator=g).to(dtype)
    p = {"wh": torch.randn(2 * c, kx + f, generator=g).to(dtype),
         "bh": torch.zeros(2 * c)}
    return xin, h, p, z[..., :c], z[..., c:]


def test_coupling_head_wrapper_accepts_good_inputs():
    xin, h, p, x, out = _args()
    assert coupling.coupling_head(xin, h, p, x, out=out).data_ptr() == \
        out.data_ptr()


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "bias_dtype",
                                  "shape", "wh_shape", "channels",
                                  "strides", "misaligned"])
def test_coupling_head_wrapper_rejects(case):
    xin, h, p, x, out = _args()
    if case == "dtype":
        xin, h, x, out = (t.double() for t in (xin, h, x, out))
        p = {"wh": p["wh"].double(), "bh": p["bh"]}
        err = TypeError
    elif case == "mixed_dtype":
        h, err = h.to(torch.bfloat16), TypeError
    elif case == "bias_dtype":
        p, err = {"wh": p["wh"], "bh": p["bh"].double()}, ValueError
    elif case == "shape":
        h, err = torch.zeros(1, 2, 3, 32), ValueError
    elif case == "wh_shape":
        p, err = {"wh": p["wh"][:-8], "bh": p["bh"]}, ValueError
    elif case == "channels":  # the s/t interleave works in blocks of 8
        xin, h, p, x, out = _args(c=12, kx=12)
        err = ValueError
    elif case == "strides":  # rows must be uniform with unit channel stride
        x, err = x.permute(0, 2, 1, 3), ValueError
    else:
        err = ValueError
        with pytest.raises(err):  # what the card path checks on CUDA tensors
            _lib.check_aligned(torch.zeros(64)[1:], "xin")
        with pytest.raises(err):
            _lib.check_aligned(torch.zeros(64), "xin", row_stride=3)
        _lib.check_aligned(torch.zeros(64), "xin", row_stride=4)
        return
    with pytest.raises(err):
        coupling.coupling_head(xin, h, p, x, out=out)
