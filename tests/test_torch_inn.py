"""Parity of the port's INN (packed executor, K1 + K2 plain versions) with
vwfd_tpu/nets/inn_packed.py at the flagship widths: 12 channels, down_num 3,
block_num (1,1,1), trunk width 128, on 32² inputs — every transition kind,
including p2u at 768 channels. f32 on the CPU; the zero-init coupling heads
are perturbed so that the INN is not the identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.nets import InvertibleNet as JInvertibleNet
from vwfd_tpu.nets import inn_packed as jpk
from vwfd_tpu_torch.convert import params_from_jax, params_to_jax
from vwfd_tpu_torch.kernels import launch_counts
from vwfd_tpu_torch.nets import InvertibleNet


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    """(JAX params with perturbed heads, port net holding the same)."""
    rng = np.random.default_rng(1)
    jnet = JInvertibleNet(channels=12, down_num=3, block_num=(1, 1, 1),
                          subnet="res_tpu2", fused_st=True, haar="conv")
    v = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 12)))

    def perturb(path, a):
        if any(getattr(k, "key", "") == "Conv_2" for k in path):
            return a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                   jnp.float32)
        return a

    p = jax.tree_util.tree_map_with_path(perturb, v["params"])
    net = InvertibleNet(channels=12, down_num=3, block_num=(1, 1, 1))
    net_sd, _ = params_from_jax(jax.tree_util.tree_map(np.asarray, p), {}, {})
    net.load_state_dict(net_sd)
    return p, net


def _scale_tol(ref, rtol=1e-4):
    return rtol * max(1.0, float(np.abs(ref).max()))


def test_forward_matches_jax_packed_executor(nets):
    p, net = nets
    x = np.random.default_rng(2).random((2, 32, 32, 12), dtype=np.float32)
    ref = np.asarray(jpk.forward(p, jnp.asarray(x), channels=12, down_num=3,
                                 dtype=None))
    before = launch_counts()
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    assert launch_counts() == before  # CPU tensors: plain versions only
    assert np.abs(ref - x).max() > 1e-2  # the perturbed INN is no identity
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=_scale_tol(ref))


def test_inverse_matches_jax_and_inverts(nets):
    p, net = nets
    x = np.random.default_rng(3).random((2, 32, 32, 12), dtype=np.float32)
    with torch.no_grad():
        y = net(torch.from_numpy(x))
        back, middle = net.inverse(y)
    ref_back, ref_mid = jpk.inverse(p, jnp.asarray(y.numpy()), channels=12,
                                    down_num=3, dtype=None)
    np.testing.assert_allclose(back.numpy(), np.asarray(ref_back), rtol=1e-4,
                               atol=_scale_tol(ref_back))
    np.testing.assert_allclose(middle.numpy(), np.asarray(ref_mid),
                               rtol=1e-4, atol=_scale_tol(ref_mid))
    assert middle.shape == (2, 4, 4, 768)
    assert float((back - torch.from_numpy(x)).abs().max()) < 1e-4


def test_packed_weights_follow_loaded_state(nets):
    """The permuted executor weights are cached per weight version: loading
    new weights changes the output, the state dict stays unpermuted and
    round-trips through the flax tree layout."""
    p, net = nets
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    x = torch.from_numpy(
        np.random.default_rng(4).random((1, 32, 32, 12), dtype=np.float32))
    with torch.no_grad():
        y0 = net(x)
        zero = {k: (torch.zeros_like(v) if "Conv_2" in k else v)
                for k, v in sd.items()}
        net.load_state_dict(zero)
        y_id = net(x)
        net.load_state_dict(sd)
        y1 = net(x)
    # zero heads: every affine is e(0)·x = (1 + 1e-4)·x, five couplings deep
    np.testing.assert_allclose(y_id.numpy(), x.numpy(), rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(y0.numpy(), y1.numpy())
    tree, _, _ = params_to_jax(sd, {})
    flat_ref = jax.tree_util.tree_leaves_with_path(p)
    for path, leaf in flat_ref:
        node = tree
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_unported_variants_raise():
    """Every subnet, split and Haar is ported (tests/test_torch_inn_module.py
    holds them against JAX); what raises is the JAX package's own rule: the
    packed executor takes ``res_tpu2`` with ``fused_st`` only."""
    for kw in ({"subnet": "res"}, {"fused_st": False},
               {"subnet": "dense", "fused_st": False}):
        with pytest.raises(ValueError, match="inn_packed requires"):
            InvertibleNet(packed=True, **kw)
        InvertibleNet(packed=False, **kw)  # the module path takes them
    with pytest.raises(ValueError, match="unknown haar"):
        InvertibleNet(haar="wavelet")
    with pytest.raises(ValueError, match="unknown subnet"):
        InvertibleNet(subnet="res_tpu3", packed=False)
    # the packed executor ignores the Haar setting: one linear map
    assert InvertibleNet(haar="lift").packed
