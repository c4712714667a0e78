"""Parity of the port's UNetTPU (eval mode) with vwfd_tpu/nets/unet.py at
the flagship plan: f=64, s2d 2, enc_convs (2,2,1,1,1), d2s head, convt up,
concat decoder, on 32² frames in f32. Weights and random BatchNorm running
statistics go through ``convert.params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.nets import UNetTPU as JUNetTPU
from vwfd_tpu_torch.convert import params_from_jax, params_to_jax
from vwfd_tpu_torch.nets import UNetTPU
from vwfd_tpu_torch.ops import space_to_depth


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_bn(tree, rng):
    """Random BatchNorm scale/bias and running stats (positive var)."""
    def go(path, a):
        key = getattr(path[-1], "key", "")
        if key in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if key in ("bias", "mean"):
            return a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                   jnp.float32)
        return a
    return jax.tree_util.tree_map_with_path(go, tree)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(5)
    jnet = JUNetTPU(out_channels=1, init_features=64, s2d=2,
                    enc_convs=(2, 2, 1, 1, 1))
    v = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    v = {"params": _random_bn(v["params"], rng),
         "batch_stats": _random_bn(v["batch_stats"], rng)}
    np_v = jax.tree_util.tree_map(np.asarray, v)
    _, gen_sd = params_from_jax({}, np_v["params"], np_v["batch_stats"])
    net = UNetTPU(init_features=64, s2d=2, enc_convs=(2, 2, 1, 1, 1))
    net.load_state_dict(gen_sd)
    return jnet, v, net.eval()


def test_unet_tpu_eval_matches_jax(nets):
    jnet, v, net = nets
    x = np.random.default_rng(6).random((3, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    assert ours.shape == (3, 32, 32, 1) and ours.dtype == np.float32
    assert ref.std() > 1e-2  # random BN stats: a non-trivial mask
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_body_returns_packed_logits(nets):
    """``body`` on the s2d stem gives the packed logits that ``forward``
    unpacks — the tensor the serving path hands to K4."""
    _, _, net = nets
    x = torch.from_numpy(
        np.random.default_rng(7).random((2, 32, 32, 3), dtype=np.float32))
    with torch.no_grad():
        logits = net.body(space_to_depth(x, 2))
        probs = net(x)
    assert logits.shape == (2, 16, 16, 4) and logits.is_contiguous()
    p00 = torch.sigmoid(logits[:, :, :, 0])  # sub-pixel (0, 0)
    np.testing.assert_allclose(p00.numpy(), probs[:, ::2, ::2, 0].numpy(),
                               atol=1e-7)


def test_convert_roundtrip_and_convtranspose_flip(nets):
    """params_to_jax inverts params_from_jax exactly, including the spatial
    flip of the ConvTranspose kernels and the BatchNorm statistics."""
    _, v, net = nets
    params, stats = v["params"], v["batch_stats"]
    _, tree, back_stats = params_to_jax({}, net.state_dict())
    for ref, got in ((params, tree), (stats, back_stats)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
            node = got
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))
    k = np.asarray(params["up4"]["kernel"])
    np.testing.assert_array_equal(net.up4.weight.detach().numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))


def test_train_mode_is_not_ported(nets):
    with pytest.raises(NotImplementedError):
        nets[2](torch.zeros(1, 32, 32, 3), train=True)
