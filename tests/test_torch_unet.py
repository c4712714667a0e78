"""Parity of the port's UNetTPU with vwfd_tpu/nets/unet.py at the flagship
plan: f=64, s2d 2, enc_convs (2,2,1,1,1), d2s head, convt up, concat
decoder, on 32² frames in f32, in eval mode; train mode at f=8. Weights and
random BatchNorm running statistics go through ``convert``."""

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
    """Train mode returns the batch-statistics probabilities and the new
    running statistics without writing them; ``load_stats`` writes them,
    unless the step's guard is False."""
    net = nets[2]
    x = torch.from_numpy(
        np.random.default_rng(8).random((2, 32, 32, 3), dtype=np.float32))
    before = {k: b.clone() for k, b in net.named_buffers()}
    with torch.no_grad():
        probs, stats = net(x, train=True)
        evals = net(x)
    assert probs.shape == evals.shape == (2, 32, 32, 1)
    assert not torch.allclose(probs, evals)  # batch, not running, stats
    assert len(stats) == 11  # every BatchNorm of the (2,2,1,1,1) plan
    assert all(torch.equal(b, before[k]) for k, b in net.named_buffers())
    net.load_stats(stats, good=torch.tensor(False))
    assert all(torch.equal(b, before[k]) for k, b in net.named_buffers())
    net.load_stats(stats, good=torch.tensor(True))
    assert not torch.equal(net.enc1.BatchNorm_0.running_mean,
                           before["enc1.BatchNorm_0.running_mean"])
    net.load_state_dict({**net.state_dict(), **before})


def test_train_mode_matches_flax():
    """Train mode at f = 8: the batch-statistics output, the running
    statistics flax stores (BIASED batch variance, momentum 0.9: F1) and
    the gradient of every parameter (within 1e-3 of each tensor's max-abs;
    the JAX side compiled without XLA's algebraic simplifier, which would
    rewrite its divisions as reciprocal products)."""
    jnet = JUNetTPU(out_channels=1, init_features=8, s2d=2,
                    enc_convs=(2, 2, 1, 1, 1))
    net = UNetTPU(init_features=8, s2d=2, enc_convs=(2, 2, 1, 1, 1))
    net.init_params(torch.Generator().manual_seed(2))
    with torch.no_grad():  # non-trivial running statistics
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    _, tree, stats = params_to_jax({}, net.state_dict())
    tree, stats = jax.tree_util.tree_map(jnp.asarray, (tree, stats))
    x = np.random.default_rng(6).random((4, 32, 32, 3), dtype=np.float32)

    def loss(p):
        out, new = jnet.apply({"params": p, "batch_stats": stats},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, new["batch_stats"])

    (_, (ref, new_stats)), g = jax.jit(jax.value_and_grad(
        loss, has_aux=True)).lower(tree).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(tree)
    probs, new = net(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad((probs ** 2).sum(), list(net.parameters()))
    net.load_stats(new)
    _, got_tree, got_stats = params_to_jax(
        {}, {**dict(zip(names, grads)), **dict(net.named_buffers())})
    for want_tree, got, atol in ((new_stats, got_stats, 1e-5),
                                 (g, got_tree, None)):
        for path, w in jax.tree_util.tree_leaves_with_path(want_tree):
            node = got
            for k in path:
                node = node[k.key]
            w = np.asarray(w)
            tol = atol if atol else 1e-3 * np.abs(w).max()
            np.testing.assert_allclose(node, w, rtol=0, atol=tol,
                                       err_msg=jax.tree_util.keystr(path))
