"""The reference ``UNet`` (with and without ``fast_upsample``) and every
``UNetTPU`` option (``slim_skip``, ``enc_convs`` as an int, the ``convt``
head, the ``gemm`` upsample, the ``split`` decoder, and all together)
against ``vwfd_tpu/nets/unet.py``, on the CPU in f32, in eval mode and in
train mode.

Weights come from the port's initialisation with random BatchNorm scales,
biases and running statistics, converted to the flax tree (whose structure
and shapes are held to the JAX net's own, ``jax.eval_shape`` of its
``init``). Tolerances, max abs: eval-mode logits and probabilities within
1e-5 (float32 sums in another order); in train mode, where the deep
levels' batch statistics (1–16 pixels × 4 frames) amplify that rounding,
the probabilities within 1e-5, as ``test_torch_unet.py`` holds the
flagship's, and the running statistics within 1e-5 (F1: flax's biased
batch variance, momentum 0.9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.nets import UNet as JUNet
from vwfd_tpu.nets import UNetTPU as JUNetTPU
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu_torch.convert import params_from_jax, params_to_jax
from vwfd_tpu_torch.nets import UNet, UNetTPU
from vwfd_tpu_torch.ops import depth_to_space, space_to_depth

ATOL = 1e-5
S = 32
VARIANTS = {
    "unet": (JUNet, UNet, dict(init_features=4)),
    "unet_fast_upsample": (JUNet, UNet, dict(init_features=4,
                                             fast_upsample=True)),
    "tpu_slim_skip": (JUNetTPU, UNetTPU, dict(init_features=8,
                                              slim_skip=True)),
    "tpu_enc_convs_int": (JUNetTPU, UNetTPU, dict(init_features=8,
                                                  enc_convs=1)),
    "tpu_convt_head": (JUNetTPU, UNetTPU, dict(init_features=8,
                                               head_impl="convt")),
    "tpu_gemm_up": (JUNetTPU, UNetTPU, dict(init_features=8,
                                            up_impl="gemm")),
    "tpu_split_dec": (JUNetTPU, UNetTPU, dict(init_features=8,
                                              dec_impl="split")),
    "tpu_all": (JUNetTPU, UNetTPU, dict(
        init_features=8, slim_skip=True, enc_convs=(2, 1, 1, 1, 1),
        head_impl="convt", up_impl="gemm", dec_impl="split")),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(name, seed=0):
    """(JAX net returning logits, its variables, the port's net holding
    them)."""
    jcls, tcls, kw = VARIANTS[name]
    jnet = jcls(apply_sigmoid=False, **kw)
    net = tcls(**kw)
    gen = torch.Generator().manual_seed(seed)
    net.init_params(gen)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
                assert mod.running_var.shape == (c,)
    _, tree, stats = params_to_jax({}, net.state_dict())
    want = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, S, S, 3)))
    jsq._s2d_kernel.cache_clear()  # the trace left tracers in the cache
    for ours, ref in ((tree, want["params"]), (stats, want["batch_stats"])):
        assert jax.tree_util.tree_structure(ours) == \
            jax.tree_util.tree_structure(ref)
        assert [a.shape for a in jax.tree_util.tree_leaves(ours)] == \
            [a.shape for a in jax.tree_util.tree_leaves(ref)]
    _, sd = params_from_jax({}, tree, stats)
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    v = jax.tree_util.tree_map(jnp.asarray, {"params": tree,
                                             "batch_stats": stats})
    return jnet, v, net


def _logits(net, x, stats=None):
    """The port's full-resolution logits from ``body``."""
    xs = space_to_depth(x, net.s2d)
    return depth_to_space(net.body(xs, stats), net.head_s2d)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_extractor_matches_jax_eval_and_train(name):
    jnet, v, net = _pair(name)
    x = np.random.default_rng(1).random((4, S, S, 3), dtype=np.float32)
    xt = torch.from_numpy(x)
    ref = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = _logits(net.eval(), xt)
        probs = net(xt)
    assert ours.shape == (4, S, S, 1) and ref.std() > 1e-2
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax.nn.sigmoid(ref)),
                               rtol=0, atol=ATOL)
    # body's logits are packed at head_s2d: K4's input on the card
    s = 2 if isinstance(net, UNetTPU) and net.head_impl == "d2s" else 1
    assert net.head_s2d == s

    ref_t, new = jnet.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    with torch.no_grad():
        probs_t, stats = net(xt, train=True)
    np.testing.assert_allclose(probs_t.numpy(),
                               np.asarray(jax.nn.sigmoid(ref_t)), rtol=0,
                               atol=ATOL)
    assert len(stats) > 0
    net.load_stats(stats)
    _, _, got = params_to_jax({}, net.state_dict())
    want = jax.tree_util.tree_leaves_with_path(new["batch_stats"])
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=str(path))


def test_extractor_options_are_checked():
    for kw in ({"head_impl": "x"}, {"up_impl": "x"}, {"dec_impl": "x"}):
        with pytest.raises(ValueError):
            UNetTPU(**kw)
    with pytest.raises(ValueError, match="enc_convs"):
        UNetTPU(enc_convs=(1, 2))
