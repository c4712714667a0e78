"""The INN module path (``vwfd_tpu_torch/nets/inn.py`` with
``packed=False``: every subnet, both (s, t) layouts, every Haar setting)
against ``vwfd_tpu/nets/inn.py``; K15 ``coupling_affine``'s plain version
against the JAX affine; the packed executor at ``down_num`` 4 (K14 at the
unpacked levels past 768 channels) against ``vwfd_tpu/nets/inn_packed.py``.
On the CPU in f32, weights converted from the flax trees
(``convert.py``), the zero-init heads perturbed by 0.01·N(0,1) so that the
INN is not the identity (larger heads make the outputs large, and their
float32 rounding with them).

Tolerance 1e-5 (max abs): both sides run the same float32 operations, the
convolutions summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.nets import InvertibleNet as JInvertibleNet
from vwfd_tpu.nets import inn as jinn
from vwfd_tpu.nets import inn_packed as jpk
from vwfd_tpu.ops import haar as jhaar
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu_torch.convert import params_from_jax, params_to_jax
from vwfd_tpu_torch.kernels import KERNELS, PLAIN, affine, launch_counts
from vwfd_tpu_torch.nets import InvertibleNet

ATOL = 1e-5
SUBNETS = ("res", "dense", "res_tpu", "res_tpu2")
HAARS = ("lift", "conv", "mixed")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(seed, size=16, scale=0.01, packed=False, **kw):
    """(JAX net, its params, the port's net holding them): the port's
    initialisation, the zero-init heads (the all-zero kernels and their
    biases) perturbed by ``scale``·N(0,1), converted to the flax tree,
    whose structure and shapes are held to the JAX net's own
    (``jax.eval_shape`` of its ``init``)."""
    jnet = JInvertibleNet(channels=12, **kw)
    net = InvertibleNet(channels=12, packed=packed, **kw)
    gen = torch.Generator().manual_seed(seed)
    net.init_params(gen)
    heads = {n.rsplit(".", 1)[0] for n, q in net.named_parameters()
             if n.endswith(".weight") and not q.any()}
    with torch.no_grad():
        for n, q in net.named_parameters():
            if n.rsplit(".", 1)[0] in heads:
                q.add_(scale * torch.randn(q.shape, generator=gen))
    tree, _, _ = params_to_jax(net.state_dict(), {})
    want = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 12)))["params"]
    # the trace left tracers in the JAX package's fixed-kernel caches
    jhaar._haar_kernel.cache_clear()
    jsq._s2d_kernel.cache_clear()
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(want)
    assert [a.shape for a in jax.tree_util.tree_leaves(tree)] == \
        [a.shape for a in jax.tree_util.tree_leaves(want)]
    # and the flax tree converts back to the same state dict
    sd, _ = params_from_jax(tree, {}, {})
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items())
    return jnet, jax.tree_util.tree_map(jnp.asarray, tree), net


@pytest.mark.parametrize("haar", HAARS)
@pytest.mark.parametrize("fused_st", [True, False])
@pytest.mark.parametrize("subnet", SUBNETS)
def test_module_path_matches_jax(subnet, fused_st, haar):
    """Forward, and the inverse with its middle, of every subnet × (s, t)
    layout × Haar setting; down_num 2, block_num (1, 1), width 8."""
    jnet, p, net = _pair(SUBNETS.index(subnet), down_num=2,
                         block_num=(1, 1), subnet=subnet, fused_st=fused_st,
                         width=8, haar=haar)
    x = np.random.default_rng(1).random((1, 16, 16, 12), dtype=np.float32)
    ref = np.asarray(jnet.apply({"params": p}, jnp.asarray(x)))
    ref_back, ref_mid = jnet.apply({"params": p}, jnp.asarray(ref), rev=True)
    before = launch_counts()
    with torch.no_grad():
        y = net(torch.from_numpy(x))
        back, mid = net.inverse(torch.from_numpy(ref.copy()))
    assert launch_counts() == before  # CPU tensors: plain versions only
    assert np.abs(ref - x).max() > 1e-3  # the perturbed INN is no identity
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(back.numpy(), np.asarray(ref_back), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(mid.numpy(), np.asarray(ref_mid), rtol=0,
                               atol=ATOL)
    assert mid.shape == (1, 4, 4, 192)


def test_module_path_with_grad_matches_no_grad():
    """Under autograd the couplings return fresh halves (K15's autograd
    function on the card): the same values, and gradients reach every
    subnet."""
    _, _, net = _pair(5, down_num=2, block_num=(1, 1), subnet="dense",
                      fused_st=False, width=8, haar="lift")
    x = torch.from_numpy(np.random.default_rng(2).random(
        (1, 16, 16, 12), dtype=np.float32))
    with torch.no_grad():
        want = net(x)
        back = net.inverse(want, return_middle=False)
    y = net(x)
    np.testing.assert_array_equal(y.detach().numpy(), want.numpy())
    b = net.inverse(y, return_middle=False)
    np.testing.assert_allclose(b.detach().numpy(), back.numpy(), rtol=0,
                               atol=ATOL)
    grads = torch.autograd.grad((y * y).sum() + b.sum(),
                                list(net.parameters()), allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert float((back - x).abs().max()) < 1e-4


def test_module_path_equals_packed_executor():
    """``res_tpu2`` with fused (s, t) on the module path (conv Haar) equals
    the packed executor on the same parameters."""
    _, _, net = _pair(6, down_num=3, block_num=(1, 1, 1), subnet="res_tpu2",
                      fused_st=True, width=16, haar="conv", size=32)
    packed = InvertibleNet(12, 3, (1, 1, 1), width=16)
    packed.load_state_dict(net.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 32, 32, 12), dtype=np.float32))
    with torch.no_grad():
        a, b = net(x), packed(x)
        ia, ma = net.inverse(a)
        ib, mb = packed.inverse(a)
    for u, v in ((a, b), (ia, ib), (ma, mb)):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=0, atol=ATOL)


def test_packed_executor_down_num_4_matches_jax():
    """``inn_packed`` at down_num 4: the 768 → 3072-channel level is an
    unpacked→unpacked Haar (K14), its coupling an unpacked K2 head."""
    rng = np.random.default_rng(4)
    _, p, net = _pair(4, down_num=4, block_num=(1, 1, 1, 1),
                      subnet="res_tpu2", fused_st=True, width=8, haar="conv",
                      packed=True)
    x = rng.random((1, 16, 16, 12), dtype=np.float32)
    ref = np.asarray(jpk.forward(p, jnp.asarray(x), channels=12, down_num=4,
                                 dtype=None))
    ref_back, ref_mid = jpk.inverse(p, jnp.asarray(ref), channels=12,
                                    down_num=4, dtype=None)
    with torch.no_grad():
        y = net(torch.from_numpy(x))
        back, mid = net.inverse(torch.from_numpy(ref.copy()))
    assert mid.shape == (1, 1, 1, 3072)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(back.numpy(), np.asarray(ref_back), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(mid.numpy(), np.asarray(ref_mid), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_coupling_affine_plain_matches_jax(fused, inverse):
    """K15's plain version against ``e(s)·x + t`` / ``(x − t)/e(s)`` with
    JAX's ``_e``, forward and VJP (the head's two halves or two tensors,
    x a channel slice)."""
    rng = np.random.default_rng(5)
    head = rng.standard_normal((2, 4, 4, 14)).astype(np.float32)
    z = rng.standard_normal((2, 4, 4, 14)).astype(np.float32)
    g = rng.standard_normal((2, 4, 4, 7)).astype(np.float32)

    def jfn(h, x):
        s, t = h[..., :7], h[..., 7:]
        return (x - t) / jinn._e(s) if inverse else jinn._e(s) * x + t

    ref, vjp = jax.vjp(jfn, jnp.asarray(head), jnp.asarray(z[..., :7]))
    ref_dh, ref_dx = vjp(jnp.asarray(g))
    ht = torch.from_numpy(head).requires_grad_()
    zt = torch.from_numpy(z).requires_grad_()
    st = ht if fused else (ht[..., :7], ht[..., 7:])
    for k in (KERNELS, PLAIN):
        out = k.coupling_affine(st, zt[..., :7], inverse=inverse)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=ATOL)
        dh, dz = torch.autograd.grad(out, [ht, zt], torch.from_numpy(g))
        np.testing.assert_allclose(dh.numpy(), np.asarray(ref_dh), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(dz[..., :7].numpy(), np.asarray(ref_dx),
                                   rtol=0, atol=ATOL)
        assert not dz[..., 7:].any()
    # without autograd it writes into a channel slice of the output
    out = torch.zeros(2, 4, 4, 14)
    with torch.no_grad():
        affine.coupling_affine(st, zt[..., :7], out=out[..., 7:],
                               inverse=inverse)
    np.testing.assert_allclose(out[..., 7:].numpy(), np.asarray(ref),
                               rtol=0, atol=ATOL)
    assert not out[..., :7].any()
