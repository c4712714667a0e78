"""Parity of the port's localizer blocks (``nets/blocks.py::SNConv``,
``ResnetBlock``; ``nets/localizer.py::UNetDiscriminator``) with the flax
modules of vwfd_tpu, on the CPU in float32, from the port's weights
converted to flax trees (``convert.py``).

* ``SNConv`` plain, strided (k 4, padding 1), dilated (2, VALID) and
  transposed (k 4, stride 2, "SAME": ``conv_transpose2d(k=4, s=2, p=1)`` on
  the flipped kernel, F3), with and without spectral norm, from a ``u``
  that is not flax's initial one: the output within 1e-5 of its max, the
  new ``u`` (``update_sn=True``) within 1e-6 and σ within 1e-6 relative of
  the flax module's one power iteration;
* ``ResnetBlock`` within 1e-5 of its output's max;
* ``UNetDiscriminator`` with every option (``use_srm`` on and off,
  ``use_spectral_norm``, ``with_qf_attn``, ``use_sigmoid``): the
  probabilities within 1e-5 (logits within 1e-5 of their max), every new
  ``u`` within 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.nets.blocks import ResnetBlock as JResnetBlock
from vwfd_tpu.nets.blocks import SNConv as JSNConv
from vwfd_tpu.nets.localizer import UNetDiscriminator as JDisc
from vwfd_tpu_torch.convert import (spectral_from_jax, spectral_to_jax,
                                    state_dict_to_jax)
from vwfd_tpu_torch.nets import ResnetBlock, SNConv, UNetDiscriminator


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _perturbed_u(module, seed):
    """A unit ``u`` other than ``ones/√n`` in every spectral-norm conv, so
    that the power iteration's start is tested."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, SNConv) and m.use_spectral_norm:
                u = torch.rand(m.u.shape, generator=gen) + 0.5
                m.u.copy_(u / torch.linalg.norm(u))


def _flax_kernel(conv: SNConv) -> np.ndarray:
    return conv.kernel_matrix().detach().reshape(
        conv.k, conv.k, conv.cin, conv.features).numpy()


CASES = {
    "plain": dict(cin=5, features=7, kernel_size=3),
    "strided": dict(cin=4, features=6, kernel_size=4, stride=2, padding=1),
    "dilated": dict(cin=6, features=6, kernel_size=3, padding="VALID",
                    dilation=2, use_bias=False),
    "transposed": dict(cin=8, features=3, kernel_size=4, stride=2,
                       padding="SAME", transpose=True),
}


@pytest.mark.parametrize("sn", [True, False], ids=["sn", "nosn"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_snconv_matches_flax(case, sn):
    kw = dict(CASES[case])
    cin, feats, k = kw.pop("cin"), kw.pop("features"), kw.pop("kernel_size")
    conv = SNConv(cin, feats, k, use_spectral_norm=sn, **kw)
    conv.init_params(torch.Generator().manual_seed(1))
    with torch.no_grad():
        if conv.bias is not None:
            conv.bias.normal_(generator=torch.Generator().manual_seed(2))
    if sn:
        _perturbed_u(conv, 3)
    x = np.random.default_rng(4).random((2, 12, 10, cin)).astype(np.float32)
    jconv = JSNConv(feats, (k, k), strides=(kw.get("stride", 1),) * 2,
                    padding=kw.get("padding", "SAME"),
                    dilation=kw.get("dilation", 1),
                    use_bias=kw.get("use_bias", True),
                    use_spectral_norm=sn, transpose=kw.get("transpose", False))
    params = {"kernel": jnp.asarray(_flax_kernel(conv))}
    if conv.bias is not None:
        params["bias"] = jnp.asarray(conv.bias.detach().numpy())
    variables = {"params": params}
    if sn:
        variables["spectral"] = {"u": jnp.asarray(conv.u.numpy())}
    want, new = jconv.apply(variables, jnp.asarray(x), update_sn=True,
                            mutable=["spectral"])
    store = {}
    got = conv(_nchw(x), store)
    w = np.asarray(want)
    np.testing.assert_allclose(_nhwc(got), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    if sn:
        np.testing.assert_allclose(store[conv].numpy(),
                                   np.asarray(new["spectral"]["u"]),
                                   rtol=0, atol=1e-6)
        # σ: flax's one power iteration from the stored u, in numpy
        mat = _flax_kernel(conv).reshape(-1, feats).astype(np.float64)
        v = mat.T @ conv.u.numpy()
        v /= np.linalg.norm(v) + 1e-12
        u = mat @ v
        u /= np.linalg.norm(u) + 1e-12
        sigma, _ = conv.sigma()
        assert math.isclose(float(sigma), float(u @ mat @ v), rel_tol=1e-6)
    else:
        assert not store


def test_transposed_snconv_doubles_the_grid_as_flax():
    """The transposed ``SNConv`` (k 4, stride 2, "SAME") maps H × W to
    2H × 2W, as ``jax.lax.conv_transpose`` does (pinned above value for
    value)."""
    conv = SNConv(4, 2, 4, stride=2, transpose=True, use_spectral_norm=False)
    assert conv(torch.zeros(1, 4, 5, 7)).shape == (1, 2, 10, 14)


def test_resnet_block_matches_flax():
    blk = ResnetBlock(8, dilation=2)
    gen = torch.Generator().manual_seed(5)
    for m in blk.modules():
        if isinstance(m, SNConv):
            m.init_params(gen)
    _perturbed_u(blk, 6)
    x = np.random.default_rng(7).random((2, 9, 11, 8)).astype(np.float32)
    params, _ = state_dict_to_jax({k: v for k, v in blk.state_dict().items()
                                   if not k.endswith(".u")})
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "spectral": jax.tree_util.tree_map(
                     jnp.asarray, spectral_to_jax(blk.state_dict()))}
    want, new = JResnetBlock(8, dilation=2).apply(
        variables, jnp.asarray(x), update_sn=True, mutable=["spectral"])
    store = {}
    got = blk(_nchw(x), store)
    w = np.asarray(want)
    np.testing.assert_allclose(_nhwc(got), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    names = {m: n for n, m in blk.named_modules()}
    got_u = {f"{names[m]}.u": u for m, u in store.items()}
    want_u = spectral_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      new["spectral"]))
    assert got_u.keys() == want_u.keys()
    for k in want_u:
        np.testing.assert_allclose(got_u[k].numpy(), want_u[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


OPTIONS = [
    dict(use_srm=True, use_spectral_norm=True, with_qf_attn=False,
         use_sigmoid=True),
    dict(use_srm=False, use_spectral_norm=True, with_qf_attn=False,
         use_sigmoid=True),
    dict(use_srm=True, use_spectral_norm=False, with_qf_attn=False,
         use_sigmoid=False),
    dict(use_srm=True, use_spectral_norm=True, with_qf_attn=True,
         use_sigmoid=True),
    dict(use_srm=False, use_spectral_norm=False, with_qf_attn=True,
         use_sigmoid=False),
]


@pytest.mark.parametrize("opts", OPTIONS, ids=[
    "-".join(k.split("_")[-1] if v else "no" + k.split("_")[-1]
             for k, v in o.items()) for o in OPTIONS])
def test_unet_discriminator_matches_flax(opts):
    net = UNetDiscriminator(residual_blocks=1, dim=16, **opts)
    net.init_params(torch.Generator().manual_seed(8))
    _perturbed_u(net, 9)
    rng = np.random.default_rng(10)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    qf = rng.random((2, 1)).astype(np.float32)
    sd = net.state_dict()
    params, _ = state_dict_to_jax({k: v for k, v in sd.items()
                                   if not k.endswith(".u")})
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    spectral = spectral_to_jax(sd)
    if spectral:
        variables["spectral"] = jax.tree_util.tree_map(jnp.asarray, spectral)
    jnet = JDisc(residual_blocks=1, dim=16, **opts)
    (want, _), new = jnet.apply(variables, jnp.asarray(x), jnp.asarray(qf),
                                update_sn=True, mutable=["spectral"])
    store = {}
    got = net(torch.from_numpy(x), torch.from_numpy(qf), store).detach()
    w = np.asarray(want)
    atol = 1e-5 if opts["use_sigmoid"] else 1e-5 * np.abs(w).max()
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=atol)
    names = {m: n for n, m in net.named_modules()}
    got_u = {f"{names[m]}.u": u for m, u in store.items()}
    want_u = spectral_from_jax(jax.tree_util.tree_map(
        np.asarray, new.get("spectral", {})))
    assert got_u.keys() == want_u.keys()
    assert bool(want_u) == opts["use_spectral_norm"]
    for k in want_u:
        np.testing.assert_allclose(got_u[k].numpy(), want_u[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
