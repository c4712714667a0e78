"""Parity of the port's KD-JPEG pieces with vwfd_tpu's, on the CPU in
float32: ``FBCNN`` (``nets/fbcnn.py``) and its QF-attention epilogue (K23
``film_residual``'s plain version), the FBCNN tree through ``convert.py``,
``LQJpegDataset``, ``KDJpegModel.collate`` and ``simulate``.

Inputs come from numpy with a seed; the weights are the port's own
initialisation carried to flax trees by ``convert.py``. The nets are
narrow: FBCNN ``nc`` (8, 8, 16, 16) at ``nb`` 1 and 2, 32² images.

Tolerances and why:

* FBCNN's ``out`` and ``m1``-``m4`` within 1e-5 of each tensor's max
  (float32 convolutions summed in another order);
* the epilogue ``x + (γ·h + β)``: under ``jax.jit`` XLA:CPU contracts
  ``γ·h + β`` into one FMA (found by this file: the jitted JAX value is
  ``x + fma(γ, h, β)`` exactly, 14 % of the elements one rounding off the
  separately rounded value); op by op JAX rounds the product and each sum
  apart, as the plain version and K23 do. So the plain version is EQUAL to
  JAX's op-by-op epilogue and within one float32 ulp each of |γ·h|,
  |γ·h + β| and |out| of the jitted one; its gradients within 1e-6 of the JAX
  gradient's max (γ's and β's are sums over the plane in another order),
  gx and gh EQUAL;
* the dataset's items and the collate EQUAL (the same PIL encoder);
* ``simulate`` within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.config import Config as JConfig
from vwfd_tpu.config import DataConfig as JDataConfig
from vwfd_tpu.data.jpeg_data import LQJpegDataset as JLQ
from vwfd_tpu.models.kdjpeg_model import KDJpegModel as JKD
from vwfd_tpu.models.state import NetState
from vwfd_tpu.nets.fbcnn import FBCNN as JFBCNN
from vwfd_tpu_torch import Config, DataConfig
from vwfd_tpu_torch.convert import state_dict_from_jax, state_dict_to_jax
from vwfd_tpu_torch.data import LQJpegDataset
from vwfd_tpu_torch.kernels import PLAIN, film, launch_counts
from vwfd_tpu_torch.models.kdjpeg_model import KDJpegModel
from vwfd_tpu_torch.nets import FBCNN

NC = (8, 8, 16, 16)
S = 32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _image(seed, shape=(2, S, S, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _fbcnn(nb, seed=3):
    net = FBCNN(nc=NC, nb=nb, kernels=PLAIN)
    net.init_params(torch.Generator().manual_seed(seed))
    # biases away from 0, so that a layout slip in any of them shows
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return net


def _close(got, want, rtol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("nb", [1, 2])
def test_fbcnn_matches_jax(nb):
    """``out`` and ``m1``-``m4`` of the port's FBCNN (K23's plain
    version) against flax's ``FBCNN`` on the converted tree."""
    net = _fbcnn(nb)
    params, _ = state_dict_to_jax(net.state_dict())
    x, qf = _image(5), np.array([[0.2], [0.8]], np.float32)
    jnet = JFBCNN(nc=NC, nb=nb)
    jout, jms = jax.jit(lambda p, a, q: jnet.apply({"params": p}, a, q))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(qf))
    with torch.no_grad():
        out, ms = net(torch.from_numpy(x), torch.from_numpy(qf))
    _close(out.numpy(), jout, 1e-5, "out")
    for i, (m, jm) in enumerate(zip(ms, jms)):
        assert m.shape == jm.shape
        _close(m.numpy(), jm, 1e-5, f"m{i + 1}")


def _epilogue_jax(x, h, gamma, beta):
    """``_QFAttention``'s epilogue as JAX writes it (NHWC)."""
    return x + (gamma[:, None, None, :] * h + beta[:, None, None, :])


def _film_inputs(seed, shape=(2, 5, 6, 7)):
    rng = np.random.default_rng(seed)
    x, h, g = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    gamma = rng.random(shape[:2]).astype(np.float32)
    beta = np.tanh(rng.standard_normal(shape[:2])).astype(np.float32)
    return x, h, gamma, beta, g


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def test_film_plain_matches_jax_epilogue_and_its_vjp():
    """K23's plain version against JAX's epilogue and ``jax.vjp`` of it:
    forward EQUAL to JAX's op-by-op form; XLA:CPU's jitted form contracts
    ``γ·h + β`` into one FMA (pinned: EQUAL to ``x + fma(γ, h, β)``), an
    ulp or two from the plain version; gx, gh EQUAL; gγ, gβ within 1e-6 of
    the max."""
    x, h, gamma, beta, g = _film_inputs(0)
    jargs = [jnp.asarray(_nhwc(x)), jnp.asarray(_nhwc(h)),
             jnp.asarray(gamma), jnp.asarray(beta)]
    jitted, vjp = jax.vjp(jax.jit(_epilogue_jax), *jargs)
    eager = _epilogue_jax(*jargs)
    jg = vjp(jnp.asarray(_nhwc(g)))
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (x, h, gamma, beta)]
    out = film.film_residual_plain(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    got = _nhwc(out.detach().numpy())
    np.testing.assert_array_equal(got, np.asarray(eager))
    fma = _nhwc((gamma[:, :, None, None].astype(np.float64) * h
                 + beta[:, :, None, None]).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jitted), _nhwc(x) + fma)
    prod = np.abs(_nhwc(gamma[:, :, None, None] * h))
    ulp = (np.spacing(prod) + np.spacing(np.abs(fma))
           + np.spacing(np.abs(got)))
    assert np.all(np.abs(got - np.asarray(jitted)) <= ulp)
    np.testing.assert_array_equal(_nhwc(grads[0].numpy()), np.asarray(jg[0]))
    np.testing.assert_array_equal(_nhwc(grads[1].numpy()), np.asarray(jg[1]))
    for i in (2, 3):
        _close(grads[i].numpy(), jg[i], 1e-6, f"grad {i}")


def test_film_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version (no launch counted),
    and it refuses shapes that do not fit."""
    x, h, gamma, beta, _ = _film_inputs(1)
    ts = [torch.from_numpy(a) for a in (x, h, gamma, beta)]
    before = launch_counts()
    assert torch.equal(film.film_residual(*ts),
                       film.film_residual_plain(*ts))
    assert launch_counts() == before
    with pytest.raises(ValueError):
        film.film_residual(ts[0], ts[1][:, :4], ts[2], ts[3])
    with pytest.raises(ValueError):
        film.film_residual(ts[0], ts[1], ts[2][:, :4], ts[3])


def test_film_backward_segments_fill_the_card():
    """The backward's runs a plane: at KD-JPEG's three levels and the
    simulator's at 512² b3 on 132 SMs, enough CTAs for the card and each
    run at least one CTA sweep."""
    for planes, hw, want in ((6 * 128, 64 * 64, 1), (6 * 64, 128 * 128, 3),
                             (6 * 32, 256 * 256, 6), (3 * 16, 512 * 512, 22),
                             (5, 7, 1)):
        segs = film.segments(planes, hw, 132)
        assert segs == want, (planes, hw, segs)
        nv = hw // 4 if hw % 4 == 0 else hw
        assert segs == 1 or nv // segs >= film.UNROLL * film.BLOCK


def test_fbcnn_tree_round_trip():
    """``state_dict_to_jax`` ∘ ``state_dict_from_jax`` is the identity on
    FBCNN's tree, and the ConvTranspose kernels are flax's flipped (F3):
    the tree has flax's module names."""
    net = _fbcnn(1)
    params, stats = state_dict_to_jax(net.state_dict())
    assert not stats
    jnet = JFBCNN(nc=NC, nb=1)
    ref = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                         jnp.zeros((1, S, S, 3)), jnp.zeros((1, 1)))
    want = jax.tree_util.tree_map(lambda a: a.shape, ref["params"])
    assert jax.tree_util.tree_map(np.shape, params) == want
    back = state_dict_from_jax(params)
    sd = net.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    w = sd["up3_up.weight"].numpy()
    np.testing.assert_array_equal(params["up3_up"]["kernel"],
                                  w.transpose(2, 3, 0, 1)[::-1, ::-1])


def test_lq_dataset_items_equal_jax():
    """``LQJpegDataset`` on the same seed: the clean image and PIL's 4:2:0
    JPEG at each quality EQUAL to JAX's, labels 0..5."""
    ds = LQJpegDataset(size=S, synthetic_length=4, seed=10)
    jds = JLQ(size=S, synthetic_length=4, seed=10)
    assert len(ds) == len(jds) == 4
    for i in (0, 3):
        v, lab = ds[i]
        jv, jlab = jds[i]
        assert v.shape == (6, S, S, 3) and v.dtype == np.float32
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(lab, jlab)
    # the 4:2:0 encoder is not jpeg_real's 4:4:4
    from vwfd_tpu_torch.attacks import jpeg_real
    assert not np.array_equal(ds[0][0][1], jpeg_real(ds[0][0][0], 10))


def test_collate_is_class_major_and_refuses_other_layouts():
    """``collate`` EQUAL to JAX's on an LQ batch; a batch with another
    class count or labels out of order raises on both packages."""
    ds = LQJpegDataset(size=16, synthetic_length=2, seed=1)
    versions = np.stack([ds[i][0] for i in range(2)])
    labels = np.stack([ds[i][1] for i in range(2)])
    flat, lab = KDJpegModel.collate(versions, labels)
    jflat, jlab = JKD.collate(versions, labels)
    np.testing.assert_array_equal(flat, np.asarray(jflat))
    np.testing.assert_array_equal(lab, np.asarray(jlab))
    np.testing.assert_array_equal(lab, [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5])
    np.testing.assert_array_equal(flat[2], versions[0, 1])
    for bad in ((versions[:, :5], labels[:, :5]),
                (versions, labels[:, ::-1])):
        with pytest.raises(ValueError):
            KDJpegModel.collate(*bad)
        with pytest.raises(ValueError):
            JKD.collate(*bad)


def test_simulate_matches_jax():
    """``simulate``: the clipped FBCNN at a normalised quality, within
    1e-5 of JAX's on the converted generator."""
    cfg = Config(data=DataConfig(gt_size=S, batch_size=6))
    port = KDJpegModel(cfg, nc=NC, nb=1, disc_dim=8, device="cpu",
                       kernels=PLAIN)
    port.init_states(2)
    params, _ = state_dict_to_jax(port.generator.state_dict())
    jmodel = JKD(JConfig(data=JDataConfig(gt_size=S, batch_size=6)),
                 nc=NC, nb=1, disc_dim=8)
    states = {"generator": NetState.create(
        jmodel.generator.apply,
        jax.tree_util.tree_map(jnp.asarray, params), {}, jmodel.tx)}
    x = _image(9, (3, S, S, 3))
    qf = np.array([[0.2], [0.6], [1.0]], np.float32)
    simulate = functools.partial(JKD.simulate.__wrapped__, jmodel)
    want = jax.jit(simulate)(states, jnp.asarray(x), jnp.asarray(qf))
    got = port.simulate(x, qf)
    assert got.shape == (3, S, S, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_film_constants_and_c_interface_match_the_source():
    """``film.py``'s geometry is ``csrc/film.cu``'s (``kBlock``,
    ``kUnroll``), and each C entry takes as many arguments as ``_lib``
    declares."""
    import re
    from pathlib import Path

    from vwfd_tpu_torch.kernels import _lib
    src = (Path(_lib.CSRC) / "film.cu").read_text()
    for const, want in (("kBlock", film.BLOCK), ("kUnroll", film.UNROLL)):
        m = re.search(rf"constexpr int {const} = (\d+);", src)
        assert m and int(m.group(1)) == want, const
    for name in ("vwfd_film_fwd", "vwfd_film_bwd"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        assert len(m.group(1).split(",")) == len(_lib._SIGNATURES[name])
