"""The port's int8 PTQ modules against the JAX package's, on the CPU in
float32: ``ops/resize.py::resize_bilinear``, ``nets/unet_int8.py`` (fold,
calibrate, quantize, the int8 forward through the plain versions of K11
``qconv`` and K12 ``qconv_t``) and ``nets/inn_int8.py`` (the calibration
walk, quantize, the int8 forward through the plain versions of K11 and K13
``qcoupling_head``). Small widths: UNet f = 16 or 8 on 32²/64² frames, the
INN at the flagship widths (12 channels, down_num 3, trunk 128) on 16²
inputs with perturbed coupling heads. The JAX int8 forwards run under
``jax.jit`` with the int8 tree as an ARGUMENT, as the JAX server runs them
(a closure constant lets XLA's algsimp turn ``/ s`` into a reciprocal
multiply)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from vwfd_tpu.nets import InvertibleNet as JInvertibleNet
from vwfd_tpu.nets import UNetTPU as JUNetTPU
from vwfd_tpu.nets import inn_int8 as jinn8
from vwfd_tpu.nets import unet_int8 as junet8
from vwfd_tpu.ops import resize as jresize
from vwfd_tpu_torch.convert import (inn_int8_from_jax, params_from_jax,
                                    unet_int8_from_jax)
from vwfd_tpu_torch.kernels import PLAIN, launch_counts, qconv, wire
from vwfd_tpu_torch.nets import InvertibleNet, UNetTPU
from vwfd_tpu_torch.nets import inn_int8, unet_int8
from vwfd_tpu_torch.nets.unet_int8 import tree_map
from vwfd_tpu_torch.ops.resize import resize_bilinear, resize_matrix


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


def _assert_tree_equal(ours, ref, where=""):
    """Every leaf of the port's tree equal to the converted JAX tree's."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), where
        for k in ref:
            _assert_tree_equal(ours[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_tree_equal(a, b, f"{where}/{i}")
    else:
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, where
        assert torch.equal(ours, ref), (
            f"{where}: {int((ours != ref).sum())} of {ref.numel()} differ")


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("hw,out", [((16, 16), (64, 64)), ((32, 32), (16, 16)),
                                    ((7, 9), (13, 5)), ((16, 15), (16, 31))])
def test_resize_bilinear_matches_jax(hw, out):
    x = np.random.default_rng(0).random((2, 3, *hw, 3), dtype=np.float32)
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out))
    ours = _np(resize_bilinear(torch.from_numpy(x), out))
    assert ours.shape == ref.shape == (2, 3, *out, 3)
    np.testing.assert_array_equal(
        resize_matrix(hw[0], out[0], "bilinear"),
        jresize.resize_matrix(hw[0], out[0], "bilinear"))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_stem_levels_sweep_all_bytes():
    """The int8 stem ``round((u/255)·127)``: no byte lies closer than 1/510
    to a rounding boundary, far beyond a float32 rounding, so the IEEE
    quotient, XLA's ``u·(1/255)`` and the exact rational all give the same
    level."""
    u = np.arange(256)
    exact = u * 127 / 255
    assert np.abs(exact - np.floor(exact) - 0.5).min() >= 1 / 510 - 1e-12
    q_ieee = np.float32(u) / np.float32(255)
    q_recip = np.float32(u) * (np.float32(1) / np.float32(255))
    want = np.round(exact).astype(np.int8)
    for q in (q_ieee, q_recip):
        np.testing.assert_array_equal(
            np.clip(np.round(q * np.float32(127)), 0, 127).astype(np.int8),
            want)
    ours = wire.stem_levels(torch.arange(256, dtype=torch.uint8))
    np.testing.assert_array_equal(_np(ours), want)
    jax_lv = jnp.clip(jnp.round(jnp.arange(256, dtype=jnp.uint8).astype(
        jnp.float32) / 255.0 * 127.0), 0, 127).astype(jnp.int8)
    np.testing.assert_array_equal(np.asarray(jax_lv), want)


# -------------------------------------------------------------------- UNet


def _random_bn(tree, rng):
    def go(path, a):
        key = getattr(path[-1], "key", "")
        if key in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if key in ("bias", "mean"):
            return a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                   jnp.float32)
        return a
    return jax.tree_util.tree_map_with_path(go, tree)


def _unet(econvs=(2, 2, 1, 1, 1), s2d=2, feats=16, cout=1, seed=0):
    """(JAX variables, port UNetTPU holding the same, eval mode)."""
    rng = np.random.default_rng(seed)
    jnet = JUNetTPU(init_features=feats, s2d=s2d, enc_convs=econvs,
                    out_channels=cout, apply_sigmoid=True)
    v = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
                  train=False)
    v = {"params": _random_bn(v["params"], rng),
         "batch_stats": _random_bn(v["batch_stats"], rng)}
    np_v = jax.tree_util.tree_map(np.asarray, v)
    _, sd = params_from_jax({}, np_v["params"], np_v["batch_stats"])
    net = UNetTPU(out_channels=cout, init_features=feats, s2d=s2d,
                  enc_convs=econvs)
    net.load_state_dict(sd)
    return jnet, v, net.eval()


@pytest.fixture(scope="module")
def unet16():
    return _unet()


def _frames(n=2, size=32, seed=1):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def test_fold_equals_jax(unet16):
    _, v, net = unet16
    ref = junet8.fold_unet_tpu(v, enc_convs=(2, 2, 1, 1, 1))
    ours = unet_int8.fold_unet_tpu(net)

    def conv(w):  # OIHW → HWIO
        return _np(w.permute(2, 3, 1, 0))

    for lv_o, lv_r in zip(ours["enc"], ref["enc"]):
        for (w, b), (wr, br) in zip(lv_o, lv_r):
            np.testing.assert_array_equal(conv(w), np.asarray(wr))
            np.testing.assert_array_equal(_np(b), np.asarray(br))
    for (w, b), (wr, br) in zip(ours["dec"], ref["dec"]):
        np.testing.assert_array_equal(conv(w), np.asarray(wr))
        np.testing.assert_array_equal(_np(b), np.asarray(br))
    for (k, b), (kr, br) in zip(ours["up"], ref["up"]):  # torch ConvT, flipped
        np.testing.assert_array_equal(_np(k.permute(2, 3, 0, 1))[::-1, ::-1],
                                      np.asarray(kr))
        np.testing.assert_array_equal(_np(b), np.asarray(br))
    np.testing.assert_array_equal(conv(ours["head"][0]),
                                  np.asarray(ref["head"][0]))


def test_apply_folded_matches_module_and_jax(unet16):
    jnet, v, net = unet16
    x = _frames()
    folded = unet_int8.fold_unet_tpu(net)
    with torch.no_grad():
        out, amax = unet_int8.apply_folded(folded, torch.from_numpy(x),
                                           collect_amax=True)
        mod = net(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(mod), atol=2e-5, rtol=1e-4)
    ref, ramax = junet8.apply_folded(junet8.fold_unet_tpu(v), jnp.asarray(x),
                                     collect_amax=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)
    flat_o = jax.tree_util.tree_leaves(tree_map(float, amax))
    flat_r = jax.tree_util.tree_leaves(jax.tree_util.tree_map(float, ramax))
    assert len(flat_o) == len(flat_r) == 5 + 2 + 4 + 4
    np.testing.assert_allclose(flat_o, flat_r, rtol=1e-5, atol=0)


def test_calibrate_matches_jax(unet16):
    _, v, net = unet16
    batches = [_frames(seed=2), _frames(n=3, seed=3)]
    ref = junet8.calibrate(v, [jnp.asarray(b) for b in batches])
    ours = unet_int8.calibrate(net, batches)
    np.testing.assert_allclose(jax.tree_util.tree_leaves(ours),
                               jax.tree_util.tree_leaves(ref), rtol=1e-5,
                               atol=0)
    with pytest.raises(ValueError, match="at least one batch"):
        unet_int8.calibrate(net, [])


def test_quantize_equals_jax_tree(unet16):
    """On the same (JAX's) scales the port's int8 tree is EQUAL to the JAX
    package's: int8 weights, every m and b."""
    _, v, net = unet16
    scales = junet8.calibrate(v, [jnp.asarray(_frames(seed=4))])
    ref = unet_int8_from_jax(junet8.quantize(v, scales))
    _assert_tree_equal(unet_int8.quantize(net, scales), ref)


def _jax_int8_acts(qp, x, s2d, out_channels):
    """``vwfd_tpu/nets/unet_int8.py::apply_int8`` step by step, returning
    its output and every int8 activation in order (the test checks that it
    reproduces ``apply_int8`` exactly)."""
    dn = ("NHWC", "HWIO", "NHWC")

    def qc(zi, wi):
        return lax.conv_general_dilated(zi, wi, (1, 1), "SAME",
                                        dimension_numbers=dn,
                                        preferred_element_type=jnp.int32)

    def requant(acc, m, b, lo):
        y = acc.astype(jnp.float32) * m[None, None, None, :] + b
        return jnp.clip(jnp.round(y), lo, 127).astype(jnp.int8)

    acts = []
    zi = jnp.clip(jnp.round(x * 127.0), 0, 127).astype(jnp.int8)
    zi = junet8._s2d(zi, s2d)
    skips = []
    for j, level in enumerate(qp["enc"]):
        if j > 0:
            zi = lax.reduce_window(zi, jnp.int8(-128), lax.max,
                                   (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
        for c in level:
            zi = requant(qc(zi, c["w"]), c["m"], c["b"], 0)
            acts.append(zi)
        if j < 4:
            skips.append(zi)
    for i, d in enumerate(qp["dec"]):
        u = lax.conv_transpose(zi, d["up_w"], (2, 2), "SAME",
                               dimension_numbers=dn,
                               preferred_element_type=jnp.int32)
        ui = requant(u, d["up_m"], d["up_b"], -127)
        acts.append(ui)
        ya = qc(ui, d["w_up"]).astype(jnp.float32)
        yb = qc(skips[3 - i], d["w_skip"]).astype(jnp.float32)
        y = (ya * d["m_up"][None, None, None, :]
             + yb * d["m_skip"][None, None, None, :] + d["b"])
        zi = jnp.clip(jnp.round(y), 0, 127).astype(jnp.int8)
        acts.append(zi)
    h = qp["head"]
    o = qc(zi, h["w"]).astype(jnp.float32) * h["m"][None, None, None, :] \
        + h["b"]
    o = junet8._d2s(o, s2d, out_channels)
    return jax.nn.sigmoid(o), acts


@pytest.mark.parametrize("econvs,s2d,cout,feats,size", [
    ((2, 2, 1, 1, 1), 2, 1, 16, 32),
    ((1, 1, 1, 1, 1), 2, 1, 8, 64),
    ((2, 1, 1, 1, 1), 4, 1, 8, 64),
    ((2, 2, 2, 2, 2), 2, 2, 8, 64),
])
def test_apply_int8_matches_jax(econvs, s2d, cout, feats, size):
    """Through the plain versions of K11 / K12, on the converted JAX tree:
    every int8 activation EQUAL to the JAX package's, probabilities within
    1e-6."""
    _, v, _ = _unet(econvs, s2d, feats, cout, seed=3)
    x = _frames(size=size, seed=5)
    scales = junet8.calibrate(v, [jnp.asarray(x)], enc_convs=econvs, s2d=s2d,
                              out_channels=cout)
    jqp = junet8.quantize(v, scales, enc_convs=econvs)
    run = jax.jit(_jax_int8_acts, static_argnums=(2, 3))
    ref, ref_acts = run(jqp, jnp.asarray(x), s2d, cout)
    direct = jax.jit(junet8.apply_int8, static_argnums=(2, 3))(
        jqp, jnp.asarray(x), s2d, cout)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(direct))

    acts = []
    before = launch_counts()
    out = unet_int8.apply_int8(unet_int8_from_jax(jqp), torch.from_numpy(x),
                               s2d=s2d, acts=acts)
    assert launch_counts() == before  # CPU tensors: the plain versions
    assert out.shape == (x.shape[0], size, size, cout)
    assert len(acts) == len(ref_acts) == sum(econvs) + 8
    for i, (a, r) in enumerate(zip(acts, ref_acts)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(_np(a), np.asarray(r),
                                      err_msg=f"activation {i}")
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-6)
    assert float(np.asarray(ref).std()) > 1e-3  # a non-trivial output


def test_int8_tracks_port_f32_after_calibration():
    """The port's own calibrate → quantize → apply_int8 tracks its float32
    net under the JAX package's bounds (test_unet_int8.py)."""
    _, _, net = _unet(feats=16, seed=0)
    x = torch.from_numpy(_frames(n=4, size=64, seed=6))
    with torch.no_grad():
        ref = _np(net(x))
    qp = unet_int8.quantize(net, unet_int8.calibrate(net, [x]))
    out = _np(unet_int8.apply_int8(qp, x))
    assert np.mean(np.abs(out - ref)) < 0.05
    assert np.max(np.abs(out - ref)) < 0.35
    assert np.mean((out > 0.5) == (ref > 0.5)) > 0.95


# -------------------------------------------------------------------- INN


@pytest.fixture(scope="module")
def inn():
    """(JAX params with perturbed coupling heads, port net holding the
    same)."""
    rng = np.random.default_rng(11)
    jnet = JInvertibleNet(channels=12, down_num=3, block_num=(1, 1, 1),
                          subnet="res_tpu2", fused_st=True, haar="conv",
                          dtype=None)
    v = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 12)))

    def perturb(path, a):
        if any(getattr(k, "key", "") == "Conv_2" for k in path):
            return a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                   jnp.float32)
        return a

    p = jax.tree_util.tree_map_with_path(perturb, v["params"])
    net = InvertibleNet(channels=12, down_num=3, block_num=(1, 1, 1))
    sd, _ = params_from_jax(jax.tree_util.tree_map(np.asarray, p), {}, {})
    net.load_state_dict(sd)
    return p, net.eval()


def _inn_x(seed=12, n=2):
    return np.random.default_rng(seed).random((n, 16, 16, 12),
                                              dtype=np.float32)


def _scale(ref):
    return max(1.0, float(np.abs(ref).max()))


def test_inn_collect_amax_walk_is_the_packed_forward(inn):
    p, net = inn
    x = torch.from_numpy(_inn_x())
    y, amax = inn_int8.collect_amax(net, x)
    with torch.no_grad():
        ref = _np(net(x))
    assert float(np.abs(ref - _np(x)).max()) > 1e-2  # not the identity
    assert float(np.abs(_np(y) - ref).max()) < 1e-4 * _scale(ref)
    assert set(amax) == set(p) and all(set(d) == {"st1", "st2"}
                                       for d in amax.values())


def test_inn_calibrate_matches_jax(inn):
    p, net = inn
    batches = [_inn_x(seed=13), _inn_x(seed=14, n=1)]
    ref = jinn8.calibrate(p, [jnp.asarray(b) for b in batches])
    ours = inn_int8.calibrate(net, batches)
    assert set(ours) == set(ref)
    for k in ref:
        for st in ("st1", "st2"):
            np.testing.assert_allclose(ours[k][st], ref[k][st], rtol=1e-5,
                                       atol=0, err_msg=f"{k}/{st}")


def test_inn_quantize_equals_jax_tree(inn):
    p, net = inn
    scales = jinn8.calibrate(p, [jnp.asarray(_inn_x(seed=15))])
    ref = inn_int8_from_jax(jinn8.quantize(p, scales))
    _assert_tree_equal(inn_int8.quantize(net, scales), ref)


def _jax_inn_int8_acts(q, x):
    """``vwfd_tpu/nets/inn_int8.py::forward_int8`` (dtype None) through its
    own walk, recording every int8 trunk activation (h0i, h1i) in order."""
    def qc(zi, wi, pad):
        return lax.conv_general_dilated(
            zi, wi, (1, 1), ((pad, pad), (pad, pad)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)

    acts = []

    def st(c, name, xin, packed):
        p = c[name]
        xi = jnp.clip(jnp.round(xin.astype(jnp.float32) / p["s_x"]),
                      -127, 127).astype(jnp.int8)
        h0 = jax.nn.elu(qc(xi, p["w0"], 1).astype(jnp.float32)
                        * p["m0"] + p["b0"])
        h0i = jnp.clip(jnp.round(h0 / p["s_h0"]), -127, 127).astype(jnp.int8)
        h1 = jax.nn.elu(qc(h0i, p["w1"], 1).astype(jnp.float32)
                        * p["m1"] + p["b1"])
        h1i = jnp.clip(jnp.round(h1 / p["s_h1"]), -127, 127).astype(jnp.int8)
        acts.extend([h0i, h1i])
        out = (qc(xi, p["w2x"], 0).astype(jnp.float32) * p["m2x"]
               + qc(h1i, p["w2h"], 0).astype(jnp.float32) * p["m2h"]
               + p["b2"])
        half = out.shape[-1] // 2
        return out[..., :half], out[..., half:]

    y = jinn8._walk(q, x, st, 12, 3, None)
    return y, acts


def test_inn_forward_int8_matches_jax(inn):
    """Through the plain versions of K11 / K13 on the converted JAX tree,
    float32 (``dtype=None``). XLA's CPU ``expm1``/``exp``/``sigmoid`` and
    torch's may differ by an ulp, which can flip an int8 trunk level at a
    rounding boundary; the flips are counted and bounded (at most 1 level,
    on at most 1e-3 of the trunk activations; 0 of 45,056 observed), and
    the output is within 1e-4 of its scale."""
    p, net = inn
    x = _inn_x(seed=16)
    scales = jinn8.calibrate(p, [jnp.asarray(x)])
    jq = jinn8.quantize(p, scales)
    ref, ref_acts = jax.jit(_jax_inn_int8_acts)(jq, jnp.asarray(x))
    direct = jax.jit(lambda q, v: jinn8.forward_int8(q, v, dtype=None))(
        jq, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(direct))

    acts = []

    def recording_qconv(*a, **kw):
        acts.append(qconv.qconv_plain(*a, **kw))
        return acts[-1]

    out = inn_int8.forward_int8(inn_int8_from_jax(jq), torch.from_numpy(x),
                                dtype=None,
                                kernels=PLAIN._replace(qconv=recording_qconv))
    assert len(acts) == len(ref_acts) == 20  # 2 per subnet evaluation
    flips = total = 0
    for a, r in zip(acts, ref_acts):
        d = np.abs(_np(a).astype(int) - np.asarray(r).astype(int))
        assert d.max() <= 1
        flips += int((d > 0).sum())
        total += d.size
    assert flips <= 1e-3 * total, f"{flips} of {total} int8 levels flipped"
    ref = np.asarray(ref)
    assert float(np.abs(_np(out) - ref).max()) < 1e-4 * _scale(ref), (
        f"{flips} flipped levels")
    with torch.no_grad():
        f32 = _np(net(torch.from_numpy(x)))
    err = np.abs(_np(out) - f32)  # the PTQ envelope of test_nets.py
    assert float(err.max()) < 0.10 * _scale(f32)
    assert float(err.mean()) < 0.02 * _scale(f32)
