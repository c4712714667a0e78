"""The port's int8 serving options against the JAX package's server: the
flagship config (``configs/video.yaml``) cut to 32² clips, B=2, T=4, f32 on
the CPU, the extractor at f = 16. The JAX ``WatermarkServer`` and the
port's serve the same weights (the JAX init with the zero-init coupling
heads perturbed and random BatchNorm statistics, converted through
``convert.py``) and calibrate on the same explicit ``int8_calib`` clips:
self-calibration draws its clips from ``jax.random`` in the JAX package and
from a numpy generator in the port (F15), so only explicit clips compare.
Then the JAX tests' own properties (tests/test_serving.py:253-360) on the
port's server, the CLI, and the card rule (no card, no ``device="cpu"``:
raise)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vwfd_tpu
from vwfd_tpu import serving as jserving
from vwfd_tpu.config import load_config as jload_config
from vwfd_tpu.models.video_model import VideoWatermarkModel as JModel
from vwfd_tpu.nets import unet_int8 as junet8
from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config, serve
from vwfd_tpu_torch.convert import params_from_jax, unet_int8_from_jax
from vwfd_tpu_torch.kernels import launch_counts
from vwfd_tpu_torch.nets import unet_int8
from vwfd_tpu_torch.serving import WatermarkServer, unpack_mask_bits

B, T, S = 2, 4, 32
MODES = ("embed", "detect", "roundtrip")
# the zero-init coupling heads' perturbation: a faint watermark (pixels move
# by 4.5 levels on average). The two packages' float paths (transitions,
# affines) differ by float32 roundings, which the random INN amplifies in
# proportion to its heads: measured on this clip, bytes differing by one
# level are 4e-5 of all at 1e-3, 0.85 % at 5e-3 (with JAX's int8 tree as
# with the port's own), and at 5e-2 the INN saturates and its output is
# noise.
HEAD_PERTURB = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _small(cfg):
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=B, frames=T,
                                      gt_size=S),
        model=dataclasses.replace(cfg.model, extractor_features=16),
        train=dataclasses.replace(cfg.train, dtype="float32"))


def _perturb(tree, rng):
    def go(path, a):
        keys = [getattr(k, "key", "") for k in path]
        if "Conv_2" in keys:  # zero-init coupling heads
            return a + jnp.asarray(HEAD_PERTURB * rng.standard_normal(a.shape),
                                   jnp.float32)
        if keys[-1] in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if keys[-1] == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(a.shape),
                               jnp.float32)
        return a
    return jax.tree_util.tree_map_with_path(go, tree)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX states, the port's config and weights)."""
    jcfg = _small(jload_config(os.path.join(
        os.path.dirname(vwfd_tpu.__file__), "configs", "video.yaml")))
    states = JModel(jcfg).init_states(jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    g = states["generator"]
    states["netG"] = states["netG"].replace(
        params=_perturb(states["netG"].params, rng))
    states["generator"] = g.replace(
        params=_perturb(g.params, rng),
        variables={"batch_stats": _perturb(g.variables["batch_stats"], rng)})
    tree = jax.tree_util.tree_map(np.asarray, {
        "netG": states["netG"].params, "gen": states["generator"].params,
        "stats": states["generator"].variables["batch_stats"]})
    netG, gen = params_from_jax(tree["netG"], tree["gen"], tree["stats"])
    return (jcfg, states, _small(load_config(FLAGSHIP_CONFIG)),
            {"netG": netG, "generator": gen})


def _jax_server(jcfg, states, **kw):
    """The JAX package's server on ``states`` (its constructor takes
    weights only from a checkpoint directory)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JModel, "init_states", lambda self, key: states)
        return jserving.WatermarkServer(jcfg, **kw)


@pytest.fixture(scope="module")
def calib():
    return np.random.default_rng(22).integers(0, 256, (B, T, S, S, 3),
                                              dtype=np.uint8)


@pytest.fixture()
def clip():
    return np.random.default_rng(23).integers(0, 256, (B, T, S, S, 3),
                                              dtype=np.uint8)


@pytest.fixture(scope="module")
def servers(weights, calib):
    """(JAX server, port server): both int8 paths, the same weights and
    calibration clips."""
    jcfg, states, cfg, w = weights
    kw = dict(modes=MODES, int8_extract=True, int8_embed=True,
              int8_calib=calib)
    return (_jax_server(jcfg, states, **kw),
            WatermarkServer(cfg, device="cpu", weights=w, **kw))


def _jax_probs(jsrv, u8):
    flat = jnp.asarray(u8, jnp.float32).reshape(-1, S, S, 3) / 255.0
    return np.asarray(junet8.apply_int8(jsrv._params["qext"], flat, s2d=2),
                      np.float32).reshape(B, T, S, S, 1)


def test_int8_detect_matches_jax_server(servers, clip):
    """Masks equal except where JAX's probability is within 1e-6 of the
    threshold; tamper fraction within 1e-5."""
    jsrv, srv = servers
    ref = jsrv.serve(clip, "detect")
    before = launch_counts()
    got = srv.serve(clip, "detect")
    assert launch_counts() == before  # CPU tensors: the plain versions
    near = np.abs(_jax_probs(jsrv, clip) - 0.5) < 1e-6
    assert not ((got.mask != ref.mask) & ~near).any()
    np.testing.assert_allclose(got.tamper_fraction, ref.tamper_fraction,
                               rtol=0, atol=1e-5)
    assert 0.0 < float(np.std(_jax_probs(jsrv, clip)))  # a non-trivial mask


def test_int8_embed_and_roundtrip_match_jax_server(servers, clip):
    """Watermarked bytes within 1 level of the JAX server's on ≥ 99.99 % of
    pixels; the roundtrip's detect half as the detect test, on the bytes the
    port's embed wrote."""
    jsrv, srv = servers
    for mode in ("embed", "roundtrip"):
        ref, got = jsrv.serve(clip, mode), srv.serve(clip, mode)
        d = np.abs(got.watermarked.astype(int) - ref.watermarked.astype(int))
        assert d.max() <= 1 and (d == 0).mean() >= 0.9999, (mode, d.max())
    assert np.abs(got.watermarked.astype(int) - clip.astype(int)).max() > 1
    ref = jsrv.serve(got.watermarked, "detect")
    near = np.abs(_jax_probs(jsrv, got.watermarked) - 0.5) < 1e-6
    assert not ((got.mask != ref.mask) & ~near).any()
    np.testing.assert_allclose(got.tamper_fraction, ref.tamper_fraction,
                               rtol=0, atol=1e-5)


def test_int8_detect_is_thresholded_apply_int8(servers, clip):
    """The served mask equals thresholding ``apply_int8`` on the server's
    own tree, exactly (test_serving.py's
    test_int8_detect_matches_direct_quantized_forward)."""
    _, srv = servers
    res = srv.serve(clip, "detect")
    flat = torch.from_numpy(clip).float().reshape(-1, S, S, 3) / 255.0
    probs = unet_int8.apply_int8(srv._qext, flat, s2d=2).numpy().reshape(
        B, T, S, S, 1)
    np.testing.assert_array_equal(res.mask,
                                  (probs > 0.5).astype(np.uint8) * 255)
    np.testing.assert_allclose(res.tamper_fraction,
                               probs.mean(axis=(1, 2, 3, 4)), atol=1e-5)


def test_int8_trees_track_jax_server(servers):
    """Both servers calibrate on the same clips: their int8 weights are
    EQUAL (weights do not depend on the scales) and every m within 1e-5
    relative (the scales come from each package's float32 convolutions)."""
    jsrv, srv = servers
    ref = unet_int8_from_jax(jsrv._params["qext"])
    for lv, rlv in zip(srv._qext["enc"], ref["enc"]):
        for c, rc in zip(lv, rlv):
            assert torch.equal(c["w"], rc["w"])
            np.testing.assert_allclose(c["m"], rc["m"], rtol=1e-5)
    for d, rd in zip(srv._qext["dec"], ref["dec"]):
        for k in ("up_w", "w_up", "w_skip"):
            assert torch.equal(d[k], rd[k])


def test_int8_margin_changes_the_scales(weights, clip):
    _, _, cfg, w = weights
    kw = dict(device="cpu", weights=w, modes=("detect",), int8_extract=True)
    a = WatermarkServer(cfg, int8_calib=clip, **kw)
    b = WatermarkServer(cfg, int8_calib=[clip], int8_margin=2.0, **kw)
    assert a.serve(clip, "detect").mask.shape == (B, T, S, S, 1)
    assert not torch.allclose(a._qext["enc"][0][0]["m"],
                              b._qext["enc"][0][0]["m"])


def test_int8_fused_roundtrip_is_embed_then_detect(weights, clip):
    """Self-calibrated (no clips): the roundtrip equals serving the embed's
    output through detect, with both int8 paths on."""
    _, _, cfg, w = weights
    srv = WatermarkServer(cfg, device="cpu", weights=w, modes=MODES,
                          int8_extract=True, int8_embed=True)
    fused = srv.serve(clip, "roundtrip")
    wm = srv.serve(clip, "embed").watermarked
    two = srv.serve(wm, "detect")
    np.testing.assert_array_equal(fused.watermarked, wm)
    np.testing.assert_array_equal(fused.mask, two.mask)
    np.testing.assert_array_equal(fused.tamper_fraction,
                                  two.tamper_fraction)
    np.testing.assert_array_equal(fused.mask,
                                  unpack_mask_bits(fused.mask_bits))


def test_int8_rejects_unsupported_configs(weights):
    _, _, cfg, _ = weights
    unet = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, extractor="unet"))
    with pytest.raises(ValueError, match="int8_extract"):
        WatermarkServer(unet, device="cpu", int8_extract=True)
    unpacked = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, inn_packed=False))
    with pytest.raises(ValueError, match="int8_embed"):
        WatermarkServer(unpacked, device="cpu", modes=("embed",),
                        int8_embed=True)


def test_int8_needs_the_card_or_cpu(weights, monkeypatch):
    _, _, cfg, w = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WatermarkServer(cfg, weights=w, int8_extract=True)


def test_int8_calib_oneshot_iterable_feeds_both_paths(weights, clip):
    """A one-shot iterable is listed once, so both int8 paths calibrate from
    it: the same trees as from a list; per-path clips work too."""
    _, _, cfg, w = weights
    kw = dict(device="cpu", weights=w, modes=("roundtrip",),
              int8_extract=True, int8_embed=True)
    one = WatermarkServer(cfg, int8_calib=(c for c in [clip]), **kw)
    lst = WatermarkServer(cfg, int8_calib=[clip], **kw)
    for a, b in ((one._qext, lst._qext), (one._qemb, lst._qemb)):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert torch.equal(x, y)
    two = WatermarkServer(cfg, int8_calib_embed=clip,
                          int8_calib_detect=(c for c in [clip]), **kw)
    out = two.serve(clip, "roundtrip")
    assert out.watermarked.shape == clip.shape
    assert out.tamper_fraction.shape == (B,)


def test_serve_cli_int8(capsys):
    serve.main(["--mode", "roundtrip", "--synthetic", "1", "--device", "cpu",
                "--batch", "1", "--size", "32", "--int8", "--int8-embed"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["int8"] is True and info["int8_embed"] is True
    assert info["clips"] == 1 and info["frames_per_s"] > 0
