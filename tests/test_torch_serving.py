"""The serving slice of the port against the JAX package: the flagship nets
(vwfd_tpu_torch/configs/video.yaml widths) on 32² clips, B=2, T=4, f32 on the
CPU. The JAX side is ``VideoWatermarkModel.embed`` / ``predict_mask`` plus
``serving._pack_mask_bits``; the port side is ``WatermarkServer(device=
"cpu")`` on the same weights (converted through ``convert.py``), with the
zero-init coupling heads perturbed and random BatchNorm statistics."""

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
from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config
from vwfd_tpu_torch.convert import params_from_jax
from vwfd_tpu_torch.serving import (WatermarkServer, save_weights,
                                    unpack_mask_bits)

B, T, S = 2, 4, 32
MODES = ("embed", "detect", "roundtrip")


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
        train=dataclasses.replace(cfg.train, dtype="float32"))


def _perturb(tree, rng):
    def go(path, a):
        keys = [getattr(k, "key", "") for k in path]
        if "Conv_2" in keys:  # zero-init coupling heads
            return a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                   jnp.float32)
        if keys[-1] in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if keys[-1] == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(a.shape),
                               jnp.float32)
        return a
    return jax.tree_util.tree_map_with_path(go, tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its states, port server on the same weights)."""
    jcfg = _small(jload_config(os.path.join(
        os.path.dirname(vwfd_tpu.__file__), "configs", "video.yaml")))
    jmodel = JModel(jcfg)
    states = jmodel.init_states(jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    g = states["generator"]
    states["netG"] = states["netG"].replace(
        params=_perturb(states["netG"].params, rng))
    states["generator"] = g.replace(
        params=_perturb(g.params, rng),
        variables={"batch_stats": _perturb(g.variables["batch_stats"], rng)})
    np_tree = jax.tree_util.tree_map(np.asarray, {
        "netG": states["netG"].params, "gen": states["generator"].params,
        "stats": states["generator"].variables["batch_stats"]})
    netG, gen = params_from_jax(np_tree["netG"], np_tree["gen"],
                                np_tree["stats"])
    server = WatermarkServer(_small(load_config(FLAGSHIP_CONFIG)),
                             device="cpu",
                             weights={"netG": netG, "generator": gen},
                             modes=MODES)
    return jmodel, states, server


@pytest.fixture()
def clip():
    return np.random.default_rng(9).integers(0, 256, (B, T, S, S, 3),
                                             dtype=np.uint8)


def test_roundtrip_matches_jax_embed_and_detect(pair, clip):
    """u8 watermark within 1 level of the JAX embed; mask bits equal except
    where the JAX probability is within 1e-5 of the threshold; tamper
    fraction within 1e-5."""
    jmodel, states, server = pair
    video = jnp.asarray(clip).astype(jnp.float32) / 255.0
    fwd = jmodel.embed(states, video)
    ref_wm = np.asarray(jnp.round(jnp.clip(fwd, 0.0, 1.0) * 255.0)
                        ).astype(np.uint8)
    res = server.serve(clip, "roundtrip")
    wm = res.watermarked
    assert wm.dtype == np.uint8 and wm.shape == clip.shape
    assert np.abs(wm.astype(int) - ref_wm.astype(int)).max() <= 1
    assert np.abs(wm.astype(int) - clip.astype(int)).max() > 1  # not identity

    probs = jmodel.predict_mask(states, jnp.asarray(wm).astype(jnp.float32)
                                / 255.0, train=False)
    ref_bits = np.asarray(jserving._pack_mask_bits(probs > 0.5))
    bits = res.mask_bits
    assert bits.shape == (B, T, S, S // 8)
    near = np.abs(np.asarray(probs)[..., 0] - 0.5) < 1e-5
    differ = unpack_mask_bits(bits) != unpack_mask_bits(ref_bits)
    assert not (differ[..., 0] & ~near).any()
    np.testing.assert_allclose(
        res.tamper_fraction, np.asarray(jnp.mean(probs, axis=(1, 2, 3, 4))),
        rtol=0, atol=1e-5)
    assert 0.0 < float(np.asarray(probs).std())  # a non-trivial mask
    np.testing.assert_array_equal(res.mask, unpack_mask_bits(bits))


def test_modes_agree_and_tail_padding_is_exact(pair, clip):
    _, _, server = pair
    rt = server.serve(clip, "roundtrip")
    emb = server.serve(clip, "embed")
    det = server.serve(emb.watermarked, "detect")
    np.testing.assert_array_equal(emb.watermarked, rt.watermarked)
    np.testing.assert_array_equal(det.mask_bits, rt.mask_bits)
    np.testing.assert_array_equal(det.tamper_fraction, rt.tamper_fraction)
    one = server.serve(clip[:1], "roundtrip")
    assert one.n == 1 and one.watermarked.shape == (1, T, S, S, 3)
    np.testing.assert_array_equal(one.watermarked, rt.watermarked[:1])
    np.testing.assert_array_equal(one.mask_bits, rt.mask_bits[:1])
    np.testing.assert_array_equal(one.tamper_fraction,
                                  rt.tamper_fraction[:1])


def test_stream_preserves_order(pair):
    _, _, server = pair
    rng = np.random.default_rng(10)
    clips = [rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
             for _ in range(3)]
    out = list(server.serve_stream(iter(clips), "embed", window=2))
    assert len(out) == 3
    for c, r in zip(clips, out):
        np.testing.assert_array_equal(r.watermarked,
                                      server.serve(c, "embed").watermarked)


def test_wire_checks(pair, clip):
    _, _, server = pair
    with pytest.raises(TypeError):
        server.serve(clip.astype(np.float32), "embed")
    with pytest.raises(ValueError):
        server.serve(clip[:, :, :16], "embed")
    with pytest.raises(ValueError):
        server.serve(np.concatenate([clip, clip]), "embed")
    with pytest.raises(KeyError):
        WatermarkServer(server.cfg, device="cpu", modes=("embed",)
                        ).serve(clip, "detect")


def test_weights_file_roundtrip(pair, clip, tmp_path):
    _, _, server = pair
    path = str(tmp_path / "weights.pt")
    save_weights(server.model.states(), path)
    other = WatermarkServer(server.cfg, device="cpu", weights=path,
                            modes=MODES)
    np.testing.assert_array_equal(other.serve(clip, "roundtrip").mask_bits,
                                  server.serve(clip, "roundtrip").mask_bits)


def test_server_raises_without_a_card(monkeypatch):
    """The default device is the card: no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WatermarkServer(_small(load_config(FLAGSHIP_CONFIG)))


@pytest.mark.parametrize("flag", ["--synthetic", "--latency"])
def test_serve_cli_on_cpu(capsys, flag):
    """``python -m vwfd_tpu_torch.serve`` prints one JSON line per run."""
    from vwfd_tpu_torch import serve
    serve.main(["--mode", "roundtrip", flag, "2", "--device", "cpu",
                "--batch", "2", "--size", "32"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["requests"] == 2
    if flag == "--synthetic":
        assert out["clips"] == 4 and out["frames_per_s"] > 0
    else:
        assert 0 < out["p50_ms"] <= out["p99_ms"]
