"""The reference-shaped video model (``ModelConfig()``'s nets: the INN module
path with ``res`` subnets and the lifting Haar, the reference ``UNet``) in
the port against the JAX package, on the CPU in f32.

A small refshape model (down_num 2, block_num (1, 1), subnet width 8;
``UNet`` with f = 4; 32², B = 2, T = 2; resize ratios (0.5, 1, 1.5)) is
initialised in the port, its zero-init coupling heads (each subnet's last
conv) perturbed, and converted to flax trees (``convert.params_to_jax``),
so both sides start from the same weights. The harness is
``test_torch_train.py``'s and ``test_torch_eval.py``'s: the JAX steps are
compiled without XLA's algebraic simplifier (F9), the train step's attack
draws come from ``split(key)[0]`` and the eval step's from the unsplit key
(F13), the clip lies a quarter (train) or three quarters (eval) of a level
above the 8-bit grid and the heads move by 5e-6·N(0,1), so both embeds
round every pixel to the same level.

Tolerances, as those files state them: losses 1e-4 relative, PF 1e-3 dB,
every gradient within 1e-3 of its own max-abs, updated parameters within
2.1·lr, BatchNorm running statistics within 1e-5 (F1); eval PSNR 1e-3 dB,
SSIM 1e-5 (F12), each F1 within ``4·n/(2·tp + fp + fn)`` of JAX's, ``n``
the pixels within 1e-5 of that level's boundary. The server (heads at
1e-3): watermarked bytes within one level of JAX's server's on ≥ 99.99 %
of them (F7), mask bits equal. The orbax checkpoint of JAX's step,
converted by ``tools/jax_checkpoint_to_torch.py``, restores EXACTLY.
"""

import copy
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import _f1_bound
from test_torch_train import _batch, _leaves, _tree, jax_draws
from vwfd_tpu import config as jconfig
from vwfd_tpu import serving as jserving
from vwfd_tpu.models import VideoBatch
from vwfd_tpu.models import VideoWatermarkModel as JModel
from vwfd_tpu.models.state import NetState, save_checkpoint
from vwfd_tpu_torch import REFSHAPE_CONFIG
from vwfd_tpu_torch import config as tconfig
from vwfd_tpu_torch.attacks import attack_pool_video
from vwfd_tpu_torch.convert import params_to_jax
from vwfd_tpu_torch.models import VideoWatermarkModel
from vwfd_tpu_torch.models.state import restore_checkpoint
from vwfd_tpu_torch.nets import UNet
from vwfd_tpu_torch.serving import WatermarkServer

RATIOS = (0.5, 1.0, 1.5)
B, T, S = 2, 2, 32
MODEL = dict(inn_down_num=2, inn_block_num=(1, 1), inn_subnet="res",
             inn_haar="lift", inn_packed=False, inn_width=8,
             extractor="unet", unet_features=4, attack_ratios=RATIOS)
ROOT = Path(__file__).resolve().parents[1]
SMALL_YAML = """\
data: {gt_size: 32, batch_size: 2, frames: 2}
model:
  inn_down_num: 2
  inn_block_num: [1, 1]
  inn_subnet: res
  inn_haar: lift
  inn_packed: false
  inn_width: 8
  extractor: unet
  unet_features: 4
  attack_ratios: [0.5, 1.0, 1.5]
train: {dtype: float32}
"""


def _cfg(mod):
    return mod.Config(data=mod.DataConfig(gt_size=S, batch_size=B, frames=T),
                      model=mod.ModelConfig(**MODEL),
                      train=mod.TrainConfig(dtype="float32"))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_model(perturb, seed=0):
    """The port's refshape model, the zero-init heads (the INN's convs
    whose weights are all zero, and their biases) perturbed."""
    model = VideoWatermarkModel(_cfg(tconfig), device="cpu")
    model.init_states(seed)
    heads = {n.rsplit(".", 1)[0] for n, p in model.inn.named_parameters()
             if n.endswith(".weight") and not p.any()}
    assert heads and all(h.endswith("Conv_4") for h in heads)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.inn.named_parameters():
            if name.rsplit(".", 1)[0] in heads:
                p.add_(perturb * torch.randn(p.shape, generator=gen))
    return model


def _jax_states(model, jm):
    netg, gen, stats = params_to_jax(*(net.state_dict() for net in
                                       model.nets().values()))
    j = jax.tree_util.tree_map(jnp.asarray, (netg, gen, stats))
    return {"netG": NetState.create(jm.inn.apply, j[0], {}, jm.tx),
            "generator": NetState.create(jm.unet.apply, j[1],
                                         {"batch_stats": j[2]}, jm.tx)}


def test_refshape_config_is_modelconfigs_defaults():
    """``configs/refshape.yaml`` names ``ModelConfig()``'s nets, and the
    port builds them: the module path and the reference UNet."""
    cfg = tconfig.load_config(REFSHAPE_CONFIG)
    default = tconfig.ModelConfig()
    for k in ("inn_subnet", "inn_haar", "inn_packed", "fused_st",
              "extractor", "unet_features", "inn_down_num", "inn_block_num"):
        assert getattr(cfg.model, k) == getattr(default, k), k
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(
        jconfig.load_config(REFSHAPE_CONFIG).model)
    model = VideoWatermarkModel(_cfg(tconfig), device="cpu")
    assert not model.inn.packed and isinstance(model.unet, UNet)


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """One JAX train step from the port model's weights, saved with orbax
    and converted by the tool."""
    model = _port_model(5e-6)
    jm = JModel(_cfg(jconfig))
    states = _jax_states(model, jm)
    video, mask, prev = _batch(1)
    key = jax.random.PRNGKey(5)
    params = {k: s.params for k, s in states.items()}
    args = (params, states, VideoBatch(jnp.asarray(video), jnp.asarray(mask)),
            jnp.asarray(prev), key)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        jm._loss, has_aux=True)).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args)
    new = {k: s.apply_gradients(grads[k]) for k, s in states.items()}
    new["generator"] = new["generator"].replace(
        variables={"batch_stats": aux["unet_vars"]["batch_stats"]})
    tmp = tmp_path_factory.mktemp("refshape")
    save_checkpoint(str(tmp / "jax"), 1, new)
    (tmp / "small.yaml").write_text(SMALL_YAML)
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch",
        ROOT / "tools" / "jax_checkpoint_to_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main(["--ckpt-dir", str(tmp / "jax"), "--out", str(tmp / "port"),
               "--config", str(tmp / "small.yaml")])
    draws = jax_draws(jax.random.split(key)[0], B, T, len(RATIOS))
    ref = {"loss": float(loss), "lF": float(aux["lF"]),
           "lB": float(aux["lB"]), "PF": float(aux["PF"]), "grads": grads,
           "new": new, "tool": tool}
    return model, (video, mask, prev, draws), ref, tmp


def test_refshape_train_step_matches_jax(step):
    model, (video, mask, prev, draws), ref, _ = step
    loss, aux, grads, _ = model.loss_and_grads(video, mask, prev, draws)
    got = {"loss": float(loss), "lF": float(aux["lF"]),
           "lB": float(aux["lB"])}
    for k, v in got.items():
        assert abs(v - ref[k]) <= 1e-4 * abs(ref[k]), (k, v, ref[k])
    assert abs(float(aux["PF"]) - ref["PF"]) <= 1e-3
    ours, want = _leaves(_tree(model, grads)), _leaves(ref["grads"])
    assert ours.keys() == want.keys() and len(want) > 50
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(ours[name] - w).max())
        assert err <= 1e-3 * scale, (name, err, scale)
    # the heads and the INN's first conv receive gradient
    assert np.abs(want["['netG']['down_blocks_0_0']['st1']['Conv_4']"
                       "['kernel']"]).max() > 0

    model = copy.deepcopy(model)
    model.train_step(video, mask, prev, draws)
    params = {k: list(net.parameters()) for k, net in model.nets().items()}
    got = _leaves(_tree(model, params))
    lr = model.cfg.train.lr
    for name, w in _leaves({k: s.params
                            for k, s in ref["new"].items()}).items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=2.1 * lr,
                                   err_msg=name)
    _, _, stats = params_to_jax({}, model.unet.state_dict())
    want = _leaves(ref["new"]["generator"].variables["batch_stats"])
    assert len(want) == 36  # 18 BatchNorms of the reference UNet
    for name, w in want.items():
        np.testing.assert_allclose(_leaves(stats)[name], w, rtol=0,
                                   atol=1e-5, err_msg=name)


def test_refshape_orbax_checkpoint_restores_exactly(step):
    """``tools/jax_checkpoint_to_torch.py`` on JAX's refshape checkpoint:
    parameters, BatchNorm statistics, AdamW moments and counts EQUAL."""
    _, _, ref, tmp = step
    model = VideoWatermarkModel(_cfg(tconfig), device="cpu")
    model.init_states(99)
    restore_checkpoint(str(tmp / "port"), 1, model)
    new = ref["new"]
    adam = {k: ref["tool"]._adam_state(s.opt_state) for k, s in new.items()}
    params = {k: list(net.parameters()) for k, net in model.nets().items()}
    for ours, want in (
            (params, {k: s.params for k, s in new.items()}),
            ({k: o.mu for k, o in model.optimizers.items()},
             {k: a.mu for k, a in adam.items()}),
            ({k: o.nu for k, o in model.optimizers.items()},
             {k: a.nu for k, a in adam.items()})):
        got, exp = _leaves(_tree(model, ours)), _leaves(want)
        assert got.keys() == exp.keys() and len(exp) > 50
        for name, w in exp.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    _, _, stats = params_to_jax({}, model.unet.state_dict())
    for name, w in _leaves(new["generator"].variables["batch_stats"]).items():
        np.testing.assert_array_equal(_leaves(stats)[name], w, err_msg=name)
    assert all(int(o.count) == 1 for o in model.optimizers.values())


def test_refshape_eval_step_matches_jax():
    model = _port_model(5e-6)
    jm = JModel(_cfg(jconfig))
    states = _jax_states(model, jm)
    video, mask, prev = _batch(1)
    video = (video + np.float32(0.5 / 255)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    args = (jm, states, VideoBatch(jnp.asarray(video), jnp.asarray(mask)),
            jnp.asarray(prev), key)
    ref = JModel.eval_step.lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args[1:])
    ref = {k: np.asarray(v) for k, v in ref.items()}
    draws = jax_draws(key, B, T, len(RATIOS))  # the unsplit key (F13)
    out = model.eval_step(video, mask, prev, draws)
    assert abs(float(out["psnr_forward"]) - float(ref["psnr_forward"])) \
        <= 1e-3
    assert abs(float(out["ssim_forward"]) - float(ref["ssim_forward"])) \
        <= 1e-5
    v, m, p = model.to_device(video, mask, prev)
    attacked = attack_pool_video(model.embed(v) * (1 - m) + p * m, draws,
                                 model.attack_ratios, model.kernels)
    bound, near = _f1_bound(model, attacked.clamp(0, 1), mask)
    diff = np.abs(out["f1_sweep"].numpy() - ref["f1_sweep"])
    assert (diff <= bound).all(), (diff, bound, near)
    assert 40.0 < float(out["psnr_forward"]) < 60.0


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server) of the refshape model at B = 2, T = 2,
    32², the heads perturbed by 1e-3 and random BatchNorm statistics."""
    model = _port_model(1e-3, seed=2)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for mod in model.unet.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(
                    0.1 * rng.standard_normal(mod.num_features)))
                mod.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, mod.num_features)))
    jm = JModel(_cfg(jconfig))
    states = _jax_states(model, jm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JModel, "init_states", lambda self, key: states)
        jsrv = jserving.WatermarkServer(_cfg(jconfig), modes=("roundtrip",))
    srv = WatermarkServer(_cfg(tconfig), device="cpu", weights=model.states(),
                          modes=("embed", "detect", "roundtrip"))
    return jsrv, srv


def test_refshape_server_matches_jax_server(servers):
    jsrv, srv = servers
    clip = np.random.default_rng(4).integers(0, 256, (B, T, S, S, 3),
                                             dtype=np.uint8)
    ours, ref = srv.serve(clip, "roundtrip"), jsrv.serve(clip, "roundtrip")
    d = np.abs(ours.watermarked.astype(int) - ref.watermarked.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.9999, (d.max(),
                                                        (d == 0).mean())
    moved = np.abs(ours.watermarked.astype(int) - clip.astype(int))
    assert moved.max() > 0  # the perturbed INN is no identity
    np.testing.assert_array_equal(ours.mask_bits, ref.mask_bits)
    np.testing.assert_allclose(ours.tamper_fraction, ref.tamper_fraction,
                               rtol=0, atol=1e-5)
    det = srv.serve(ours.watermarked, "detect")
    np.testing.assert_array_equal(det.mask_bits, ours.mask_bits)


def test_refshape_int8_options_raise_as_jax(servers):
    """``int8_extract`` needs ``UNetTPU``, ``int8_embed`` the packed INN, in
    both packages."""
    for kw, what in (({"int8_extract": True}, "int8_extract"),
                     ({"int8_embed": True}, "int8_embed")):
        with pytest.raises(ValueError, match=what):
            WatermarkServer(_cfg(tconfig), device="cpu", **kw)
        with pytest.raises(ValueError, match=what):
            jserving.WatermarkServer(_cfg(jconfig), **kw)


CONFIGS = {
    "split_st": dict(fused_st=False),
    "dense_conv": dict(inn_subnet="dense", inn_haar="conv"),
    "res_tpu_mixed": dict(inn_subnet="res_tpu", inn_haar="mixed"),
    "res_tpu2_module": dict(inn_subnet="res_tpu2", inn_haar="conv"),
    "packed_down_num_4": dict(inn_subnet="res_tpu2", inn_haar="conv",
                              inn_packed=True, inn_down_num=4,
                              inn_block_num=(1, 1, 1, 1)),
    "unet_tpu": dict(extractor="unet_tpu", extractor_features=8),
    "unet_tpu_slim_convt_gemm_split": dict(
        extractor="unet_tpu_slim", extractor_features=8,
        extractor_head="convt", extractor_up="gemm", extractor_dec="split"),
    "unet_tpu2": dict(extractor="unet_tpu2", extractor_features=8),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configuration_trains_evaluates_and_serves(name):
    """Each configuration ``ModelConfig`` names builds, takes a train step
    (finite losses, parameters moved), an eval step and a server roundtrip
    on the CPU (32², B = 2, T = 2, f32)."""
    mc = dataclasses.replace(_cfg(tconfig).model, **CONFIGS[name])
    cfg = dataclasses.replace(_cfg(tconfig), model=mc)
    model = VideoWatermarkModel(cfg, device="cpu")
    model.init_states(0)
    video, mask, prev = _batch(2)
    before = [p.clone() for p in model.unet.parameters()]
    logs = model.train_step(video, mask, prev)
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(model.unet.parameters(), before))
    ev = model.eval_step(video, mask, prev)
    assert np.isfinite(ev["f1_sweep"].numpy()).all()
    # near the identity at init: a high PSNR, or 0 where the embed returns
    # the clip exactly (``psnr``'s convention for a zero error)
    pf = float(ev["psnr_forward"])
    assert pf == 0.0 or pf > 30.0
    srv = WatermarkServer(cfg, device="cpu", weights=model.states(),
                          modes=("roundtrip",))
    clip = np.random.default_rng(6).integers(0, 256, (B, T, S, S, 3),
                                             dtype=np.uint8)
    res = srv.serve(clip, "roundtrip")
    assert res.watermarked.shape == clip.shape
    assert res.mask_bits.shape == (B, T, S, S // 8)
    assert np.isfinite(res.tamper_fraction).all()
