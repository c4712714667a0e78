"""The JAX-checkpoint bridge, on the CPU in f32: an orbax checkpoint the JAX
package wrote, converted by ``tools/jax_checkpoint_to_torch.py``, restored
by the port; the npz pretrain trees (``model.pretrain_path``); and the
server and ``train --resume`` reading a converted directory.

The model, weights and batches are ``test_torch_train.py``'s (a small
flagship-shaped model, 32², B 2, T 2, its heads perturbed by 5e-6·N(0,1)).
JAX takes one step (``_loss`` compiled without XLA's algebraic simplifier,
F9, and the two optax updates) and saves it with orbax; the tool converts
it; the restored port model must hold the step's parameters, BatchNorm
statistics, AdamW moments and count EXACTLY (the conversion only moves and
flips entries). Both then take a second step on the same batch and draws
(derived from the JAX key as in ``test_torch_train.py``), held within that
file's tolerances: losses 1e-4 relative, PF 1e-3 dB, updated parameters
2.1·lr (a second AdamW step moves an entry by at most about lr), running
statistics 1e-5.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (RATIOS, _batch, _cfg, _leaves, _port_model,
                              _tree, jax_draws)
from vwfd_tpu import config as jconfig
from vwfd_tpu.models import VideoBatch
from vwfd_tpu.models import VideoWatermarkModel as JModel
from vwfd_tpu.models.state import NetState, save_checkpoint
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu_torch import config as tconfig
from vwfd_tpu_torch import serve as serve_cli
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.convert import (opt_state_from_jax, opt_state_to_jax,
                                    params_to_jax)
from vwfd_tpu_torch.models import VideoWatermarkModel
from vwfd_tpu_torch.models.state import (apply_pretrain, load_npz_tree,
                                         restore_checkpoint, save_npz_tree)
from vwfd_tpu_torch.serving import WatermarkServer

B, T = 2, 2
ROOT = Path(__file__).resolve().parents[1]
# test_torch_train._cfg as YAML, for the tool and the CLI
SMALL_YAML = """\
data: {gt_size: 32, batch_size: 2, frames: 2}
model:
  inn_down_num: 2
  inn_block_num: [1, 1]
  inn_subnet: res_tpu2
  inn_haar: conv
  inn_packed: true
  inn_width: 16
  extractor: unet_tpu
  extractor_features: 8
  extractor_enc_convs: [2, 2, 1, 1, 1]
  attack_ratios: [0.5, 1.0, 1.5]
train: {dtype: float32}
"""


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", ROOT / "tools" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _JaxSteps:
    """JAX train steps from the port model's weights: ``_loss``'s gradients
    (compiled once, without ``algsimp``), both optax updates and the new
    batch statistics, as ``test_torch_train.py``'s reference step."""

    def __init__(self, model):
        self.jm = JModel(_cfg(jconfig))
        netg, gen, stats = params_to_jax(*(net.state_dict() for net in
                                           model.nets().values()))
        j = jax.tree_util.tree_map(jnp.asarray, (netg, gen, stats))
        self.states = {
            "netG": NetState.create(self.jm.inn.apply, j[0], {}, self.jm.tx),
            "generator": NetState.create(self.jm.unet.apply, j[1],
                                         {"batch_stats": j[2]}, self.jm.tx)}
        # the squeeze kernels' cache must hold arrays, not a trace's tracers
        jsq.space_to_depth_conv(jnp.zeros((1, 2, 2, 3)), 2)
        jsq.depth_to_space_conv(jnp.zeros((1, 1, 1, 4)), 2)
        self._compiled = None

    def step(self, batch, key):
        video, mask, prev = batch
        params = {k: s.params for k, s in self.states.items()}
        args = (params, self.states,
                VideoBatch(jnp.asarray(video), jnp.asarray(mask)),
                jnp.asarray(prev), key)
        if self._compiled is None:
            self._compiled = jax.jit(jax.value_and_grad(
                self.jm._loss, has_aux=True)).lower(*args).compile(
                compiler_options={"xla_disable_hlo_passes": "algsimp"})
        (loss, aux), grads = self._compiled(*args)
        new = {k: s.apply_gradients(grads[k]) for k, s in self.states.items()}
        new["generator"] = new["generator"].replace(
            variables={"batch_stats": aux["unet_vars"]["batch_stats"]})
        self.states = new
        return {"loss": float(loss), "lF": float(aux["lF"]),
                "lB": float(aux["lB"]), "PF": float(aux["PF"])}


@pytest.fixture(scope="module")
def bridge(tmp_path_factory):
    """JAX's first step saved with orbax and converted by the tool; the
    stepper and the step's states."""
    tmp = tmp_path_factory.mktemp("bridge")
    (tmp / "small.yaml").write_text(SMALL_YAML)
    model = _port_model(perturb=5e-6)
    jax_steps = _JaxSteps(model)
    jax_steps.step(_batch(1), jax.random.PRNGKey(5))
    save_checkpoint(str(tmp / "jax"), 1, jax_steps.states)
    _tool().main(["--ckpt-dir", str(tmp / "jax"), "--out", str(tmp / "port"),
                  "--config", str(tmp / "small.yaml"),
                  "--npz-dir", str(tmp / "npz")])
    return tmp, jax_steps, jax_steps.states


def _restored(tmp):
    model = VideoWatermarkModel(_cfg(tconfig), device="cpu")
    model.init_states(99)
    restore_checkpoint(str(tmp / "port"), 1, model)
    return model


def test_small_yaml_is_the_test_config():
    import yaml
    d = yaml.safe_load(SMALL_YAML)
    for mod in (tconfig, jconfig):
        assert mod.load_config(overrides=d) == _cfg(mod)


def test_converted_checkpoint_restores_exactly(bridge):
    """Parameters, BatchNorm statistics, AdamW moments and counts after the
    JAX step equal the restored port model's, entry for entry."""
    tmp, _, step1 = bridge
    model = _restored(tmp)
    adam = {k: _tool()._adam_state(s.opt_state) for k, s in step1.items()}
    params = {k: list(net.parameters()) for k, net in model.nets().items()}
    for ours, want in (
            (params, {k: s.params for k, s in step1.items()}),
            ({k: o.mu for k, o in model.optimizers.items()},
             {k: a.mu for k, a in adam.items()}),
            ({k: o.nu for k, o in model.optimizers.items()},
             {k: a.nu for k, a in adam.items()})):
        got, ref = _leaves(_tree(model, ours)), _leaves(want)
        assert got.keys() == ref.keys() and len(ref) > 50
        for name, w in ref.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    _, _, stats = params_to_jax({}, model.unet.state_dict())
    ref = _leaves(step1["generator"].variables["batch_stats"])
    for name, w in ref.items():
        np.testing.assert_array_equal(_leaves(stats)[name], w, err_msg=name)
    for name, opt in model.optimizers.items():
        assert int(opt.count) == int(adam[name].count) == 1


def test_converted_checkpoint_trains_on_as_jax(bridge):
    """One more step on both sides from the restored state matches JAX's
    within ``test_torch_train.py``'s tolerances."""
    tmp, jax_steps, step1 = bridge
    model = _restored(tmp)
    jax_steps.states = step1
    key = jax.random.PRNGKey(6)
    batch = _batch(2)
    ref = jax_steps.step(batch, key)
    logs = model.train_step(*batch, jax_draws(jax.random.split(key)[0], B, T,
                                              len(RATIOS)))
    for k in ("loss", "lF", "lB"):
        assert abs(float(logs[k]) - ref[k]) <= 1e-4 * abs(ref[k]), k
    assert abs(float(logs["PF"]) - ref["PF"]) <= 1e-3
    params = {k: list(net.parameters()) for k, net in model.nets().items()}
    got = _leaves(_tree(model, params))
    lr = model.cfg.train.lr
    for name, w in _leaves({k: s.params for k, s in
                            jax_steps.states.items()}).items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=2.1 * lr,
                                   err_msg=name)
    _, _, stats = params_to_jax({}, model.unet.state_dict())
    for name, w in _leaves(jax_steps.states["generator"]
                           .variables["batch_stats"]).items():
        np.testing.assert_allclose(_leaves(stats)[name], w, rtol=0,
                                   atol=1e-5, err_msg=name)
    assert all(int(o.count) == 2 for o in model.optimizers.values())


def test_opt_state_round_trips_through_the_jax_layout():
    """``opt_state_to_jax`` inverts ``opt_state_from_jax`` on both nets
    (the ConvTranspose flip and BatchNorm scale/bias included)."""
    model = _port_model(2)
    gen = torch.Generator().manual_seed(3)
    for name, net in model.nets().items():
        mu = [torch.randn(p.shape, generator=gen) for p in net.parameters()]
        nu = [torch.rand(p.shape, generator=gen) for p in net.parameters()]
        mt, nt, count = opt_state_to_jax(net, mu, nu, 7)
        mu2, nu2, count2 = opt_state_from_jax(net, mt, nt, count)
        assert all(torch.equal(a, b) for a, b in zip(mu + nu, mu2 + nu2))
        assert int(count2) == 7 and count2.dtype == torch.int32
    with pytest.raises(ValueError, match="does not fit"):
        opt_state_from_jax(model.inn, mt, nt, count)  # the UNet's trees


def test_tool_writes_the_jax_npz_pretrain_trees(bridge):
    """``--npz-dir``: both nets' trees in the JAX interchange format, equal
    to the JAX step's parameters (and the extractor's statistics)."""
    tmp, _, step1 = bridge
    for name, s in step1.items():
        tree = load_npz_tree(str(tmp / "npz" / f"{name}.npz"))
        want = {"params": s.params, **s.variables}
        assert _leaves(tree).keys() == _leaves(want).keys()
        for k, w in _leaves(want).items():
            np.testing.assert_array_equal(_leaves(tree)[k], w, err_msg=k)


def test_apply_pretrain_loads_skips_and_checks_shapes(tmp_path):
    """``model.pretrain_path`` (state.py:82-113): ``<net>.npz`` trees load
    into the nets exactly, and the JAX package loads the same files to the
    same values; a net without a file keeps its init; a tree of another
    shape raises."""
    src = _port_model(4)
    netg, gen, stats = params_to_jax(src.inn.state_dict(),
                                     src.unet.state_dict())
    save_npz_tree(str(tmp_path / "netG.npz"), {"params": netg})
    cfg = _cfg(tconfig)
    import dataclasses
    pcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pretrain_path=str(tmp_path)))
    fresh = VideoWatermarkModel(cfg, device="cpu")
    fresh.init_states(9)
    model = VideoWatermarkModel(pcfg, device="cpu")
    model.init_states(9)
    assert all(torch.equal(a, b) for a, b in
               zip(model.inn.state_dict().values(),
                   src.inn.state_dict().values()))
    assert all(torch.equal(a, b) for a, b in
               zip(model.unet.state_dict().values(),
                   fresh.unet.state_dict().values()))
    # the JAX package reads the port's files to the same values
    jcfg = jconfig.Config(data=jconfig.DataConfig(gt_size=32, batch_size=2,
                                                  frames=2),
                          model=jconfig.ModelConfig(
                              **{**dataclasses.asdict(_cfg(jconfig).model),
                                 "pretrain_path": str(tmp_path)}),
                          train=jconfig.TrainConfig(dtype="float32"))
    jstates = JModel(jcfg).init_states(jax.random.PRNGKey(0))
    for k, w in _leaves(netg).items():
        np.testing.assert_array_equal(_leaves(jstates["netG"].params)[k], w)
    # a wrong shape: the first conv of the extractor's stem
    save_npz_tree(str(tmp_path / "generator.npz"),
                  {"params": gen, "batch_stats": stats})
    apply_pretrain(model, str(tmp_path))  # fits: loads
    assert all(torch.equal(a, b) for a, b in
               zip(model.unet.state_dict().values(),
                   src.unet.state_dict().values()))
    leaf = next(iter(_leaves(gen)))
    path = [p.strip("[]'") for p in leaf.split("][")]
    node = gen
    for p in path[:-1]:
        node = node[p]
    shape = list(node[path[-1]].shape)
    shape[0] += 1
    node[path[-1]] = np.zeros(shape, np.float32)
    save_npz_tree(str(tmp_path / "generator.npz"), {"params": gen})
    with pytest.raises(ValueError, match="shape mismatch in generator"):
        apply_pretrain(model, str(tmp_path))


def test_server_and_resume_take_the_converted_directory(bridge, capsys,
                                                        tmp_path):
    """``WatermarkServer(ckpt_dir=...)`` serves the restored weights (equal
    to a server built from them); ``train --val --resume`` and ``serve
    --ckpt-dir`` take the converted directory; an empty directory
    raises."""
    tmp = bridge[0]
    model = _restored(tmp)
    cfg = _cfg(tconfig)
    clip = np.random.default_rng(0).integers(0, 256, (B, T, 32, 32, 3),
                                             dtype=np.uint8)
    served = WatermarkServer(cfg, device="cpu", ckpt_dir=str(tmp / "port"),
                             modes=("roundtrip",)).serve(clip, "roundtrip")
    direct = WatermarkServer(cfg, device="cpu", weights=model.states(),
                             modes=("roundtrip",)).serve(clip, "roundtrip")
    for k in ("watermarked", "mask_bits", "tamper_fraction"):
        np.testing.assert_array_equal(getattr(served, k), getattr(direct, k))
    with pytest.raises(FileNotFoundError):
        WatermarkServer(cfg, device="cpu", ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="not both"):
        WatermarkServer(cfg, device="cpu", ckpt_dir=str(tmp / "port"),
                        weights=model.states())
    train_cli.main(["--synthetic", "--val", "--val-batches", "1", "--resume",
                    "--ckpt-dir", str(tmp / "port"), "--config",
                    str(tmp / "small.yaml"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["resumed_step"] == 1 and np.isfinite(out["psnr_forward"])
    serve_cli.main(["--mode", "roundtrip", "--synthetic", "1", "--device",
                    "cpu", "--config", str(tmp / "small.yaml"),
                    "--ckpt-dir", str(tmp / "port"), "--step", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["clips"] == B and out["frames"] == T
