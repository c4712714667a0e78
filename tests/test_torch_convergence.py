"""The port's convergence runner (``vwfd_tpu_torch/run_convergence.py``), its
clip generator (``data/ondevice.py``), ``jpeg_real`` and the int8 quality
gate (``vwfd_tpu_torch/int8_eval.py``), on the CPU.

* The generator against the JAX runner's ``gen``
  (tools/run_convergence.py:123-140, rebuilt here from the JAX package's
  ``resize_bilinear`` and ``rect_mask`` with the same formula), fed the
  JAX generator's own draws: the mask EQUAL, the clip within 1e-6 (two
  float32 products summed in another order).
* ``jpeg_real`` EQUAL to the JAX package's, byte for byte (both call PIL).
* Resume: a run in segments (stops at steps 1 and 2, then ``--resume``)
  ends with every parameter, BatchNorm statistic and AdamW moment EQUAL to
  an unbroken run's, and the same record lines but for ``wall_s``; the
  record's keys are the JAX record's (``runs/conv_r4_flagship_10k.jsonl``).
* One ``int8_eval`` batch (F1 of the bf16 and the int8 extractor, mean
  |Δprob|) against the JAX composition of tools/exp_int8_eval.py:92-181 on
  the same weights, clips, attack draws (from JAX's key, F4) and
  calibration batch, within 1e-5. The model, weights and batch are
  ``test_torch_eval.py``'s (f32; a clip three quarters of a level above the
  8-bit grid, so that both embeds round every pixel alike); the JAX side is
  compiled without XLA's algebraic simplifier (F9).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import RATIOS, _batch, _cfg, _port_model, jax_draws
from vwfd_tpu import config as jconfig
from vwfd_tpu.attacks import attack_pool_video as j_attack_pool
from vwfd_tpu.attacks.jpeg import jpeg_real as j_jpeg_real
from vwfd_tpu.attacks.spatial import rect_mask as j_rect_mask
from vwfd_tpu.metrics import f1_sweep as j_f1_sweep
from vwfd_tpu.metrics import psnr255_int as j_psnr
from vwfd_tpu.models import VideoWatermarkModel as JModel
from vwfd_tpu.models.state import NetState
from vwfd_tpu.nets import unet_int8 as jq8
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from vwfd_tpu_torch import int8_eval
from vwfd_tpu_torch import run_convergence as rc
from vwfd_tpu_torch.attacks import jpeg_real
from vwfd_tpu_torch.convert import params_to_jax
from vwfd_tpu_torch.data import (ClipDraws, clips_from_draws, rect_mask,
                                 sample_clip_draws, seeded_generator,
                                 synthetic_clips)
from vwfd_tpu_torch.models import VideoWatermarkModel
from vwfd_tpu_torch.models.state import load_nets

RECORD = os.path.join(os.path.dirname(__file__), "..", "runs",
                      "conv_r4_flagship_10k.jsonl")
# the flagship's options, spelled out: the runner's defaults are the JAX
# runner's reference shapes
FLAGSHIP = ["--subnet", "res_tpu2", "--extractor", "unet_tpu", "--haar",
            "conv", "--packed", "--econvs", "2,2,1,1,1"]
TINY = ["--batch", "2", "--size", "32", "--frames", "2", "--efeatures", "8",
        "--down-num", "2", "--width", "16", *FLAGSHIP]
REFSHAPE_RECORD = os.path.join(os.path.dirname(__file__), "..", "runs",
                               "conv_r4_refshape_10k.jsonl")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ generator


def test_rect_mask_equals_jax():
    apexes = [(3.0, 17.5, 0.0, 31.99), (0.2, 0.9, 5.0, 5.0),
              (12.25, 40.0, 30.5, 31.0)]
    for apex in apexes:
        want = np.asarray(j_rect_mask((32, 32), apex))
        assert np.array_equal(rect_mask((32, 32), apex).numpy(), want)
    # batched bounds: one mask per entry
    got = rect_mask((32, 32), tuple(torch.tensor(a) for a in zip(*apexes)))
    assert got.shape == (3, 32, 32)
    for i, apex in enumerate(apexes):
        assert np.array_equal(got[i].numpy(),
                              np.asarray(j_rect_mask((32, 32), apex)))


def _jax_gen(key, b, t, s):
    """The JAX runner's ``gen`` (tools/run_convergence.py:123-140), and its
    draws."""
    @jax.jit
    def gen(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        coarse = jax.random.uniform(k1, (b, 1, 16, 16, 3))
        noise = jax.random.normal(k2, (b, t, 1, 1, 3))
        u3 = jax.random.uniform(k3, (b, 2))
        u4 = jax.random.uniform(k4, (b, 2))
        drift = 0.05 * noise
        video = jnp.clip(j_resize_bilinear(coarse, (s, s)) + drift, 0.0, 1.0)
        video = jnp.broadcast_to(video, (b, t, s, s, 3))
        h0 = u3 * (0.7 * s)
        sz = 0.15 * s + u4 * (0.25 * s)
        m = jax.vmap(lambda a, z: j_rect_mask(
            (s, s), (a[0], a[0] + z[0], a[1], a[1] + z[1])))(h0, sz)
        mask = jnp.broadcast_to(m[:, None, :, :, None], (b, t, s, s, 1))
        return (video, mask), (coarse, noise, u3, u4)
    return jax.tree_util.tree_map(np.asarray, gen(key))


@pytest.mark.parametrize("size", [32, 256])
def test_clips_equal_jax_given_its_draws(size):
    b, t = 3, 2
    (video, mask), draws = _jax_gen(jax.random.PRNGKey(size), b, t, size)
    got_v, got_m = clips_from_draws(
        ClipDraws(*(torch.tensor(d) for d in draws)), size)
    assert got_v.shape == (b, t, size, size, 3)
    assert got_m.shape == (b, t, size, size, 1)
    assert got_v.is_contiguous() and got_m.is_contiguous()
    assert np.array_equal(got_m.numpy(), mask)
    assert 0.0 < mask.mean() < 0.3
    np.testing.assert_allclose(got_v.numpy(), video, rtol=0, atol=1e-6)


def test_clip_draws_are_a_function_of_seed_stream_and_step():
    def draws(seed, stream, step):
        return sample_clip_draws(seeded_generator("cpu", seed, stream, step),
                                 2, 3)

    a = draws(0, 1, 5)
    assert [tuple(x.shape) for x in a] == [(2, 1, 16, 16, 3), (2, 3, 1, 1, 3),
                                           (2, 2), (2, 2)]
    assert all(torch.equal(x, y) for x, y in zip(a, draws(0, 1, 5)))
    for other in (draws(1, 1, 5), draws(0, 2, 5), draws(0, 1, 6)):
        assert not torch.equal(a.coarse, other.coarse)
    assert 0 <= float(a.coarse.min()) and float(a.coarse.max()) < 1


# ------------------------------------------------------------ jpeg_real


@pytest.mark.parametrize("quality", [50, 70, 90])
def test_jpeg_real_equals_jax(quality):
    rng = np.random.default_rng(quality)
    frames = np.clip(rng.random((3, 32, 40, 3)) * 1.1 - 0.05, -0.05,
                     1.05).astype(np.float32)
    got = jpeg_real(frames, quality)
    want = j_jpeg_real(frames, quality)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    one = jpeg_real(frames[1], quality)  # a single (H, W, 3) frame
    assert np.array_equal(one, j_jpeg_real(frames[1], quality))


def test_jpeg_real_names_pil_when_it_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        jpeg_real(np.zeros((8, 8, 3), np.float32), 90)


# ------------------------------------------------------------ the runner


@pytest.fixture(autouse=True)
def _record_every_step(monkeypatch):
    """The tiny runs write a record at every step (the runner's is 20)."""
    monkeypatch.setattr(rc, "LOG_EVERY", 1)


def _run(tmp_path, name, *extra):
    args = ["--steps", "4", "--eval-every", "2",
            "--libjpeg-batches", "0", "--device", "cpu", *TINY,
            "--ckpt-dir", str(tmp_path / name),
            "--out", str(tmp_path / f"{name}.jsonl"), *extra]
    return rc.main(args)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _payload(path):
    steps = [d for d in os.listdir(path) if d.isdigit()]
    assert len(steps) == 1, steps  # only the latest checkpoint is kept
    return torch.load(os.path.join(path, steps[0], "state.pt"),
                      weights_only=True)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_resume_is_exact(tmp_path):
    """4 unbroken steps; and the same run as 1 step (a stop at step 1), 1
    step (a stop at step 2) and 2 steps (``--resume``): the same
    parameters, BatchNorm statistics, AdamW moments and step counts, and
    the same records but for ``wall_s``."""
    assert _run(tmp_path, "whole") == "done"
    assert _run(tmp_path, "parts", "--resume", "--stop-at-step",
                "1") == "stopped"
    assert sorted(os.listdir(tmp_path / "parts")) == ["1"]
    assert _run(tmp_path, "parts", "--resume", "--stop-at-step",
                "2") == "stopped"
    assert _run(tmp_path, "parts", "--resume") == "done"
    whole, parts = _payload(tmp_path / "whole"), _payload(tmp_path / "parts")
    assert whole["step"] == parts["step"] == 4
    a, b = _flat(whole), _flat(parts)
    assert len(a) == len(b) > 100
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(whole["optimizers"]["netG"]["count"]) == 4

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "wall_s"} for r in recs]

    ra, rb = _records(tmp_path / "whole.jsonl"), _records(
        tmp_path / "parts.jsonl")
    assert [r.get("step") for r in ra] == [None, 1, 2, 3, 4]
    assert strip(ra) == strip(rb)
    assert all(np.isfinite(v) for r in ra[1:] for k, v in r.items()
               if isinstance(v, float))


def test_record_keys_match_the_jax_record(tmp_path):
    """Config, step, eval and libjpeg lines carry the JAX record's keys (the
    config line adds the device and its name, the libjpeg line the
    device); ``--bce-finetune-at`` writes its event line once, before the
    first BCE step, also across a resume."""
    ref = _records(RECORD)
    assert _run(tmp_path, "keys", "--libjpeg-batches", "1",
                "--bce-finetune-at", "2", "--stop-at-step", "2") == "stopped"
    assert _run(tmp_path, "keys", "--libjpeg-batches", "1",
                "--bce-finetune-at", "2", "--resume") == "done"
    ours = _records(tmp_path / "keys.jsonl")

    def keys(recs, want):
        return [list(r) for r in recs if want(r)]

    assert set(ours[0]) == {"config"}
    assert set(ours[0]["config"]) == set(ref[0]["config"]) | {
        "device", "device_name"}
    assert ours[0]["config"]["device"] == "cpu"
    step_keys = keys(ref, lambda r: "loss" in r and "f1_best" not in r)[0]
    eval_keys = keys(ref, lambda r: "f1_best" in r)[0]
    assert keys(ours, lambda r: "loss" in r and "f1_best" not in r) == [
        step_keys, step_keys]
    assert keys(ours, lambda r: "f1_best" in r) == [eval_keys, eval_keys]
    jl = [r for r in ours if "libjpeg_f1" in r]
    jl_ref = [r for r in ref if "libjpeg_f1" in r][0]
    assert len(jl) == 1 and list(jl[0]) == list(jl_ref) + ["device"]
    assert list(jl[0]["libjpeg_f1"]) == list(jl_ref["libjpeg_f1"])
    assert jl[0]["device"] == "cpu" and jl[0]["batches"] == 1
    events = [i for i, r in enumerate(ours) if "event" in r]
    assert len(events) == 1 and ours[events[0]] == {"step": 2,
                                                    "event": "bce_finetune"}
    assert ours[events[0] - 1]["step"] == 2
    assert ours[events[0] + 1]["step"] == 3


def test_runner_refuses_reference_shapes_and_needs_a_card_or_cpu(
        tmp_path, monkeypatch):
    """The runner refuses the reference shapes only where the JAX package does:
    on the packed executor. With no model options the runner builds the JAX
    runner's defaults (the reference shapes: res subnets, lifting Haar, the
    INN module path, the reference UNet) and takes a tiny CPU step; its
    config line is the JAX refshape record's key for key, with the same
    model values (the device and its name added). ``--packed`` keeps JAX's
    own rule, and without a card and ``--device cpu`` the runner and the
    gate raise."""
    tiny = ["--batch", "2", "--size", "32", "--frames", "2", "--down-num",
            "2", "--width", "8"]
    assert rc.main(["--steps", "1", "--eval-every", "1", "--libjpeg-batches",
                    "0", "--device", "cpu", *tiny, "--out",
                    str(tmp_path / "ref.jsonl")]) == "done"
    ours = _records(tmp_path / "ref.jsonl")
    ref = _records(REFSHAPE_RECORD)[0]["config"]
    cfg = ours[0]["config"]
    assert list(cfg) == list(ref) + ["device", "device_name"]
    for k in ("subnet", "extractor", "s2d", "efeatures", "haar",
              "criterion"):
        assert cfg[k] == ref[k], k
    assert cfg["block_num"] == "1,1" and cfg["device"] == "cpu"
    assert [r["step"] for r in ours[1:]] == [1]
    assert all(np.isfinite(v) for v in ours[1].values()
               if isinstance(v, float))
    model = VideoWatermarkModel(rc.build_config(rc.parse_args(tiny)),
                                device="cpu")
    assert not model.inn.packed and type(model.unet).__name__ == "UNet"
    with pytest.raises(ValueError, match="inn_packed requires"):
        _run(tmp_path, "packed_res", "--subnet", "res")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rc.main(["--steps", "1", *TINY, "--out", str(tmp_path / "x.jsonl")])
    with pytest.raises(RuntimeError, match="CUDA"):
        int8_eval.main(["--ckpt-dir", str(tmp_path), *TINY])


def test_libjpeg_only_appends_the_line_and_needs_pil(tmp_path, monkeypatch):
    _run(tmp_path, "lj", "--nets-out", str(tmp_path / "nets"))
    out = tmp_path / "lj.jsonl"
    before = _records(out)
    assert not any("libjpeg_f1" in r for r in before)
    args = ["--libjpeg-only", "--libjpeg-batches", "1", "--device", "cpu",
            *TINY, "--ckpt-dir", str(tmp_path / "nets"), "--out", str(out)]
    assert rc.main(args) == "libjpeg"
    after = _records(out)
    assert after[:-1] == before
    assert after[-1]["step"] == 4 and after[-1]["device"] == "cpu"
    assert set(after[-1]["libjpeg_f1"]) == {"none", "qf50", "qf70", "qf90"}
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        rc.main(args)
    assert _records(out) == after


def test_compact_nets_give_the_same_forward(tmp_path):
    """``--nets-out`` stores the extractor's convolutions in the compute
    dtype (bf16): a model loaded from them embeds and predicts EQUAL to
    one loaded from the full checkpoint, in bf16 compute."""
    _run(tmp_path, "c", "--nets-out", str(tmp_path / "nets"))
    full = load_nets(str(tmp_path / "c"), 4)
    compact = load_nets(str(tmp_path / "nets"), 4)
    assert all(torch.equal(full["netG"][k], v)
               for k, v in compact["netG"].items())
    halved = [k for k, v in compact["generator"].items()
              if v.dtype == torch.bfloat16]
    assert halved and all(k.endswith((".weight", ".bias")) for k in halved)
    assert not any("BatchNorm" in k for k in halved)
    cfg = rc.build_config(rc.parse_args(["--device", "cpu", *TINY]))
    assert cfg.train.dtype == "bfloat16"
    models = []
    for nets in (full, compact):
        m = VideoWatermarkModel(cfg, device="cpu")
        m.load_states(nets)
        models.append(m)
    video, _ = synthetic_clips("cpu", 0, 7, 0, 2, 2, 32)
    a, b = (m.embed(video) for m in models)
    assert torch.equal(a, b)
    assert torch.equal(*(m.predict_mask(a) for m in models))


def test_int8_eval_runs_on_a_runner_checkpoint(tmp_path, capsys):
    """The gate's CLI on a runner's nets (``--nets-out``: the extractor's
    convolutions in bf16), with the int8 embed: the JAX script's lines,
    finite means."""
    _run(tmp_path, "g", "--nets-out", str(tmp_path / "nets"))
    capsys.readouterr()
    got = int8_eval.main(["--ckpt-dir", str(tmp_path / "nets"),
                          "--device", "cpu", *TINY, "--calib-batches", "1",
                          "--eval-batches", "2", "--int8-embed"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("restored step 4 from")
    assert sum(ln.startswith("batch ") for ln in lines) == 2
    assert sum("embed-int8:" in ln for ln in lines) == 2
    assert lines[-2].startswith("mean over 2 batches: F1 bf16")
    assert lines[-1].startswith("embed-int8 mean: PF bf16")
    assert all(np.isfinite(v) for v in got.values())
    assert got["mean_abs_dprob"] < 0.05
    assert 0.0 <= got["f1_int8"] <= 1.0


# ------------------------------------------------------------ int8 gate


def test_int8_eval_batch_matches_jax():
    model = _port_model(perturb=5e-6)
    jm = JModel(_cfg(jconfig))
    netg, gen, stats = params_to_jax(*(net.state_dict() for net in
                                       model.nets().values()))
    j = jax.tree_util.tree_map(jnp.asarray, (netg, gen, stats))
    states = {"netG": NetState.create(jm.inn.apply, j[0], {}, jm.tx),
              "generator": NetState.create(jm.unet.apply, j[1],
                                           {"batch_stats": j[2]}, jm.tx)}
    s, econvs = 32, (2, 2, 1, 1, 1)
    # the squeeze kernels' cache must hold arrays, not a trace's tracers
    jsq.space_to_depth_conv(jnp.zeros((1, 2, 2, 3)), 2)
    jsq.depth_to_space_conv(jnp.zeros((1, 1, 1, 4)), 2)

    def compiled(fn, *args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args)

    def attacked_flat(k, video, mask, prev):  # exp_int8_eval.py:92-98
        fwd = jm.embed(states, video)
        spliced = fwd * (1.0 - mask) + prev * mask
        att = jnp.clip(j_attack_pool(k, spliced, ratios=jm.attack_ratios),
                       0, 1)
        return att, fwd

    def eval_both(qp, k, video, mask, prev):  # :168-177
        att, fwd = attacked_flat(k, video, mask, prev)
        p_bf = jm.predict_mask(states, att, train=False)
        p_i8 = jq8.apply_int8(qp, att.reshape(-1, s, s, 3)).reshape(
            mask.shape)
        _, f_bf = j_f1_sweep(p_bf, mask)
        _, f_i8 = j_f1_sweep(p_i8, mask)
        return (jnp.max(f_bf), jnp.max(f_i8), j_psnr(video, fwd),
                jnp.mean(jnp.abs(p_i8 - p_bf.reshape(p_i8.shape))))

    video, mask, prev = _batch(1)
    video = (video + np.float32(0.5 / 255)).astype(np.float32)
    jv, jmask, jprev = (jnp.asarray(a) for a in (video, mask, prev))
    kc, ke = jax.random.PRNGKey(123), jax.random.PRNGKey(999)
    # calibration on one attacked batch (:101-117), the same on both sides
    calib = np.array(compiled(attacked_flat, kc, jprev, jmask, jv)[0])
    calib = calib.reshape(-1, s, s, 3)
    gvars = {"params": states["generator"].params,
             **states["generator"].variables}
    qp = jq8.quantize(gvars, jq8.calibrate(gvars, [jnp.asarray(calib)],
                                           enc_convs=econvs),
                      enc_convs=econvs)
    want = [float(x) for x in compiled(eval_both, qp, ke, jv, jmask, jprev)]

    qp_port = int8_eval.quantize_extract(model, [calib])
    got = [float(x) for x in int8_eval.eval_both(
        model, qp_port, video, mask, prev, jax_draws(ke, 2, 2, len(RATIOS)))]
    f_bf, f_i8, pf, dm = got
    assert abs(f_bf - want[0]) <= 1e-5, (got, want)
    assert abs(f_i8 - want[1]) <= 1e-5, (got, want)
    assert abs(dm - want[3]) <= 1e-5, (got, want)
    assert abs(pf - want[2]) <= 1e-3, (got, want)
    assert 0.0 < f_i8 <= 1.0 and 0.0 < dm < 0.05
