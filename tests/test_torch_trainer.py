"""The trainer's remainder against the JAX package, on the CPU: the logger,
the progress bar, the scalar log, the montage images and PNG writer, the
DAVIS dataset, ``fit``'s telemetry and the ``train --root`` CLI.

Tolerances: the logger's lines, the progress bar's text (on one fake
clock), the JSONL records (``time`` masked), ``stitch_images``' canvas and
the DAVIS items (the same OpenCV readers on both sides) are EQUAL. The
montage (a small flagship-shaped model, ``test_torch_train.py``'s, on the
same draws, derived from the UNSPLIT key as F13 says) is within one 8-bit
level on ≥ 99.99 % of its values: its attacked and predicted-mask columns
carry float32 differences of the two attack pools and UNets, which move a
value across a rounding boundary only rarely.
"""

import functools
import json
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_train import RATIOS, _batch, _cfg, _port_model, jax_draws
from vwfd_tpu import config as jconfig
from vwfd_tpu.data.davis import DavisVideoDataset as JDavis
from vwfd_tpu.models import VideoBatch
from vwfd_tpu.models import VideoWatermarkModel as JModel
from vwfd_tpu.models.state import NetState
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu.utils import images as jimages
from vwfd_tpu.utils import logging as jlogging
from vwfd_tpu.utils import progbar as jprogbar
from vwfd_tpu.utils import telemetry as jtelemetry
from vwfd_tpu_torch import config as tconfig
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.convert import params_to_jax
from vwfd_tpu_torch.data import (DavisVideoDataset, Loader,
                                 SyntheticVideoDataset, cv2_readers)
from vwfd_tpu_torch.models import VideoWatermarkModel
from vwfd_tpu_torch.utils import (Progbar, ScalarLogger, images,
                                  profile_trace, read_png, save_image,
                                  save_png, setup_logger, stitch_images,
                                  step_annotation)
from vwfd_tpu_torch.utils import logging as tlogging
from vwfd_tpu_torch.utils import progbar as tprogbar
from vwfd_tpu_torch.utils import telemetry as ttelemetry

B, T = 2, 2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_setup_logger_matches_jax(tmp_path, capsys):
    """The same handlers, format and lines (the timestamp masked)."""
    lines = []
    for mod, name in ((tlogging, "port_logger_t"), (jlogging, "jax_logger_t")):
        lg = mod.setup_logger(name, root=str(tmp_path / name), tofile=True)
        assert mod.setup_logger(name) is lg  # set up once
        lg.info("step %d loss %.3f", 3, 0.25)
        lg.warning("non-finite")
        kinds = [type(h) for h in lg.handlers]
        fmts = [(h.formatter._fmt, h.formatter.datefmt) for h in lg.handlers]
        for h in list(lg.handlers):
            h.close()
            lg.removeHandler(h)
        text = (tmp_path / name / "train.log").read_text().splitlines()
        lines.append((kinds, fmts, lg.level, [s[22:] for s in text]))
    assert lines[0] == lines[1]
    assert lines[0][3] == ["- INFO: step 3 loss 0.250",
                           "- WARNING: non-finite"]
    capsys.readouterr()
    assert setup_logger is tlogging.setup_logger


def test_progbar_text_matches_jax(capsys, monkeypatch):
    """Running means, the stateful metric's last value, the bar and the
    final newline: the same text on the same clock."""
    outs = []
    for mod in (tprogbar, jprogbar):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(time, "time", lambda: float(next(clock)))
        pb = mod.Progbar(4, stateful_metrics=["PF"])
        for i in range(4):
            pb.add(1, [("loss", 0.5 + i), ("PF", 40.0 + i)])
        pb.update(4, [("loss", 1.0)])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].endswith("\n") and "4/4 [=========================]" \
        in outs[0] and "PF: 43.0000" in outs[0]
    assert Progbar is tprogbar.Progbar


def test_scalar_logger_records_match_jax(tmp_path):
    """One JSONL record a call: ``step``, ``time`` and the scalars as
    floats, from Python, numpy and 0-dim tensor values alike."""
    recs = []
    for mod, name in ((ttelemetry, "port"), (jtelemetry, "jax")):
        lg = mod.ScalarLogger(str(tmp_path / name), use_tensorboard=False)
        lg.log(1, loss=0.5, PF=np.float32(41.25))
        lg.log(2, loss=torch.tensor(0.125), lB=3)
        lg.close()
        lines = (tmp_path / name / "scalars.jsonl").read_text().splitlines()
        recs.append([{k: v for k, v in json.loads(s).items() if k != "time"}
                     for s in lines])
    assert recs[0] == recs[1] == [{"step": 1, "loss": 0.5, "PF": 41.25},
                                  {"step": 2, "loss": 0.125, "lB": 3.0}]
    assert ScalarLogger is ttelemetry.ScalarLogger


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        with step_annotation("vwfd_step"):
            torch.ones(8).add_(1)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "vwfd_step" for e in trace["traceEvents"])
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_stitch_images_and_png_match_jax(tmp_path):
    """The canvas equals ``np.asarray`` of the JAX module's PIL image (a
    one-channel group repeated to RGB, out-of-range values clipped); the
    port's PNG decodes, by PIL and by ``read_png``, to it; a one-channel
    ``save_image`` equals the JAX module's file."""
    rng = np.random.default_rng(0)
    groups = [rng.uniform(-0.1, 1.1, (3, 8, 10, 3)).astype(np.float32)
              for _ in range(2)] + [(rng.random((3, 8, 10, 1)) > 0.5)
                                    .astype(np.float32)]
    for per_row in (1, 2):
        ours = stitch_images(*groups, img_per_row=per_row)
        want = np.asarray(jimages.stitch_images(*groups,
                                                img_per_row=per_row))
        assert ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, want)
        path = str(tmp_path / f"m{per_row}.png")
        save_png(path, ours)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), ours)
        np.testing.assert_array_equal(read_png(path), ours)
    save_image(groups[2], str(tmp_path / "gray.png"))
    jimages.save_image(groups[2], str(tmp_path / "gray_jax.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "gray.png")),
        np.asarray(Image.open(tmp_path / "gray_jax.png")))
    np.testing.assert_array_equal(
        images.tensor_to_uint8(groups[0]),
        jimages.tensor_to_uint8(groups[0]))
    img = groups[0][0]
    for a, b in zip(images.create_augmentations(img),
                    jimages.create_augmentations(img)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(images.crop_to_multiple(groups[0], 4),
                                  jimages.crop_to_multiple(groups[0], 4))


# video: (frames, tamper rate of its masks); "short" has fewer frames than
# a clip, "empty" no tamper, "wide" too much, "gap" lacks its last mask
_VIDEOS = {"bear": (6, 0.08), "blackswan": (5, 0.12), "short": (2, 0.1),
           "empty": (5, 0.0), "wide": (5, 0.5), "gap": (4, 0.1)}


def _davis_tree(root, seed=0):
    rng = np.random.default_rng(seed)
    for vid, (n, rate) in _VIDEOS.items():
        img_dir = root / "JPEGImages" / "480p" / vid
        mask_dir = root / "Annotations" / "480p" / vid
        img_dir.mkdir(parents=True)
        mask_dir.mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(img_dir / f"{i:05d}.jpg"),
                        rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
            if vid == "gap" and i == n - 1:
                continue
            m = np.zeros((40, 48), np.uint8)
            h, w = int(40 * rate ** 0.5), int(48 * rate ** 0.5)
            y0, x0 = rng.integers(0, 40 - h + 1), rng.integers(0, 48 - w + 1)
            m[y0:y0 + h, x0:x0 + w] = 255
            cv2.imwrite(str(mask_dir / f"{i:05d}.png"), m)
    return root


def test_davis_dataset_matches_jax(tmp_path):
    """Items fetched in order with the same seed and OpenCV readers equal
    the JAX dataset's, and so do the skip list and the rng's state."""
    root = str(_davis_tree(tmp_path))
    ours = DavisVideoDataset(root, *cv2_readers(), size=32, frames=3,
                             mask_rate_max=0.2, seed=5)
    ref = JDavis(root, size=32, frames=3, mask_rate_max=0.2, seed=5)
    assert len(ours) == len(ref) == len(_VIDEOS)
    for i in range(10):
        (v, m), (rv, rm) = ours[i], ref[i]
        assert v.shape == (3, 32, 32, 3) and m.shape == (3, 32, 32, 1)
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(m, rm)
    assert ours.skip_list == ref.skip_list
    assert {"short", "empty", "wide"} <= ours.skip_list
    assert ours.rng.random() == ref.rng.random()


def test_montage_matches_jax(tmp_path):
    """``_dump_montage`` against JAX's on the same weights, batch and draws
    (the JAX montage hands its key to the pool unsplit, F13)."""
    model = _port_model(perturb=5e-6)
    jm = JModel(_cfg(jconfig))
    netg, gen, stats = params_to_jax(*(net.state_dict() for net in
                                       model.nets().values()))
    j = jax.tree_util.tree_map(jnp.asarray, (netg, gen, stats))
    states = {"netG": NetState.create(jm.inn.apply, j[0], {}, jm.tx),
              "generator": NetState.create(jm.unet.apply, j[1],
                                           {"batch_stats": j[2]}, jm.tx)}
    jsq.space_to_depth_conv(jnp.zeros((1, 2, 2, 3)), 2)
    jsq.depth_to_space_conv(jnp.zeros((1, 1, 1, 4)), 2)
    video, mask, prev = _batch(1)
    key = jax.random.PRNGKey(11)
    jm._dump_montage(states, VideoBatch(jnp.asarray(video), jnp.asarray(mask)),
                     jnp.asarray(prev), key, str(tmp_path / "jax"), 7)
    path = model._dump_montage(video, mask, prev, str(tmp_path / "port"), 7,
                               jax_draws(key, B, T, len(RATIOS)))
    assert path.endswith("00007.png")
    ours = read_png(path).astype(int)
    want = np.asarray(Image.open(tmp_path / "jax" / "00007.png")).astype(int)
    assert ours.shape == want.shape == (B * 32, 6 * 37, 3)
    d = np.abs(ours - want)
    assert (d <= 1).mean() >= 0.9999, (d.max(), (d > 1).sum())


def _cfg_with(montage_interval):
    import dataclasses
    cfg = _cfg(tconfig)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, montage_interval=montage_interval))


def test_fit_telemetry_keeps_the_training_draws(tmp_path, capsys):
    """``fit`` with a progress bar, a scalar log and a montage every 2
    steps trains exactly as without them (the montage's draws come from its
    own generator); one record a step, equal to the returned logs."""
    runs = []
    for telemetry in (False, True):
        model = VideoWatermarkModel(_cfg_with(2), device="cpu")
        model.init_states(0)
        loader = Loader(SyntheticVideoDataset(size=32, frames=T, length=8),
                        B, seed=0)
        kw, times = {}, []
        if telemetry:
            logger = ScalarLogger(str(tmp_path / "logs"),
                                  use_tensorboard=False)
            kw = dict(progbar=Progbar(3, stateful_metrics=["PF"]),
                      scalar_logger=logger,
                      montage_dir=str(tmp_path / "montage"), step_ms=times)
        _, logs = model.fit(loader, 3, **kw)
        if telemetry:
            logger.close()
        runs.append((logs, [t.clone() for net in model.nets().values()
                            for t in net.state_dict().values()], times))
    (la, sa, _), (lb, sb, times) = runs
    assert la == lb and all(torch.equal(a, b) for a, b in zip(sa, sb))
    recs = [json.loads(s) for s in
            (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3] and len(times) == 3
    assert {k: recs[-1][k] for k in lb} == lb
    pngs = sorted(p.name for p in (tmp_path / "montage").iterdir())
    assert pngs == ["00002.png"]
    assert read_png(str(tmp_path / "montage" / "00002.png")).shape == (
        B * 32, 6 * 37, 3)
    assert "3/3 [" in capsys.readouterr().out


def test_train_cli_trains_on_a_davis_tree(tmp_path, capsys, monkeypatch):
    """``train --root``: DAVIS through OpenCV, the scalar log in
    ``--logdir``, and the one JSON line."""
    root = _davis_tree(tmp_path / "davis")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_cli, "ScalarLogger", functools.partial(
        ScalarLogger, use_tensorboard=False))
    train_cli.main(["--root", str(root), "--steps", "2", "--device", "cpu",
                    "--batch", "2", "--size", "32", "--frames", "2",
                    "--logdir", str(tmp_path / "logs"),
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["data"] == "davis" and out["steps"] == 2
    for k in ("loss", "lF", "lB", "PF", "ms_per_step"):
        assert np.isfinite(out[k]), k
    recs = (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in recs] == [1, 2]


def test_train_cli_needs_data_and_a_decoder(tmp_path, capsys, monkeypatch):
    """No ``--root`` (nor ``data.root``) and no ``--synthetic``: an error,
    never synthetic data on its own; ``--root`` without OpenCV: an error
    naming it."""
    with pytest.raises(SystemExit):
        train_cli.main(["--steps", "1", "--device", "cpu"])
    assert "--root" in capsys.readouterr().err

    def no_cv2():
        raise ImportError("No module named 'cv2'")
    monkeypatch.setattr(train_cli, "cv2_readers", no_cv2)
    with pytest.raises(SystemExit):
        train_cli.main(["--root", str(tmp_path), "--device", "cpu"])
    assert "OpenCV (cv2)" in capsys.readouterr().err
