"""The serving CLI's media folders, ``--stream`` and ``--s2d``
(``vwfd_tpu_torch/serve.py``) against ``scripts/serve_video.py`` (loaded by
path, not edited) and the JAX ``WatermarkServer``, on the CPU.

* On an OpenCV-written tree (two clip directories of 9 and 5 frames at
  40 × 48, another size than the served 32², a ``.txt`` file and a
  ``.png`` that does not decode), the request stream and its batches are
  EQUAL, names and bytes, to the script's ``_iter_disk_clips`` /
  ``_batched``;
* ``--root --out``: the file names, ``verdicts.json``'s keys and the
  pixels of every frame and mask are what the port's server returned for
  those batches, in the script's formats (RGB written as BGR PNG, masks
  one-channel {0, 255});
* ``--stream 3`` prints the script's three lines (windows 1, 2, 4) with
  its keys and ``clips`` = 3·b;
* ``--s2d 4``: a detect's mask bits EQUAL to the JAX server's at s2d 4 on
  the same weights (converted), except where JAX's probability lies within
  1e-5 of the threshold (none here); tamper fractions within 1e-5.
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

import vwfd_tpu
from vwfd_tpu.config import load_config as jload_config
from vwfd_tpu.serving import WatermarkServer as JServer
from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config, serve
from vwfd_tpu_torch.convert import params_from_jax
from vwfd_tpu_torch.serving import WatermarkServer, unpack_mask_bits

from test_torch_serving import _perturb

ROOT = Path(__file__).resolve().parents[1]
B, T, S = 2, 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _script():
    spec = importlib.util.spec_from_file_location(
        "serve_video", ROOT / "scripts" / "serve_video.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for clip, n in (("clipA", 9), ("clipB", 5)):
        (root / clip).mkdir()
        for i in range(n):
            cv2.imwrite(str(root / clip / f"{i:05d}.png"),
                        (rng.random((40, 48, 3)) * 255).astype(np.uint8))
    (root / "clipA" / "notes.txt").write_text("not an image")
    (root / "clipB" / "00002b.png").write_bytes(b"not a png")
    (root / "loose.png").write_bytes(b"a file, not a clip directory")
    return str(root)


def test_request_stream_and_batches_equal_the_script(tree):
    """Names and bytes of every request and every batch EQUAL to the
    script's (9 frames → 4 windows of 2, the ninth left over; 5 frames and
    a broken PNG → 2 windows; 6 requests → batches of 2, 2, 2; at B = 4 the
    tail batch of 2 stays short)."""
    js = _script()
    read, _ = serve.cv2_io()
    got = list(serve.iter_disk_clips(tree, T, S, read))
    want = list(js._iter_disk_clips(tree, T, S))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == 6 and got[0][0] == "clipA/00000..00001"
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == (1, T, S, S, 3)
        np.testing.assert_array_equal(a, b)
    for batch in (2, 4):
        gb = list(serve.batched(iter(got), batch))
        wb = list(js._batched(iter(want), batch))
        assert [n for n, _ in gb] == [n for n, _ in wb]
        for (_, a), (_, b) in zip(gb, wb):
            np.testing.assert_array_equal(a, b)
    assert [len(n) for n, _ in serve.batched(iter(got), 4)] == [4, 2]


def _cfg(size=S, s2d=None):
    cfg = load_config(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=B, frames=T, gt_size=size))
    if s2d:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, extractor_s2d=s2d))
    return cfg


@pytest.mark.parametrize("mode", ["roundtrip", "detect", "embed"])
def test_out_tree_holds_the_servers_results(tree, tmp_path, capsys, mode):
    """``--root --out``: the script's file names and ``verdicts.json`` keys,
    and the frames and masks the server returned for the same batches."""
    out = tmp_path / "out"
    serve.main(["--mode", mode, "--root", tree, "--out", str(out),
                "--device", "cpu", "--batch", str(B), "--size", str(S),
                "--frames", str(T)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"mode", "clips", "frames", "wall_s", "compile_s",
            "frames_per_s", "window", "batch", "size"} <= set(line)
    assert line["clips"] == 6 and line["frames"] == 12

    server = WatermarkServer(_cfg(), device="cpu", modes=(mode,))
    read, _ = serve.cv2_io()
    batches = list(serve.batched(serve.iter_disk_clips(tree, T, S, read), B))
    files, verdicts = set(), {}
    for names, arr in batches:
        res = server.serve(arr, mode)
        for i, name in enumerate(names):
            safe = name.replace("/", "_")
            if mode != "embed":
                verdicts[f"{name}#{i}"] = float(res.tamper_fraction[i])
            for t in range(T):
                if mode != "detect":
                    f = f"{safe}_f{t}.png"
                    files.add(f)
                    img = cv2.imread(str(out / f), cv2.IMREAD_COLOR)
                    np.testing.assert_array_equal(img[:, :, ::-1],
                                                  res.watermarked[i, t])
                if mode != "embed":
                    f = f"{safe}_f{t}_mask.png"
                    files.add(f)
                    m = cv2.imread(str(out / f), cv2.IMREAD_UNCHANGED)
                    np.testing.assert_array_equal(m, res.mask[i, t][..., 0])
    if mode != "embed":
        files.add("verdicts.json")
        with open(out / "verdicts.json") as f:
            assert json.load(f) == pytest.approx(verdicts, abs=0)
    assert set(os.listdir(out)) == files


def test_stream_prints_the_scripts_lines(capsys):
    """``--stream 3``: windows 1, 2, 4, the script's keys, 3·b clips."""
    serve.main(["--mode", "roundtrip", "--stream", "3", "--device", "cpu",
                "--batch", str(B), "--size", str(S), "--frames", str(T)])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [r["window"] for r in lines] == [1, 2, 4]
    keys = {"mode", "window", "requests", "clips", "batch", "frames", "size",
            "int8", "wall_s", "clips_per_s", "frames_per_s"}
    for r in lines:
        assert keys <= set(r)
        assert r["clips"] == 3 * B and r["requests"] == 3
        assert r["frames_per_s"] == pytest.approx(r["clips_per_s"] * T)


def test_media_folder_needs_a_reader(monkeypatch, tree):
    """Without OpenCV a media folder fails with its name, unless the caller
    passes the reader (and, with --out, the writer)."""
    import builtins
    real = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(SystemExit):
        serve.main(["--root", tree, "--device", "cpu", "--batch", str(B),
                    "--size", str(S), "--frames", str(T)])
    with pytest.raises(ImportError, match="cv2"):
        serve.cv2_io()
    monkeypatch.setattr(builtins, "__import__", real)
    read, _ = serve.cv2_io()
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    serve.main(["--mode", "detect", "--root", tree, "--device", "cpu",
                "--batch", str(B), "--size", str(S), "--frames", str(T)],
               read_image=read)


def test_s2d_4_detect_bits_equal_jax():
    """``--s2d 4`` (``model.extractor_s2d``) at 64²: the port server's
    detect against the JAX server's on the same, converted weights (the
    JAX server's random init with BatchNorm statistics perturbed)."""
    size = 64
    jcfg = jload_config(os.path.join(os.path.dirname(vwfd_tpu.__file__),
                                     "configs", "video.yaml"))
    jcfg = dataclasses.replace(
        jcfg, data=dataclasses.replace(jcfg.data, batch_size=B, frames=T,
                                       gt_size=size),
        model=dataclasses.replace(jcfg.model, extractor_s2d=4),
        train=dataclasses.replace(jcfg.train, dtype="float32"))
    jserver = JServer(jcfg, modes=("detect",))
    rng = np.random.default_rng(3)
    gp, gv = jserver._params["generator"]
    gv = {"batch_stats": _perturb(gv["batch_stats"], rng)}
    jserver._params["generator"] = (gp, gv)
    tree = jax.tree_util.tree_map(np.asarray, {
        "netG": jserver._params["netG"][0], "gen": gp,
        "stats": gv["batch_stats"]})
    netG, gen = params_from_jax(tree["netG"], tree["gen"], tree["stats"])
    cfg = dataclasses.replace(_cfg(size, 4), train=dataclasses.replace(
        _cfg().train, dtype="float32"))
    port = WatermarkServer(cfg, device="cpu",
                           weights={"netG": netG, "generator": gen},
                           modes=("detect",))
    assert port.model.unet.s2d == 4
    clip = np.random.default_rng(4).integers(0, 256, (B, T, size, size, 3),
                                             dtype=np.uint8)
    want, got = jserver.serve(clip, "detect"), port.serve(clip, "detect")
    np.testing.assert_array_equal(got.mask_bits, np.asarray(want.mask_bits))
    np.testing.assert_allclose(got.tamper_fraction,
                               np.asarray(want.tamper_fraction), rtol=0,
                               atol=1e-5)
    m = unpack_mask_bits(got.mask_bits)
    assert 0 < m.mean() < 255  # a mask with both values
