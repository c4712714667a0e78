"""Parity of the port's adversarial library and the JPEG-vs-adversarial study
with the JAX package (vwfd_tpu/adversarial.py, scripts/jpegadv_experiment.py),
float32 on the CPU, the victims' weights from flax's initialisation through
``convert.victim_from_jax``.

Tolerances and why:

* victim logits: 1e-5 of the logits' max (cuDNN-free CPU convolutions and
  GEMMs sum in another order than XLA's);
* one attack step fed the same iterate: EQUAL wherever the JAX gradient is
  larger than 1e-4 of its max. Nearer 0 the sign of a gradient that is
  rounding noise may flip between the frameworks and move the pixel by 2·step
  (or 2ε for FGSM); such pixels are allowed;
* whole 10-step runs: the adversarial images equal on all but 2 % of pixels
  (a flipped sign at one step moves the later iterates too) and within ε
  anywhere (both sides project onto the ε-ball);
* the study at ``--n 2 --size 16``: the summary line EQUAL and every row's
  labels equal, its PSNRs within 0.05 dB and its L2s within 1e-4.
"""

import contextlib
import io
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vwfd_tpu import adversarial as jadv
from vwfd_tpu.attacks.jpeg import diffjpeg as jdiffjpeg
from vwfd_tpu_torch import adversarial as adv
from vwfd_tpu_torch import jpegadv_experiment as study
from vwfd_tpu_torch.convert import victim_from_jax
from vwfd_tpu_torch.models.state import save_npz_tree

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "jpegadv_experiment.py"
EPS, STEP = 0.03, 0.005


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _victims(name, size=32, classes=10):
    jm = jadv.VICTIMS[name](num_classes=classes)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3))))
    tm = adv.VICTIMS[name](num_classes=classes, size=size)
    tm.load_state_dict(victim_from_jax(params))
    return jm, params, tm.eval()


def _jax_ce(jm, params, label):
    def loss(x):
        lg = jm.apply(params, x[None] if x.ndim == 3 else x)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            lg, jnp.full((lg.shape[0],), label)))
    return loss


def _images(n=3, size=32, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_victim_logits_match_flax(name):
    jm, params, tm = _victims(name)
    x = _images()
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _sure(g, rel=1e-4):
    """Pixels whose gradient is clearly away from 0."""
    return np.abs(g) > rel * np.abs(g).max()


@pytest.mark.parametrize("name", ["A", "C"])
def test_fgsm_matches_jax_where_the_gradient_is_not_noise(name):
    jm, params, tm = _victims(name)
    x = _images(1)[0]
    label = int(np.argmax(np.asarray(jm.apply(params, jnp.asarray(x[None])))))
    jloss = _jax_ce(jm, params, label)
    want = np.asarray(jadv.fgsm(jloss, jnp.asarray(x), EPS))
    got = adv.fgsm(adv.cross_entropy_of(tm, label), torch.from_numpy(x),
                   EPS).numpy()
    g = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    sure = _sure(g)  # (VictimA's stride-2 VALID conv never reads row 31)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[sure], want[sure])


@pytest.mark.parametrize("kind", ["igsm", "targeted", "jpeg_resistant"])
def test_one_step_fed_the_jax_iterate(kind):
    """Three steps of JAX's loop; at each the port's step from JAX's iterate
    equals JAX's next iterate where the gradient is not rounding noise."""
    jm, params, tm = _victims("A")
    orig = _images(1, seed=3)[0]
    lg = np.asarray(jm.apply(params, jnp.asarray(orig[None])))[0]
    label = int(np.argmin(lg) if kind == "targeted" else np.argmax(lg))
    jloss = _jax_ce(jm, params, label)
    tloss = adv.cross_entropy_of(tm, label)
    if kind == "jpeg_resistant":
        jloss = (lambda f: lambda x: f(jdiffjpeg(x, 75)))(jloss)
        tloss = (lambda f: lambda x: f(adv.diffjpeg(x, 75)))(tloss)
    descend = kind == "targeted"
    x = jnp.asarray(orig)
    for _ in range(3):
        g = np.asarray(jax.grad(jloss)(x))
        s = STEP * jnp.sign(jnp.asarray(g))
        nxt = jnp.clip(x - s if descend else x + s, orig - EPS, orig + EPS)
        nxt = np.asarray(jnp.clip(nxt, 0.0, 1.0))
        got = adv.igsm_step(tloss, torch.from_numpy(np.array(x)),
                            torch.from_numpy(orig), EPS, STEP,
                            descend=descend).numpy()
        sure = _sure(g)
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(got[sure], nxt[sure])
        x = jnp.asarray(nxt)


@pytest.mark.parametrize("kind", ["igsm", "targeted", "jpeg_resistant"])
def test_ten_step_runs_part_on_few_pixels(kind):
    jm, params, tm = _victims("A")
    orig = _images(1, seed=4)[0]
    lg = np.asarray(jm.apply(params, jnp.asarray(orig[None])))[0]
    label = int(np.argmin(lg) if kind == "targeted" else np.argmax(lg))
    jloss = _jax_ce(jm, params, label)
    tloss = adv.cross_entropy_of(tm, label)
    xj, xt = jnp.asarray(orig), torch.from_numpy(orig)
    if kind == "igsm":
        want, got = jadv.igsm(jloss, xj, EPS), adv.igsm(tloss, xt, EPS)
    elif kind == "targeted":
        want = jadv.igsm_targeted(jloss, xj, EPS)
        got = adv.igsm_targeted(tloss, xt, EPS)
    else:
        want = jadv.jpeg_resistant_fgsm(jloss, xj, EPS)
        got = adv.jpeg_resistant_fgsm(tloss, xt, EPS)
    want, got = np.asarray(want), got.numpy()
    assert np.mean(got != want) <= 0.02
    assert np.abs(got - orig).max() <= EPS + 1e-6
    assert np.abs(got - want).max() <= 2 * EPS + 1e-6


def _run_jax_script(args):
    buf = io.StringIO()
    argv = sys.argv
    try:
        sys.argv = [str(SCRIPT), *args]
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(SCRIPT), run_name="__main__")
    finally:
        sys.argv = argv
    return buf.getvalue()


@pytest.mark.parametrize("args", [
    ["--attack", "igsm"], ["--attack", "fgsm"],
    ["--attack", "jpeg_resistant"], ["--attack", "igsm", "--targeted"],
    ["--victim", "C", "--attack", "igsm"]],
    ids=["igsm", "fgsm", "jpeg_resistant", "targeted", "C_igsm"])
def test_study_matches_the_jax_script(tmp_path, args):
    common = ["--n", "2", "--size", "16", *args]
    name = args[1] if args[0] == "--victim" else "A"
    jm = jadv.VICTIMS[name](num_classes=10)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    npz = tmp_path / "victim.npz"
    save_npz_tree(str(npz), params)
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    jlines = _run_jax_script(common + ["--out", str(jout)]).splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        study.main(common + ["--out", str(tout), "--params", str(npz),
                             "--device", "cpu"])
    tlines = buf.getvalue().splitlines()
    assert tlines[-2] == jlines[-2]  # the summary line
    assert [ln.split(" psnr=")[0] for ln in tlines[:-2]] == \
        [ln.split(" psnr=")[0] for ln in jlines[:-2]]
    jrows = json.loads(jout.read_text())["rows"]
    trows = json.loads(tout.read_text())["rows"]
    for j, t in zip(jrows, trows):
        assert (t["label"], t["target"], t["adv_label"]) == \
            (j["label"], j["target"], j["adv_label"])
        assert abs(t["adv_psnr"] - j["adv_psnr"]) <= 0.05
        assert abs(t["adv_l2"] - j["adv_l2"]) <= 1e-4
        for variant in ("jpg_pic", "jpg_adv"):
            for a, b in zip(t["sweep"][variant], j["sweep"][variant]):
                assert (a["q"], a["label"], a["acc"], a["target_hit"]) == \
                    (b["q"], b["label"], b["acc"], b["target_hit"])
                for k in ("psnr_with_pic", "psnr_with_adv"):
                    assert abs(a[k] - b[k]) <= 0.05
                assert abs(a["l2_with_pic"] - b["l2_with_pic"]) <= 1e-4


def test_study_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        study.main(["--n", "1", "--size", "16"])


def test_study_reads_an_image_folder(tmp_path):
    from vwfd_tpu_torch.utils import save_png
    rng = np.random.default_rng(5)
    for i in range(3):
        save_png(str(tmp_path / f"{i}.png"),
                 rng.integers(0, 256, (20, 28, 3), dtype=np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    imgs = study.load_images(str(tmp_path), 4, 16)
    assert imgs.shape == (3, 16, 16, 3) and imgs.dtype == np.float32
    assert np.all((imgs >= 0) & (imgs <= 1))
    np.testing.assert_array_equal(imgs * 255, np.rint(imgs * 255))
