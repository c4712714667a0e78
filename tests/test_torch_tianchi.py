"""Parity of the port's Tianchi trainer (``vwfd_tpu_torch/models/
tianchi_model.py``) with vwfd_tpu's, on the CPU, at a narrow SUNet (embed
32, depths (2, 2), heads (1, 2), window 4) at 32², batch 2, lr 2⁻¹³, from
the same weights (the port's ``init_params`` carried to JAX's
``NetState`` by ``convert.py``). A step's JPEG draw comes from the JAX
key as ``jpeg_pool`` takes it: ``k1, k2 = split(key)``, the band index
``randint(k1, (), 0, 4)``, the mode ``randint(k2, (), 0, 3)``.

The train step and the JPEG draws run in float64 on both sides, as
``test_torch_mbrs_step.py`` does and for its reasons (the step's JPEG may
flip a rounding between JAX's dense DCT and the port's blockwise one in
float32, and Adam's first steps divide a gradient by its own size): JAX
under ``jax.enable_x64`` with the float32 pins of its DCT, its window
attention's einsums and its bilinear resize lifted (their
``preferred_element_type``), compiled without ``algsimp`` (F9). Both sides
then agree to about 1e-12. Tolerances: the JPEG draws within 1e-10; CE and
CE1 within 1e-9 relative; the parameters after both AdamW updates within
1e-3 of the rate; the Adam moments within 1e-7 of each tensor's max-abs,
the count EQUAL.

The eval step runs in float32 (K7's plain version takes float32):
predictions within 1e-5 of their max, ``f1_best`` within the bound of the
pixels whose 8-bit level differs between the two predictions (each moves
one count: 2 / (2·tp + fp + fn) apiece), 0 where none does. The guard: a
batch with an Inf pixel keeps every tensor on both packages (F21 at the
caller), in float64.

The runner (``run_family_convergence --task tianchi``): its train and eval
batches EQUAL to the JAX runner's (``tools/run_family_convergence.py::
_tianchi`` with its model replaced by a recorder), both packages' masks
drawn as rectangles (the stroke rasterisers differ, F11); its ``--resume``
stream EQUAL to an unbroken run's (a narrow SUNet, so that the test's
checkpoint is small).
"""

import dataclasses
import functools
import importlib.util
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vwfd_tpu.nets.sunet as jsunet_mod
import vwfd_tpu.ops.dct as jdct
import vwfd_tpu.ops.resize as jresize
from vwfd_tpu.attacks.blur import gaussian_blur_attack as jblur
from vwfd_tpu.attacks.jpeg import jpeg_pool as jjpeg_pool
from vwfd_tpu.config import Config as JConfig
from vwfd_tpu.config import DataConfig as JDataConfig
from vwfd_tpu.config import TrainConfig as JTrainConfig
from vwfd_tpu.models.state import NetState
from vwfd_tpu.models.tianchi_model import TianchiModel as JTianchi
from vwfd_tpu_torch import Config, DataConfig, TrainConfig
from vwfd_tpu_torch.convert import states_from_jax, states_to_jax
from vwfd_tpu_torch.models.tianchi_model import (QF_BANDS, TianchiDraws,
                                                 TianchiModel,
                                                 TianchiSampler)

ROOT = Path(__file__).resolve().parents[1]
# the rate 2⁻¹³ (about 1.2e-4) is exact in float32: the port keeps its
# rate in float32, optax under x64 in float64
S, B, LR = 32, 2, 2.0 ** -13
NARROW = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=4)
BAND = QF_BANDS[50]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs():
    d, t = dict(gt_size=S, batch_size=B), dict(lr=LR)
    return (Config(data=DataConfig(**d), train=TrainConfig(**t)),
            JConfig(data=JDataConfig(**d), train=JTrainConfig(**t)))


@pytest.fixture(scope="module")
def jmodel():
    return JTianchi(_cfgs()[1], **NARROW)


@pytest.fixture(scope="module")
def trees():
    """The port's fresh state (seed 4) as numpy trees: params, mu, nu,
    count."""
    port = TianchiModel(_cfgs()[0], device="cpu", **NARROW)
    port.init_states(4)
    return states_to_jax(port)


def _jstates(jmodel, trees, dtype=jnp.float32):
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                    trees["netG"]["params"])
    return {"netG": NetState.create(jmodel.net.apply, params, {},
                                    jmodel.tx)}


def _port(trees, double=False):
    model = TianchiModel(_cfgs()[0], device="cpu", **NARROW)
    if double:
        model.net.double()
        model.optimizers = model._adamw()
    states_from_jax(model, trees)
    return model


def _images(seed, n=B):
    rng = np.random.default_rng(seed)
    img = rng.random((n, S, S, 3))
    mask = np.zeros((n, S, S, 1))
    mask[:, 8:20, 10:26] = 1.0
    return img, mask


class _UnpinnedJnp:
    """``jax.numpy`` whose ``einsum`` ignores ``preferred_element_type``."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kw):
        return jnp.einsum(*args, **kw)


@pytest.fixture
def f64(monkeypatch):
    """Both packages in float64: torch's default dtype, ``jax.enable_x64``
    and JAX's float32 einsum pins lifted (DCT, window attention, resize)."""
    for mod in (jdct, jsunet_mod, jresize):
        monkeypatch.setattr(mod, "jnp", _UnpinnedJnp())
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    with jax.enable_x64(True):
        yield
    torch.set_default_dtype(prev)


def jax_draws(key) -> TianchiDraws:
    """The draw ``jpeg_pool(key, img, band)`` takes (call under the dtype
    mode the step runs in: x64 draws other numbers)."""
    k1, k2 = jax.random.split(key)
    return TianchiDraws(int(jax.random.randint(k1, (), 0, len(BAND))),
                        int(jax.random.randint(k2, (), 0, 3)))


def _keys(pairs):
    found, i = {}, 0
    while len(found) < len(pairs):
        key = jax.random.PRNGKey(900 + i)
        d = jax_draws(key)
        if tuple(d) in pairs:
            found.setdefault(tuple(d), key)
        i += 1
    return found


def test_jpeg_pool_draw_follows_the_jax_key(f64):
    """For every (band member, mode) of band 50 (Q 40-55: two below 50),
    the port's processed image (``jpeg_pool_draw`` at the drawn quality
    value, the blur, the clip) equals JAX's ``clip(blur(jpeg_pool(key,
    img, band)))`` on the draws derived from the key."""
    cfg = _cfgs()[0]
    model = TianchiModel(cfg, device="cpu", **NARROW)
    img = np.random.default_rng(3).random((B, S, S, 3))
    pairs = {(q, m) for q in range(len(BAND)) for m in range(3)}
    for (q, m), key in sorted(_keys(pairs).items()):
        want = jnp.clip(jblur(None, jjpeg_pool(key, jnp.asarray(img),
                                               qualities=BAND)), 0.0, 1.0)
        got = model.processed(torch.from_numpy(img), TianchiDraws(q, m))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-10, err_msg=f"Q{BAND[q]} mode {m}")


_COMPILED = {}


def _jax(method, jmodel, *args):
    """JAX's ``train_step`` / ``eval_step`` jitted without ``algsimp``
    (F9), once a test process and dtype mode (the key is an argument)."""
    key = (method, jax.config.jax_enable_x64)
    if key not in _COMPILED:
        fn = functools.partial(getattr(JTianchi, method).__wrapped__, jmodel)
        _COMPILED[key] = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return _COMPILED[key](*args)


def _adam_of(state):
    """optax's ScaleByAdamState of ``chain(clip, adamw)``."""
    return state.opt_state[1][0]


@pytest.mark.parametrize("pair", [(1, 0), (0, 1), (3, 2)])
def test_train_step_matches_jax(jmodel, trees, pair, f64):
    """One train step per JPEG mode (hard at Q45, soft at Q40, zonal at
    Q55): CE, CE1, and the parameters, Adam moments and count after both
    AdamW updates."""
    key = _keys({pair})[pair]
    img, mask = _images(11)
    new, jlogs = _jax("train_step", jmodel,
                      _jstates(jmodel, trees, jnp.float64), jnp.asarray(img),
                      jnp.asarray(mask), key)
    port = _port(trees, double=True)
    logs = port.train_step(img, mask, jax_draws(key))
    for term in ("CE", "CE1"):
        np.testing.assert_allclose(float(logs[term]), float(jlogs[term]),
                                   rtol=1e-9, err_msg=term)
    got = states_to_jax(port)["netG"]
    adam = _adam_of(new["netG"])
    assert int(got["count"]) == int(adam.count) == 2
    for what, want_tree, rel in (("params", new["netG"].params, None),
                                 ("mu", adam.mu, 1e-7), ("nu", adam.nu, 1e-7)):
        want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
        have = dict(jax.tree_util.tree_leaves_with_path(got[what]))
        assert set(want) == set(have)
        for path, w in want.items():
            w = np.asarray(w)
            atol = 1e-3 * LR if rel is None else rel * float(
                np.abs(w).max())
            np.testing.assert_allclose(have[path], w, rtol=0, atol=atol,
                                       err_msg=f"{what} {path}")


def test_guard_keeps_every_tensor_on_both_packages(jmodel, trees, f64):
    """A batch with an Inf pixel: non-finite CE, and every parameter, Adam
    moment and the count as they were, on both packages."""
    img, mask = _images(12)
    img[1, 3, 4, 0] = np.inf
    key = jax.random.PRNGKey(7)
    before = _jstates(jmodel, trees, jnp.float64)
    new, jlogs = _jax("train_step", jmodel, before, jnp.asarray(img),
                      jnp.asarray(mask), key)
    assert not np.isfinite(float(jlogs["CE"]))
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(
                        _jstates(jmodel, trees, jnp.float64))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    port = _port(trees, double=True)
    was = [t.clone() for t in port._tensors()]
    logs = port.train_step(img, mask, jax_draws(key))
    assert not np.isfinite(float(logs["CE"]))
    assert all(torch.equal(a, b) for a, b in zip(was, port._tensors()))


def test_eval_step_matches_jax(jmodel, trees):
    """``eval_step`` in float32: the prediction within 1e-5 of its max and
    ``f1_best`` within the bound of the pixels whose level differs."""
    img, mask = _images(13)
    img, mask = img.astype(np.float32), mask.astype(np.float32)
    jout = _jax("eval_step", jmodel, _jstates(jmodel, trees),
                jnp.asarray(img), jnp.asarray(mask))
    port = _port(trees)
    out = port.eval_step(img, mask)
    pj, pp = np.asarray(jout["predicted"]), _np(out["predicted"])
    np.testing.assert_allclose(pp, pj, rtol=0,
                               atol=1e-5 * float(np.abs(pj).max()))
    crossed = int((np.trunc(pp * 255) != np.trunc(pj * 255)).sum())
    gt = mask > 0.5
    denom = max(1, int(gt.sum()))  # 2·tp + fp + fn ≥ tp + fn = the mask
    assert abs(float(out["f1_best"]) - float(jout["f1_best"])) \
        <= 2 * crossed / denom + 1e-7
    assert out["f1_sweep"].shape == (9,)


def test_sampler_is_seeded():
    """The host sampler: the band index then the mode, from
    ``default_rng(seed)``, replayable."""
    a, b = TianchiSampler(5), TianchiSampler(5)
    draws = [a() for _ in range(50)]
    assert draws == [b() for _ in range(50)]
    rng = np.random.default_rng(5)
    want = []
    for _ in range(50):
        q = int(rng.integers(4))
        want.append(TianchiDraws(q, int(rng.integers(3))))
    assert draws == want
    assert {d.mode for d in draws} == {0, 1, 2}


# ------------------------------------------------------------- the runner

def _jax_runner():
    spec = importlib.util.spec_from_file_location(
        "jax_family_runner", ROOT / "tools" / "run_family_convergence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_runner_batches(monkeypatch, steps, eval_every, eval_batches):
    """The JAX runner's ``_tianchi`` with its model replaced by a recorder:
    the train batches and each eval's batches it hands the model."""
    import vwfd_tpu.models.tianchi_model as jtm
    from vwfd_tpu.config import load_config as jload
    seen = {"train": [], "eval": []}

    class Recorder:
        def __init__(self, cfg, *a, **kw):
            pass

        def init_states(self, key):
            return {}

        def train_step(self, states, img, mask, key):
            seen["train"].append((np.asarray(img), np.asarray(mask)))
            return states, {"CE": 0.0, "CE1": 0.0}

        def eval_step(self, states, img, mask):
            seen["eval"].append((np.asarray(img), np.asarray(mask)))
            return {"f1_best": 0.0}
    monkeypatch.setattr(jtm, "TianchiModel", Recorder)
    cfg = jload(str(ROOT / "vwfd_tpu" / "configs" / "tianchi.yaml"))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, gt_size=S, batch_size=B, synthetic=True))
    import argparse
    args = argparse.Namespace(
        steps=steps, size=S, batch=B, eval_batch=None,
        eval_batches=eval_batches, eval_every=eval_every, log_every=1,
        save_every=1000, ckpt_dir=None, resume=False)
    _jax_runner()._tianchi(args, cfg, jax.random.PRNGKey(10), None)
    return seen


def _same_forgery(got, want, what):
    """The images and masks EQUAL."""
    for a, b, part in zip(got, want, ("images", "masks")):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {part}")


def _rect_strokes(monkeypatch):
    """Both packages' synthetic masks from one rectangle drawer: the stroke
    rasterisers differ (F11, pinned in ``test_torch_train.py``), rectangles
    are bit-equal, so the runners' pipelines compare EQUAL."""
    import vwfd_tpu.data.synthetic as jsyn
    import vwfd_tpu_torch.data.synthetic as psyn

    def rect(rng, hw, percent_range=(0.05, 0.2)):
        return psyn.random_rect_mask(rng, hw, *percent_range)
    monkeypatch.setattr(jsyn, "free_form_stroke_mask", rect)
    monkeypatch.setattr(psyn, "free_form_stroke_mask", rect)


def test_runner_batches_match_the_jax_runners(monkeypatch, tmp_path):
    """The port runner's first train batches and its evals' held-out
    batches EQUAL to the JAX runner's (``_Img`` through its loaders, the
    masks from one rectangle drawer); the run stopped at step 2 and resumed
    sees the same batches and draws at steps 3-4 as an unbroken one, and
    its evals the same orders."""
    from vwfd_tpu_torch import run_family_convergence as runner
    _rect_strokes(monkeypatch)
    want = _jax_runner_batches(monkeypatch, 4, 2, 2)
    monkeypatch.setattr(runner, "TianchiModel",
                        functools.partial(TianchiModel, **NARROW))
    seen = {"a": {}, "b": {}}

    def recorder(name):
        def on_step(step, imgs, masks, draws):
            seen[name][step] = (imgs, masks, draws)
        return on_step

    def args(name, *extra):
        return runner.parse_args([
            "--task", "tianchi", "--steps", "4", "--size", str(S), "--batch",
            str(B), "--eval-every", "2", "--eval-batches", "2",
            "--log-every", "1", "--device", "cpu", "--out",
            str(tmp_path / f"{name}.jsonl"), "--ckpt-dir",
            str(tmp_path / name), *extra])
    assert runner.run(args("a"), recorder("a")) == "done"
    for step in range(1, 5):
        _same_forgery(seen["a"][step][:2], want["train"][step - 1],
                      f"step {step}")
    assert runner.run(args("b", "--stop-at-step", "2"),
                      recorder("b")) == "stopped"
    assert runner.run(args("b", "--resume"), recorder("b")) == "done"
    for step in (3, 4):
        a, b = seen["a"][step], seen["b"][step]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    # evals at steps 2 and 4, two batches each, a fresh order each
    for e in range(2):
        loader = runner.tianchi_eval_loader(S, B, evals_done=e)
        for k, batch in enumerate(itertools.islice(iter(loader), 2)):
            _same_forgery(batch, want["eval"][2 * e + k], f"eval {e} {k}")
    recs = [json.loads(x) for x in open(tmp_path / "b.jsonl")]
    assert [r["step"] for r in recs if r.get("eval")] == [2, 4]
    assert {"CE", "CE1", "wall"} <= set(recs[1])


@pytest.mark.parametrize("augment", [False, True])
def test_image_folder_with_masks_equals_jax(tmp_path, augment):
    """``ImageFolderDataset(mask_root=)`` on an OpenCV-written tree (images
    of 40 × 52 in a nested folder, gray masks of the same base names with
    values on both sides of 127) EQUAL to JAX's, with OpenCV's readers:
    the image at 32² (flipped and turned as JAX draws them where
    ``augment``), the mask nearest-resized, > 127, (32, 32, 1), not
    augmented."""
    import cv2
    from vwfd_tpu.data.images import ImageFolderDataset as JFolder
    from vwfd_tpu_torch.data import (ImageFolderDataset, cv2_mask_reader,
                                     cv2_readers)
    img_dir, mask_dir = tmp_path / "img" / "sub", tmp_path / "mask"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        cv2.imwrite(str(img_dir / f"f{i}.png"),
                    (rng.random((40, 52, 3)) * 255).astype(np.uint8))
        cv2.imwrite(str(mask_dir / f"f{i}.png"),
                    rng.integers(100, 156, (40, 52)).astype(np.uint8))
    read_image, _ = cv2_readers()
    ours = ImageFolderDataset(str(tmp_path / "img"), read_image, size=S,
                              augment=augment, mask_root=str(mask_dir),
                              read_mask=cv2_mask_reader(), seed=4)
    ref = JFolder(str(tmp_path / "img"), size=S, augment=augment,
                  mask_root=str(mask_dir), seed=4)
    assert len(ours) == len(ref) == 3
    for i in range(6):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) == {"image", "mask"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
        assert a["mask"].shape == (S, S, 1) and 0 < a["mask"].mean() < 1
    with pytest.raises(ValueError, match="read_mask"):
        ImageFolderDataset(str(tmp_path / "img"), read_image,
                           mask_root=str(mask_dir))
