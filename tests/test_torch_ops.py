"""Parity of the port's ops and kernel plain versions with the JAX package.

Each kernel module of ``vwfd_tpu_torch.kernels`` is driven through its
wrapper with CPU tensors, which takes the plain PyTorch version; the same
seeded numpy inputs go through the JAX function it replaces. The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu import serving as jserving
from vwfd_tpu.models import video_model as jvm
from vwfd_tpu.nets import inn as jinn
from vwfd_tpu.nets import inn_packed as jpk
from vwfd_tpu.ops import quantize as jq
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu_torch.kernels import coupling, mask, transition, wire
from vwfd_tpu_torch.ops import (clamp_with_grad, depth_to_space,
                                space_to_depth, ste_quantize_255)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("s", [2, 4])
def test_squeeze_matches_jax(rng, s):
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    ours = space_to_depth(torch.from_numpy(x), s)
    ref = jsq.space_to_depth_conv(jnp.asarray(x), s)
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))
    back = depth_to_space(ours, s)
    np.testing.assert_array_equal(
        _np(back), np.asarray(jsq.depth_to_space_conv(ref, s)))
    np.testing.assert_array_equal(_np(back), x)


def test_quantize_matches_jax_with_identity_grads(rng):
    x = (rng.standard_normal((4, 64)) * 0.7 + 0.5).astype(np.float32)
    x[0, :4] = [0.5 / 255, 1.5 / 255, 2.5 / 255, 254.5 / 255]  # ties
    xt = torch.from_numpy(x).requires_grad_(True)
    q = ste_quantize_255(clamp_with_grad(xt))
    ref = jq.ste_quantize_255(jq.clamp_with_grad(jnp.asarray(x)))
    np.testing.assert_allclose(_np(q), np.asarray(ref), rtol=0, atol=1e-7)
    q.sum().backward()
    np.testing.assert_array_equal(_np(xt.grad), np.ones_like(x))
    g = jax.grad(lambda v: jq.ste_quantize_255(jq.clamp_with_grad(v)).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(g), np.ones_like(x))


# the flagship's widths: entry 12 → 192, p2p 48 → 768, p2u 768 → 768
_MAPS = [("entry", (2, 16, 16, 12)), ("p2p", (2, 8, 8, 48)),
         ("p2u", (2, 4, 4, 768))]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind,shape", _MAPS)
def test_transition_matches_fixed_conv(rng, kind, shape, transpose):
    """All six K1 maps against inn_packed._fixed_conv / _fixed_conv_t with
    the JAX package's own fixed kernels (f32, tolerance 1e-6: sums of four
    ±0.5 taps in another order)."""
    fwd_shape = transition.out_shape(shape, kind)
    x = rng.standard_normal(fwd_shape if transpose else shape
                            ).astype(np.float32)
    ours = _np(transition.transition(torch.from_numpy(x), kind, transpose))
    c = shape[-1]
    if kind == "entry":
        jk, s = jpk._entry_kernel(c, transpose), 4
    elif kind == "p2p":
        jk, s = jpk._p2p_kernel(c // 4, transpose), 2
    else:
        jk, s = jpk._p2u_kernel(c // 4, transpose), 1
    if transpose and kind != "p2u":
        ref = jpk._fixed_conv_t(jnp.asarray(x), jk, s)
    else:
        ref = jpk._fixed_conv(jnp.asarray(x), jk, s)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-6)
    # each transpose inverts its forward map (orthogonal)
    back = transition.transition(
        transition.transition(torch.from_numpy(x), kind, transpose), kind,
        not transpose)
    np.testing.assert_allclose(_np(back), x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_coupling_affine_matches_e(rng, inverse):
    """K2's affine (``coupling_affine_plain``, which ``coupling_head_plain``
    ends in) against ``_e(s)·x + t`` (and ``(x − t)/_e(s)``), writing into
    a channel slice of a wider output as the executor does."""
    n, h, w, c = 2, 4, 4, 24
    head = rng.standard_normal((n, h, w, 2 * c)).astype(np.float32) * 2
    bias = rng.standard_normal(2 * c).astype(np.float32)
    z = rng.standard_normal((n, h, w, 2 * c)).astype(np.float32)
    zt = torch.from_numpy(z)
    out = torch.zeros(n, h, w, 2 * c)
    got = coupling.coupling_affine_plain(torch.from_numpy(head),
                                         torch.from_numpy(bias), zt[..., :c],
                                         out=out[..., c:], inverse=inverse)
    assert got.data_ptr() == out[..., c:].data_ptr()
    st = jnp.asarray(head + bias)
    s, t = st[..., :c], st[..., c:]
    x = jnp.asarray(z[..., :c])
    ref = (x - t) / jinn._e(s) if inverse else jinn._e(s) * x + t
    np.testing.assert_allclose(_np(out[..., c:]), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(out[..., :c]), 0.0)


def test_wire_to_channels_and_s2d_match_jax(rng):
    clip = rng.integers(0, 256, (2, 4, 8, 8, 3), dtype=np.uint8)
    video = jnp.asarray(clip).astype(jnp.float32) / 255.0
    ours = wire.to_channels(torch.from_numpy(clip), torch.float32)
    np.testing.assert_array_equal(_np(ours),
                                  np.asarray(jvm._to_channels(video)))
    for s in (2, 4):
        flat = torch.from_numpy(clip.reshape(8, 8, 8, 3))
        ref = jsq.space_to_depth_conv(video.reshape(8, 8, 8, 3), s)
        np.testing.assert_array_equal(
            _np(wire.to_s2d(flat, s, torch.float32)), np.asarray(ref))


def test_wire_to_u8_matches_jax_round(rng):
    """K3(b) against ``round(clip(_to_frames(x), 0, 1)·255)`` with exact
    .5 ties (half to even) and out-of-range values."""
    x = rng.uniform(-0.2, 1.2, (2, 8, 8, 12)).astype(np.float32)
    ties = (np.arange(96, dtype=np.float32) + 0.5) / 255.0
    x.reshape(-1)[:96] = ties
    ref_in = jvm._to_frames(jnp.asarray(x), 4)
    ref = jnp.round(jnp.clip(ref_in, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    ours = wire.to_u8(torch.from_numpy(x), 4)
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))


@pytest.mark.parametrize("w", [16, 12])
def test_mask_pack_matches_pack_mask_bits(rng, w):
    """K4 against UNetTPU's d2s + sigmoid and serving's threshold, bit-pack
    (W % 8 == 0) or u8 mask, and per-clip mean — with logits exactly at
    the threshold (p == 0.5 is not tampered)."""
    b, t, h, s = 2, 4, 8, 2
    logits = rng.standard_normal((b * t, h // s, w // s, s * s)
                                 ).astype(np.float32)
    logits.reshape(-1)[::7] = 0.0
    m, frac = mask.mask_pack(torch.from_numpy(logits), t, s, 0.5)
    probs = jax.nn.sigmoid(jsq.depth_to_space_conv(jnp.asarray(logits), s)
                           ).reshape(b, t, h, w, 1)
    if w % 8 == 0:
        ref = jserving._pack_mask_bits(probs > 0.5)
    else:
        ref = jserving._mask_u8(probs, 0.5)
    np.testing.assert_array_equal(_np(m), np.asarray(ref))
    np.testing.assert_allclose(_np(frac),
                               np.asarray(jnp.mean(probs, axis=(1, 2, 3, 4))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("clips,rows,sms", [(16, 512, 132), (2, 16, 132),
                                            (1, 3, 8), (64, 1024, 132)])
def test_mask_fast_grid_covers_each_clip(clips, rows, sms):
    """K4's fast path: G blocks of 8 warps × rows-per-warp cover a clip's
    logits rows, no block is empty, and the flagship (16 clips of 512 rows
    on 132 SMs) gets about four blocks per SM, two rows per warp."""
    g, rpw = mask.fast_grid(clips, rows, sms)
    assert g * 8 * rpw >= rows > (g - 1) * 8 * rpw
    if (clips, rows) == (16, 512):
        assert (g, rpw) == (32, 2)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        transition.transition(torch.zeros(1, 4, 4, 3, dtype=torch.float64),
                              "entry")
    with pytest.raises(ValueError):
        transition.transition(torch.zeros(1, 6, 6, 3), "entry")
    with pytest.raises(ValueError):  # not contiguous
        transition.transition(torch.zeros(1, 3, 4, 4).permute(0, 2, 3, 1),
                              "entry")
    with pytest.raises(ValueError):  # head must hold s ‖ t for x
        coupling.coupling_affine_plain(torch.zeros(1, 2, 2, 6),
                                       torch.zeros(6), torch.zeros(1, 2, 2, 2))
    with pytest.raises(ValueError):  # wire input is uint8 RGB
        wire.to_channels(torch.zeros(1, 2, 4, 4, 3), torch.float32)
    with pytest.raises(ValueError):
        mask.mask_pack(torch.zeros(3, 2, 2, 4), 2, 2, 0.5)


def test_port_imports_no_jax_and_no_reference_package():
    """Importing every module of the port brings in no jax/flax/optax/orbax,
    nothing of vwfd_tpu and neither OpenCV nor PIL (the card machine has
    none of them), checked in a fresh interpreter."""
    code = (
        "import sys, pkgutil, importlib, vwfd_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "vwfd_tpu_torch.__path__, 'vwfd_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vwfd_tpu', 'cv2', "
        "'PIL')]\n"
        "print(' '.join(names))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 80  # every module was imported
    assert {f"vwfd_tpu_torch.{m}" for m in (
        "kernels.zigzag", "kernels.crop_resize", "attacks.noise",
        "nets.blocks", "nets.hidden", "models.hidden_model", "data.images",
        "eval_hidden", "continue_hidden", "nets.mbrs", "models.mbrs_model",
        "run_family_convergence", "nets.sunet", "models.tianchi_model",
        "kernels.window_attention", "serve", "kernels.canny", "ops.canny",
        "ops.pad", "nets.localizer", "models.image_model", "data.edges",
        "kernels.crop_cubic", "kernels.rectify", "kernels.ssim_grad",
        "nets.fbcnn", "nets.discriminator", "metrics.perceptual",
        "kernels.film", "models.kdjpeg_model", "data.jpeg_data",
        "parallel", "parallel.spawn", "dryrun_multiprocess",
        "kernels.diffjpeg", "native", "adversarial", "jpegadv_experiment",
        "data.cvtransforms", "attacks.stegastamp", "ops.dwt",
        "ops.morphology", "ops.warp")
    } <= names


def test_serve_imports_and_parses_without_cv2():
    """With OpenCV absent (``sys.modules['cv2'] = None``, in a fresh
    interpreter) ``vwfd_tpu_torch.serve`` and the Tianchi modules import,
    and a media folder without a reader stops with cv2's name."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "import vwfd_tpu_torch.serve as serve\n"
        "import vwfd_tpu_torch.models.tianchi_model\n"
        "import vwfd_tpu_torch.nets.sunet\n"
        "import vwfd_tpu_torch.kernels.window_attention\n"
        "try:\n"
        "    serve.cv2_io()\n"
        "except ImportError as e:\n"
        "    assert 'cv2' in str(e), e\n"
        "    print('refused')\n"
        "try:\n"
        "    serve.main(['--root', '.', '--device', 'cpu'])\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["refused", "exit", "2"]
    assert "cv2" in proc.stderr
