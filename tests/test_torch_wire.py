"""K3 `wire` on the CPU: the roundtrip's one-pass encode + stem decode
(``to_u8_s2d``) against the JAX package's composition, the choice between
the tiled and the general kernel path, and the server's roundtrip through
the wrappers against the plain versions. The kernels themselves are held to
the plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.models import video_model as jvm
from vwfd_tpu.ops import squeeze as jsq
from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config
from vwfd_tpu_torch.kernels import PLAIN, wire
from vwfd_tpu_torch.serving import WatermarkServer


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inn_output(rng, shape):
    """Values in [-0.2, 1.2] with exact .5 ties x = (k + .5)/255."""
    x = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    n = min(x.size, 255)
    x.reshape(-1)[:n] = (np.arange(n, dtype=np.float32) + 0.5) / 255.0
    return x


@pytest.mark.parametrize("s", [2, 4])
def test_to_u8_s2d_matches_jax_composition(rng, s):
    """(d) = ``round(clip(_to_frames(x), 0, 1)·255)`` → u8, then
    ``space_to_depth_conv(u8/255, s)``: bit-exact, ties half to even."""
    b, t, h, w = 2, 4, 8, 16
    x = _inn_output(rng, (b, h, w, 3 * t))
    q = jnp.round(jnp.clip(jvm._to_frames(jnp.asarray(x), t), 0.0, 1.0)
                  * 255.0).astype(jnp.uint8)
    ref = jsq.space_to_depth_conv(
        q.reshape(b * t, h, w, 3).astype(jnp.float32) / 255.0, s)
    u8, xs = wire.to_u8_s2d(torch.from_numpy(x), t, s)
    assert u8.dtype == torch.uint8 and xs.dtype == torch.float32
    np.testing.assert_array_equal(u8.numpy(), np.asarray(q))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(ref))
    ties = np.clip(x, 0, 1) * np.float32(255) % 1 == 0.5
    assert ties.sum() > 0


def test_to_u8_s2d_plain_is_to_u8_then_to_s2d(rng):
    x = torch.from_numpy(_inn_output(rng, (1, 6, 10, 12))).to(torch.bfloat16)
    u8, xs = wire.to_u8_s2d_plain(x, 4, 2)
    assert torch.equal(u8, wire.to_u8_plain(x, 4))
    assert torch.equal(xs, wire.to_s2d_plain(u8.reshape(4, 6, 10, 3), 2,
                                             torch.bfloat16))


def _buf(misalign=0):
    """A uint8 view whose address is ``misalign`` bytes past a 16-byte
    boundary."""
    base = torch.empty(96, dtype=torch.uint8)
    return base[(16 - base.data_ptr() % 16) % 16 + misalign:]


# (width, staged rows, channels per dtype-side pixel, tiled?): the flagship
# maps (256², T=4, s=2), widths whose rows are no multiple of 16 bytes,
# rows too wide for the staged shared memory, and too many channels
_PATHS = [
    (256, 4, 12, True),     # (a), (b)
    (256, 2, 12, True),     # (c)
    (256, 8, 12, True),     # (d)
    (48, 8, 12, True),      # 144-byte rows: a ragged last thread pass
    (16, 2, 48, True),      # (c) at s = 4
    (36, 4, 12, False),     # 108-byte rows
    (250, 2, 12, False),    # 750-byte rows
    (2048, 8, 12, False),   # 8 rows of 6 KB exceed 48 KB
    (2048, 4, 12, True),    # 4 of them fit
    (4000, 4, 12, True),    # (a), (b): 47 KB of staged rows, the most
    (8000, 2, 12, True),    # (c): 47 KB
    (1984, 8, 12, True),    # (d): 47 KB
    (4096, 4, 12, False),   # (a), (b): 48.06 KB
    (256, 22, 66, False),   # 22 frames: 66 channels
]


@pytest.mark.parametrize("width,rows,channels,want", _PATHS)
def test_tiled_path_choice(width, rows, channels, want):
    assert wire.tiled(_buf(), width, rows, channels) is want
    # an input that does not start on a 16-byte boundary never tiles
    assert wire.tiled(_buf(misalign=4), width, rows, channels) is False


def _small_cfg(dtype="float32"):
    cfg = load_config(FLAGSHIP_CONFIG)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, gt_size=32),
        train=dataclasses.replace(cfg.train, dtype=dtype))


def test_server_roundtrip_through_wrappers_equals_plain():
    """The roundtrip through ``KERNELS`` (the wrappers, which take the plain
    versions on the CPU) and through ``PLAIN`` give the same bytes, and the
    roundtrip's mask equals detect of its watermark."""
    cfg = _small_cfg()
    modes = ("embed", "detect", "roundtrip")
    srv = WatermarkServer(cfg, device="cpu", modes=modes)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(3)
        for p in srv.model.inn.parameters():
            if p.dim() == 4 and p.shape[-1] == 1:  # perturb the zero heads
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    ref = WatermarkServer(cfg, device="cpu", modes=modes, kernels=PLAIN,
                          weights=srv.model.states())
    clip = np.random.default_rng(4).integers(0, 256, (2, 4, 32, 32, 3),
                                             dtype=np.uint8)
    got, want = srv.serve(clip, "roundtrip"), ref.serve(clip, "roundtrip")
    np.testing.assert_array_equal(got.watermarked, want.watermarked)
    np.testing.assert_array_equal(got.mask_bits, want.mask_bits)
    np.testing.assert_array_equal(got.tamper_fraction, want.tamper_fraction)
    assert np.abs(got.watermarked.astype(int) - clip.astype(int)).max() > 0
    det = srv.serve(got.watermarked, "detect")
    np.testing.assert_array_equal(det.mask_bits, got.mask_bits)
    np.testing.assert_array_equal(det.tamper_fraction, got.tamper_fraction)
