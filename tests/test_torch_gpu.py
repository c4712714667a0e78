"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when no
card is present (decided at run time, never at import, so that every xdist
worker collects the same tests). Run on a machine with an H100:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: bf16 within one bf16 ulp relative (2⁻⁷·|plain|), f32 within
1e-5 relative (sums of the same terms in another order, one rounding);
the uint8 wire is exact; mask bits are exact except where the probability
is within 1e-6 of the threshold. K5 ``jpeg_pair`` agrees to 1e-4 except in
8×8 blocks where a coefficient within rounding of a .5 boundary rounded the
other way (its DCT sums in another order than ``torch.matmul``); those
blocks are counted and bounded. K6 ``median3`` is exact, forward and
backward (same codes, same summation order). K7 ``f1_sweep``'s counts are
exact (integer sums); K8 ``ssim`` is within ``ssim.ATOL`` (1e-5) on every
per-image mean and on the mean (separable window sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config
from vwfd_tpu_torch.attacks import quant_tables
from vwfd_tpu_torch.kernels import (PLAIN, coupling, f1, jpeg,
                                    launch_counts, mask, median,
                                    reset_launch_counts, ssim, transition,
                                    wire)
from vwfd_tpu_torch.metrics import DEFAULT_THRESHOLDS, threshold_level
from vwfd_tpu_torch.models.video_model import VideoWatermarkModel
from vwfd_tpu_torch.serving import WatermarkServer, unpack_mask_bits

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32


def _close(got, want):
    got, want = got.float(), want.float()
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-5
    scale = float(want.abs().max()) or 1.0
    err = (got - want).abs()
    bad = err > rtol * want.abs() + 1e-6 * scale
    assert not bool(bad.any()), float(err.max())


def _gen(seed=0):
    return torch.Generator("cuda").manual_seed(seed)


# the flagship's widths at small sizes, ragged tiles (widths that are no
# multiple of the block's column tile, an odd p2u group count) and widths
# that take the runtime-C path
_MAPS = [("entry", (2, 32, 32, 12)), ("p2p", (2, 8, 8, 192)),
         ("p2u", (2, 4, 4, 768)), ("entry", (3, 36, 44, 12)),
         ("p2p", (3, 10, 14, 48)), ("p2u", (3, 5, 7, 12)),
         ("entry", (1, 8, 12, 3)), ("p2p", (1, 4, 6, 20))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind,shape", _MAPS)
def test_transition_kernel_matches_plain(cuda, kind, shape, transpose, dtype):
    src = transition.out_shape(shape, kind) if transpose else shape
    x = torch.randn(src, device=cuda, generator=_gen()).to(dtype)
    y = transition.transition(x, kind, transpose)
    torch.cuda.synchronize()
    _close(y, transition.transition_plain(x, kind, transpose))
    if dtype == torch.float32:
        back = transition.transition(y, kind, not transpose)
        torch.testing.assert_close(back, x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_transition_p2u_is_its_own_transpose(cuda, dtype):
    x = torch.randn(2, 4, 4, 768, device=cuda, generator=_gen(5)).to(dtype)
    assert torch.equal(transition.transition(x, "p2u", transpose=True),
                       transition.transition(x, "p2u"))
    assert torch.equal(transition.transition_plain(x, "p2u", transpose=True),
                       transition.transition_plain(x, "p2u"))


# (N, H, W, channels of z): the flagship's level-48 packed coupling and its
# 768-channel ones, at row counts that are no multiple of the 64-row tile
_COUPLINGS = [(3, 9, 7, 192), (2, 5, 6, 768)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", _COUPLINGS)
def test_coupling_kernel_matches_plain(cuda, shape, inverse, dtype):
    g = _gen(1)
    n, hh, ww, cz = shape
    c = cz // 2
    z = torch.randn(shape, device=cuda, generator=g).to(dtype)
    h = torch.randn(n, hh, ww, 128, device=cuda, generator=g).to(dtype)
    k = c + 128
    p = {"wh": (torch.randn(cz, k, device=cuda, generator=g) / k ** 0.5
                ).to(dtype),
         "bh": 0.1 * torch.randn(cz, device=cuda, generator=g)}
    out = torch.zeros_like(z)
    ref = torch.zeros_like(z)
    before = launch_counts()["coupling_head"]
    coupling.coupling_head(z[..., c:], h, p, z[..., :c], out=out[..., :c],
                           inverse=inverse)
    assert launch_counts()["coupling_head"] == before + 1
    coupling.coupling_head_plain(z[..., c:], h, p, z[..., :c],
                                 out=ref[..., :c], inverse=inverse)
    torch.cuda.synchronize()
    _close(out, ref)
    assert bool((out[..., c:] == 0).all())


# (B, T, H, W, s): tiled rows (W·3 % 16 == 0; W = 48 leaves a ragged last
# pass of the block's threads), s = 4, and rows of W·3 % 16 != 0 that take
# the general path
_WIRE = [(2, 4, 16, 16, 2), (1, 4, 6, 48, 2), (1, 4, 8, 32, 4),
         (1, 4, 10, 40, 2), (2, 3, 6, 20, 2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,h,w,s", _WIRE)
def test_wire_kernels_are_exact(cuda, b, t, h, w, s, dtype):
    g = _gen(2)
    clip = torch.randint(0, 256, (b, t, h, w, 3), device=cuda, generator=g,
                         dtype=torch.uint8)
    tiles = wire.tiled(clip, w, t, 3 * t)
    assert tiles is ((3 * w) % 16 == 0)
    assert torch.equal(wire.to_channels(clip, dtype),
                       wire.to_channels_plain(clip, dtype))
    flat = clip.reshape(b * t, h, w, 3)
    assert torch.equal(wire.to_s2d(flat, s, dtype),
                       wire.to_s2d_plain(flat, s, dtype))
    x = torch.rand(b, h, w, 3 * t, device=cuda, generator=g) * 1.4 - 0.2
    n = min(x.numel(), 255)
    x.view(-1)[:n] = (torch.arange(n, device=cuda) + 0.5) / 255.0
    x = x.to(dtype)
    assert torch.equal(wire.to_u8(x, t), wire.to_u8_plain(x, t))
    before = launch_counts()["wire"]
    u8, xs = wire.to_u8_s2d(x, t, s)
    assert launch_counts()["wire"] == before + (1 if tiles else 2)
    u8_ref, xs_ref = wire.to_u8_s2d_plain(x, t, s)
    assert xs.dtype == dtype
    assert torch.equal(u8, u8_ref) and torch.equal(xs, xs_ref)


# widths whose staged rows come within the kernels' static tables of 48 KB:
# the launch must opt in to its dynamic shared memory
@pytest.mark.parametrize("name,w", [("to_channels", 4000), ("to_u8", 4000),
                                    ("to_s2d", 8000), ("to_u8_s2d", 1984)])
def test_wire_tiles_rows_at_the_shared_memory_limit(cuda, name, w):
    t, s, dtype = 4, 2, torch.bfloat16
    g = _gen(8)
    clip = torch.randint(0, 256, (1, t, 2, w, 3), device=cuda, generator=g,
                         dtype=torch.uint8)
    flat = clip.reshape(t, 2, w, 3)
    x = (torch.rand(1, 2, w, 3 * t, device=cuda, generator=g) * 1.4
         - 0.2).to(dtype)
    fn, plain, args, rows, channels = {
        "to_channels": (wire.to_channels, wire.to_channels_plain,
                        (clip, dtype), t, 3 * t),
        "to_u8": (wire.to_u8, wire.to_u8_plain, (x, t), t, 3 * t),
        "to_s2d": (wire.to_s2d, wire.to_s2d_plain, (flat, s, dtype), s,
                   3 * s * s),
        "to_u8_s2d": (wire.to_u8_s2d, wire.to_u8_s2d_plain, (x, t, s),
                      t * s, 3 * t),
    }[name]
    assert wire.tiled(args[0], w, rows, channels)
    assert rows * (3 * w + 16) > 46 * 1024
    before = launch_counts()["wire"]
    got = fn(*args)
    assert launch_counts()["wire"] == before + 1
    want = plain(*args)
    if name == "to_u8_s2d":
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("w", [32, 36, 256])
def test_mask_kernel_matches_plain(cuda, w, s, dtype):
    logits = torch.randn(8, 8, w // s, s * s, device=cuda, generator=_gen(3))
    logits.view(-1)[::5] = 0.0  # p == threshold exactly
    logits = logits.to(dtype)
    m, frac = mask.mask_pack(logits, 4, s, 0.5)
    m_ref, frac_ref = mask.mask_pack_plain(logits, 4, s, 0.5)
    torch.cuda.synchronize()
    if w % 8 == 0:
        m, m_ref = (unpack_mask_bits(t.cpu().numpy()) for t in (m, m_ref))
    else:
        m, m_ref = m.cpu().numpy(), m_ref.cpu().numpy()
    np.testing.assert_array_equal(m, m_ref)
    torch.testing.assert_close(frac, frac_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("s", [2, 4])
def test_mask_fraction_is_repeatable(cuda, s):
    """The tamper fraction is bit-identical over consecutive calls, also
    after a call of another shape in between: each launch leaves its
    tickets at 0 for the next."""
    g = _gen(6)
    big = torch.randn(64, 128 // s, 128 // s, s * s, device=cuda,
                      generator=g).to(torch.bfloat16)
    small = torch.randn(6, 24 // s, 32 // s, s * s, device=cuda, generator=g)
    first = mask.mask_pack(big, 4, s, 0.5)[1]
    again = mask.mask_pack(big, 4, s, 0.5)[1]
    mid = mask.mask_pack(small, 2, s, 0.5)[1]
    last = mask.mask_pack(big, 4, s, 0.5)[1]
    assert torch.equal(first, again) and torch.equal(first, last)
    assert torch.equal(mid, mask.mask_pack(small, 2, s, 0.5)[1])
    torch.testing.assert_close(first, mask.mask_pack_plain(big, 4, s, 0.5)[1],
                               rtol=0, atol=1e-5)


def test_mask_scratch_is_per_stream(cuda):
    """Calls on two streams at once keep their own tickets and partials:
    each fraction equals the one from the default stream."""
    g = _gen(7)
    clips = [torch.randn(64, 64, 64, 4, device=cuda, generator=g).to(
        torch.bfloat16) for _ in range(2)]
    want = [mask.mask_pack(z, 4, 2, 0.5)[1] for z in clips]
    streams = [torch.cuda.Stream(cuda) for _ in clips]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(8):
        for k, (st, z) in enumerate(zip(streams, clips)):
            with torch.cuda.stream(st):
                got[k].append(mask.mask_pack(z, 4, 2, 0.5)[1])
    torch.cuda.synchronize()
    for k in range(2):
        assert all(torch.equal(f, want[k]) for f in got[k])


def test_server_on_card_matches_plain_and_counts_launches(cuda):
    """A small flagship server on the card: one roundtrip launches K1 ×6,
    K2 (``coupling_head``) ×10, K3 ×2 (``to_channels`` and the one-pass
    ``to_u8_s2d``), K4 ×1, and agrees with the same server through the
    plain versions (f32)."""
    cfg = load_config(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, gt_size=64),
        train=dataclasses.replace(cfg.train, dtype="float32"))
    modes = ("roundtrip",)
    srv = WatermarkServer(cfg, modes=modes)
    with torch.no_grad():
        for p in srv.model.inn.parameters():
            if p.dim() == 4 and p.shape[-1] == 1:  # perturb the zero heads
                p.add_(0.05 * torch.randn(p.shape, device=cuda,
                                          generator=_gen(4)))
    ref = WatermarkServer(cfg, modes=modes, kernels=PLAIN,
                          weights=srv.model.states())
    clip = np.random.default_rng(0).integers(0, 256, (2, 4, 64, 64, 3),
                                             dtype=np.uint8)
    reset_launch_counts()
    got = srv.serve(clip, "roundtrip")
    got.prefetch()
    torch.cuda.synchronize()
    assert launch_counts() == {"transition": 6, "coupling_head": 10,
                               "wire": 2, "mask_pack": 1, "jpeg_pair": 0,
                               "median3": 0, "f1_sweep": 0, "ssim": 0}
    want = ref.serve(clip, "roundtrip")
    assert launch_counts()["transition"] == 6  # the plain server launches none
    diff = np.abs(got.watermarked.astype(int) - want.watermarked.astype(int))
    assert diff.max() <= 1
    assert (unpack_mask_bits(got.mask_bits)
            != unpack_mask_bits(want.mask_bits)).mean() < 1e-3
    np.testing.assert_allclose(got.tamper_fraction, want.tamper_fraction,
                               atol=1e-4)


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def _flipped_blocks(got, want, atol):
    """8×8 blocks (all channels) of NHWC frames where |got − want| > atol
    somewhere, and the number of blocks."""
    n, h, w, c = got.shape
    d = (got - want).abs().reshape(n, h // 8, 8, w // 8, 8, c)
    bad = d.amax(dim=(2, 4, 5)) > atol
    return int(bad.sum()), bad.numel()


def _jpeg_draws(n, device, seed):
    """Quality indices and modes covering every (quality, mode) pair."""
    g = torch.Generator().manual_seed(seed)
    pairs = torch.arange(2 * n) % 15
    q_idx = (pairs % 5).view(n, 2)
    mode = (pairs // 5).view(n, 2).to(torch.int32)
    w = torch.softmax(torch.randn(n, 5, generator=g), -1)[:, 1:3]
    return (quant_tables(q_idx).contiguous().to(device),
            mode.contiguous().to(device), w.contiguous().to(device))


# (N, H, W): 40 = 5 blocks (a unit holds 32), a square frame, 264 = one
# unit of 32 blocks and a ragged one of 1, and a single frame
@pytest.mark.parametrize("shape", [(8, 32, 40), (8, 64, 64), (2, 16, 264),
                                   (1, 24, 48)])
def test_jpeg_pair_kernel_matches_plain(cuda, shape):
    n, h, w = shape
    g = _gen(9)
    x = torch.rand(n, h, w, 3, device=cuda, generator=g)
    x = torch.round(x * 255) / 255  # attack inputs are 8-bit levels
    qt, mode, wts = _jpeg_draws(n, cuda, 9)
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    before = launch_counts()["jpeg_pair"]
    yk = jpeg.jpeg_pair(xk, qt, mode, wts)
    yp = jpeg.jpeg_pool_pair_plain(xp, qt, mode, wts)
    cot = torch.randn(yk.shape, device=cuda, generator=g)
    (gk,) = torch.autograd.grad(yk, xk, cot)
    (gp,) = torch.autograd.grad(yp, xp, cot)
    torch.cuda.synchronize()
    assert launch_counts()["jpeg_pair"] == before + 2
    bad, blocks = _flipped_blocks(yk, yp, 1e-4)
    assert bad <= max(1, blocks // 1000), (bad, blocks)
    assert float((yk - yp).detach().abs().max()) < 1.0
    gbad, _ = _flipped_blocks(gk, gp, 1e-4 * float(gp.abs().max()))
    assert gbad <= max(1, blocks // 1000), (gbad, blocks)


# (N, H, W): ragged tiles off the 16-byte grid (W % 4 != 0), whole 32×32
# tiles, frames over several tiles with ragged last ones (130: scalar
# path; 100: 16-byte path with a ragged right tile), a single frame
@pytest.mark.parametrize("shape", [(3, 20, 45), (2, 64, 64), (2, 67, 130),
                                   (1, 33, 100)])
def test_median3_kernel_is_exact(cuda, shape):
    n, h, w = shape
    g = _gen(10)
    x = torch.randint(0, 8, (n, h, w, 3), device=cuda, generator=g) / 255.0
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    before = launch_counts()["median3"]
    yk = median.median3(xk)
    yp = median.median3_plain(xp)
    cot = torch.randn(yk.shape, device=cuda, generator=g)
    (gk,) = torch.autograd.grad(yk, xk, cot)
    (gp,) = torch.autograd.grad(yp, xp, cot)
    torch.cuda.synchronize()
    assert launch_counts()["median3"] == before + 2
    assert torch.equal(yk, yp)
    assert torch.equal(gk, gp)


@pytest.mark.parametrize("shape", [(2, 16, 20), (2, 40, 72)])
def test_median3_kernel_propagates_nan_as_plain(cuda, shape):
    """NaN pixels: the kernel's NaN outputs fall where the plain version's
    do (NaN-propagating min/max in the same network), every other value is
    equal, and an output whose median is NaN routes its cotangent nowhere
    in both, so the input gradients are equal."""
    n, h, w = shape
    g = _gen(12)
    x = torch.randint(0, 8, (n, h, w, 3), device=cuda, generator=g) / 255.0
    x.view(-1)[torch.randperm(x.numel(), device=cuda, generator=g)[:3]] = \
        float("nan")
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    yk = median.median3(xk)
    yp = median.median3_plain(xp)
    cot = torch.randn(yk.shape, device=cuda, generator=g)
    (gk,) = torch.autograd.grad(yk, xk, cot)
    (gp,) = torch.autograd.grad(yp, xp, cot)
    torch.cuda.synchronize()
    nan = torch.isnan(yp)
    assert bool(nan.any())
    assert torch.equal(torch.isnan(yk), nan)
    assert torch.equal(yk[~nan], yp[~nan])
    assert torch.equal(gk, gp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,shape", _MAPS[:3])
def test_transition_autograd_is_the_flipped_kernel(cuda, kind, shape, dtype):
    x = torch.randn(shape, device=cuda, generator=_gen(11)).to(dtype)
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    before = launch_counts()["transition"]
    yk = transition.transition(xk, kind)
    cot = torch.randn(yk.shape, device=cuda, generator=_gen(12)).to(dtype)
    (gk,) = torch.autograd.grad(yk, xk, cot)
    assert launch_counts()["transition"] == before + 2
    (gp,) = torch.autograd.grad(transition.transition_plain(xp, kind), xp,
                                cot)
    torch.cuda.synchronize()
    _close(gk, gp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", _COUPLINGS)
def test_coupling_head_autograd_matches_plain(cuda, shape, dtype):
    g = _gen(13)
    n, hh, ww, cz = shape
    c = cz // 2
    z = torch.randn(shape, device=cuda, generator=g).to(dtype)
    h = torch.randn(n, hh, ww, 128, device=cuda, generator=g).to(dtype)
    wh = (torch.randn(cz, c + 128, device=cuda, generator=g)
          / (c + 128) ** 0.5).to(dtype)
    bh = 0.1 * torch.randn(cz, device=cuda, generator=g)
    cot = torch.randn(n, hh, ww, c, device=cuda, generator=g).to(dtype)
    grads = []
    for fn in (coupling.coupling_head, coupling.coupling_head_plain):
        leaves = [t.clone().requires_grad_(True) for t in (z, h, wh, bh)]
        zz, hl, whl, bhl = leaves
        out = fn(zz[..., c:], hl, {"wh": whl, "bh": bhl}, zz[..., :c])
        grads.append(torch.autograd.grad(out, leaves, cot))
    torch.cuda.synchronize()
    for gk, gp in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(gk, gp, rtol=1e-4,
                                       atol=1e-5 * float(gp.abs().max()))
        else:
            assert _cos(gk, gp) > 0.999


def test_train_step_kernels_match_plain(cuda):
    """One bf16 step of the flagship model at 64² through KERNELS and
    PLAIN from the same weights, batch and draws: loss terms within 1e-2
    relative, each net's gradient with cosine ≥ 0.999; the kernel step
    launches K1 ×11 (six maps forward, five backward: the entry map's
    input, the clip, takes no gradient), K2 ×10, K5 ×2, K6 ×2."""
    cfg = load_config(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, gt_size=64))
    km = VideoWatermarkModel(cfg)
    km.init_states(3)
    with torch.no_grad():
        for p in km.inn.parameters():
            if p.dim() == 4 and p.shape[-1] == 1:  # perturb the zero heads
                p.add_(5e-4 * torch.randn(p.shape, device=cuda,
                                          generator=_gen(14)))
    pm = VideoWatermarkModel(cfg, kernels=PLAIN)
    pm.load_states(km.states())
    rng = np.random.default_rng(0)
    video = rng.random((2, 4, 64, 64, 3), dtype=np.float32)
    prev = rng.random((2, 4, 64, 64, 3), dtype=np.float32)
    mask = (rng.random((2, 4, 64, 64, 1)) < 0.2).astype(np.float32)
    draws = km.sample_draws(2, 4)
    reset_launch_counts()
    lk, ak, gk, _ = km.loss_and_grads(video, mask, prev, draws)
    torch.cuda.synchronize()
    assert launch_counts() == {"transition": 11, "coupling_head": 10,
                               "wire": 0, "mask_pack": 0, "jpeg_pair": 2,
                               "median3": 2, "f1_sweep": 0, "ssim": 0}
    lp, ap, gp, _ = pm.loss_and_grads(video, mask, prev, draws)
    for a, b in ((lk, lp), (ak["lF"], ap["lF"]), (ak["lB"], ap["lB"])):
        assert abs(float(a) - float(b)) <= 1e-2 * abs(float(b))
    for net in ("netG", "generator"):
        flat_k = torch.cat([t.flatten() for t in gk[net]])
        flat_p = torch.cat([t.flatten() for t in gp[net]])
        assert _cos(flat_k, flat_p) >= 0.999, net


_LEVELS = [threshold_level(t) for t in np.float32(DEFAULT_THRESHOLDS)]


# (shape, element offset): 16-byte vectors with a tail, an odd size, a
# base off the 16-byte grid (the scalar path)
@pytest.mark.parametrize("shape,offset", [((2, 4, 32, 33, 1), 0),
                                          ((3, 5, 7), 0), ((4097,), 1)])
def test_f1_sweep_kernel_counts_equal_plain(cuda, shape, offset):
    g = _gen(15)
    n = int(np.prod(shape))
    base = torch.rand(n + offset, device=cuda, generator=g)
    k = torch.arange(256, device=cuda) / 255.0
    m = min(n, 256)
    base[offset:offset + m] = k[:m]  # every k/255 boundary
    base[offset + n // 2] = float("nan")
    pred = base[offset:].view(shape)
    gt = (torch.rand(shape, device=cuda, generator=g) < 0.3).float()
    gt.view(-1)[-1] = float("nan")
    for levels in (_LEVELS, list(range(0, 256, 16))):
        before = launch_counts()["f1_sweep"]
        got = f1.f1_sweep(pred, gt, levels)
        assert launch_counts()["f1_sweep"] == before + 1
        want = f1.f1_sweep_plain(pred, gt, levels)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64 and torch.equal(got, want)


# (N, H, W): whole 32×32 tiles on the 16-byte path, ragged tiles with
# W % 4 != 0 (scalar staging), ragged tiles with W % 4 == 0, a frame
# narrower than the halo
@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 37, 45), (1, 40, 52),
                                   (2, 31, 8)])
def test_ssim_kernel_matches_plain(cuda, shape):
    g = _gen(16)
    x = torch.rand(*shape, 3, device=cuda, generator=g)
    y = (x + 0.05 * torch.randn(x.shape, device=cuda, generator=g)).clamp(0, 1)
    y[:, :10, :10] = x[:, :10, :10] = 0.5  # a flat patch: σ² cancels
    before = launch_counts()["ssim"]
    means, mean = ssim.ssim(x, y)
    assert launch_counts()["ssim"] == before + 1
    pmeans, pmean = ssim.ssim_plain(x, y)
    torch.cuda.synchronize()
    torch.testing.assert_close(means, pmeans, rtol=0, atol=ssim.ATOL)
    torch.testing.assert_close(mean, pmean, rtol=0, atol=ssim.ATOL)
    again = ssim.ssim(x, y)
    assert torch.equal(again[0], means) and torch.equal(again[1], mean)


def test_eval_step_kernels_match_plain(cuda):
    """One bf16 eval step of the flagship model at 64² through KERNELS and
    PLAIN from the same weights, batch and draws: it launches K1 ×6, K2
    ×10, K5 ×1, K6 ×1, K7 ×1, K8 ×1; PSNR within 0.01 dB, SSIM within
    1e-4 and each F1 within 0.05 (64² frames: a pixel that crosses a level
    between the paths moves an F1 by about 1e-4)."""
    cfg = load_config(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, gt_size=64))
    km = VideoWatermarkModel(cfg)
    km.init_states(3)
    with torch.no_grad():
        for p in km.inn.parameters():
            if p.dim() == 4 and p.shape[-1] == 1:  # perturb the zero heads
                p.add_(5e-4 * torch.randn(p.shape, device=cuda,
                                          generator=_gen(17)))
    pm = VideoWatermarkModel(cfg, kernels=PLAIN)
    pm.load_states(km.states())
    rng = np.random.default_rng(1)
    video = rng.random((2, 4, 64, 64, 3), dtype=np.float32)
    prev = rng.random((2, 4, 64, 64, 3), dtype=np.float32)
    mask = (rng.random((2, 4, 64, 64, 1)) < 0.2).astype(np.float32)
    draws = km.sample_draws(2, 4)
    reset_launch_counts()
    ok = km.eval_step(video, mask, prev, draws)
    torch.cuda.synchronize()
    assert launch_counts() == {"transition": 6, "coupling_head": 10,
                               "wire": 0, "mask_pack": 0, "jpeg_pair": 1,
                               "median3": 1, "f1_sweep": 1, "ssim": 1}
    op = pm.eval_step(video, mask, prev, draws)
    assert abs(float(ok["psnr_forward"]) - float(op["psnr_forward"])) <= 0.01
    assert abs(float(ok["ssim_forward"]) - float(op["ssim_forward"])) <= 1e-4
    torch.testing.assert_close(ok["f1_sweep"], op["f1_sweep"], rtol=0,
                               atol=0.05)
