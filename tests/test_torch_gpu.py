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
K9 ``attack_mix`` and K10 ``splice`` forwards are EQUAL to their plain
versions (every operation one IEEE rounding in the plain order); their
backwards within 1e-6 of the plain gradient's max (K9's blur sums the nine
products in another order than autograd; the rest is exact). K11 ``qconv``,
K12 ``qconv_t``, K13 ``qcoupling_head`` and K3's int8 stem are EQUAL to
their plain versions (exact int32 sums, the epilogues one IEEE rounding
per operation in the plain order). K14 ``haar`` is EQUAL to its plain
version (the same four-term sums, one rounding). K15 ``coupling_affine``'s
forward is within one ulp of its plain version (``expf`` of the two
libraries may differ in the last place), its gradients within 1e-6 of the
plain gradient's max in f32 and one bf16 ulp relative in bf16 (autograd
rounds the same f32 values in another order). K2 on down_num 4's
3072-channel head in bf16 (W streamed through the ring beside A) is held
as K2's other shapes are. K16 ``zigzag_jpeg``'s forward is within 2e-6 of
its plain version (the DCT sums in another order than ``torch.matmul``)
and its gradient within 1e-6 of the plain max, and on a block whose z is
exactly 0 its gradient is exactly ½ of the unclipped one (``jnp.clip``'s
tie); K17
``crop_resize``'s forward is EQUAL to its plain version (each tap one IEEE
rounding in the plain order) and its gradient within 1e-6 of the plain max
(autograd's scatter-adds sum in another order), on rows off the 16-byte
grid, to another output size and past the whole-row width limit on column
tiles (F22: one pixel past it, twice it and 3840 × 2160); K16 on a view off
the 16-byte grid too (the wrapper copies it onto the grid). MBRS:
``jpeg_basic`` through K5 (weights (1, 0)) at its train shape as K5's
tolerance allows, and one MBRS train step per noise mode through the
kernels against ``PLAIN`` (loss terms within 1e-5 relative, gradient
cosines ≥ 0.9999; K5 ×0, ×1, ×2). With NaN and Inf pixels and a NaN
cotangent, K16's and K17's outputs and gradients are NaN (and ±Inf) where
their plain versions' are, and within those tolerances elsewhere. K18
``window_attention`` on the map: its forward, dqkv and table gradient
are within 1e-5 of the plain tensor's max-abs (3×TF32 products and
float32 sums in another order than the plain version's einsums) at
SUNet's four stage shapes of 256² b8 (shifted and not), N = 16, 25 and
49, d = 16 and 64, and a non-square map whose shift wraps both edges; its
outputs are bit-identical over two calls (no float atomics); a NaN and an
Inf in q give NaN where the plain version has it; it raises on a window
past 8, d outside {16, 32, 64} or windows that do not tile the map. K3 and K4 at s = 4 in a server (``extractor_s2d`` 4): a roundtrip
with K3 ×2 and K4 ×1 against the plain server, mask bits EQUAL but within
1e-6 of the threshold. K19 ``canny_soft``: its forward within 1e-6 of the
plain version and its input gradient within 1e-5 of the plain max (the
plain version with ``exact_border``, F24), on 8-bit, continuous and flat
images (every pixel tied at the max), ragged shapes (one past its 32 × 90
tile, 3 × 3, 300 × 5), the image step's (48, 256, 256, 3) and the
PAMI-512 record's (9, 512, 512, 3); NaN where the plain version has NaN
with NaN and Inf pixels and a NaN cotangent; one forward and one backward
launch; the same bits over calls; a forward that keeps y and a few KB, a
backward whose peak is dx, two planes and its slots. K14 and
K15 at the image INN's shapes (4 → 16 → 64 → 256 channels) as above.
K20 ``crop_cubic``'s forward is EQUAL to its plain version (the weights'
FMAs and every product and sum in the plain order) and its gradient within
1e-5 of the plain max (the transpose sums up to 4·OH terms an input in
another order than autograd's atomic index_adds), bit-identical over
calls, NaN where the plain version's is, at CLR's shapes, column tiles
(3840 and 20000 wide, 2160 × 3840), downsampling and upsampling
``out_hw``, a window narrow enough for more column terms than a pixel
lists, 1 and 4 channels; one launch each way, nothing allocated beyond y
and gx; K21 ``rectify`` EQUAL forward,
its backward kernel's gradient into the clean images within 1e-6 of the
plain max, both bit-identical over calls, one launch each way, NaN where
the plain version's is (an attacked pixel forward, a cotangent outside
the window backward); K22 ``ssim_grad`` within ``ssim_grad.RTOL`` (1e-3)
of the plain gradient's max (separable window sums, and σ² = E[x²] − μ²
cancels in flat windows), bit-identical over calls, one launch that
allocates nothing but dx, and ``metrics.ssim`` under autograd launches
K8 forward and K22 backward. A small CLR step through ``KERNELS`` against
``PLAIN`` (loss terms within 1e-5 relative, gradient cosines ≥ 0.9999)
with K20 ×2, K21 ×2, K8 ×1, K22 ×1 and K19 ×2. K23 ``film_residual``: its
forward and gh EQUAL to the plain version (each product and sum one IEEE
rounding in the plain order), gx the cotangent itself, gγ and gβ within
1e-5 of the plain Σ|g·h| and Σ|g| of their plane (sums in another order),
at KD-JPEG's three up levels, the simulator's three at 512² b3 and a
ragged plane; bit-identical over calls; equal with γ and β frozen (no
sums); a CUDA tensor of another dtype raises. A small KD-JPEG step through
``KERNELS`` against ``PLAIN`` (logs within 1e-5 relative, PSSIMU within
1e-3 dB, gradient cosines ≥ 0.9999) with K23 ×12 at ``nb`` 2 (one
generator forward and its backward) and nothing else.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vwfd_tpu_torch import FLAGSHIP_CONFIG, load_config
from vwfd_tpu_torch.attacks import quant_tables
from vwfd_tpu_torch.kernels import (KERNELS, PLAIN, affine, canny, coupling,
                                    crop_cubic, crop_resize, f1, film, haar,
                                    jpeg, launch_counts, mask, median,
                                    mix, qconv, qconv_t, qcoupling, rectify,
                                    reset_launch_counts, splice, ssim,
                                    ssim_grad, transition, window_attention,
                                    wire, zigzag)
from vwfd_tpu_torch.ops.quantize import ste_quantize_255
from vwfd_tpu_torch.metrics import DEFAULT_THRESHOLDS, threshold_level
from vwfd_tpu_torch.models.video_model import VideoWatermarkModel
from vwfd_tpu_torch.serving import WatermarkServer, unpack_mask_bits

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]
# the counts of the int8 kernels and of the INN module path's K14/K15 on a
# path that runs none of them
_NO_INT8 = {"zigzag_jpeg": 0, "crop_resize": 0, "qconv": 0, "qconv_t": 0,
            "qcoupling_head": 0, "haar": 0,
            "coupling_affine": 0, "window_attention": 0, "canny_soft": 0,
            "crop_cubic": 0, "rectify": 0, "ssim_grad": 0,
            "film_residual": 0, "diffjpeg": 0}


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
# 768-channel ones, at row counts that are no multiple of the 64-row tile,
# and down_num 4's 3072-channel head (K = 1664: in bf16 its W column slice
# does not fit shared memory and streams through the ring, F20)
_COUPLINGS = [(3, 9, 7, 192), (2, 5, 6, 768), (2, 5, 6, 3072)]


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
                               "median3": 0, "f1_sweep": 0, "ssim": 0,
                               "attack_mix": 0, "splice": 0, **_NO_INT8}
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
    input, the clip, takes no gradient), K2 ×10, K5 ×2, K6 ×2, K9 ×2 and
    K10 ×2; its forward alone K9 and K10 once each."""
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
    with torch.no_grad():
        km._loss(*km.to_device(video, mask, prev), draws)
    assert {k: launch_counts()[k] for k in ("attack_mix", "splice")} == {
        "attack_mix": 1, "splice": 1}
    reset_launch_counts()
    lk, ak, gk, _ = km.loss_and_grads(video, mask, prev, draws)
    torch.cuda.synchronize()
    assert launch_counts() == {"transition": 11, "coupling_head": 10,
                               "wire": 0, "mask_pack": 0, "jpeg_pair": 2,
                               "median3": 2, "f1_sweep": 0, "ssim": 0,
                               "attack_mix": 2, "splice": 2,
                               **_NO_INT8}
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


# each compiled level count (9, the generic 16, which also takes 1 and 5
# levels) with unsorted, duplicate and out-of-range levels
_LEVEL_SETS = [[127.0], [204.0, 25.0, 127.0, 127.0, -1.0], _LEVELS,
               [229.0, 0.0, 255.0, 51.0, 76.0, 300.0, 102.0, 153.0, 178.0,
                25.0, 25.0, 127.5, 204.0, -0.5, 254.0, 128.0]]


def _f1_inputs(n, g, offset=1):
    """``n`` predictions one float off the 16-byte grid holding every
    k/255, its float32 neighbours, values outside [0, 1] and NaN, and a
    mask with a NaN pixel."""
    base = torch.rand(n + offset, device="cuda", generator=g) * 1.4 - 0.2
    k = torch.arange(256, device="cuda") / 255.0
    special = torch.cat([k, torch.nextafter(k, torch.full_like(k, 2.0)),
                         torch.nextafter(k, torch.full_like(k, -1.0)),
                         torch.tensor([float("nan"), float("inf"), -3.0],
                                      device="cuda")])
    idx = torch.randperm(n, device="cuda", generator=g)[:special.numel()]
    pred = base[offset:]
    pred[idx] = special[:idx.numel()]
    gt = (torch.rand(n, device="cuda", generator=g) < 0.3).float()
    gt[n // 2] = float("nan")
    return pred, gt


@pytest.mark.parametrize("n", [1, 3, 4 * 1000 + 1, 100_003])
@pytest.mark.parametrize("levels", _LEVEL_SETS,
                         ids=lambda lv: f"{len(lv)}levels")
def test_f1_sweep_kernel_level_sets_equal_plain(cuda, levels, n):
    pred, gt = _f1_inputs(n, _gen(18))
    got = f1.f1_sweep(pred, gt, levels)
    torch.cuda.synchronize()
    assert torch.equal(got, f1.f1_sweep_plain(pred, gt, levels))


def test_f1_sweep_and_ssim_repeat_on_a_second_stream(cuda):
    """Two calls in a row and one on another stream give the same counts
    and means bit for bit: each kernel's last block leaves its ticket at 0,
    and each stream has its own scratch."""
    g = _gen(19)
    pred, gt = _f1_inputs(64 * 64 * 9 + 5, g, offset=0)
    x = torch.rand(3, 70, 90, 3, device=cuda, generator=g)
    y = (x + 0.05 * torch.randn(x.shape, device=cuda, generator=g)).clamp(0, 1)
    runs = [(f1.f1_sweep(pred, gt, _LEVELS), ssim.ssim(x, y))
            for _ in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs.append((f1.f1_sweep(pred, gt, _LEVELS), ssim.ssim(x, y)))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    counts, (means, mean) = runs[0]
    assert torch.equal(counts, f1.f1_sweep_plain(pred, gt, _LEVELS))
    for c, (m, mm) in runs[1:]:
        assert torch.equal(c, counts)
        assert torch.equal(m, means) and torch.equal(mm, mean)


def test_ssim_kernel_nan_pixel_gives_nan_means_as_plain(cuda):
    g = _gen(20)
    x = torch.rand(3, 30, 40, 3, device=cuda, generator=g)
    y = torch.rand(3, 30, 40, 3, device=cuda, generator=g)
    x[1, 12, 7, 2] = float("nan")
    means, mean = ssim.ssim(x, y)
    pmeans, _ = ssim.ssim_plain(x, y)
    torch.cuda.synchronize()
    assert torch.equal(means.isnan(), pmeans.isnan())
    assert bool(means.isnan()[1]) and bool(mean.isnan())
    torch.testing.assert_close(means[[0, 2]], pmeans[[0, 2]], rtol=0,
                               atol=ssim.ATOL)


# (N, H, W): whole 64-column strips, ragged strips (W % 4 != 0), ragged
# strips with W % 4 == 0, a frame narrower than the halo, one window, a
# frame shorter than the halo, and the flagship eval shape
@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 37, 45), (1, 40, 52),
                                   (2, 31, 8), (1, 11, 11), (2, 5, 300),
                                   (64, 256, 256)])
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
    ×10, K5 ×1, K6 ×1, K7 ×1, K8 ×1, K9 ×1, K10 ×1; PSNR within 0.01 dB,
    SSIM within
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
                               "median3": 1, "f1_sweep": 1, "ssim": 1,
                               "attack_mix": 1, "splice": 1, **_NO_INT8}
    op = pm.eval_step(video, mask, prev, draws)
    assert abs(float(ok["psnr_forward"]) - float(op["psnr_forward"])) <= 0.01
    assert abs(float(ok["ssim_forward"]) - float(op["ssim_forward"])) <= 1e-4
    torch.testing.assert_close(ok["f1_sweep"], op["f1_sweep"], rtol=0,
                               atol=0.05)


def _ties(shape, g, lo=-0.2, hi=1.2):
    """Values in [lo, hi) with a quarter of them exact (k + 0.5)/255 ties
    of the quantizer and some exactly 0 and 1."""
    x = lo + (hi - lo) * torch.rand(shape, device="cuda", generator=g)
    k = torch.randint(0, 255, shape, device="cuda", generator=g)
    tie = (k.float() + 0.5) / 255.0
    pick = torch.rand(shape, device="cuda", generator=g)
    x = torch.where(pick < 0.25, tie, x)
    return torch.where(pick > 0.97, (pick > 0.985).float(), x)


def _within(got, want, rel=1e-6):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= rel * scale


# (N, H, W): 16-byte rows; rows off the 16-byte grid (W % 4 != 0, the
# scalar path); a single row; a single column
@pytest.mark.parametrize("shape", [(8, 32, 40), (4, 17, 45), (3, 1, 12),
                                   (2, 9, 1)])
@pytest.mark.parametrize("epilogue", mix.EPILOGUES)
def test_attack_mix_kernel_matches_plain(cuda, shape, epilogue):
    """K9 forward EQUAL to the plain version with each epilogue, on inputs
    outside [0, 1] and, in half the frames (α0 = α3 = α4 = 0, x = 0: the
    output is a_jpeg itself), on exact quantizer ties; gradients of x, a0,
    a_jpeg and a3 within 1e-6 of the plain version's max."""
    n, h, w = shape
    g = _gen(21)
    x, a0, aj, a3 = (_ties((n, h, w, 3), g) for _ in range(4))
    alpha = torch.softmax(torch.randn(n, 5, device=cuda, generator=g), -1)
    half = torch.arange(n, device=cuda) >= n // 2
    alpha[half] = alpha[half] * torch.tensor([0.0, 1, 1, 0, 0], device=cuda)
    x[half] = 0.0
    cot = torch.randn((n, h, w, 3), device=cuda, generator=g)
    outs = []
    for fn in (mix.attack_mix, mix.attack_mix_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, a0, aj, a3)]
        y = fn(*ins, alpha, epilogue)
        outs.append((y.detach(), torch.autograd.grad(y, ins, cot)))
    torch.cuda.synchronize()
    (yk, gk), (yp, gp) = outs
    assert torch.equal(yk, yp)
    for a, b in zip(gk, gp):
        _within(a, b)
    assert torch.equal(gk[1], gp[1]) and torch.equal(gk[3], gp[3])


@pytest.mark.parametrize("dtype", DTYPES)
# (B, T, H, W): the flagship's 4 frames; rows off the 16-byte grid; rows
# over two 64-pixel chunks with a ragged second; a single frame
@pytest.mark.parametrize("shape", [(2, 4, 16, 24), (1, 3, 7, 13),
                                   (2, 2, 5, 70), (1, 1, 4, 8)])
def test_splice_kernel_matches_plain(cuda, shape, dtype):
    """K10: ``fwd_video`` and ``attacked_fwd`` EQUAL to the plain version's
    (INN output outside [0, 1] with exact quantizer ties, a mask of 0/1
    edges and soft values), the gradient of the INN output too; and the
    embed's form (no mask) equal."""
    b, t, h, w = shape
    g = _gen(22)
    x = _ties((b, h, w, 3 * t), g).to(dtype)
    m = (torch.rand((b, t, h, w, 1), device=cuda, generator=g) < 0.3).float()
    m[..., :2, :] = 0.37  # soft mask values in two columns
    prev = torch.rand((b, t, h, w, 3), device=cuda, generator=g)
    gf, ga = (torch.randn((b, t, h, w, 3), device=cuda, generator=g)
              for _ in range(2))
    outs = []
    for fn in (splice.splice, splice.splice_plain):
        xi = x.clone().requires_grad_(True)
        fv, att = fn(xi, t, m, prev)
        (gx,) = torch.autograd.grad((fv, att), xi, (gf, ga))
        outs.append((fv.detach(), att.detach(), gx, fn(x, t)))
    torch.cuda.synchronize()
    (fk, ak, gk, ek), (fp, ap, gp, ep) = outs
    assert torch.equal(fk, fp) and torch.equal(ak, ap) and torch.equal(ek, ep)
    assert gk.dtype == dtype and gk.shape == x.shape
    _within(gk.float(), gp.float())


def test_ste_quantize_divides_by_255_on_the_card(cuda):
    """The straight-through quantizer on a CUDA tensor is the IEEE x / 255
    of every level (PyTorch's CUDA division by a Python scalar multiplies
    by the reciprocal instead, one ulp off for 126 of 256 levels: F14)."""
    k = torch.arange(256, dtype=torch.float32)
    want = (k.numpy() / np.float32(255)).astype(np.float32)
    got = ste_quantize_255((k / 255.0 + 1e-4).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- int8 (K11, K12, K13, stem)


def _i8(g, shape, lo=-127):
    return torch.randint(lo, 128, shape, device="cuda", generator=g,
                         dtype=torch.int8)


def _qscale(g, n, k, spread):
    """Per-channel multipliers that put float(acc)·m near ±spread."""
    base = spread / (5376.0 * k ** 0.5)  # std of a sum of k int8 products
    return (base * (0.5 + torch.rand(n, device="cuda", generator=g))).float()


# (N, H, W, Cin, Cout, k, epilogue, pool, dual Cin, float input dtype):
# enc1's Cin 12, ragged H/W and Cout, the pool prologue on an odd input,
# the dual epilogue, signed, ELU with int8 / bf16 / f32 inputs, the head
_QCONVS = [(2, 13, 21, 12, 64, 3, "relu", False, 0, None),
           (2, 9, 17, 64, 96, 3, "relu", True, 0, None),
           (2, 8, 8, 64, 40, 3, "relu", False, 32, None),
           (1, 7, 9, 32, 70, 3, "signed", False, 0, None),
           (2, 16, 16, 96, 128, 3, "elu", False, 0, torch.bfloat16),
           (2, 8, 8, 128, 128, 3, "elu", False, 0, None),
           (2, 10, 12, 40, 72, 3, "elu", False, 0, torch.float32),
           (2, 16, 16, 64, 4, 1, "f32", False, 0, None),
           (3, 5, 6, 20, 24, 1, "relu", False, 0, None)]


@pytest.mark.parametrize("case", _QCONVS)
def test_qconv_kernel_equals_plain(cuda, case):
    n, h, w, cin, cout, k, epi, pool, cin2, xdt = case
    g = _gen(31)
    hin, win = (2 * h + 1, 2 * w + 1) if pool else (h, w)
    kw = {}
    if xdt is None:
        x = _i8(g, (n, hin, win, cin), lo=0 if pool else -127)
    else:  # a channel slice, as the INN trunk reads its coupling half
        full = torch.randn((n, h, w, 2 * cin), device=cuda, generator=g)
        x = full.to(xdt)[..., cin:]
        kw["x_scale"] = torch.tensor(0.02, device=cuda)
    wt = _i8(g, (cout, k, k, cin))
    m = _qscale(g, cout, k * k * cin, 1.0 if epi == "elu" else 80.0)
    b = torch.randn(cout, device=cuda, generator=g)
    if epi == "elu":
        kw["out_scale"] = torch.tensor(0.015, device=cuda)
    if cin2:
        kw.update(x2=_i8(g, (n, h, w, cin2), lo=0), w2=_i8(g, (cout, k, k,
                                                                cin2)),
                  m2=_qscale(g, cout, k * k * cin2, 80.0))
    before = launch_counts()["qconv"]
    got = qconv.qconv(x, wt, m, b, epi, pool=pool, **kw)
    assert launch_counts()["qconv"] == before + 1
    want = qconv.qconv_plain(x, wt, m, b, epi, pool=pool, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape == (
        n, h, w, cout)
    assert torch.equal(got, want), int((got != want).sum())
    if epi != "f32":  # the epilogue reaches its clip bounds
        assert int(want.max()) == 127
        if epi == "elu":  # ELU ≥ −1: levels down to about −1/0.015
            assert int(want.min()) < -60
        else:
            assert int(want.min()) == (0 if epi == "relu" else -127)


# (N, h, w, Cin, Cout): ragged tiles (16-byte stores); up3's 4 resident
# stages (TMA stores); Cin off the 16-byte grid with BN 64 and Cout % 8 != 0
# (byte stores); an up1-shaped launch (h 64, Cin 128, one stage); 16-row
# tiles across images of h = w = 8 with up4's 8 streamed stages; Cin 40 by
# cp.async with Cout 20 % 8 != 0; TMA stores clipped at odd h and w
@pytest.mark.parametrize("shape", [(2, 5, 7, 64, 40), (1, 8, 8, 512, 256),
                                   (2, 3, 3, 24, 12), (2, 64, 64, 128, 64),
                                   (3, 8, 8, 1024, 512), (3, 5, 7, 40, 20),
                                   (3, 5, 7, 128, 64)])
def test_qconv_t_kernel_equals_plain(cuda, shape):
    n, h, w, cin, cout = shape
    g = _gen(32)
    x = _i8(g, (n, h, w, cin), lo=0)
    wt = _i8(g, (2, 2, cout, cin))
    m, b = _qscale(g, cout, cin, 80.0), torch.randn(cout, device=cuda,
                                                     generator=g)
    before = launch_counts()["qconv_t"]
    got = qconv_t.qconv_t(x, wt, m, b)
    assert launch_counts()["qconv_t"] == before + 1
    want = qconv_t.qconv_t_plain(x, wt, m, b)
    torch.cuda.synchronize()
    assert got.shape == (n, 2 * h, 2 * w, cout)
    assert torch.equal(got, want), int((got != want).sum())


# (N, H, W, C, trunk width F): the flagship's packed level-48 and unpacked
# 768-channel couplings at small sizes, and a ragged width
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 16, 96, 128), (1, 8, 8, 384, 128),
                                   (2, 5, 7, 40, 24)])
def test_qcoupling_head_kernel_equals_plain(cuda, shape, dtype):
    n, h, w, c, f = shape
    g = _gen(33)
    z = torch.randn((n, h, w, 2 * c), device=cuda, generator=g).to(dtype)
    p = {"w2x": _i8(g, (2 * c, 1, 1, c)), "w2h": _i8(g, (2 * c, 1, 1, f)),
         "m2x": _qscale(g, 2 * c, c + f, 1.0),
         "m2h": _qscale(g, 2 * c, c + f, 1.0),
         "b2": 0.1 * torch.randn(2 * c, device=cuda, generator=g),
         "s_x": torch.tensor(0.02, device=cuda)}
    h1i = _i8(g, (n, h, w, f))
    outs = []
    for fn in (qcoupling.qcoupling_head, qcoupling.qcoupling_head_plain):
        out = torch.zeros_like(z)
        fn(z[..., c:], h1i, p, z[..., :c], out=out[..., :c])
        outs.append(out)
    torch.cuda.synchronize()
    got, want = outs
    assert torch.equal(got[..., c:], torch.zeros_like(got[..., c:]))
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("b,t,h,w,s", [(2, 4, 32, 32, 2), (1, 2, 24, 40, 4),
                                       (2, 3, 16, 36, 2)])
def test_wire_int8_stem_is_exact(cuda, b, t, h, w, s):
    """K3's int8 stem, on the tiled path and (36: rows off the 16-byte grid)
    the general one, equal to the plain version, every byte level seen."""
    g = _gen(34)
    u8 = torch.randint(0, 256, (b * t, h, w, 3), device=cuda, generator=g,
                       dtype=torch.uint8)
    u8.view(-1)[:256] = torch.arange(256, device=cuda, dtype=torch.uint8)
    got = wire.to_s2d_i8(u8, s)
    assert got.dtype == torch.int8
    assert torch.equal(got, wire.to_s2d_i8_plain(u8, s))
    for dtype in DTYPES:
        x = torch.rand((b, h, w, 3 * t), device=cuda, generator=g).to(dtype)
        (wk, sk), (wp, sp) = (fn(x, t, s) for fn in (
            wire.to_u8_s2d_i8, wire.to_u8_s2d_i8_plain))
        assert torch.equal(wk, wp) and torch.equal(sk, sp)


def test_int8_server_on_card_matches_plain_and_counts_launches(cuda):
    """A small flagship server (bf16, 64²) with both int8 options: one
    roundtrip launches K1 ×6, K11 ×(12 + 2 per subnet evaluation = 32),
    K12 ×4, K13 ×10, K3 ×2 (``to_channels``, ``to_u8_s2d_i8``), K4 ×1 and
    no K2; a detect K3 ×1 (the stem), K11 ×12, K12 ×4, K4 ×1. The same
    trees through the plain versions: watermarked bytes within 1 level on
    ≥ 99.99 % (K1's bf16 transitions are within a bf16 ulp of theirs), the
    detect's mask bits on the same bytes equal (K4 sums the tamper
    fraction in its own order: within 1e-5)."""
    cfg = load_config(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, gt_size=64))
    modes = ("roundtrip", "detect")
    base = WatermarkServer(cfg, modes=modes)
    with torch.no_grad():
        for p in base.model.inn.parameters():
            if p.dim() == 4 and p.shape[-1] == 1:  # perturb the zero heads
                p.add_(1e-3 * torch.randn(p.shape, device=cuda,
                                          generator=_gen(35)))
    clip = np.random.default_rng(1).integers(0, 256, (2, 4, 64, 64, 3),
                                             dtype=np.uint8)
    kw = dict(modes=modes, weights=base.model.states(), int8_extract=True,
              int8_embed=True, int8_calib=clip)
    srv = WatermarkServer(cfg, **kw)
    ref = WatermarkServer(cfg, kernels=PLAIN, modes=modes,
                          weights=base.model.states())
    ref._qext, ref._qemb = srv._qext, srv._qemb
    srv.serve(clip, "roundtrip").prefetch()
    torch.cuda.synchronize()
    reset_launch_counts()
    got = srv.serve(clip, "roundtrip")
    got.prefetch()
    torch.cuda.synchronize()
    assert launch_counts() == {"transition": 6, "coupling_head": 0,
                               "wire": 2, "mask_pack": 1, "jpeg_pair": 0,
                               "median3": 0, "f1_sweep": 0, "ssim": 0,
                               "attack_mix": 0, "splice": 0, "qconv": 32,
                               "qconv_t": 4, "qcoupling_head": 10,
                               "haar": 0, "coupling_affine": 0,
                               "zigzag_jpeg": 0, "crop_resize": 0,
                               "window_attention": 0, "canny_soft": 0,
                               "crop_cubic": 0, "rectify": 0,
                               "ssim_grad": 0, "film_residual": 0,
                               "diffjpeg": 0}
    want = ref.serve(clip, "roundtrip")
    diff = np.abs(got.watermarked.astype(int) - want.watermarked.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999
    reset_launch_counts()
    det = srv.serve(got.watermarked, "detect")
    det.prefetch()
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {
        "wire": 1, "mask_pack": 1, "qconv": 12, "qconv_t": 4}
    np.testing.assert_array_equal(det.mask_bits, got.mask_bits)
    pdet = ref.serve(got.watermarked, "detect")
    np.testing.assert_array_equal(det.mask_bits, pdet.mask_bits)
    np.testing.assert_allclose(det.tamper_fraction, pdet.tamper_fraction,
                               rtol=0, atol=1e-5)


# K11 on the wgmma core (csrc/qwgmma.cuh): (N, H, W, Cin, Cout, k, epilogue,
# input kind, Cin2, pixel stride or None). Cin within one 32-channel stage,
# two stages and many (384); H, W off the 16 × 8 tiles so that tiles touch
# every image border; 8 frames of 64² = 256 tiles against at most 132
# blocks, so a persistent block walks several; each loader: TMA, cp.async
# (Cin 12, 20), byte copies (Cin 7), the pool, the quantize prologue in
# 16-byte loads (bf16, f32) and in 4-value units (Cin 12 f32); each
# epilogue (relu, signed, elu, f32, dual).
_QCORE = [(2, 9, 11, 32, 48, 3, "relu", "int8", 0, None),
          (2, 17, 19, 64, 64, 3, "signed", "int8", 0, None),
          (1, 13, 7, 384, 128, 3, "relu", "int8", 0, None),
          (8, 64, 64, 64, 128, 3, "relu", "int8", 0, None),
          (3, 21, 17, 12, 70, 3, "relu", "int8", 0, None),
          (2, 11, 13, 7, 24, 3, "signed", "int8", 0, None),
          (2, 9, 10, 48, 80, 3, "relu", "pool", 0, None),
          (2, 10, 12, 96, 128, 3, "elu", "bfloat16", 0, 192),
          (2, 9, 13, 40, 72, 3, "elu", "float32", 0, 80),
          (2, 9, 13, 12, 32, 3, "elu", "float32", 0, 24),
          (2, 19, 15, 64, 96, 3, "relu", "int8", 96, None),
          (2, 17, 9, 64, 4, 1, "f32", "int8", 0, None),
          (3, 18, 10, 20, 136, 1, "relu", "int8", 0, None),
          (2, 12, 20, 96, 128, 1, "elu", "bfloat16", 0, 192)]


@pytest.mark.parametrize("case", _QCORE)
def test_qconv_core_equals_plain(cuda, case):
    """K11 equal to its plain version across stage counts, borders,
    persistent tiles, loaders, prologues and epilogues; the quantize
    prologue's side output ``xi`` equal to the plain one."""
    n, h, w, cin, cout, k, epi, kind, cin2, ld = case
    g = _gen(36)
    kw = {}
    if kind in ("int8", "pool"):
        hin, win = (2 * h + 1, 2 * w + 1) if kind == "pool" else (h, w)
        x = _i8(g, (n, hin, win, cin), lo=-127 if epi != "relu" else 0)
        kw["pool"] = kind == "pool"
    else:  # a channel slice, as the INN trunk reads its coupling half
        full = torch.randn((n, h, w, ld), device=cuda, generator=g)
        x = full.to(getattr(torch, kind))[..., ld - cin:]
        kw["x_scale"] = torch.tensor(0.02, device=cuda)
    wt = _i8(g, (cout, k, k, cin))
    m = _qscale(g, cout, k * k * cin, 1.0 if epi == "elu" else 80.0)
    b = torch.randn(cout, device=cuda, generator=g)
    if epi == "elu":
        kw["out_scale"] = torch.tensor(0.015, device=cuda)
    if cin2:
        kw.update(x2=_i8(g, (n, h, w, cin2), lo=0),
                  w2=_i8(g, (cout, k, k, cin2)),
                  m2=_qscale(g, cout, k * k * cin2, 80.0))
    xi = xi_plain = None
    if "x_scale" in kw:
        xi = torch.empty(x.shape, device=cuda, dtype=torch.int8)
        xi_plain = torch.empty_like(xi)
    before = launch_counts()["qconv"]
    got = qconv.qconv(x, wt, m, b, epi, xi_out=xi, **kw)
    assert launch_counts()["qconv"] == before + 1
    want = qconv.qconv_plain(x, wt, m, b, epi, xi_out=xi_plain, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    if xi is not None:
        assert torch.equal(xi, xi_plain), int((xi != xi_plain).sum())
    pl = qconv.plan_of(x, wt, epi, pool=kw.get("pool", False),
                       x2=kw.get("x2"), w2=kw.get("w2"))
    if (n, h, w) == (8, 64, 64):  # more tiles than blocks
        assert 8 * 4 * 8 > pl.grid


# K13: the flagship's level-48 and level-192/768 couplings at small sizes,
# a ragged even width, and odd widths (no paired accesses, no TMA rows)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 16, 96, 128), (1, 8, 8, 384, 128),
                                   (2, 5, 7, 40, 24), (2, 9, 11, 21, 40)])
def test_qcoupling_head_on_xi_equals_plain(cuda, shape, dtype):
    """K13 on the ``xi`` K11 writes (the main path) and quantizing the half
    itself, equal to its plain version, bf16 and f32."""
    n, h, w, c, f = shape
    g = _gen(37)
    z = torch.randn((n, h, w, 2 * c), device=cuda, generator=g).to(dtype)
    p = {"w2x": _i8(g, (2 * c, 1, 1, c)), "w2h": _i8(g, (2 * c, 1, 1, f)),
         "m2x": _qscale(g, 2 * c, c + f, 1.0),
         "m2h": _qscale(g, 2 * c, c + f, 1.0),
         "b2": 0.1 * torch.randn(2 * c, device=cuda, generator=g),
         "s_x": torch.tensor(0.02, device=cuda)}
    h1i = _i8(g, (n, h, w, f))
    xin, x = z[..., c:], z[..., :c]
    xi = qconv.quantize_input(xin, p["s_x"]).contiguous()
    want = torch.zeros_like(z)
    qcoupling.qcoupling_head_plain(xin, h1i, p, x, out=want[..., :c])
    for src in (xi, None):
        got = torch.zeros_like(z)
        qcoupling.qcoupling_head(xin, h1i, p, x, out=got[..., :c], xi=src)
        torch.cuda.synchronize()
        assert torch.equal(got, want), int((got != want).sum())


# K14: the refshape levels' channel counts, a count that is not a multiple
# of 8 (8-byte and one-value accesses) and odd N·H·W
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 16, 12), (1, 8, 8, 192),
                                   (3, 6, 10, 5), (1, 2, 6, 7),
                                   (1, 4, 4, 768), (48, 256, 256, 4),
                                   (48, 128, 128, 16), (48, 64, 64, 64)])
def test_haar_equals_plain(cuda, shape, dtype):
    g = _gen(41)
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    before = launch_counts()["haar"]
    y = haar.haar(x)
    back = haar.haar(y, transpose=True)
    assert launch_counts()["haar"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(y, haar.haar_plain(x))
    assert torch.equal(back, haar.haar_plain(y, transpose=True))
    # the backward of down is up (K14 again)
    xr = x.clone().requires_grad_()
    cot = torch.randn(y.shape, device=cuda, generator=g).to(dtype)
    (gx,) = torch.autograd.grad(haar.haar(xr), xr, cot)
    assert torch.equal(gx, haar.haar_plain(cot, transpose=True))


def _affine_grads(fn, st, x, inverse, cot):
    leaves = [x.detach().clone().requires_grad_()]
    if isinstance(st, torch.Tensor):
        leaves.append(st.detach().clone().requires_grad_())
        arg = leaves[1]
    else:
        leaves += [v.detach().clone().requires_grad_() for v in st]
        arg = (leaves[1], leaves[2])
    return torch.autograd.grad(fn(arg, leaves[0], inverse=inverse), leaves,
                               cot)


# K15: the refshape halves' widths, ragged widths (one value a thread) and
# odd N·H·W; x and out channel slices of wider tensors, s and t the halves
# of one head or two tensors
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 16, 24), (1, 8, 8, 96),
                                   (3, 5, 7, 13), (1, 3, 3, 8),
                                   (48, 128, 128, 8), (48, 64, 64, 32),
                                   (48, 32, 32, 128)])
def test_coupling_affine_equals_plain(cuda, shape, dtype, fused, inverse):
    n, h, w, c = shape
    g = _gen(43)
    z = torch.randn(n, h, w, 2 * c, device=cuda, generator=g).to(dtype)
    head = torch.randn(n, h, w, 2 * c, device=cuda, generator=g).to(dtype)
    st = head if fused else (head[..., :c].contiguous(),
                             head[..., c:].contiguous())
    x = z[..., c:]
    got = torch.zeros(n, h, w, 3 * c, device=cuda, dtype=dtype)
    want = torch.zeros_like(got)
    before = launch_counts()["coupling_affine"]
    affine.coupling_affine(st, x, out=got[..., c:2 * c], inverse=inverse)
    assert launch_counts()["coupling_affine"] == before + 1
    affine.coupling_affine_plain(st, x, out=want[..., c:2 * c],
                                 inverse=inverse)
    torch.cuda.synchronize()
    bits = 7 if dtype == torch.bfloat16 else 23
    ref = want[..., c:2 * c].float()
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), e - 1 - bits)
    assert bool(((got[..., c:2 * c].float() - ref).abs() <= ulp).all())
    assert not got[..., :c].any() and not got[..., 2 * c:].any()
    cot = torch.randn(x.shape, device=cuda, generator=g).to(dtype)
    gk = _affine_grads(affine.coupling_affine, st, x, inverse, cot)
    gp = _affine_grads(affine.coupling_affine_plain, st, x, inverse, cot)
    for a, b in zip(gk, gp):
        scale = float(b.float().abs().max())
        d = (a.float() - b.float()).abs()
        if dtype == torch.float32:
            assert float(d.max()) <= 1e-6 * scale
        else:
            assert bool((d <= 2.0 ** -7 * b.float().abs()
                         + 1e-6 * scale).all())


def test_refshape_server_equals_plain_on_the_card(cuda):
    """The reference-shaped model (``configs/refshape.yaml``) served on the
    card at a small size: a roundtrip launches K14 ×6, K15 ×10, K3 ×2 and
    K4 ×1, and its bytes and mask bits EQUAL the plain server's."""
    from vwfd_tpu_torch import REFSHAPE_CONFIG
    cfg = load_config(REFSHAPE_CONFIG)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=2, gt_size=64))
    model = VideoWatermarkModel(cfg, device="cpu")
    states = model.init_states(3)
    srv = WatermarkServer(cfg, weights=states, modes=("roundtrip",))
    ref = WatermarkServer(cfg, weights=states, modes=("roundtrip",),
                          kernels=PLAIN)
    clip = np.random.default_rng(5).integers(0, 256, (2, 4, 64, 64, 3),
                                             dtype=np.uint8)
    reset_launch_counts()
    got = srv.serve(clip, "roundtrip")
    got.prefetch()
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {
        "haar": 6, "coupling_affine": 10, "wire": 2, "mask_pack": 1}
    want = ref.serve(clip, "roundtrip")
    assert np.array_equal(got.watermarked, want.watermarked)
    assert np.array_equal(got.mask_bits, want.mask_bits)


def _grads(fn, x, cot):
    xr = x.clone().requires_grad_()
    y = fn(xr)
    (g,) = torch.autograd.grad(y, xr, cot)
    return y.detach(), g


# K16 at HiDDeN's path shape (b8, 128²) and a ragged batch and size
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("shape", [(8, 128, 128, 3), (3, 40, 24, 3)])
def test_zigzag_jpeg_matches_plain(cuda, shape, clip):
    g = _gen(61)
    x = torch.rand(shape, device=cuda, generator=g) * 1.2 - 0.1
    x[0, :8, :8] = 0.0          # z exactly 0: the clip's ½ tie
    cot = torch.randn(shape, device=cuda, generator=g)
    before = launch_counts()["zigzag_jpeg"]
    yk, gk = _grads(lambda v: zigzag.zigzag_jpeg(v, clip=clip), x, cot)
    assert launch_counts()["zigzag_jpeg"] == before + 2
    yp, gp = _grads(lambda v: zigzag.zigzag_jpeg_plain(v, clip=clip), x, cot)
    torch.cuda.synchronize()
    assert float((yk - yp).abs().max()) <= 2e-6
    assert float((gk - gp).abs().max()) <= 1e-6 * float(gp.abs().max())
    if clip:
        _, free = _grads(zigzag.zigzag_jpeg, x, cot)
        assert torch.equal(gk[0, :8, :8], 0.5 * free[0, :8, :8])


# K17: windows inside, whole, at the edges and of one pixel, at HiDDeN's
# path shape; a ragged batch and size; rows of 120 bytes (not a multiple of
# 16: the kernels' element-wise copies) with the window at the right edge;
# another output size
@pytest.mark.parametrize("shape,apex,out_hw", [
    ((8, 128, 128, 3), (10.0, 100.0, 3.0, 128.0), None),
    ((8, 128, 128, 3), (0.0, 128.0, 0.0, 128.0), None),
    ((8, 128, 128, 3), (30.0, 31.0, 64.0, 65.0), None),
    ((3, 40, 24, 3), (5.0, 27.0, 0.0, 13.0), None),
    ((2, 24, 10, 3), (3.0, 20.0, 4.0, 10.0), None),
    ((2, 40, 24, 3), (6.0, 38.0, 2.0, 21.0), (32, 48))])
def test_crop_resize_matches_plain(cuda, shape, apex, out_hw):
    g = _gen(62)
    x = torch.rand(shape, device=cuda, generator=g)
    oshape = shape if out_hw is None else (shape[0], *out_hw, shape[3])
    cot = torch.randn(oshape, device=cuda, generator=g)
    ap = torch.tensor(apex, device=cuda)
    fn = lambda v: crop_resize.crop_resize(v, ap, out_hw)  # noqa: E731
    before = launch_counts()["crop_resize"]
    yk, gk = _grads(fn, x, cot)
    assert launch_counts()["crop_resize"] == before + 2
    yp, gp = _grads(lambda v: crop_resize.crop_resize_plain(v, ap, out_hw),
                    x, cot)
    torch.cuda.synchronize()
    assert yk.shape == oshape and torch.equal(yk, yp)
    assert float((gk - gp).abs().max()) <= 1e-6 * float(gp.abs().max())
    # the gradient is deterministic (no float atomics)
    assert torch.equal(gk, _grads(fn, x, cot)[1])


# K17 past the whole-row limit (F22, repaired): one pixel wider than the
# widest 8-row RGB rows a CTA holds whole, twice that width, and a 3840 ×
# 2160 frame with an off-centre window, the backward (and where whole rows
# do not fit, the forward) on column tiles: forward EQUAL, gradient within
# 1e-6 of the plain max and bit-identical over two calls
@pytest.mark.parametrize("case", ["max_width+1", "2*max_width", "3840x2160"])
def test_crop_resize_at_the_width_limit(cuda, case):
    mw = crop_resize.max_width(8, 3, 8)
    shape, apex = {
        "max_width+1": ((1, 8, mw + 1, 3), (1.0, 7.0, 5.0, mw - 2.0)),
        "2*max_width": ((1, 8, 2 * mw, 3), (1.0, 7.0, 5.0, 2 * mw - 3.0)),
        "3840x2160": ((1, 2160, 3840, 3), (301.0, 1901.0, 517.0, 3333.0)),
    }[case]
    _, h, w, c = shape
    assert crop_resize.tiles(h, w, c, h, w) < (w, w)  # column tiles
    g = _gen(67)
    x = torch.rand(shape, device=cuda, generator=g)
    cot = torch.randn(shape, device=cuda, generator=g)
    ap = torch.tensor(apex, device=cuda)
    fn = lambda v: crop_resize.crop_resize(v, ap)  # noqa: E731
    before = launch_counts()["crop_resize"]
    yk, gk = _grads(fn, x, cot)
    assert launch_counts()["crop_resize"] == before + 2
    yp, gp = _grads(lambda v: crop_resize.crop_resize_plain(v, ap), x, cot)
    torch.cuda.synchronize()
    assert torch.equal(yk, yp)
    assert float((gk - gp).abs().max()) <= 1e-6 * float(gp.abs().max())
    assert torch.equal(gk, _grads(fn, x, cot)[1])


def _nonfinite(shape, out_shape, nan_at, inf_at, cot_nan_at, lo, hi, seed):
    g = _gen(seed)
    x = lo + (hi - lo) * torch.rand(shape, device="cuda", generator=g)
    cot = torch.randn(out_shape, device="cuda", generator=g)
    x[nan_at], x[inf_at], cot[cot_nan_at] = (float("nan"), float("inf"),
                                              float("nan"))
    return x, cot


def _same_nonfinite(got, want, atol, rel):
    """NaN and ±Inf at the same places; the rest within ``atol`` plus
    ``rel`` of the finite max."""
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    fin = want.isfinite()
    err = float((got[fin] - want[fin]).abs().max())
    assert err <= atol + rel * float(want[fin].abs().max()), err


# a NaN and an Inf pixel inside the window, a NaN in the cotangent: NaN
# where the plain version's are, forward and backward
@pytest.mark.parametrize("shape,apex,out_hw", [
    ((8, 128, 128, 3), (10.0, 100.0, 3.0, 128.0), None),
    ((2, 40, 24, 3), (6.0, 38.0, 2.0, 21.0), (32, 48))])
def test_crop_resize_nonfinite_as_plain(cuda, shape, apex, out_hw):
    oshape = shape if out_hw is None else (shape[0], *out_hw, shape[3])
    x, cot = _nonfinite(shape, oshape, (1, 30, 12, 0), (0, 6, 2, 2),
                        (1, 31, 20, 1), 0.0, 1.0, 64)
    ap = torch.tensor(apex, device=cuda)
    yk, gk = _grads(lambda v: crop_resize.crop_resize(v, ap, out_hw), x, cot)
    yp, gp = _grads(lambda v: crop_resize.crop_resize_plain(v, ap, out_hw),
                    x, cot)
    torch.cuda.synchronize()
    assert bool(yp.isnan().any()) and bool(gp.isnan().any())
    _same_nonfinite(yk, yp, 0.0, 0.0)
    _same_nonfinite(gk, gp, 0.0, 1e-6)


@pytest.mark.parametrize("clip", [False, True])
def test_zigzag_jpeg_nonfinite_as_plain(cuda, clip):
    shape = (8, 128, 128, 3)
    x, cot = _nonfinite(shape, shape, (0, 3, 5, 1), (2, 70, 33, 0),
                        (5, 100, 17, 2), -0.1, 1.1, 65)
    yk, gk = _grads(lambda v: zigzag.zigzag_jpeg(v, clip=clip), x, cot)
    yp, gp = _grads(lambda v: zigzag.zigzag_jpeg_plain(v, clip=clip), x, cot)
    torch.cuda.synchronize()
    assert int(yp.isnan().sum()) == 2 * 192  # two 8×8 blocks × 3 channels
    _same_nonfinite(yk, yp, 2e-6, 0.0)
    _same_nonfinite(gk, gp, 0.0, 1e-6)


# K16 on a view 4 bytes off the 16-byte grid, forward and backward: the
# wrapper hands the kernel an aligned copy
def test_zigzag_jpeg_off_the_16_byte_grid_matches_plain(cuda):
    g = _gen(68)
    shape = (2, 16, 24, 3)
    n = int(np.prod(shape))
    x = (torch.rand(n + 1, device=cuda, generator=g) * 1.2 - 0.1)[1:]
    x = x.view(shape)
    cot = torch.randn(n + 1, device=cuda, generator=g)[1:].view(shape)
    assert x.data_ptr() % 16 and cot.data_ptr() % 16
    for clip in (False, True):
        xr = x.detach().requires_grad_()  # the view itself, off the grid
        yk = zigzag.zigzag_jpeg(xr, clip=clip)
        (gk,) = torch.autograd.grad(yk, xr, cot)
        yk = yk.detach()
        yp, gp = _grads(lambda v: zigzag.zigzag_jpeg_plain(v, clip=clip), x,
                        cot)
        torch.cuda.synchronize()
        assert float((yk - yp).abs().max()) <= 2e-6
        assert float((gk - gp).abs().max()) <= 1e-6 * float(gp.abs().max())


# K16 on one 8×8 block: a unit mostly empty
def test_zigzag_jpeg_one_block_matches_plain(cuda):
    g = _gen(66)
    shape = (1, 8, 8, 3)
    x = torch.rand(shape, device=cuda, generator=g) * 1.2 - 0.1
    cot = torch.randn(shape, device=cuda, generator=g)
    for clip in (False, True):
        yk, gk = _grads(lambda v: zigzag.zigzag_jpeg(v, clip=clip), x, cot)
        yp, gp = _grads(lambda v: zigzag.zigzag_jpeg_plain(v, clip=clip), x,
                        cot)
        torch.cuda.synchronize()
        assert float((yk - yp).abs().max()) <= 2e-6
        assert float((gk - gp).abs().max()) <= 1e-6 * float(gp.abs().max())


# MBRS's JPEG: jpeg_basic through K5 with weights (1, 0), both roundings at
# each of MBRS's qualities, at its train shape (b16, 128²)
@pytest.mark.parametrize("rounding", ["round", "ss"])
def test_jpeg_basic_on_k5_matches_plain(cuda, rounding):
    from vwfd_tpu_torch.attacks import jpeg_basic
    from vwfd_tpu_torch.models.mbrs_model import QUALITY_INDICES
    g = _gen(71)
    x = torch.rand(16, 128, 128, 3, device=cuda, generator=g)
    cot = torch.randn(x.shape, device=cuda, generator=g)
    for q in QUALITY_INDICES:
        before = launch_counts()["jpeg_pair"]
        yk, gk = _grads(lambda v: jpeg_basic(v, q, rounding), x, cot)
        assert launch_counts()["jpeg_pair"] == before + 2
        yp, gp = _grads(lambda v: jpeg_basic(v, q, rounding, kernels=PLAIN),
                        x, cot)
        torch.cuda.synchronize()
        bad, blocks = _flipped_blocks(yk, yp, 1e-4)
        assert bad <= max(1, blocks // 1000), (q, bad, blocks)
        assert float((yk - yp).abs().max()) < 1.0
        gbad, _ = _flipped_blocks(gk, gp, 1e-4 * float(gp.abs().max()))
        assert gbad <= max(1, blocks // 1000), (q, gbad, blocks)
    # F23: a NaN and an Inf pixel, NaN where the plain version's are: the
    # forward on their 8×8 blocks, the gradient too (autograd's 0·NaN)
    x[0, 5, 9, 1] = float("nan")
    x[3, 70, 33, 0] = float("inf")
    yk, gk = _grads(lambda v: jpeg_basic(v, 2, rounding), x, cot)
    yp, gp = _grads(lambda v: jpeg_basic(v, 2, rounding, kernels=PLAIN), x,
                    cot)
    torch.cuda.synchronize()
    assert torch.equal(yk.isnan(), yp.isnan()) and int(yp.isnan().sum())
    assert torch.equal(gk.isnan(), gp.isnan()) and int(gp.isnan().sum())


# one MBRS train step per noise mode at full width, KERNELS against PLAIN
# from the same state, batch, messages and draws
@pytest.mark.parametrize("mode", ["identity", "hard", "soft"])
def test_mbrs_step_on_the_card_matches_plain(cuda, mode):
    from vwfd_tpu_torch.models.mbrs_model import MODES, MBRSDraws, MBRSModel
    model = MBRSModel(device=cuda)
    model.init_states(16)
    ref = MBRSModel(device=cuda, kernels=PLAIN)
    ref.load_states({n: net.state_dict() for n, net in model.nets().items()})
    g = _gen(72)
    imgs = torch.rand(16, 128, 128, 3, device=cuda, generator=g)
    msgs = (torch.rand(16, 30, device=cuda, generator=g) > 0.5).float()
    draws = MBRSDraws(MODES.index(mode), 2)
    gp, gk = {}, {}
    lp = ref.train_step(imgs, msgs, draws, gp)
    reset_launch_counts()
    lk = model.train_step(imgs, msgs, draws, gk)
    torch.cuda.synchronize()
    assert launch_counts()["jpeg_pair"] == MODES.index(mode)
    for k in ("loss", "encoder_mse", "message_mse"):
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-5 * abs(float(lp[k]))
    for net in gk:
        a = torch.cat([t.flatten() for t in gk[net]])
        b = torch.cat([t.flatten() for t in gp[net]])
        assert float(torch.dot(a, b) / (a.norm() * b.norm())) >= 0.9999


# K18 at SUNet's stage shapes of 256² b8 on the map (qkv, window, shift),
# at N = 16, 25 and 49, d = 16 and d = 64, and on a non-square map whose
# shift wraps both edges
_WINATT = [((8, 64, 64, 3, 3, 32), 8, 4), ((8, 64, 64, 3, 3, 32), 8, 0),
           ((8, 32, 32, 3, 6, 32), 8, 4), ((8, 16, 16, 3, 12, 32), 8, 4),
           ((8, 8, 8, 3, 24, 32), 8, 0), ((8, 8, 8, 3, 2, 32), 4, 2),
           ((4, 8, 8, 3, 4, 16), 4, 2), ((2, 16, 16, 3, 2, 64), 8, 4),
           ((2, 16, 24, 3, 2, 32), 8, 4), ((2, 10, 15, 3, 2, 32), 5, 2),
           ((1, 14, 14, 3, 3, 16), 7, 3)]


def _winatt(fn, qkv, table, cot, ws, shift):
    q = qkv.clone().requires_grad_(True)
    t = table.clone().requires_grad_(True)
    y = fn(q, t, ws, shift)
    return (y.detach(), *torch.autograd.grad(y, (q, t), cot))


def _winatt_inputs(shape, ws, seed):
    g = _gen(seed)
    b, hm, wm, _, h, d = shape
    return (torch.randn(shape, device="cuda", generator=g),
            0.02 * torch.randn(((2 * ws - 1) ** 2, h), device="cuda",
                               generator=g),
            torch.randn((b, hm, wm, h * d), device="cuda", generator=g))


@pytest.mark.parametrize("shape,ws,shift", _WINATT)
def test_window_attention_matches_plain(cuda, shape, ws, shift):
    qkv, table, cot = _winatt_inputs(shape, ws, 18)
    before = launch_counts()["window_attention"]
    got = _winatt(window_attention.window_attention, qkv, table, cot, ws,
                  shift)
    assert launch_counts()["window_attention"] == before + 2
    again = _winatt(window_attention.window_attention, qkv, table, cot, ws,
                    shift)
    want = _winatt(window_attention.window_attention_plain, qkv, table, cot,
                   ws, shift)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_window_attention_nonfinite_as_plain(cuda):
    qkv, table, cot = _winatt_inputs((2, 16, 16, 3, 3, 32), 8, 19)
    qkv[0, 1, 5, 0, 2, 7] = float("nan")
    qkv[1, 7, 4, 0, 0, 1] = float("inf")
    got = _winatt(window_attention.window_attention, qkv, table, cot, 8, 4)
    want = _winatt(window_attention.window_attention_plain, qkv, table, cot,
                   8, 4)
    for a, b in zip(got, want):
        assert torch.equal(a.isnan(), b.isnan())
        fin = b.isfinite()
        if bool(fin.any()):
            assert float((a[fin] - b[fin]).abs().max()) <= 1e-5 * float(
                b[fin].abs().max())


@pytest.mark.parametrize("shape,ws", [((1, 9, 9, 3, 1, 32), 9),
                                      ((1, 8, 8, 3, 1, 48), 8),
                                      ((1, 8, 12, 3, 1, 32), 8)])
def test_window_attention_refuses_other_shapes(cuda, shape, ws):
    table = torch.zeros(((2 * ws - 1) ** 2, 1), device=cuda)
    with pytest.raises(ValueError):
        window_attention.window_attention(torch.zeros(shape, device=cuda),
                                          table, ws, 0)
    with pytest.raises(TypeError):
        window_attention.window_attention(
            torch.zeros((1, 4, 4, 3, 1, 32), device=cuda,
                        dtype=torch.float64),
            torch.zeros((49, 1), device=cuda, dtype=torch.float64), 4, 0)


def test_s2d_4_roundtrip_matches_plain(cuda):
    """K3 and K4 at s = 4: a roundtrip of a server at ``extractor_s2d`` 4
    launches K3 ×2 and K4 ×1 and agrees with the plain server (f32)."""
    cfg = load_config(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, gt_size=64),
        model=dataclasses.replace(cfg.model, extractor_s2d=4),
        train=dataclasses.replace(cfg.train, dtype="float32"))
    srv = WatermarkServer(cfg, modes=("roundtrip",))
    ref = WatermarkServer(cfg, modes=("roundtrip",), kernels=PLAIN,
                          weights=srv.model.states())
    clip = np.random.default_rng(1).integers(0, 256, (2, 4, 64, 64, 3),
                                             dtype=np.uint8)
    reset_launch_counts()
    got = srv.serve(clip, "roundtrip")
    got.prefetch()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["wire"] == 2 and counts["mask_pack"] == 1
    want = ref.serve(clip, "roundtrip")
    diff = np.abs(got.watermarked.astype(int) - want.watermarked.astype(int))
    assert diff.max() <= 1
    assert (unpack_mask_bits(got.mask_bits)
            != unpack_mask_bits(want.mask_bits)).mean() < 1e-3


def _canny_input(kind, shape, g, cuda):
    if kind == "levels":
        return torch.randint(0, 256, shape, device=cuda,
                             generator=g).float() / 255.0
    if kind == "flat":
        return torch.full(shape, 0.3, device=cuda)
    return torch.rand(shape, device=cuda, generator=g)


# K19's tile is 32 × 90 outputs: shapes one past it in each dimension,
# two tiles and one row past, the 3 × 3 minimum, a tall narrow image, the
# PAMI step's (48, 256, 256) and the PAMI-512 record's (9, 512, 512)
@pytest.mark.parametrize("kind", ["levels", "rand", "flat"])
@pytest.mark.parametrize("shape", [(2, 9, 11, 3), (3, 40, 24, 3),
                                   (2, 33, 70, 3), (2, 33, 91, 3),
                                   (1, 65, 181, 3), (1, 3, 3, 3),
                                   (2, 300, 5, 3), (48, 256, 256, 3),
                                   (9, 512, 512, 3)])
def test_canny_soft_matches_plain(cuda, shape, kind):
    g = _gen(79)
    x = _canny_input(kind, shape, g, cuda)
    cot = torch.randn(shape[:3] + (1,), device=cuda, generator=g)
    before = launch_counts()["canny_soft"]
    yk, gk = _grads(canny.canny_soft, x, cot)
    assert launch_counts()["canny_soft"] == before + 2
    yp, gp = _grads(lambda v: canny.canny_soft_plain(v, exact_border=True),
                    x, cot)
    torch.cuda.synchronize()
    assert float((yk - yp).abs().max()) <= 1e-6
    assert float((gk - gp).abs().max()) <= 1e-5 * max(
        float(gp.abs().max()), 1e-30)


def test_canny_soft_geometry_is_the_plan(cuda):
    canny.check_geometry()


# two calls give the same bits, forward and backward (no atomics, slots
# summed in one fixed order)
@pytest.mark.parametrize("kind", ["levels", "flat"])
def test_canny_soft_bit_identical_over_calls(cuda, kind):
    shape = (9, 512, 512, 3)
    g = _gen(80)
    x = _canny_input(kind, shape, g, cuda)
    cot = torch.randn(shape[:3] + (1,), device=cuda, generator=g)
    y1, g1 = _grads(canny.canny_soft, x, cot)
    y2, g2 = _grads(canny.canny_soft, x, cot)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(g1, g2)


# the forward keeps y and one max word a tile, nothing a pixel beside y;
# the backward's peak is dx, its two planes and the tiles' slots and tie
# lists (under 1 MB), within 1 MB
def test_canny_soft_memory(cuda):
    shape = (48, 256, 256, 3)
    g = _gen(81)
    x = torch.rand(shape, device=cuda, generator=g).requires_grad_()
    cot = torch.randn(shape[:3] + (1,), device=cuda, generator=g)
    p = canny.plan(*shape[:3])
    y_bytes = cot.numel() * 4
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = canny.canny_soft(x)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    assert kept <= y_bytes + 16 * 1024, kept
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (dx,) = torch.autograd.grad(y, x, cot)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert p.scratch_bytes() <= 4 * 2 * cot.numel() + 2 ** 20
    assert peak <= dx.numel() * 4 + p.scratch_bytes() + 2 ** 20, peak


def test_canny_soft_nonfinite_as_plain(cuda):
    shape = (4, 64, 64, 3)
    x, cot = _nonfinite(shape, shape[:3] + (1,), (1, 5, 6, 0),
                        (2, 30, 31, 2), (3, 10, 10, 0), 0.0, 1.0, 83)
    yk, gk = _grads(canny.canny_soft, x, cot)
    yp, gp = _grads(lambda v: canny.canny_soft_plain(v, exact_border=True),
                    x, cot)
    torch.cuda.synchronize()
    assert bool(yp.isnan().any()) and bool(gp.isnan().any())
    _same_nonfinite(yk, yp, 1e-6, 0.0)
    _same_nonfinite(gk, gp, 0.0, 1e-5)


# ----------------------------------------------------------- K20, K21, K22

_CUBIC_CASES = [((8, 256, 256, 3), (10.0, 230.0, 3.0, 256.0), None),
                ((8, 256, 256, 3), (100.0, 101.0, 7.0, 8.0), None),
                ((3, 512, 512, 3), (0.0, 480.0, 40.0, 512.0), None),
                ((2, 40, 70, 3), (6.0, 38.0, 2.0, 61.0), (32, 48)),
                ((2, 40, 70, 3), (0.0, 40.0, 0.0, 70.0), (96, 20)),
                # column tiles: 15 of 256 pixels; a row of 240 KB, whose
                # forward tiles shrink to 60 output pixels for (8, 300)
                ((1, 2160, 3840, 3), (100.0, 2000.0, 37.0, 3801.0), None),
                ((1, 8, 20000, 3), (1.0, 7.0, 123.0, 19877.0), (8, 300)),
                ((2, 64, 600, 3), (3.0, 60.0, 5.0, 590.0), (50, 700)),
                ((3, 512, 512, 3), (31.0, 480.0, 0.0, 400.0), (200, 160)),
                # 30 columns to 300: about 40 column terms a pixel
                ((2, 64, 300, 3), (10.0, 50.0, 100.0, 130.0), None),
                # 150 heavy pixels a tile (about 13 terms each): chunks of
                # 4 output rows
                ((1, 32, 1000, 3), (0.0, 32.0, 100.0, 400.0), (32, 1000)),
                # rows downsampled 5 and 5.12 times: output rows skip input
                # rows at a band's top and bottom
                ((2, 40, 70, 3), (0.0, 40.0, 0.0, 70.0), (8, 48)),
                ((3, 512, 512, 3), (0.0, 512.0, 0.0, 512.0), (100, 100)),
                ((2, 33, 45, 1), (2.0, 30.0, 4.0, 41.0), None),
                ((2, 33, 45, 4), (2.0, 30.0, 4.0, 41.0), (20, 64))]


@pytest.mark.parametrize("shape,apex,out_hw", _CUBIC_CASES)
def test_crop_cubic_matches_plain(cuda, shape, apex, out_hw):
    g = _gen(90)
    x = torch.rand(shape, device=cuda, generator=g) * 1.2 - 0.1
    oshape = shape if out_hw is None else (shape[0], *out_hw, shape[3])
    cot = torch.randn(oshape, device=cuda, generator=g)
    ap = torch.tensor(apex, device=cuda)
    before = launch_counts()["crop_cubic"]
    yk, gk = _grads(lambda v: crop_cubic.crop_cubic(v, ap, out_hw), x, cot)
    assert launch_counts()["crop_cubic"] == before + 2
    yk2, gk2 = _grads(lambda v: crop_cubic.crop_cubic(v, ap, out_hw), x, cot)
    yp, gp = _grads(lambda v: crop_cubic.crop_cubic_plain(v, ap, out_hw), x,
                    cot)
    torch.cuda.synchronize()
    assert torch.equal(yk, yp)
    assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    assert torch.equal(yk, yk2) and torch.equal(gk, gk2)


@pytest.mark.parametrize("shape,out_hw", [((8, 256, 256, 3), None),
                                          ((1, 2160, 3840, 3), (200, 300))])
def test_crop_cubic_allocates_only_its_outputs(cuda, shape, out_hw):
    """The forward allocates y and the backward gx, nothing else (the
    allocator's 2 MiB rounding allowed)."""
    g = _gen(92)
    x = torch.rand(shape, device=cuda, generator=g).requires_grad_(True)
    ap = torch.tensor((10.0, 200.0, 3.0, 250.0), device=cuda)
    oshape = shape if out_hw is None else (shape[0], *out_hw, shape[3])
    cot = torch.randn(oshape, device=cuda, generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = crop_cubic.crop_cubic(x, ap, out_hw)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= y.numel() * 4 + 2 ** 21
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (gx,) = torch.autograd.grad(y, x, cot)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= gx.numel() * 4 + 2 ** 21


def test_crop_cubic_nonfinite_as_plain(cuda):
    shape, apex = (4, 64, 64, 3), (5.0, 60.0, 2.0, 50.0)
    x, cot = _nonfinite(shape, shape, (1, 30, 12, 0), (0, 6, 3, 2),
                        (1, 31, 20, 1), 0.0, 1.0, 91)
    ap = torch.tensor(apex, device=cuda)
    yk, gk = _grads(lambda v: crop_cubic.crop_cubic(v, ap), x, cot)
    yp, gp = _grads(lambda v: crop_cubic.crop_cubic_plain(v, ap), x, cot)
    torch.cuda.synchronize()
    assert bool(yp.isnan().any()) and bool(gp.isnan().any())
    _same_nonfinite(yk, yp, 0.0, 0.0)
    _same_nonfinite(gk, gp, 0.0, 1e-5)


@pytest.mark.parametrize("shape,reps,apex", [
    ((8, 256, 256, 3), 6, (10.0, 230.0, 3.0, 256.0)),
    ((8, 256, 256, 3), 6, (100.0, 101.0, 7.0, 200.0)),  # one pixel high
    ((8, 256, 256, 3), 6, (180.0, 256.0, 150.0, 256.0)),  # bottom, right
    ((3, 512, 512, 3), 3, (31.0, 512.0, 0.0, 400.0)),
    ((2, 40, 70, 3), 2, (6.0, 7.0, 2.0, 61.0)),
    ((2, 40, 71, 3), 2, (6.0, 40.0, 30.0, 71.0))])  # W·C % 4: scalar path
def test_rectify_matches_plain(cuda, shape, reps, apex):
    g = _gen(92)
    att = torch.rand((shape[0] * reps,) + shape[1:], device=cuda,
                     generator=g) * 1.2 - 0.1
    clean = torch.rand(shape, device=cuda, generator=g)
    cot = torch.randn(att.shape, device=cuda, generator=g)
    ap = torch.tensor(apex, device=cuda)
    before = launch_counts()["rectify"]
    yk, gk = _grads(lambda c: rectify.rectify(att, c, ap), clean, cot)
    assert launch_counts()["rectify"] == before + 2  # forward + backward
    yk2, gk2 = _grads(lambda c: rectify.rectify(att, c, ap), clean, cot)
    yp, gp = _grads(lambda c: rectify.rectify_plain(att, c, ap), clean, cot)
    torch.cuda.synchronize()
    assert torch.equal(yk, yp)
    assert float((gk - gp).abs().max()) <= 1e-6 * float(gp.abs().max())
    assert torch.equal(yk, yk2) and torch.equal(gk, gk2)


def test_rectify_nonfinite_as_plain(cuda):
    shape, apex = (2, 64, 64, 3), (5.0, 60.0, 2.0, 50.0)
    g = _gen(93)
    att = torch.rand((4,) + shape[1:], device=cuda, generator=g)
    att[0, 1, 1, 0] = float("inf")     # outside the window
    att[3, 30, 30, 2] = float("nan")   # inside
    clean = torch.rand(shape, device=cuda, generator=g)
    ap = torch.tensor(apex, device=cuda)
    yk = rectify.rectify(att, clean, ap)
    yp = rectify.rectify_plain(att, clean, ap)
    torch.cuda.synchronize()
    assert bool(yp.isnan().any())
    _same_nonfinite(yk, yp, 0.0, 0.0)


def test_rectify_backward_nonfinite_as_plain(cuda):
    """A NaN cotangent outside the window: NaN in the clean image's
    gradient where the plain version's ``g·inside`` gives NaN·0."""
    shape, apex = (2, 64, 64, 3), (5.0, 60.0, 2.0, 50.0)
    g = _gen(96)
    att = torch.rand((4,) + shape[1:], device=cuda, generator=g)
    clean = torch.rand(shape, device=cuda, generator=g)
    cot = torch.randn(att.shape, device=cuda, generator=g)
    cot[1, 62, 1, 1] = float("nan")    # outside the window
    cot[2, 30, 30, 0] = float("nan")   # inside
    ap = torch.tensor(apex, device=cuda)
    _, gk = _grads(lambda c: rectify.rectify(att, c, ap), clean, cot)
    _, gp = _grads(lambda c: rectify.rectify_plain(att, c, ap), clean, cot)
    torch.cuda.synchronize()
    assert bool(gp[1, 62, 1, 1].isnan()) and int(gp.isnan().sum()) == 2
    _same_nonfinite(gk, gp, 0.0, 1e-6)


@pytest.mark.parametrize("shape,flat", [((8, 256, 256, 3), False),
                                        ((8, 256, 256, 3), True),
                                        ((3, 512, 512, 3), False),
                                        ((3, 40, 70, 3), False),
                                        ((1, 11, 5, 3), False),
                                        ((8, 69, 65, 3), False)])
def test_ssim_grad_matches_plain(cuda, shape, flat):
    """(8, 69, 65, 3): one past the 64-column strip and past the 68-row
    segment of the step shape's plan."""
    g = _gen(94)
    x2 = torch.rand(shape, device=cuda, generator=g)
    x1 = (x2 + 0.02 * torch.randn(shape, device=cuda, generator=g)).clamp(
        0, 1)
    if flat:
        x1[:, 40:120, 30:200] = 0.5
        x2[:, 40:120, 30:200] = 0.5
    xk = x1.clone().requires_grad_()
    before = (launch_counts()["ssim"], launch_counts()["ssim_grad"])
    gk, = torch.autograd.grad(KERNELS.ssim(xk, x2)[1], xk)
    assert (launch_counts()["ssim"], launch_counts()["ssim_grad"]) == (
        before[0] + 1, before[1] + 1)
    gk2, = torch.autograd.grad(KERNELS.ssim(xk, x2)[1], xk)
    xp = x1.clone().requires_grad_()
    gp, = torch.autograd.grad(ssim.ssim_plain(xp, x2)[1], xp)
    torch.cuda.synchronize()
    assert float((gk - gp).abs().max()) <= ssim_grad.RTOL * float(
        gp.abs().max())
    assert torch.equal(gk, gk2)
    # one launch: nothing allocated but dx (1 MB of slack)
    sc = ssim_grad.scale_of(torch.zeros(shape[0], device=cuda),
                            torch.ones((), device=cuda), shape)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dx = ssim_grad.ssim_grad(x1, x2, sc)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= \
        dx.numel() * 4 + (1 << 20)


def test_ssim_grad_per_image_cotangents(cuda):
    g = _gen(95)
    x1 = torch.rand((3, 48, 40, 3), device=cuda, generator=g)
    x2 = torch.rand((3, 48, 40, 3), device=cuda, generator=g)
    gm = torch.tensor([0.5, -1.0, 2.0], device=cuda)
    xk, xp = x1.clone().requires_grad_(), x1.clone().requires_grad_()
    means, mean = KERNELS.ssim(xk, x2)
    gk, = torch.autograd.grad((means * gm).sum() + 0.3 * mean, xk)
    means, mean = ssim.ssim_plain(xp, x2)
    gp, = torch.autograd.grad((means * gm).sum() + 0.3 * mean, xp)
    assert float((gk - gp).abs().max()) <= ssim_grad.RTOL * float(
        gp.abs().max())
    with pytest.raises(ValueError, match="img2"):
        KERNELS.ssim(x1, x2.clone().requires_grad_())


def test_clr_step_on_the_card_matches_plain(cuda):
    """A small CLR step (64², b2, k 6, INN down_num 2) through the kernels
    and through ``PLAIN`` from the same state and draws: loss terms within
    1e-5 relative, each net's gradient cosine ≥ 0.9999; K20 ×2, K21 ×2
    (forward and backward), K8 ×1, K22 ×1, K19 ×2."""
    from vwfd_tpu_torch import (CLR_CONFIG, load_config)
    from vwfd_tpu_torch.models.image_model import (ImageBatch,
                                                   ImageImmunizationModel)
    cfg = load_config(CLR_CONFIG)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, gt_size=64, batch_size=2),
        model=dataclasses.replace(cfg.model, inn_down_num=2,
                                  inn_block_num=(1, 1),
                                  localizer_residual_blocks=1),
        train=dataclasses.replace(cfg.train, dtype="float32"))
    model = ImageImmunizationModel(cfg, task="clr")
    model.init_states(3)
    ref = ImageImmunizationModel(cfg, task="clr", kernels=PLAIN)
    with torch.no_grad():
        for a, b in zip(ref._tensors(), model._tensors()):
            a.copy_(b)
    rng = np.random.default_rng(5)
    x = ((rng.integers(0, 255, (2, 64, 64, 3)) + 0.25) / 255).astype(
        np.float32)
    canny_ = (rng.random((2, 64, 64, 1)) > 0.85).astype(np.float32)
    mask_ = np.zeros((2, 64, 64, 1), np.float32)
    draws = model.sampler(2)((2, 64, 64))
    gk, gp = {}, {}
    lp = ref.train_step(ImageBatch(x, canny_, mask_), x[::-1].copy(), draws,
                        gp)
    reset_launch_counts()
    lk = model.train_step(ImageBatch(x, canny_, mask_), x[::-1].copy(),
                          draws, gk)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert {k: counts[k] for k in ("crop_cubic", "rectify", "ssim",
                                   "ssim_grad", "canny_soft")} == {
        "crop_cubic": 2, "rectify": 2, "ssim": 1, "ssim_grad": 1,
        "canny_soft": 2}
    for k in ("loss", "lF", "lB", "l_mask", "l_apex", "l_ce"):
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-5 * abs(float(lp[k]))
    for name in gk:
        a = torch.cat([t.flatten() for t in gk[name]])
        b = torch.cat([t.flatten() for t in gp[name]])
        assert float(torch.nn.functional.cosine_similarity(
            a, b, dim=0)) >= 0.9999, name


_FILM_SHAPES = [(6, 128, 64, 64), (6, 64, 128, 128), (6, 32, 256, 256),
                (3, 32, 128, 128), (3, 24, 256, 256), (3, 16, 512, 512),
                (2, 5, 7, 9)]


def _film_case(shape, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    x, h, cot = (torch.randn(shape, device="cuda", generator=g)
                 for _ in range(3))
    gamma = torch.rand(shape[:2], device="cuda", generator=g)
    beta = torch.rand(shape[:2], device="cuda", generator=g) * 2 - 1
    return [x, h, gamma, beta], cot


def _film_grads(fn, ins, cot):
    ins = [t.clone().requires_grad_(True) for t in ins]
    y = fn(*ins)
    return y.detach(), torch.autograd.grad(y, ins, cot)


@pytest.mark.parametrize("shape", _FILM_SHAPES)
def test_film_matches_plain(cuda, shape):
    ins, cot = _film_case(shape)
    before = launch_counts()["film_residual"]
    yk, gk = _film_grads(film.film_residual, ins, cot)
    assert launch_counts()["film_residual"] == before + 2
    yp, gp = _film_grads(film.film_residual_plain, ins, cot)
    assert torch.equal(yk, yp)
    assert torch.equal(gk[0], cot) and torch.equal(gk[1], gp[1])
    h = ins[1]
    for got, want, scale in ((gk[2], gp[2], (cot * h).abs().sum((2, 3))),
                             (gk[3], gp[3], cot.abs().sum((2, 3)))):
        assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_film_bit_identical_over_calls(cuda):
    for shape in _FILM_SHAPES[2], _FILM_SHAPES[5]:
        ins, cot = _film_case(shape, 1)
        a = _film_grads(film.film_residual, ins, cot)
        b = _film_grads(film.film_residual, ins, cot)
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(u, v) for u, v in zip(a[1], b[1]))


def test_film_with_frozen_gamma_beta(cuda):
    """The simulator's attack branch: γ and β take no gradient, so the
    backward skips its sums; x's and h's gradients as the plain
    version's."""
    (x, h, gm, bt), cot = _film_case((3, 16, 512, 512), 2)
    k = _film_grads(lambda a, b: film.film_residual(a, b, gm, bt), [x, h],
                    cot)
    p = _film_grads(lambda a, b: film.film_residual_plain(a, b, gm, bt),
                    [x, h], cot)
    assert torch.equal(k[0], p[0])
    assert all(torch.equal(u, v) for u, v in zip(k[1], p[1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_film_refuses_other_dtypes(cuda, dtype):
    ins, _ = _film_case((2, 4, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        film.film_residual(*(t.to(dtype) for t in ins))


def test_kdjpeg_step_on_the_card_matches_plain(cuda):
    """A small KD-JPEG step (FBCNN nc (8, 8, 16, 16), nb 2; 32², six
    images) through the kernels and through ``PLAIN`` from the same state:
    logs within 1e-5 relative, PSSIMU within 1e-3 dB, each net's gradient
    cosine ≥ 0.9999; K23 ×12 and no other kernel."""
    from vwfd_tpu_torch import KDJPEG_CONFIG
    from vwfd_tpu_torch.data import LQJpegDataset
    from vwfd_tpu_torch.models import KDJpegModel
    cfg = load_config(KDJPEG_CONFIG)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, gt_size=32, batch_size=6))
    kw = dict(nc=(8, 8, 16, 16), nb=2, disc_dim=8)
    model = KDJpegModel(cfg, **kw)
    model.init_states(3)
    ref = KDJpegModel(cfg, kernels=PLAIN, **kw)
    with torch.no_grad():
        for a, b in zip(ref._tensors(), model._tensors()):
            a.copy_(b)
    v, lab = LQJpegDataset(size=32, synthetic_length=1, seed=1)[0]
    flat, labels = KDJpegModel.collate(v[None], lab[None])
    gk, gp = {}, {}
    lp = ref.train_step(flat, labels, grads_out=gp)
    reset_launch_counts()
    lk = model.train_step(flat, labels, grads_out=gk)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {
        "film_residual": 12}
    for k in ("lQF", "l_simul", "l_simul_bayar", "qfsimu", "FW_GAN",
              "dis_loss"):
        assert abs(float(lk[k]) - float(lp[k])) <= 1e-5 * abs(float(lp[k]))
    assert abs(float(lk["PSSIMU"]) - float(lp["PSSIMU"])) <= 1e-3
    for name in gk:
        a = torch.cat([t.flatten() for t in gk[name]])
        b = torch.cat([t.flatten() for t in gp[name]])
        assert float(torch.nn.functional.cosine_similarity(
            a, b, dim=0)) >= 0.9999, name


# ------------------------------------------------------- data parallelism


def _small_flagship(batch, size=64, frames=4):
    cfg = load_config(FLAGSHIP_CONFIG)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=batch, gt_size=size, frames=frames))


def _dp_state(model):
    out = [t.detach().clone() for net in model.nets().values()
           for t in list(net.parameters()) + list(net.buffers())]
    for opt in model.optimizers.values():
        out += [t.clone() for t in opt.mu + opt.nu + [opt.count]]
    return out


def test_world_size_1_nccl_step_equals_the_plain_step(cuda, tmp_path):
    """One NCCL rank (a ``FileStore`` under ``tmp_path``): the data-parallel
    train step (the loss means, the PSNR's MSE and the gradient buckets
    all-reduced) and eval step (K7's counts, SSIM and PSNR all-reduced)
    are ``torch.equal`` to the steps without a group, from the same
    weights, batch, previous batch and draws, in bf16, with the same
    launch counts."""
    import torch.distributed as dist
    from vwfd_tpu_torch import parallel
    cfg = _small_flagship(2)
    plain = VideoWatermarkModel(cfg)
    plain.init_states(5)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        dp = VideoWatermarkModel(cfg, mesh=parallel.make_mesh())
        dp.load_states(plain.states())
        parallel.replicate(dp, dp.mesh)
        g = _gen(6)
        video = torch.rand(2, 4, 64, 64, 3, device=cuda, generator=g)
        prev = torch.rand(2, 4, 64, 64, 3, device=cuda, generator=g)
        mask = (torch.rand(2, 4, 64, 64, 1, device=cuda, generator=g)
                > 0.7).float()
        draws = plain.sample_draws(2, 4)
        counts = []
        for m in (plain, dp):
            reset_launch_counts()
            m.train_step(video, mask, prev, draws)
            torch.cuda.synchronize()
            counts.append(launch_counts())
        assert counts[0] == counts[1] and counts[0]["transition"] == 11
        assert all(torch.equal(a, b) for a, b in zip(_dp_state(dp),
                                                     _dp_state(plain)))
        assert parallel.replicas_equal(dp, dp.mesh)
        a = plain.eval_step(video, mask, prev, draws)
        b = dp.eval_step(video, mask, prev, draws)
        assert all(torch.equal(a[k], b[k]) for k in a)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("int8", [False, True])
def test_two_replica_server_on_one_card_against_one_device(cuda, int8):
    """``WatermarkServer(devices=("cuda:0", "cuda:0"))`` on the same
    weights as the one-device server, each replica launching the
    one-device counts on its half. With both int8 paths every kernel sums
    exactly, so embed, detect and roundtrip are EQUAL. In bf16 cuDNN takes
    other convolution kernels for the half batch (other sums): the
    watermark within one level, the mask bits on ≥ 99 % of pixels."""
    cfg = _small_flagship(4)
    modes = ("embed", "detect", "roundtrip")
    clip = np.random.default_rng(1).integers(0, 256, (4, 4, 64, 64, 3),
                                             dtype=np.uint8)
    kw = dict(modes=modes)
    if int8:
        kw.update(int8_extract=True, int8_embed=True, int8_calib=clip)
    one = WatermarkServer(cfg, **kw)
    two = WatermarkServer(cfg, devices=("cuda:0", "cuda:0"),
                          weights=one.model.states(), **kw)
    for mode in modes:
        want = one.serve(clip, mode)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = two.serve(clip, mode)
        got.prefetch()
        torch.cuda.synchronize()
        n2 = launch_counts()
        reset_launch_counts()
        one.serve(clip, mode).prefetch()
        torch.cuda.synchronize()
        n1 = launch_counts()
        assert n2 == {k: 2 * v for k, v in n1.items()}, mode
        for k in want.keys():
            if int8:
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(want, k), err_msg=mode)
        if not int8 and "watermarked" in want.keys():
            d = np.abs(got.watermarked.astype(int)
                       - want.watermarked.astype(int))
            assert d.max() <= 1, mode
        if not int8 and mode != "embed":
            assert (got.mask != want.mask).mean() < 1e-2, mode


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda:0"), torch.device("cuda:1")


def test_launch_runs_on_the_tensors_card(two_cards):
    """With the other card current, K3 and K1 launch on their tensors'
    card (``_lib.launch``'s device guard): both cards' results as their
    plain versions (K3 EQUAL, K1 within its tolerance)."""
    for dev, other in (two_cards, two_cards[::-1]):
        g = torch.Generator(dev).manual_seed(3)
        clip = torch.randint(0, 256, (2, 4, 32, 32, 3), device=dev,
                             generator=g, dtype=torch.uint8)
        x = torch.randn(2, 8, 8, 192, device=dev, generator=g)
        with torch.cuda.device(other):
            got = wire.to_channels(clip, torch.bfloat16)
            t = transition.transition(x, "p2p")
        torch.cuda.synchronize(dev)
        assert got.device == dev and t.device == dev
        assert torch.equal(got, wire.to_channels_plain(clip, torch.bfloat16))
        _close(t, transition.transition_plain(x, "p2p"))


# ------------------------------------------------------------ K24, K5 4:2:0,
# the JPEG-vs-adversarial study

def _dj_grads(fn, x, cot):
    xg = x.clone().requires_grad_(True)
    y = fn(xg)
    (g,) = torch.autograd.grad(y, xg, cot)
    return y.detach(), g


def _parted_mbs(got, want, atol):
    """(N, H/16, W/16): the 16×16 macroblocks (all channels) where |got −
    want| > atol."""
    n, h, w, c = got.shape
    d = (got - want).abs().reshape(n, h // 16, 16, w // 16, 16, c)
    return d.amax(dim=(2, 4, 5)) > atol


# the plan's shapes (tests/test_torch_diffjpeg_plan.py): one macroblock;
# the study's single image; 45 macroblocks (the first version's last CTA
# held one of four); a batch of 256² frames; a width past one unit's (the
# bytes route's ragged last unit)
DJ_SHAPES = [(1, 16, 16, 3), (1, 32, 32, 3), (3, 48, 80, 3),
             (8, 256, 256, 3), (2, 64, 1040, 3)]


def _dj_plans(shape, dev):
    """The card's plan for ``shape``, then the other route's (forced)."""
    from vwfd_tpu_torch.kernels import _lib, diffjpeg
    n, h, w, _ = shape
    p = diffjpeg.plan(n, h, w, _lib.sm_count(dev))
    return [p, diffjpeg.plan(n, h, w, _lib.sm_count(dev),
                             "latency" if p.route == "bytes" else "bytes")]


@pytest.mark.parametrize("shape", DJ_SHAPES)
@pytest.mark.parametrize("q", [75, 30])
def test_diffjpeg_kernel_matches_plain(cuda, shape, q):
    """K24 on each route at each shape: forward within 1e-5 and its
    gradient within 1e-5 of the plain max on every macroblock at the
    shapes of up to 45 macroblocks, and on every one where the plain
    version has no tie (``diffjpeg.tie_macroblocks``) at the larger; the
    two routes and ``diffjpeg`` (the card's plan) EQUAL to each other,
    each bit-identical over two calls; two launches a call."""
    from vwfd_tpu_torch.kernels import diffjpeg
    from vwfd_tpu_torch.ops.quantize import quality_to_factor
    g = _gen(27)
    x = torch.rand(shape, device=cuda, generator=g)
    x[:, :16, :16] = 1.0
    f = torch.full((shape[0],), quality_to_factor(q), device=cuda)
    cot = torch.randn(shape, device=cuda, generator=g)
    yp, gp = _dj_grads(lambda v: diffjpeg.diffjpeg_plain(v, f), x, cot)
    jump, tie = diffjpeg.tie_macroblocks(x, f)
    if jump.numel() <= 45:
        jump, tie = torch.zeros_like(jump), torch.zeros_like(tie)
    got = []
    for p in _dj_plans(shape, cuda):
        before = launch_counts()["diffjpeg"]
        runs = [_dj_grads(lambda v: diffjpeg._DiffJpegKernel.apply(v, f, p),
                          x, cot) for _ in range(2)]
        torch.cuda.synchronize()
        assert launch_counts()["diffjpeg"] == before + 4
        (yk, gk), (yk2, gk2) = runs
        assert torch.equal(yk, yk2) and torch.equal(gk, gk2), p.route
        bad = _parted_mbs(yk, yp, 1e-5) & ~jump
        gbad = _parted_mbs(gk, gp, 1e-5 * float(gp.abs().max())) & ~tie
        assert int(bad.sum()) == 0 and int(gbad.sum()) == 0, (
            p.route, int(bad.sum()), int(gbad.sum()), bad.numel())
        got.append((yk, gk))
    got.append(_dj_grads(lambda v: diffjpeg.diffjpeg(v, f), x, cot))
    for yk, gk in got[1:]:
        assert torch.equal(yk, got[0][0]) and torch.equal(gk, got[0][1])


def test_diffjpeg_nonfinite_as_plain(cuda):
    """With a NaN and an Inf pixel, each route's forward and gradient are
    NaN where the plain version's are (F21: their 16×16 macroblocks)."""
    from vwfd_tpu_torch.kernels import diffjpeg
    g = _gen(28)
    x = torch.rand(2, 48, 64, 3, device=cuda, generator=g)
    x[0, 5, 9, 1] = float("nan")
    x[1, 30, 40, 0] = float("inf")
    f = torch.full((2,), 0.5, device=cuda)
    cot = torch.randn(x.shape, device=cuda, generator=g)
    yp, gp = _dj_grads(lambda v: diffjpeg.diffjpeg_plain(v, f), x, cot)
    assert bool(yp.isnan().any())
    for p in _dj_plans(x.shape, cuda):
        yk, gk = _dj_grads(
            lambda v: diffjpeg._DiffJpegKernel.apply(v, f, p), x, cot)
        assert torch.equal(yk.isnan(), yp.isnan()), p.route
        assert torch.equal(gk.isnan(), gp.isnan()), p.route


def test_diffjpeg_off_the_16_byte_grid_equals_aligned(cuda):
    """K24 on an x and a cotangent 4 bytes off the 16-byte grid (as the
    slices of a flat ``torch.cat``): the wrapper hands the kernels aligned
    copies, so forward and gradient EQUAL those of aligned copies."""
    from vwfd_tpu_torch.kernels import diffjpeg
    g = _gen(30)
    shape = (2, 32, 48, 3)
    n = int(np.prod(shape))
    x = torch.rand(n + 1, device=cuda, generator=g)[1:].view(shape)
    cot = torch.randn(n + 1, device=cuda, generator=g)[1:].view(shape)
    assert x.data_ptr() % 16 and cot.data_ptr() % 16
    f = torch.full((2,), 0.5, device=cuda)
    xr = x.detach().requires_grad_()  # the view itself, off the grid
    yk = diffjpeg.diffjpeg(xr, f)
    (gk,) = torch.autograd.grad(yk, xr, cot)
    ya, ga = _dj_grads(lambda v: diffjpeg.diffjpeg(v, f), x.clone(),
                       cot.clone())
    assert torch.equal(yk.detach(), ya) and torch.equal(gk, ga)


def test_dryrun_multiprocess_default_passes_the_card(cuda):
    """``dryrun_multiprocess.run`` with no device starts its ranks with
    ``--device cuda`` where a card is present (the ranks stubbed)."""
    from unittest import mock
    from vwfd_tpu_torch import dryrun_multiprocess

    class Stop(Exception):
        pass

    with mock.patch.object(dryrun_multiprocess, "LocalRanks") as ranks:
        ranks.return_value.__enter__.return_value.wait.side_effect = Stop
        with pytest.raises(Stop):
            dryrun_multiprocess.run(2)
    cmd = ranks.call_args.args[0]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert ranks.call_args.args[1] == 2


@pytest.mark.parametrize("rounding", ["round", "ss"])
def test_jpeg_basic_420_on_k5_matches_plain(cuda, rounding):
    """K5's 4:2:0 mode against its plain version: 1e-4 outside flipped 8×8
    blocks (at most one in a thousand, or one), forward and gradient."""
    from vwfd_tpu_torch.attacks import jpeg_basic
    g = _gen(29)
    x = torch.rand(4, 64, 96, 3, device=cuda, generator=g)
    cot = torch.randn(x.shape, device=cuda, generator=g)
    for q in (0, 2, 4):
        before = launch_counts()["jpeg_pair"]
        yk, gk = _dj_grads(lambda v: jpeg_basic(v, q, rounding, subsample=2),
                           x, cot)
        yp, gp = _dj_grads(lambda v: jpeg_basic(v, q, rounding, subsample=2,
                                                kernels=PLAIN), x, cot)
        torch.cuda.synchronize()
        assert launch_counts()["jpeg_pair"] == before + 2
        bad, blocks = _flipped_blocks(yk, yp, 1e-4)
        gbad, _ = _flipped_blocks(gk, gp, 1e-4 * float(gp.abs().max()))
        assert max(bad, gbad) <= max(1, blocks // 1000), (q, bad, gbad)


def test_study_jpeg_resistant_launches_k24_on_every_step(cuda):
    """``python -m vwfd_tpu_torch.jpegadv_experiment --attack
    jpeg_resistant`` on the card: K24 forward and backward on each of the
    10 steps of each image, and no other kernel."""
    import contextlib
    import io
    from vwfd_tpu_torch import jpegadv_experiment as study
    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = study.main(["--attack", "jpeg_resistant", "--n", "2"])
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {
        "diffjpeg": 40}
    assert 0.0 <= summary["adv_fooled_rate"] <= 1.0


def test_library_losses_on_the_card_match_the_cpu(cuda):
    from vwfd_tpu_torch.metrics import losses as L
    g = torch.Generator().manual_seed(30)
    a, b = torch.rand(2, 16, 24, 3, generator=g), \
        torch.rand(2, 16, 24, 3, generator=g)
    for name in ("smooth_l1", "reconstruction_loss", "ssim_loss_map",
                 "exclusion_loss", "gradient_loss", "grayscale_loss",
                 "std_loss"):
        fn = getattr(L, name)
        want = fn(a, b) if name not in ("gradient_loss", "std_loss") \
            else fn(a)
        got = (fn(a.to(cuda), b.to(cuda))
               if name not in ("gradient_loss", "std_loss")
               else fn(a.to(cuda)))
        _close(got.cpu(), want)
