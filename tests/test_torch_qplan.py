"""The host plan of the int8 wgmma core (``kernels/qconv.py::plan``) at every
K11, K12 and K13 launch of the flagship int8 detect and roundtrip (batch 16,
T = 4, 256²) and at the ragged shapes the card checks use, against TMA's
rules and the block's shared memory; K12's output address function against
its plain version's scatter; and the quantized input ``xi`` that
K11's trunk conv writes for K13, against JAX's ``xi``
(``vwfd_tpu/nets/inn_int8.py:248-250``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu_torch.kernels import PLAIN, qconv, qconv_t, qcoupling
from vwfd_tpu_torch.nets import inn_int8

_BASE = 0x7F00_0000_0000  # a 256-byte aligned device address
_N, _H, _F = 64, 128, 64  # the UNet's frames, s2d size and width

# (name, n, h, w, cin, cout, k, kind, cin2, epilogue, ld, split)
_FLAGSHIP = [
    ("enc1.0", _N, _H, _H, 12, _F, 3, "int8", 0, "relu", None, 0),
    ("enc1.1", _N, _H, _H, _F, _F, 3, "int8", 0, "relu", None, 0),
    ("enc2.0", _N, _H // 2, _H // 2, _F, 2 * _F, 3, "pool", 0, "relu", None,
     0),
    ("enc2.1", _N, _H // 2, _H // 2, 2 * _F, 2 * _F, 3, "int8", 0, "relu",
     None, 0),
    ("enc3", _N, _H // 4, _H // 4, 2 * _F, 4 * _F, 3, "pool", 0, "relu",
     None, 0),
    ("enc4", _N, _H // 8, _H // 8, 4 * _F, 8 * _F, 3, "pool", 0, "relu",
     None, 0),
    ("bottleneck", _N, _H // 16, _H // 16, 8 * _F, 16 * _F, 3, "pool", 0,
     "relu", None, 0),
    ("dec4", _N, _H // 8, _H // 8, 8 * _F, 8 * _F, 3, "int8", 8 * _F, "relu",
     None, 0),
    ("dec3", _N, _H // 4, _H // 4, 4 * _F, 4 * _F, 3, "int8", 4 * _F, "relu",
     None, 0),
    ("dec2", _N, _H // 2, _H // 2, 2 * _F, 2 * _F, 3, "int8", 2 * _F, "relu",
     None, 0),
    ("dec1", _N, _H, _H, _F, _F, 3, "int8", _F, "relu", None, 0),
    ("head", _N, _H, _H, _F, 4, 1, "int8", 0, "f32", None, 0),
    ("inn.96.conv0", 16, 64, 64, 96, 128, 3, "bfloat16", 0, "elu", 192, 0),
    ("inn.96.conv1", 16, 64, 64, 128, 128, 3, "int8", 0, "elu", None, 0),
    ("inn.384.conv0", 16, 32, 32, 384, 128, 3, "bfloat16", 0, "elu", 768, 0),
    ("inn.384.conv1", 16, 32, 32, 128, 128, 3, "int8", 0, "elu", None, 0),
    ("k13.96", 16, 64, 64, 96, 192, 1, "int8", 128, "f32", None, 96),
    ("k13.384", 16, 32, 32, 384, 768, 1, "int8", 128, "f32", None, 384),
]
_RAGGED = [
    ("ragged.relu", 3, 13, 21, 12, 70, 3, "int8", 0, "relu", None, 0),
    ("ragged.pool", 2, 9, 17, 64, 96, 3, "pool", 0, "relu", None, 0),
    ("ragged.dual", 2, 7, 11, 64, 40, 3, "int8", 32, "relu", None, 0),
    ("ragged.signed", 1, 7, 9, 32, 70, 3, "int8", 0, "signed", None, 0),
    ("ragged.elu_f32", 2, 10, 12, 40, 72, 3, "float32", 0, "elu", 80, 0),
    ("ragged.1x1", 3, 5, 6, 20, 24, 1, "int8", 0, "relu", None, 0),
    ("ragged.k13", 2, 5, 7, 40, 80, 1, "bfloat16", 24, "f32", 80, 40),
]


def _plan(case, sms=132):
    _, n, h, w, cin, cout, k, kind, cin2, epi, ld, split = case
    return qconv.plan(n, h, w, cin, cout, k, kind=kind, ld=ld, x_ptr=_BASE,
                      w_ptr=_BASE + 0x100_0000, cin2=cin2,
                      x2_ptr=_BASE + 0x200_0000 if cin2 else 0,
                      w2_ptr=_BASE + 0x300_0000 if cin2 else 0,
                      epilogue=epi, split=split, sms=sms)


@pytest.mark.parametrize("case", _FLAGSHIP + _RAGGED, ids=lambda c: c[0])
def test_plan_respects_tma_rules_and_shared_memory(case):
    pl = _plan(case)
    assert pl.smem + 256 <= qconv.SMEM_LIMIT
    assert 2 <= pl.stages <= qconv.MAX_STAGES
    assert pl.bn in (64, 128) and pl.kc == (32 if case[6] == 3 else 128)
    assert 1 <= pl.grid <= 132 and pl.grid % pl.groups == 0
    tma_names = {name for name, *_ in pl.maps}
    for o, (a, b) in enumerate(pl.loaders):
        assert (a == "tma") == (f"a{o}" in tma_names)
        assert (b == "tma") == (f"b{o}" in tma_names)
        assert bool(pl.tma >> (2 * o) & 1) == (a == "tma")
        assert bool(pl.tma >> (2 * o + 1) & 1) == (b == "tma")
    for name, base, dims, strides, box in pl.maps:
        assert base % 16 == 0, name
        assert all(s % 16 == 0 and s < 2 ** 40 for s in strides), name
        assert all(1 <= b <= 256 for b in box) and box[0] % 16 == 0, name
        assert all(1 <= d < 2 ** 32 for d in dims), name
        assert len(strides) == len(dims) - 1 and len(box) == len(dims)


@pytest.mark.parametrize("case", _FLAGSHIP + _RAGGED, ids=lambda c: c[0])
def test_plan_routes_what_tma_cannot_describe_to_threads(case):
    """TMA wherever the 16-byte rule holds for an int8 copy; ``cp.async``
    for int8 sources off the grid (enc1's Cin 12, the ragged widths); the
    pool and quantize prologues on the producer's threads."""
    _, n, h, w, cin, cout, k, kind, cin2, epi, ld, split = case
    a, b = _plan(case).loaders[0]
    ld = cin if ld is None else ld
    if kind == "int8":
        assert a == ("tma" if ld % 16 == 0 else "cp.async")
    else:
        assert a == ("pool" if kind == "pool" else "quant")
    assert b == ("tma" if cin % 16 == 0 else "cp.async")


def test_plan_enc1_and_ragged_copies_take_cp_async():
    plans = {c[0]: _plan(c) for c in _FLAGSHIP + _RAGGED}
    for name in ("enc1.0", "ragged.relu", "ragged.1x1"):
        assert plans[name].loaders[0] == ("cp.async", "cp.async"), name
    assert plans["dec1"].loaders == (("tma", "tma"), ("tma", "tma"))
    assert plans["k13.384"].loaders == (("tma", "tma"), ("tma", "tma"))


def test_plan_geometry():
    """3×3 stages hold a 18 × 10 halo of 32 channels and the weights of nine
    taps; 1×1 stages 128-byte rows; BN 64 up to 64 columns, else 128 (K13:
    the s and t rows of 64 channels); the grid is a whole number of column
    blocks."""
    enc = _plan(_FLAGSHIP[1])  # enc1.1: 64 → 64
    assert enc.bn == 64 and enc.maps[0][4] == (16, 10, 18, 1)
    dec4 = _plan(_FLAGSHIP[7])
    assert dec4.bn == 128 and dec4.grid == 4 * (132 // 4)
    k13 = _plan(_FLAGSHIP[17])
    assert k13.bn == 128 and k13.grid == 6 * (132 // 6)
    # 1x1: rows of 128 bytes (the swizzled layout)
    assert [m[4] for m in k13.maps if m[0].startswith("b")] == [(128, 64)] * 2
    assert _plan(_FLAGSHIP[11]).maps[0][4] == (128, 8, 16, 1)  # the head
    small = _plan(_RAGGED[3], sms=1)  # 2 tiles, one block walks both
    assert small.groups == 1 and small.grid == 1
    with pytest.raises(ValueError):
        qconv.plan(2, 8, 8, 64, 64, 3, stages=1)


def test_plan_stage_override_and_resident_weights():
    """A ring whose depth a tile's stage count divides keeps the weights
    resident; the producer's threads need 3 slots (their stages arrive one
    behind), TMA alone 2."""
    two = qconv.plan(64, 64, 64, 128, 128, 3, x_ptr=_BASE, w_ptr=_BASE,
                     stages=2)
    four = qconv.plan(64, 64, 64, 128, 128, 3, x_ptr=_BASE, w_ptr=_BASE)
    assert two.stages == 2 and four.stages == 4 and two.smem < four.smem
    assert four.b_resident and not two.b_resident  # 4 stages a tile
    deep = qconv.plan(64, 16, 16, 512, 512, 3, x_ptr=_BASE, w_ptr=_BASE,
                      cin2=512, x2_ptr=_BASE, w2_ptr=_BASE)
    assert deep.stages == 4 and not deep.b_resident  # 32 stages a tile
    with pytest.raises(ValueError):
        qconv.plan(64, 64, 64, 64, 128, 3, kind="pool", x_ptr=_BASE,
                   w_ptr=_BASE, stages=2)
    assert qconv.plan(64, 64, 64, 96, 128, 3, kind="bfloat16", ld=192,
                      x_ptr=_BASE, w_ptr=_BASE).stages == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv_plain_xi_equals_jax_xi(dtype):
    """``qconv_plain(..., xi_out=)`` writes JAX's ``xi`` =
    clip(round(xin / s_x), -127, 127) of the same (channel-slice) input."""
    rng = np.random.default_rng(40)
    full = rng.standard_normal((2, 6, 7, 2 * 24)).astype(np.float32) * 2
    s_x = np.float32(0.013)
    x = torch.from_numpy(full).to(dtype)[..., 24:]
    xf = x.float().numpy()
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(xf) / s_x), -127, 127)
                      .astype(jnp.int8))
    assert np.abs(want).max() == 127  # the clip is reached
    w = torch.from_numpy(rng.integers(-127, 128, (8, 3, 3, 24),
                                      dtype=np.int8))
    m = torch.full((8,), 1e-4)
    b = torch.zeros(8)
    xi = torch.empty(x.shape, dtype=torch.int8)
    h0 = qconv.qconv_plain(x, w, m, b, "elu", x_scale=torch.tensor(s_x),
                           out_scale=torch.tensor(0.02), xi_out=xi)
    np.testing.assert_array_equal(xi.numpy(), want)
    same = qconv.qconv(x, w, m, b, "elu", x_scale=torch.tensor(s_x),
                       out_scale=torch.tensor(0.02))
    assert torch.equal(h0, same)
    with pytest.raises(ValueError):
        qconv.qconv_plain(x, w, m, b, "elu", x_scale=torch.tensor(s_x),
                          out_scale=torch.tensor(0.02),
                          xi_out=torch.empty((2, 6, 7, 23),
                                             dtype=torch.int8))


def test_qcoupling_plain_on_xi_equals_quantizing_itself():
    rng = np.random.default_rng(41)
    c, f = 16, 8
    z = torch.from_numpy(rng.standard_normal((2, 5, 6, 2 * c))
                         .astype(np.float32)).to(torch.bfloat16)
    p = {"w2x": torch.from_numpy(rng.integers(-127, 128, (2 * c, 1, 1, c),
                                              dtype=np.int8)),
         "w2h": torch.from_numpy(rng.integers(-127, 128, (2 * c, 1, 1, f),
                                              dtype=np.int8)),
         "m2x": torch.full((2 * c,), 1e-4), "m2h": torch.full((2 * c,), 2e-4),
         "b2": torch.from_numpy(rng.standard_normal(2 * c)
                                .astype(np.float32)) * 0.1,
         "s_x": torch.tensor(0.02)}
    h1i = torch.from_numpy(rng.integers(-127, 128, (2, 5, 6, f),
                                        dtype=np.int8))
    xin, x = z[..., c:], z[..., :c]
    xi = qconv.quantize_input(xin, p["s_x"]).contiguous()
    a = qcoupling.qcoupling_head(xin, h1i, p, x, xi=xi)
    b = qcoupling.qcoupling_head_plain(xin, h1i, p, x)
    assert torch.equal(a, b)


def test_forward_int8_threads_xi_from_conv0_to_the_head():
    """Per subnet evaluation: conv0 gets ``xi_out``, conv1 none, and the head
    gets the same tensor as ``xi``, holding conv0's quantized input; still
    two K11 launches and one K13 a subnet evaluation."""
    torch.manual_seed(0)
    from vwfd_tpu_torch.nets.inn import InvertibleNet
    net = InvertibleNet(channels=12, down_num=3, block_num=(1, 1, 1)).eval()
    with torch.no_grad():
        for prm in net.parameters():
            prm.add_(0.01 * torch.randn_like(prm))
    x = torch.rand((1, 16, 16, 12))
    q = inn_int8.quantize(net, inn_int8.calibrate(net, [x]))
    calls = []

    def rec_conv(*a, **kw):
        calls.append(("conv", kw.get("xi_out")))
        out = qconv.qconv_plain(*a, **kw)
        if kw.get("xi_out") is not None:
            assert torch.equal(kw["xi_out"], qconv.quantize_input(
                a[0], kw["x_scale"]))
        return out

    def rec_head(*a, **kw):
        calls.append(("head", kw.get("xi")))
        return qcoupling.qcoupling_head_plain(*a, **kw)

    inn_int8.forward_int8(q, x, dtype=None, kernels=PLAIN._replace(
        qconv=rec_conv, qcoupling_head=rec_head))
    assert len(calls) == 30
    for i in range(0, 30, 3):
        (k0, xi0), (k1, xi1), (k2, xi2) = calls[i:i + 3]
        assert (k0, k1, k2) == ("conv", "conv", "head")
        assert xi0 is not None and xi1 is None and xi2 is xi0


@pytest.mark.parametrize("kernel", ["qconv", "qconv_t"])
def test_ablate_qconv_patches_hold_on_the_source(kernel):
    """Each variant's patches find their text of ``qwgmma.cuh`` or of the
    kernel's own source (K11's ``qconv.cu``, K12's ``qconv_t.cu``) exactly
    once and change it; the plan overrides are ``launch_args`` keywords."""
    import inspect

    from vwfd_tpu_torch import ablate_qconv
    src_name, _, launch_args = ablate_qconv._KERNELS[kernel]
    src = {f: (qconv._lib.CSRC / f).read_text()
           for f in ("qwgmma.cuh", src_name)}
    assert {"base", "no_mma", "no_tma", "no_store", "no_epi", "stages2",
            "a_cpasync"} == set(ablate_qconv._VARIANTS)
    params = inspect.signature(launch_args).parameters
    for name, (patches, overrides) in ablate_qconv._VARIANTS.items():
        patched = ablate_qconv._sources(name, kernel)
        for f, old, new in patches:
            assert f in ("qwgmma.cuh", "qconv.cu", "qconv_t.cu"), f
            if f not in src:  # the other kernel's patch
                continue
            assert src[f].count(old) == 1 and old != new, (name, old)
            assert patched[f] != src[f], (name, f)
        assert set(overrides) <= set(params), name
    # the store cut reaches each kernel
    assert ablate_qconv._sources("no_store", kernel)[src_name] != \
        src[src_name]


# K12's launches of the flagship int8 detect, (name, N, h, w, Cin, Cout)
_UPS = [("up4", _N, 8, 8, 16 * _F, 8 * _F),
        ("up3", _N, 16, 16, 8 * _F, 4 * _F),
        ("up2", _N, 32, 32, 4 * _F, 2 * _F),
        ("up1", _N, 64, 64, 2 * _F, _F)]


@pytest.mark.parametrize("case", _UPS, ids=lambda c: c[0])
def test_qconv_t_plan_is_the_stacked_1x1_gemm(case):
    """K12's plan at the flagship's four upsamples: both operands by TMA
    (16-byte rules), shared memory within the limit, the batch stacked as
    one (1, N·h, w) image, 4·Cout columns in 128-byte swizzled rows, and
    the weights resident where a tile's stages divide the ring (up1–up3;
    up4's eight stages stream)."""
    name, n, h, w, cin, cout = case
    pl = qconv_t.plan(n, h, w, cin, cout, x_ptr=_BASE,
                      w_ptr=_BASE + 0x100_0000)
    assert pl.ks == 1 and pl.kc == 128 and pl.bn == 128
    assert pl.loaders == (("tma", "tma"),) and pl.tma == 3
    assert pl.smem + 256 <= qconv.SMEM_LIMIT
    assert 2 <= pl.stages <= qconv.MAX_STAGES
    maps = {m[0]: m for m in pl.maps}
    assert maps["a0"][2:] == ((cin, w, n * h, 1),
                              (cin, cin * w, cin * w * n * h),
                              (128, 8, 16, 1))
    assert maps["b0"][2:] == ((cin, 4 * cout), (cin,), (128, 128))
    for _, base, dims, strides, box in pl.maps:
        assert base % 16 == 0 and all(s % 16 == 0 for s in strides)
        assert all(1 <= d < 2 ** 32 for d in dims)
    per_tile = -(-cin // 128)
    assert pl.b_resident == (name != "up4")
    assert pl.b_resident == (pl.stages % per_tile == 0)
    tiles = -(-n * h // 16) * -(-w // 8)
    nblk = 4 * cout // 128
    assert pl.groups == min(tiles, 132 // nblk)
    assert pl.grid == pl.groups * nblk <= 132


def test_qconv_t_store_route():
    """The flagship's four launches (Cout 512 .. 64) leave by TMA stores;
    Cout off the 64-column grid by 16-byte runs, off the 8-column grid by
    bytes; BN 64 never by TMA."""
    for *_, cout in _UPS:
        assert qconv_t.store_route(cout, 128) == "tma"
    assert qconv_t.store_route(24, 128) == "16-byte"
    assert qconv_t.store_route(20, 128) == "bytes"
    assert qconv_t.store_route(64, 64) == "16-byte"


def test_qconv_t_plan_routes_ragged_widths_to_threads():
    """Cin off the 16-byte grid goes by ``cp.async`` (4-byte units), with
    the three slots the producer's threads need; 4·Cout ≤ 64 takes BN 64."""
    pl = qconv_t.plan(3, 5, 7, 40, 24, x_ptr=_BASE, w_ptr=_BASE)
    assert pl.loaders == (("cp.async", "cp.async"),) and pl.tma == 0
    assert pl.stages >= 3 and pl.bn == 128
    assert qconv_t.plan(2, 3, 3, 24, 12, x_ptr=_BASE, w_ptr=_BASE).bn == 64


@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 8, 8, 32, 16),
                                            (3, 5, 7, 24, 12),
                                            (2, 3, 9, 16, 20)])
def test_qconv_t_out_index_is_the_plain_versions_scatter(n, h, w, cin, cout):
    """``qconv_t.out_index`` (the epilogue's address function) sends every
    (stacked row, column, GEMM column) of the stacked GEMM's requantized
    result to the element ``qconv_t_plain`` writes: the scattered GEMM
    equals the plain version, and the map is a bijection onto the output.
    The shapes put image boundaries inside a 16-row tile (h 8, 5 and 3)
    and take a Cout off the 8-column grid."""
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, cin),
                                      dtype=np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (2, 2, cout, cin),
                                       dtype=np.int8))
    m = torch.from_numpy((0.02 * (0.5 + rng.random(cout))).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    assert (n * h) % 16 and h % 16  # a 16-row tile spans images
    acc = x.reshape(-1, cin).long() @ wt.reshape(4 * cout, cin).long().t()
    cols = torch.arange(4 * cout)
    vals = qconv.requant(acc.float() * m[cols % cout] + b[cols % cout], -127)
    r = torch.arange(n * h).repeat_interleave(w)[:, None]
    j = torch.arange(w).repeat(n * h)[:, None]
    idx = qconv_t.out_index(r, j, cols[None, :], w, cout)
    out = torch.zeros(n * 2 * h * 2 * w * cout, dtype=torch.int8)
    out[idx.reshape(-1)] = vals.reshape(-1)
    assert torch.equal(torch.sort(idx.reshape(-1)).values,
                       torch.arange(out.numel()))
    want = qconv_t.qconv_t_plain(x, wt, m, b)
    assert torch.equal(out.reshape(want.shape), want)
    # one element by hand: image 1, pixel (i, j) = (h - 1, 2), p = q = 1
    i0, j0, co = h - 1, 2 % w, cout - 1
    flat = qconv_t.out_index(h + i0, j0, 3 * cout + co, w, cout)
    assert flat == ((1 * 2 * h + 2 * i0 + 1) * 2 * w + 2 * j0 + 1) * cout + co
