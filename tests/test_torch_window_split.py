"""The arithmetic of K18's products on the main path (d = 32, the
tensor-core kernels of ``csrc/window_attention.cu``), modelled in torch on
the CPU: 3×TF32.

Each operand x of a product is split as ``hi = tf32_rna(x)`` (the mantissa
rounded to 10 bits, ties away from zero, as ``cvt.rna.tf32.f32``) and
``lo = tf32_rna(x − hi)``, lo being 0 where hi is not finite; a product is
``lo·hi + hi·lo + hi·hi`` (lo·lo dropped) summed in float32. The model runs
K18's forward and backward in the kernel's order of operations (e =
2^((s − max)·log2 e), P = e · (1 / Σe), δ = Σ P·dP, dS = P·(dP − δ), the
table's gradient binned from dS) at SUNet's stage-0 and stage-3 shapes and
is held against the float64 plain version: every output sits well under
``WINATT_RTOL`` (1e-5 of the plain max), the tolerance ``chip_smoke.py``
holds the card to. A NaN and an Inf in q give NaN at the float32 plain
version's places, forward and gradients. This is the CPU's prediction of
the card's check, not a run of the kernel.
"""

import numpy as np
import pytest
import torch

from vwfd_tpu_torch.kernels import window_attention as k18

WINATT_RTOL = 1e-5  # chip_smoke.py's tolerance for K18
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
ROOM = 0.25         # the model's error stays under a quarter of it


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value, ties away from zero (non-finite
    values unchanged): add half of the 13 dropped bits to the magnitude,
    then clear them."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


def split(x: torch.Tensor):
    """(hi, lo): the kernel's split, lo 0 where hi is not finite."""
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    return hi, torch.where(torch.isfinite(hi), lo, torch.zeros_like(x))


def mm3(a: torch.Tensor, b: torch.Tensor):
    """a @ b as K18's tensor cores form it, float32."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def windows(qkv, ws, shift):
    """(nW·B, heads, N, d) q, k, v of the map, as the kernel gathers them."""
    b, hm, wm, _, h, d = qkv.shape
    x = qkv.reshape(b, hm, wm, -1)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    w = k18.window_partition(x, ws).reshape(-1, ws * ws, 3, h, d)
    return [w[:, :, i].transpose(1, 2) for i in range(3)]


def unwindows(o, ws, shift, hm, wm):
    """(nW·B, heads, N, d) → the map (B, Hm, Wm, heads·d)."""
    bnw, h, n, d = o.shape
    y = k18.window_reverse(o.transpose(1, 2).reshape(bnw, ws, ws, h * d),
                           ws, hm, wm)
    return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y


def bias_and_mask(table, ws, shift, hm, wm, b):
    n = ws * ws
    idx = torch.from_numpy(k18.relative_index(ws).reshape(-1))
    bias = table[idx].reshape(n, n, -1).permute(2, 0, 1)[None]
    mask = None
    if shift:
        mask = torch.from_numpy(k18.shift_mask(ws, hm, wm, shift)).repeat(
            b, 1, 1)[:, None]
    return idx, bias, mask


def scores(q, k, bias, mask, scale):
    s = mm3(q, k.transpose(-1, -2)) * scale + bias
    return s + mask if mask is not None else s


def model(qkv, table, cot, ws, shift):
    """K18's forward and backward in 3×TF32: (out, dqkv, dtable)."""
    b, hm, wm, _, h, d = qkv.shape
    scale = np.float32(d ** -0.5)
    q, k, v = windows(qkv, ws, shift)
    idx, bias, mask = bias_and_mask(table, ws, shift, hm, wm, b)
    s = scores(q, k, bias, mask, scale)
    # __expf: ex2.approx of the argument times log2(e), rounded to float32
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * LOG2E)
    p = e * (1.0 / e.sum(-1, keepdim=True))
    out = unwindows(mm3(p, v), ws, shift, hm, wm)
    go = windows(torch.stack([cot.reshape(b, hm, wm, h, d)] * 3, 3), ws,
                 shift)[0]
    dp = mm3(go, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dv = mm3(p.transpose(-1, -2), go)
    dq = mm3(ds, k) * scale
    dk = mm3(ds.transpose(-1, -2), q) * scale
    n = ws * ws
    dtable = torch.zeros_like(table).index_add_(
        0, idx, ds.sum(0).permute(1, 2, 0).reshape(n * n, h))
    dqkv = torch.stack([unwindows(t, ws, shift, hm, wm).reshape(
        b, hm, wm, h, d) for t in (dq, dk, dv)], 3)
    return out, dqkv, dtable


def plain(qkv, table, cot, ws, shift):
    q = qkv.clone().requires_grad_(True)
    t = table.clone().requires_grad_(True)
    y = k18.window_attention_plain(q, t, ws, shift)
    dq, dt = torch.autograd.grad(y, (q, t), cot)
    return y.detach(), dq, dt


def inputs(shape, ws, seed):
    g = np.random.default_rng(seed)
    b, hm, wm, _, h, d = shape
    return (torch.from_numpy(g.standard_normal(shape).astype(np.float32)),
            torch.from_numpy((0.02 * g.standard_normal(
                ((2 * ws - 1) ** 2, h))).astype(np.float32)),
            torch.from_numpy(g.standard_normal((b, hm, wm, h * d)).astype(
                np.float32)))


def test_tf32_rna_rounds_ties_away_and_keeps_nonfinite():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0e38, float("inf"),
                      float("nan")], dtype=torch.float32)
    r = tf32_rna(x)
    assert r[0] == 1.0 + 2.0 ** -10 and r[1] == -(1.0 + 2.0 ** -10)
    assert r[2] == 1.0
    assert (r[:4].view(torch.int32) & 0x1FFF == 0).all()
    assert r[4] == float("inf") and torch.isnan(r[5])
    hi, lo = split(torch.randn(1000, generator=torch.Generator()
                               .manual_seed(0)))
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()


# (map qkv, ws, shift): SUNet's stage 0 (heads 3, shifted) and stage 3
# (heads 24) at the published widths, a few windows each
SHAPES = [((1, 16, 16, 3, 3, 32), 8, 4), ((1, 8, 8, 3, 24, 32), 8, 0)]


@pytest.mark.parametrize("shape,ws,shift", SHAPES)
def test_split_products_within_rtol_of_float64(shape, ws, shift):
    qkv, table, cot = inputs(shape, ws, 18)
    got = model(qkv, table, cot, ws, shift)
    want = plain(qkv.double(), table.double(), cot.double(), ws, shift)
    f32 = plain(qkv, table, cot, ws, shift)
    for name, a, b, c in zip(("forward", "dqkv", "dtable"), got, want, f32):
        m = float(b.abs().max())
        e = float((a.double() - b).abs().max())
        e32 = float((c.double() - b).abs().max())
        assert e <= ROOM * WINATT_RTOL * m, (name, e, m)
        # on par with float32 itself: 3×TF32 loses no more than a few ulps
        assert e <= 8 * e32 + 1e-7 * m, (name, e, e32)


def test_nonfinite_q_gives_nan_at_the_plain_places():
    shape, ws, shift = (2, 16, 16, 3, 3, 32), 8, 4
    qkv, table, cot = inputs(shape, ws, 19)
    qkv[0, 1, 5, 0, 2, 7] = float("nan")
    qkv[1, 7, 4, 0, 0, 1] = float("inf")
    got = model(qkv, table, cot, ws, shift)
    want = plain(qkv, table, cot, ws, shift)
    for a, b in zip(got, want):
        assert torch.equal(a.isnan(), b.isnan())
        assert bool(b.isnan().any())
        fin = b.isfinite()
        e = float((a[fin] - b[fin]).abs().max())
        assert e <= WINATT_RTOL * float(b[fin].abs().max())
    # without the rule lo is NaN wherever q is not finite
    hi = tf32_rna(qkv)
    assert bool((qkv - hi).isnan().any()) and not bool(split(qkv)[1]
                                                      .isnan().any())
