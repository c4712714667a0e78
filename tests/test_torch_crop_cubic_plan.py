"""K20 ``crop_cubic``'s launch plan and a float32 model of its kernels, on
the CPU.

The kernels (``csrc/crop_cubic.cu``) run on the card only
(``tests/test_torch_gpu.py``); what decides their coverage and their order
of summation is modelled here with the plain version's own taps
(``ops/resize.py``: the float32 positions, the clamped indices, the
weights' FMAs):

* ``kernels/crop_cubic.py::plan``: each output row and column taken once
  forward, each input row and column once backward, shared memory within a
  CTA's, at widths from 1 to 20,000 and with downsampling and upsampling
  ``out_hw``; the forward's row sums fit ``fwd_smem`` for every tile of
  every window (``fwd_span``);
* the backward's ranges as the kernel finds them on the device (the output
  rows of a band by the closed form stepped to the exact index, the output
  columns of a tile widened, each pixel's own stepped on the table) against
  a brute force over the clamped taps, for windows inside, on each edge,
  one pixel, one row and the whole image;
* the backward's walk (four accumulators rolling down the band, rows stored
  as no later output row taps them) EQUAL to the first version's separable
  transpose summed j ascending, then i ascending, taps in order, and within
  ``CUBIC_GRAD_RTOL`` (1e-5) of the plain version's autograd gradient's max
  and of JAX's (autograd and XLA sum the same products in other orders);
* the forward's separable sums EQUAL to the plain version;
* the plan's constants and the C interface's argument counts against the
  source and ``_lib``.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.ops import resize as jresize
from vwfd_tpu_torch.kernels import _lib, crop_cubic
from vwfd_tpu_torch.kernels._lib import CSRC
from vwfd_tpu_torch.ops.resize import cubic_weights

F32 = np.float32
SMS = 132  # the H100's SMs; the plan takes the card's count as an argument
SMEM_CTA = 227 * 1024
CUBIC_GRAD_RTOL = 1e-5
_NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}
TERMS = 10  # csrc/crop_cubic.cu kTerms

# windows of a 40 × 70 image: inside, on the top-left and bottom-right
# edges, one pixel, one row, the whole image
APEXES = [(3.0, 37.0, 5.0, 66.0), (0.0, 20.0, 0.0, 30.0),
          (19.0, 40.0, 41.0, 70.0), (9.0, 10.0, 4.0, 5.0),
          (7.0, 8.0, 0.0, 70.0), (0.0, 40.0, 0.0, 70.0)]
# out_hw: the input's, upsampled, and downsampled as the card tests do (rows
# by 5 in the last, so that output rows skip input rows)
OUT_HWS = [None, (56, 90), (32, 48), (96, 20), (8, 48)]


def _axis(o, lo, hi):
    """An axis of o outputs through the window [lo, hi): the float32
    positions, the clamped taps (o, 4) and their weights (o, 4), as the
    plain version and ``csrc/cubic.cuh`` compute them, and the integer
    bounds."""
    f = torch.float32
    lo_t, hi_t = torch.tensor(lo, dtype=f), torch.tensor(hi, dtype=f)
    pos = lo_t + (torch.arange(o, dtype=f) + 0.5) * (hi_t - lo_t) \
        / torch.full((), o, dtype=f) - 0.5
    base = torch.floor(pos)
    lo_i, hi_i = lo_t.to(torch.int64), (hi_t - 1).to(torch.int64)
    idx = torch.minimum(torch.maximum(
        base.to(torch.int64)[:, None] + torch.arange(-1, 3), lo_i), hi_i)
    w = torch.stack(cubic_weights(pos - base), 1) if o else \
        torch.zeros((0, 4))
    return pos.numpy(), idx.numpy(), w.numpy(), int(lo_i), int(hi_i)


def _first_base_at_least(b, o, lo, hi, pos):
    """The kernel's ``first_base_at_least``: the first output index whose
    tap base is ≥ b, from the closed form's estimate stepped on the exact
    positions; and the steps taken."""
    length = float(F32(hi) - F32(lo))
    e = ((b + 0.5 - lo) * o / length - 0.5) if length > 0 else 0.0
    j = 0 if not length > 0 or e <= 0 else o if e >= o else math.ceil(e)
    steps = 0
    while j > 0 and math.floor(pos[j - 1]) >= b:
        j, steps = j - 1, steps + 1
    while j < o and math.floor(pos[j]) < b:
        j, steps = j + 1, steps + 1
    return j, steps


def _tapping(q, o, flo, fhi, lo, hi, pos):
    """The kernel's ``tapping``: the output indices whose clamped taps may
    land on source index q."""
    if q < lo or q > hi:
        return 0, -1
    first = 0 if q == lo else _first_base_at_least(q - 2, o, flo, fhi,
                                                   pos)[0]
    last = (o if q == hi else _first_base_at_least(q + 2, o, flo, fhi,
                                                   pos)[0]) - 1
    return first, last


def _band_rows(r0, r1, o, flo, fhi, lo, hi, pos):
    """The backward CTA's output rows [ia, ib] (its two lanes)."""
    qa, qb = max(r0, lo), min(r1 - 1, hi)
    if qa > qb:
        return 0, -1
    return (_tapping(qa, o, flo, fhi, lo, hi, pos)[0],
            _tapping(qb, o, flo, fhi, lo, hi, pos)[1])


def _tile_columns(q0, q1, o, w0, w1, lo, hi):
    """The backward CTA's output columns [JA, JB]: the closed form's,
    widened by 2 (the kernel's ``col_guess``)."""
    qa, qb = max(q0, lo), min(q1 - 1, hi)
    if qa > qb:
        return 0, -1
    wlen = float(F32(w1) - F32(w0))

    def guess(b):
        return (b + 0.5 - w0) * o / wlen - 0.5
    est = wlen > 0
    ja = 0 if qa == lo or not est else \
        int(max(0.0, min(math.floor(guess(qa - 2)) - 2.0, o)))
    jb = o - 1 if qb == hi or not est else \
        int(min(o - 1.0, max(math.ceil(guess(qb + 2)) + 2.0, -1.0)))
    return ja, jb


def _pixel_columns(q, ja_t, jb_t, idx):
    """A pixel's output columns on the table [ja_t, jb_t]: the first whose
    last tap is ≥ q, the last whose first is ≤ q."""
    js = range(ja_t, jb_t + 1)
    ja = next((j for j in js if idx[j, 3] >= q), jb_t + 1)
    jb = next((j for j in js if idx[j, 0] > q), jb_t + 1) - 1
    return ja, jb


def _brute_range(idx, lo, hi):
    """The output indices with a clamped tap in [lo, hi], as (first, last),
    and whether they run without a gap."""
    hit = np.nonzero(((idx >= lo) & (idx <= hi)).any(1))[0]
    if hit.size == 0:
        return (0, -1), True
    return (int(hit[0]), int(hit[-1])), hit.size == hit[-1] - hit[0] + 1


def _first_version(g, apex, h, w):
    """The separable transpose in the first version's order: gt summed j
    ascending, taps in order, then gx summed i ascending, taps in order,
    each product and sum one float32 rounding."""
    n, oh, ow, c = g.shape
    _, ry, wy, _, _ = _axis(oh, apex[0], apex[1])
    _, cx, wx, _, _ = _axis(ow, apex[2], apex[3])
    gt = np.zeros((n, oh, w, c), F32)
    for j in range(ow):
        for a in range(4):
            q = cx[j, a]
            gt[:, :, q] = gt[:, :, q] + g[:, :, j] * wx[j, a]
    gx = np.zeros((n, h, w, c), F32)
    for i in range(oh):
        for k in range(4):
            r = ry[i, k]
            gx[:, r] = gx[:, r] + gt[:, i] * wy[i, k]
    return gx


def _kernel_model(g, apex, h, w, band, tq):
    """The backward kernel's walk, CTA by CTA: its ranges, each pixel's
    column terms, the four rolling accumulators from the band's first row
    in the window, the rows it stores, and 0 in the band's rows in the
    window below the last output row's taps (NaN where it stores
    nothing)."""
    n, oh, ow, c = g.shape
    h0, h1, w0, w1 = apex
    ypos, ry, wy, hlo, hhi = _axis(oh, h0, h1)
    _, cx, wx, wlo, whi = _axis(ow, w0, w1)
    gx = np.full((n, h, w, c), np.nan, F32)
    for img in range(n):
        for r0 in range(0, h, band):
            r1 = min(h, r0 + band)
            ia, ib = _band_rows(r0, r1, oh, h0, h1, hlo, hhi, ypos)
            for q0 in range(0, w, tq):
                q1 = min(w, q0 + tq)
                ja_t, jb_t = _tile_columns(q0, q1, ow, w0, w1, wlo, whi)
                terms = []
                for q in range(q0, q1):
                    ja, jb = (_pixel_columns(q, ja_t, jb_t, cx)
                              if wlo <= q <= whi else (0, -1))
                    terms.append([(j, wx[j, a]) for j in range(ja, jb + 1)
                                  for a in range(4) if cx[j, a] == q])
                for r in range(r0, r1):
                    if ia > ib or r < hlo or r > hhi:
                        gx[img, r, q0:q1] = 0.0
                acc = np.zeros((4, q1 - q0, c), F32)
                wb = 0
                for i in range(ia, ib + 1):
                    s = np.zeros((q1 - q0, c), F32)
                    for p, lst in enumerate(terms):
                        for j, wt in lst:
                            s[p] = s[p] + g[img, i, j] * wt
                    if i == ia:
                        wb = min(ry[i, 0], max(r0, hlo))
                    while wb < ry[i, 0]:
                        if r0 <= wb < r1:
                            gx[img, wb, q0:q1] = acc[0]
                        acc = np.concatenate([acc[1:], np.zeros_like(
                            acc[:1])])
                        wb += 1
                    if ry[i, 3] == wb + 3:
                        for k in range(4):
                            acc[k] = acc[k] + s * wy[i, k]
                    else:
                        for slot in range(4):
                            for k in range(4):
                                if ry[i, k] - wb == slot:
                                    acc[slot] = acc[slot] + s * wy[i, k]
                if ia <= ib:
                    for k in range(4):
                        r = wb + k
                        if r <= hhi and r0 <= r < r1:
                            gx[img, r, q0:q1] = acc[k]
                    for r in range(max(wb + 4, r0), min(r1 - 1, hhi) + 1):
                        gx[img, r, q0:q1] = 0.0
    return gx


def _inputs(seed, shape, oshape):
    rng = np.random.default_rng(seed)
    x = (-0.1 + 1.2 * rng.random(shape)).astype(F32)
    return x, rng.standard_normal(oshape).astype(F32)


@pytest.mark.parametrize("apex", APEXES)
@pytest.mark.parametrize("out_hw", OUT_HWS)
def test_band_rows_and_tile_columns_match_brute_force(apex, out_hw):
    """Each band's output rows and each tile's and pixel's output columns,
    found as the kernel finds them, against every output's clamped taps:
    exact rows, columns holding the exact ones, a pixel's terms in the
    first version's order; the closed form's estimate 2 steps or fewer
    from the answer."""
    h, w = 40, 70
    oh, ow = out_hw or (h, w)
    ypos, ry, _, hlo, hhi = _axis(oh, apex[0], apex[1])
    xpos, cx, _, wlo, whi = _axis(ow, apex[2], apex[3])
    for band in (1, 4, 8, 16):
        for r0 in range(0, h, band):
            r1 = min(h, r0 + band)
            got = _band_rows(r0, r1, oh, apex[0], apex[1], hlo, hhi, ypos)
            if got[0] > got[1]:  # no output row: the kernel zeroes the band
                got = (0, -1)
            want, gapless = _brute_range(ry, r0, r1 - 1)
            assert gapless and got == want, (band, r0)
    for b in range(hlo - 2, hhi + 3):
        assert _first_base_at_least(b, oh, apex[0], apex[1], ypos)[1] <= 2
    for tq in (1, 7, 16, 70):
        for q0 in range(0, w, tq):
            q1 = min(w, q0 + tq)
            ja_t, jb_t = _tile_columns(q0, q1, ow, apex[2], apex[3], wlo,
                                       whi)
            (lo, hi), gapless = _brute_range(cx, q0, q1 - 1)
            assert gapless
            if lo <= hi:
                assert ja_t <= lo and jb_t >= hi and jb_t - ja_t <= hi - lo + 8
            for q in range(max(q0, wlo), min(q1 - 1, whi) + 1):
                ja, jb = _pixel_columns(q, ja_t, jb_t, cx)
                assert (ja, jb) == _brute_range(cx, q, q)[0]
                assert (ja, jb) == _tapping(q, ow, apex[2], apex[3], wlo,
                                            whi, xpos)


@pytest.mark.parametrize("apex", APEXES)
@pytest.mark.parametrize("out_hw", OUT_HWS)
@pytest.mark.parametrize("tiling", ["plan", (4, 16), (16, 7)])
def test_backward_model_equals_first_version(apex, out_hw, tiling):
    """The backward kernel's walk writes every element of gx once, EQUAL to
    the first version's order (so the kernel's gradient is bit-equal to
    it), within 1e-5 of the plain version's autograd gradient's max, with
    the plan's bands and tiles and with others (many tiles, one-pixel and
    seven-pixel tiles)."""
    shape = (2, 40, 70, 3)
    oh, ow = out_hw or shape[1:3]
    x, g = _inputs(7, shape, (2, oh, ow, 3))
    if tiling == "plan":
        p = crop_cubic.plan(*shape, oh, ow, SMS)
        band, tq = p.bwd_band, p.bwd_tile
    else:
        band, tq = tiling
    got = _kernel_model(g, apex, 40, 70, band, tq)
    np.testing.assert_array_equal(got, _first_version(g, apex, 40, 70))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = crop_cubic.crop_cubic_plain(xt, torch.tensor(apex), out_hw)
    (y * torch.from_numpy(g)).sum().backward()
    want = xt.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CUBIC_GRAD_RTOL
                               * np.abs(want).max())


@pytest.mark.parametrize("h,oh,rows", [(512, 100, (0.0, 512.0)),
                                       (512, 100, (31.0, 480.0)),
                                       (40, 8, (0.0, 40.0)),
                                       (300, 7, (13.0, 290.0))])
@pytest.mark.parametrize("band", ["plan", 4, 16])
def test_backward_model_writes_every_row_when_downsampling(h, oh, rows,
                                                           band):
    """Rows downsampled 4.6 to 40 times: output rows skip input rows, at
    a band's top, inside it and at its bottom; the walk still writes each
    row of gx once, EQUAL to the first version (0 where no output row
    taps)."""
    shape = (1, h, 6, 1)
    apex = (*rows, 1.0, 5.0)
    _, g = _inputs(11, shape, (1, oh, 6, 1))
    if band == "plan":
        band = crop_cubic.plan(*shape, oh, 6, SMS).bwd_band
    got = _kernel_model(g, apex, h, 6, band, 6)
    np.testing.assert_array_equal(got, _first_version(g, apex, h, 6))


@pytest.mark.parametrize("apex", [APEXES[0], APEXES[3], APEXES[4]])
@pytest.mark.parametrize("out_hw", [None, (96, 20)])
def test_backward_model_matches_jax(apex, out_hw):
    """The kernel's walk against ``jax.grad`` of ``crop_resize(bicubic)``:
    within 1e-5 of JAX's max."""
    shape = (2, 40, 70, 3)
    oh, ow = out_hw or shape[1:3]
    x, g = _inputs(8, shape, (2, oh, ow, 3))
    p = crop_cubic.plan(*shape, oh, ow, SMS)
    got = _kernel_model(g, apex, 40, 70, p.bwd_band, p.bwd_tile)
    a = jnp.asarray(apex, jnp.float32)

    def loss(v, a, c):
        return jnp.sum(jresize.crop_resize(v, a, out_hw, method="bicubic")
                       * c)
    fn = jax.jit(jax.grad(loss)).lower(x, a, g).compile(
        compiler_options=_NO_ALGSIMP)
    want = np.asarray(fn(x, a, g))
    np.testing.assert_allclose(got, want, rtol=0, atol=CUBIC_GRAD_RTOL
                               * np.abs(want).max())


@pytest.mark.parametrize("apex", APEXES)
@pytest.mark.parametrize("out_hw", OUT_HWS)
def test_forward_sums_equal_plain_and_fit(apex, out_hw):
    """The forward's row sums R[q] = Σ_k wy·x[r_k, q] then the column sums
    Σ_a wx·R[q_a], EQUAL to the plain version; each tile's source columns,
    from the float4 boundary below the first, fit its row of R."""
    shape = (2, 40, 70, 3)
    oh, ow = out_hw or shape[1:3]
    x, _ = _inputs(9, shape, (1,))
    _, ry, wy, _, _ = _axis(oh, apex[0], apex[1])
    _, cx, wx, _, _ = _axis(ow, apex[2], apex[3])
    rows = x[:, ry[:, 0]] * wy[:, 0, None, None]
    for k in range(1, 4):
        rows = rows + x[:, ry[:, k]] * wy[:, k, None, None]
    y = rows[:, :, cx[:, 0]] * wx[:, 0, None]
    for a in range(1, 4):
        y = y + rows[:, :, cx[:, a]] * wx[:, a, None]
    want = crop_cubic.crop_cubic_plain(torch.from_numpy(x),
                                       torch.tensor(apex), out_hw).numpy()
    np.testing.assert_array_equal(y, want)
    for tw in (crop_cubic.plan(*shape, oh, ow, SMS).fwd_tile, 1, 5, ow):
        cap = 4 * ((crop_cubic.fwd_span(tw, 70, ow) * 3 + 6) // 4)
        for j0 in range(0, ow, tw):
            qa, qb = cx[j0, 0], cx[min(ow, j0 + tw) - 1, 3]
            assert (qb + 1) * 3 - (qa * 3 & ~3) <= cap


# (n, h, w, c, oh, ow): CLR's two shapes; widths 1, 256, 512, 3840 and
# 20,000 (column tiles); downsampling and upsampling out_hw; many channels
PLAN_SHAPES = [(8, 256, 256, 3, 256, 256), (3, 512, 512, 3, 512, 512),
               (1, 1, 1, 3, 1, 1), (2, 33, 1, 3, 33, 1),
               (1, 2160, 3840, 3, 2160, 3840), (1, 8, 20000, 3, 8, 20000),
               (1, 8, 20000, 3, 8, 300), (2, 40, 70, 3, 32, 48),
               (2, 40, 70, 3, 96, 20), (2, 40, 70, 3, 8, 48),
               (3, 512, 512, 3, 100, 100), (2, 64, 600, 3, 50, 700),
               (3, 512, 512, 3, 200, 160), (1, 4, 4, 1000, 4, 4),
               (2, 33, 45, 1, 33, 45), (2, 33, 45, 4, 20, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_takes_each_row_and_column_once(shape):
    n, h, w, c, oh, ow = shape
    p = crop_cubic.plan(n, h, w, c, oh, ow, SMS)
    for size, band, cols, tile in ((oh, p.fwd_band, ow, p.fwd_tile),
                                   (h, p.bwd_band, w, p.bwd_tile)):
        assert 1 <= band and 1 <= tile <= 256
        rows = np.zeros(size, np.int32)
        for r0 in range(0, size, band):
            assert r0 < min(size, r0 + band)  # no CTA without a row
            rows[r0:r0 + band] += 1
        seen = np.zeros(cols, np.int32)
        for q0 in range(0, cols, tile):
            seen[q0:q0 + tile] += 1
        assert (rows == 1).all() and (seen == 1).all()
    assert crop_cubic.fwd_smem(p.fwd_band, p.fwd_tile, w, c, ow) \
        <= SMEM_CTA
    assert crop_cubic.BWD_SMEM <= SMEM_CTA


def test_plan_at_clr_shapes():
    """Both CLR shapes: one tile of 256 pixels a row (two at 512²), bands
    of 8 rows each way, one wave of CTAs on 132 SMs (three a backward SM)."""
    for n, s, ctas in ((8, 256, 256), (3, 512, 384)):
        p = crop_cubic.plan(n, s, s, 3, s, s, SMS)
        assert p == (8, 256, 8, 256)
        assert n * -(-s // p.bwd_band) * -(-s // p.bwd_tile) == ctas \
            <= 3 * SMS


def test_clr_windows_keep_every_pixel_in_registers():
    """CLR draws windows of 0.5 to 1 of the image (``sample_crop_apex``):
    no pixel there has more than kTerms column terms, so none takes the
    path that computes its taps again for each row."""
    for s in (256, 512):
        for wlen in (s // 2, s // 2 + 1, (3 * s) // 4, s - 1, s):
            for w0 in (0.0, float((s - wlen) // 2), float(s - wlen)):
                _, cx, _, lo, hi = _axis(s, w0, w0 + wlen)
                counts = np.bincount(cx.reshape(-1) - lo, minlength=1)
                assert counts.max() <= TERMS, (s, wlen, w0)


def _constant(src, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m, name
    return m.group(1)


def test_plan_matches_the_kernel_source():
    """The plan's constants and shared memory are the kernel's (``csrc/
    crop_cubic.cu``), and each C entry takes as many arguments as ``_lib``
    declares."""
    src = (CSRC / "crop_cubic.cu").read_text()
    consts = {k: int(_constant(src, k).split("//")[0]) for k in (
        "kThreads", "kFwdBlocks", "kBwdBlocks", "kCtab", "kTerms",
        "kHeavy", "kSpanPad")}
    assert consts == {"kThreads": crop_cubic._THREADS,
                      "kFwdBlocks": crop_cubic._FWD_CTAS,
                      "kBwdBlocks": crop_cubic._BWD_CTAS,
                      "kCtab": crop_cubic._CTAB,
                      "kTerms": crop_cubic._TERMS,
                      "kHeavy": crop_cubic._HEAVY,
                      "kSpanPad": crop_cubic._SPAN_PAD}
    assert crop_cubic._TERMS == TERMS
    smem = re.search(r"constexpr int kBwdSmem\s*=\s*([^;]+);", src).group(1)
    assert eval(f"({smem})", {}, consts) == crop_cubic.BWD_SMEM
    for name in ("vwfd_crop_cubic_fwd", "vwfd_crop_cubic_bwd"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        assert len(m.group(1).split(",")) == len(_lib._SIGNATURES[name])


def test_cpu_tensors_take_the_plain_version():
    """The wrapper on CPU tensors launches nothing and returns the plain
    version, forward and gradient."""
    from vwfd_tpu_torch.kernels import launch_counts
    x, g = _inputs(10, (2, 40, 70, 3), (2, 32, 48, 3))
    before = launch_counts()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = crop_cubic.crop_cubic(xt, torch.tensor(APEXES[0]), (32, 48))
    (y * torch.from_numpy(g)).sum().backward()
    assert launch_counts() == before
    xp = torch.from_numpy(x).requires_grad_(True)
    yp = crop_cubic.crop_cubic_plain(xp, torch.tensor(APEXES[0]), (32, 48))
    (yp * torch.from_numpy(g)).sum().backward()
    assert torch.equal(y.detach(), yp.detach())
    assert torch.equal(xt.grad, xp.grad)
