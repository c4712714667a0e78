"""K24's plan (``kernels/diffjpeg.py::plan``): which route and grids a
shape takes on a card of a given SM count, and that the CTAs it launches
cover every 16×16 macroblock exactly once, by the kernel's own index
arithmetic (``_macroblocks_of``: ``csrc/diffjpeg.cu``'s ``setup`` and
``unit_of``, or the latency route's grid stride). CPU only: the kernel
itself is held to the plain version on the card
(tests/test_torch_gpu.py)."""

import collections

import pytest

from vwfd_tpu_torch.kernels import diffjpeg

H100_SMS = 132

# one macroblock; the study's single 32² image; 45 macroblocks (the first
# version's last CTA held one of four); a batch of 256² frames; a width
# past one unit's (65 macroblocks: a ragged last unit); a shape with fewer
# units than the card has room for CTAs
SHAPES = [(1, 16, 16), (1, 32, 32), (3, 48, 80), (64, 256, 256),
          (2, 64, 1040), (70, 64, 128)]


def _macroblocks_of(p, shape, cta, backward):
    """The (frame, macroblock row, macroblock column) that CTA ``cta`` of
    plan ``p`` for ``shape`` transforms, in its order."""
    n, h, w = shape
    hm, wm = h // 16, w // 16
    grid = p.grid_bwd if backward else p.grid_fwd
    if p.route == "latency":
        return [(mb // (hm * wm), mb % (hm * wm) // wm, mb % wm)
                for mb in range(cta, p.macroblocks, grid)]
    q, r = divmod(p.units, grid)
    u0 = cta * q + min(cta, r)
    u1 = u0 + q + (1 if cta < r else 0)
    groups = -(-wm // diffjpeg.UNIT_MBS)
    out = []
    for u in range(u0, u1):
        t, grp = divmod(u, groups)
        i, band = divmod(t, hm)
        out += [(i, band, mx) for mx in range(
            grp * diffjpeg.UNIT_MBS, min(wm, (grp + 1) * diffjpeg.UNIT_MBS))]
    return out


# the card's pick, each route forced on it, and the bytes route's few CTAs
# of one SM (many units each, ragged shares)
@pytest.mark.parametrize("sms, route", [(H100_SMS, None), (H100_SMS, "bytes"),
                                        (H100_SMS, "latency"), (1, "bytes")])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_macroblock_once(shape, sms, route):
    n, h, w = shape
    p = diffjpeg.plan(n, h, w, sms, route)
    assert route is None or p.route == route
    every = {(i, my, mx) for i in range(n) for my in range(h // 16)
             for mx in range(w // 16)}
    assert p.macroblocks == len(every)
    for backward in (False, True):
        per_cta = [_macroblocks_of(p, shape, c, backward) for c in
                   range(p.grid_bwd if backward else p.grid_fwd)]
        seen = collections.Counter(mb for mbs in per_cta for mb in mbs)
        assert set(seen) == every and set(seen.values()) == {1}, (
            p, backward)
        assert all(per_cta)  # every CTA has work: none idles past the end


@pytest.mark.parametrize("shape, sms, route", [
    ((1, 32, 32), H100_SMS, "latency"),      # the study's single image
    ((1, 16, 16), H100_SMS, "latency"),
    ((3, 48, 80), H100_SMS, "latency"),
    ((64, 256, 256), H100_SMS, "bytes"),     # a batch of 256² frames
    ((8, 256, 256), H100_SMS, "bytes"),      # 2,048 macroblocks
    ((4, 256, 256), H100_SMS, "bytes"),      # 1,024: past 6 an SM
    ((3, 256, 256), H100_SMS, "latency"),    # 768: under
    ((2, 64, 1040), H100_SMS, "latency"),
    ((2, 64, 1040), 4, "bytes"),             # units 7.2 macroblocks full
    ((70, 64, 128), H100_SMS, "bytes"),
    ((256, 32, 32), H100_SMS, "latency"),    # units a quarter full
    ((256, 64, 64), H100_SMS, "latency"),    # units half full
    ((256, 64, 96), H100_SMS, "latency"),    # units 6 of 8 full
    ((256, 64, 112), H100_SMS, "bytes"),     # 7 of 8
    ((64, 64, 1040), H100_SMS, "bytes"),     # 7.2 of 8 on average
    ((1, 32, 32), 1, "latency"),
    ((1, 16, 16), 1, "latency"),             # one macroblock
])
def test_plan_picks_the_route_by_units(shape, sms, route):
    """The route by the macroblocks an SM and the units' fill (the
    crossover measured on the card: ``diffjpeg.BYTES_MBS_PER_SM``)."""
    p = diffjpeg.plan(*shape, sms)
    assert p.route == route
    if route == "bytes":  # persistent: at most the card's room, a unit each
        assert p.grid_fwd == min(p.units, sms * diffjpeg.CTAS_PER_SM[0])
        assert p.grid_bwd == min(p.units, sms * diffjpeg.CTAS_PER_SM[1])
        assert p.macroblocks >= diffjpeg.BYTES_MBS_PER_SM * sms
        assert 8 * p.macroblocks >= 7 * diffjpeg.UNIT_MBS * p.units
    else:  # a CTA a macroblock
        assert p.grid_fwd == p.grid_bwd == p.macroblocks


def test_plan_takes_a_forced_route_and_refuses_another():
    """``route=`` takes that route whatever the shape; any other name is
    refused."""
    assert diffjpeg.plan(1, 32, 32, H100_SMS, "bytes") == diffjpeg.Plan(
        "bytes", 4, 2, 2, 2)
    assert diffjpeg.plan(64, 256, 256, H100_SMS, "latency") == \
        diffjpeg.Plan("latency", 16384, 2048, 16384, 16384)
    with pytest.raises(ValueError, match="route"):
        diffjpeg.plan(1, 32, 32, H100_SMS, "first")


def test_plan_at_the_batch_shape():
    """64 frames of 256²: 2,048 units of 8 macroblocks, 4 forward and 2
    backward CTAs an SM, with fewer units than the forward's room at 70
    frames of 64 × 128."""
    p = diffjpeg.plan(64, 256, 256, H100_SMS)
    assert (p.units, p.grid_fwd, p.grid_bwd) == (2048, 528, 264)
    q = diffjpeg.plan(70, 64, 128, H100_SMS)
    assert (q.route, q.units, q.grid_fwd, q.grid_bwd) == ("bytes", 280, 280,
                                                          264)


@pytest.mark.parametrize("shape", [(1, 24, 32), (1, 32, 40), (2, 8, 8)])
def test_plan_refuses_what_the_kernel_refuses(shape):
    with pytest.raises(ValueError, match="multiples of 16"):
        diffjpeg.plan(*shape, H100_SMS)


def test_plan_refuses_a_count_past_int_max():
    n = diffjpeg.INT_MAX // 32 + 1  # 32 macroblocks a frame of 64 × 128
    with pytest.raises(ValueError, match="INT_MAX"):
        diffjpeg.plan(n, 64, 128, H100_SMS)
    p = diffjpeg.plan(n - 1, 64, 128, H100_SMS)
    assert p.macroblocks <= diffjpeg.INT_MAX and p.route == "bytes"


def test_an_empty_batch_launches_nothing():
    p = diffjpeg.plan(0, 32, 32, H100_SMS)
    assert p.macroblocks == 0 and p.grid_fwd == p.grid_bwd == 0


def test_plan_constants_are_the_kernels():
    """The plan's unit width, CTAs an SM and route codes are
    ``csrc/diffjpeg.cu``'s, so the launch follows the plan."""
    import re
    from vwfd_tpu_torch.kernels import _lib
    src = (_lib.CSRC / "diffjpeg.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert const("kUnitMB") == diffjpeg.UNIT_MBS
    assert (const("kCtasFwd"), const("kCtasBwd")) == diffjpeg.CTAS_PER_SM
    assert (const("kBytes"), const("kLatency")) == (
        diffjpeg.ROUTES["bytes"], diffjpeg.ROUTES["latency"])
