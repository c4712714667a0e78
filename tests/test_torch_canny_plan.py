"""K19's host-side plan (``vwfd_tpu_torch/kernels/canny.py::plan``), on the
CPU: the tiles cover every output pixel exactly once, each kernel's shared
memory fits a CTA, the edge-tile test (which tiles take the reflect, mask
and fold code) agrees with a pixel-by-pixel reading of the tile's halo,
the sweep's warps cover a tile's columns, and the compile-time gaussian
taps of ``csrc/canny.cu`` are the plain version's, and the patches of
``port_tools/ablate_canny.py`` still find their lines of it. The kernels
themselves run on the card only (``tests/test_torch_gpu.py``, which also
holds their geometry to this plan)."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from vwfd_tpu_torch.kernels import canny
from vwfd_tpu_torch.kernels._lib import CSRC
from vwfd_tpu_torch.ops.filters import gaussian_kernel_2d

# the PAMI step's and the PAMI-512 record's shapes, and edge shapes down to
# 3 × 3: one past a tile in each dimension, two tiles and one, tall and
# narrow, wide and short
SHAPES = [(48, 256, 256), (9, 512, 512), (1, 3, 3), (2, 33, 91),
          (1, 65, 181), (2, 300, 5), (3, 4, 700), (2, 9, 11), (3, 40, 24),
          (1, 32, 90)]


@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_cover_every_pixel_once(shape):
    p = canny.plan(*shape)
    n, h, w = shape
    assert p.grid == (p.tiles_x, p.tiles_y, n)
    assert p.slots == p.tiles_x * p.tiles_y
    seen = np.zeros((h, w), np.int32)
    for ty in range(p.tiles_y):
        for tx in range(p.tiles_x):
            r0, r1, c0, c1 = p.box(ty, tx)
            assert r0 < r1 and c0 < c1  # no tile without an output
            seen[r0:r1, c0:c1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_edge_tiles(shape):
    """A tile is an edge tile for a halo exactly when some pixel of the tile
    grown by that halo lies outside the image; an interior tile's halo is
    wholly inside."""
    p = canny.plan(*shape)
    _, h, w = shape
    for halo in sorted(set(canny.HALOS.values()) | {1, 2}):
        for ty in range(p.tiles_y):
            for tx in range(p.tiles_x):
                r0, c0 = ty * canny.TILE_H, tx * canny.TILE_W
                rows = np.arange(r0 - halo, r0 + canny.TILE_H + halo)
                cols = np.arange(c0 - halo, c0 + canny.TILE_W + halo)
                outside = ((rows < 0) | (rows >= h)).any() or \
                    ((cols < 0) | (cols >= w)).any()
                assert p.edge(ty, tx, halo) == outside


def test_step_shapes_have_interior_tiles():
    """The step shapes run the straight code on some tiles: at 256² one
    column of tiles, at 512² four, between the edge rows."""
    for shape, want in (((48, 256, 256), 6), ((9, 512, 512), 4 * 14)):
        p = canny.plan(*shape)
        inner = sum(not p.edge(ty, tx, canny.HALOS["local"])
                    for ty in range(p.tiles_y) for tx in range(p.tiles_x))
        assert inner == want


@pytest.mark.parametrize("kernel", sorted(canny.SMEM))
def test_shared_memory_fits_a_cta(kernel):
    assert 0 < canny.SMEM[kernel] <= canny.SMEM_CTA
    # each area holds the region it stages: gray at the kernel's halo
    halo = canny.HALOS[kernel]
    assert canny.SMEM[kernel] >= 4 * (canny.TILE_H + 2 * halo) * (
        canny.TILE_W + 2 * halo)


def test_sweep_covers_the_tile():
    """Six warps: three blocks of 30 output columns, each warp 32 lanes
    with one column of halo either side, times two strips of rows."""
    assert canny.THREADS == 32 * 3 * 2
    cols = [30 * b + lane - 1 for b in range(3) for lane in range(1, 31)]
    assert sorted(cols) == list(range(canny.TILE_W))
    assert canny.TILE_H % 2 == 0


@pytest.mark.parametrize("shape", [(2, 2, 5), (1, 5, 2), (0, 8, 8),
                                   (65536, 8, 8)])
def test_plan_refuses(shape):
    with pytest.raises(ValueError):
        canny.plan(*shape)


def test_scratch_is_two_planes_and_the_slots():
    p = canny.plan(48, 256, 256)
    lists = 3 * canny.TIES * 48 * p.slots  # a position and two floats a tie
    assert p.scratch_bytes() == 4 * (2 * 48 * 256 * 256 + 2 * 48 * p.slots
                                     + lists)
    assert lists * 4 < 2 ** 20  # the lists stay under a megabyte


def test_kernel_taps_are_the_plain_gaussian():
    src = (CSRC / "canny.cu").read_text()
    body = src[src.index("#define VWFD_GAUSS_TAPS"):]
    body = body[:body.index("}")]
    taps = [float.fromhex(t) for t in
            re.findall(r"(0x[0-9a-f.]+p-?\d+)f", body)]
    want = gaussian_kernel_2d(5, 1.0).reshape(-1).astype(np.float32)
    assert np.array_equal(np.asarray(taps, np.float32), want)


def _ablate_tool():
    spec = importlib.util.spec_from_file_location(
        "ablate_canny", Path(__file__).resolve().parents[1] / "port_tools"
        / "ablate_canny.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["timeline", "max_6", "map_7", "map_5",
                                     "local_4", "input_4", "max_forward"])
def test_ablate_patches_hold_on_the_source(variant):
    """Each of the timing tool's builds finds each of its lines of
    ``canny.cu`` exactly once and changes the source."""
    tool = _ablate_tool()
    src = (CSRC / "canny.cu").read_text()
    patches = tool.TIMELINE if variant == "timeline" else \
        tool.VARIANTS[variant]
    for old, _ in patches:
        assert src.count(old) == 1, old
    assert tool.patched(src, patches) != src
