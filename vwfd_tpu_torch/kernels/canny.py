"""K19 `canny_soft`: the image family's differentiable edge map, forward and
backward.

Replaces ``vwfd_tpu/ops/canny.py::canny_soft`` (:39-72), which the image
model's reverse pass applies, with its gradient, to every attacked copy
(``vwfd_tpu/models/image_model.py:362-364``, ``:550``): of (N, H, W, 3)
float32 images, the gray image (0.299, 0.587, 0.114), a 5×5 σ = 1 gaussian
under a reflect pad of 2, Sobel under a reflect pad of 1, the gradient
magnitude over its per-image max, a soft non-maximum suppression along
the gradient direction on the zero-padded magnitude, and a soft double
threshold; (N, H, W, 1) out.

The plain version is the JAX form in torch, op for op, so that autograd
gives JAX's gradient: ``amax`` shares the max's gradient evenly among tied
pixels (``jnp.max``'s rule; a flat image ties them all), the clip is
``torch.minimum(torch.maximum(·))`` (gradient ½ at exactly 0 or 1, as
``jnp.clip``; ``torch.clamp`` gives 1), the neighbour selects are
``torch.where`` on ``c ≥ 0`` and ``s ≥ 0`` (the +1 neighbour at 0, the
gradient to the picked one only), and |c|, |s| take ``jnp.abs``'s
gradient, +1 at 0 (``torch.abs`` gives 0; a flat patch has c = s = 0).
The gray image is JAX's ``img @ _GRAY`` as XLA computes it on the CPU, a
chain of fused multiply-adds ``fma(b, 0.114, fma(g, 0.587, r·0.299))``
(each rounded once; emulated here in float64): one ulp of gray moves c and
s by up to 1e-4 on a flat patch, where the gradient norm is ~1e-6.

The border (F24, ROADMAP.md §3). Under the reflect pad, gx on the first
and last columns and gy on the first and last rows are identically 0: the
taps read the same values twice with opposite signs. In float32 they are
the residue of those sums, at a corner both are, so the direction and the
NMS's denominator (1e-12 there) are rounding noise, the cotangents of gx
and gy there reach ~1e9 and cancel in the pad's transpose: the JAX form's
gradient within a few pixels of each corner is noise of up to 2.4e-2 of
the gradient's max on 8-bit images (5e-6 on continuous ones) from its
float64 exact value, the same noise in JAX and in this plain version (the
same operations in the same order on the CPU), another on the card (the
pad's transpose adds with atomics there). K19's backward sends those
structural zeros no gradient, the exact derivative; ``canny_soft_plain(x,
exact_border=True)`` does the same (the values unchanged, their gradient
cut), and is what the kernel is held to on the card.

Bound: bytes. At the image step's (48, 256, 256, 3) the forward reads x
(37.7 MB) and writes y (12.6 MB), about 0.015 ms at 3.35 TB/s; the
backward reads x and the cotangent and writes dx, 88.1 MB, about 0.026 ms.
The design (``csrc/canny.cu``): a per-image max sits between the stencils
and the NMS, and a per-image sum (the max's cotangent) between the NMS's
transpose and the stencils', so each direction takes two launches over
tiles of 32 × 90 outputs, each tile recomputing gray, the gaussian and the
Sobel of its halo from x in shared memory. The forward writes y and one max
word a tile (``plan``'s slots) and saves x and those words; the backward
writes two planes (the cotangents of gx and gy short of the max's term)
and per tile a sum, a tie count and a list of ties, and recomputes the
rest. Each direction's second kernel waits only for its image's tiles of
the first, through per-image counts kept in a zeroed scratch of the
stream (``_counters``). ``plan`` is the launch's geometry; the kernels'
own is held to it once a process (``check_geometry``) and its grid on every
launch.
"""

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _lib
from ..ops.filters import gaussian_kernel_2d

__all__ = ["canny_soft", "canny_soft_plain", "sobel_edges", "gray", "GRAY",
           "COUNT", "SHARPNESS", "LOW", "HIGH", "plan", "Plan"]

COUNT = _lib.LaunchCount("canny_soft")

GRAY = (0.299, 0.587, 0.114)
SIGMA, LOW, HIGH, SHARPNESS = 1.0, 0.1, 0.2, 20.0


def _check(x: torch.Tensor) -> None:
    _lib.check_nhwc(x, "canny_soft input")
    if x.dtype != torch.float32:
        raise TypeError(f"canny_soft takes float32, got {x.dtype}")
    n, h, w, c = x.shape
    if c != 3 or h < 3 or w < 3 or n > 65535:
        raise ValueError(f"canny_soft: expected (N ≤ 65535, H ≥ 3, W ≥ 3, "
                         f"3), got {tuple(x.shape)}")


def _fma(a: torch.Tensor, w: float, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, w, c)``: the float32 product is exact in float64."""
    return (a.double() * w + c.double()).float()


def gray(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) → (N, H, W): XLA's ``img @ (0.299, 0.587, 0.114)``."""
    w = torch.tensor(GRAY, dtype=torch.float32).tolist()  # float32 values
    return _fma(img[..., 2], w[2], _fma(img[..., 1], w[1],
                                        img[..., 0] * GRAY[0]))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient: +1 at 0."""
    return torch.where(x >= 0, x, -x)


def _reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(N, H, W) → (N, H + 2·pad, W + 2·pad), numpy's reflect."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def sobel_edges(gray: torch.Tensor):
    """(N, H, W, 1) → (gx, gy), 3×3 Sobel under a reflect pad of 1, the
    taps summed in ``vwfd_tpu/ops/canny.py::sobel_edges``'s order."""
    gx, gy = _sobel(gray[..., 0])
    return gx[..., None], gy[..., None]


def _sobel(smooth: torch.Tensor):
    h, w = smooth.shape[-2], smooth.shape[-1]
    p = _reflect(smooth, 1)

    def sh(dy, dx):
        return p[:, dy + 1:dy + 1 + h, dx + 1:dx + 1 + w]

    gx = (sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1)
          - sh(-1, -1) - 2 * sh(0, -1) - sh(1, -1))
    gy = (sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)
          - sh(-1, -1) - 2 * sh(-1, 0) - sh(-1, 1))
    return gx, gy


def canny_soft_plain(img: torch.Tensor, exact_border: bool = False
                     ) -> torch.Tensor:
    """Plain PyTorch version: the JAX form op for op (module docstring);
    with ``exact_border`` the Sobel's structural zeros pass no gradient, as
    in K19 (F24)."""
    _check(img)
    gray_ = gray(img)
    h, w = gray_.shape[-2], gray_.shape[-1]
    gp = _reflect(gray_, 2)
    k = gaussian_kernel_2d(5, SIGMA)
    smooth = torch.zeros_like(gray_)
    for dy in range(5):
        for dx in range(5):
            smooth = smooth + float(k[dy, dx]) * gp[:, dy:dy + h, dx:dx + w]
    gx, gy = _sobel(smooth)
    if exact_border:
        cols = torch.zeros(w, dtype=torch.bool, device=img.device)
        rows = torch.zeros(h, 1, dtype=torch.bool, device=img.device)
        cols[0] = cols[-1] = rows[0] = rows[-1] = True
        gx = torch.where(cols, gx.detach(), gx)
        gy = torch.where(rows, gy.detach(), gy)
    return _nms_threshold(gx, gy)[..., None]


def _nms_threshold(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """(N, H, W) Sobel gradients → the edge map (N, H, W): the magnitude
    over its per-image max, the soft NMS, the soft double threshold."""
    h, w = gx.shape[-2], gx.shape[-1]
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    mag = mag / (torch.amax(mag, dim=(-2, -1), keepdim=True) + 1e-12)
    p = F.pad(mag, (1, 1, 1, 1))

    def sh(dy, dx):
        return p[:, dy + 1:dy + 1 + h, dx + 1:dx + 1 + w]

    gnorm = torch.sqrt(gx * gx + gy * gy + 1e-8)
    c, s = gx / gnorm, gy / gnorm
    cp, sp = c >= 0, s >= 0
    n1 = (_abs(c) * torch.where(cp, sh(0, 1), sh(0, -1))
          + _abs(s) * torch.where(sp, sh(1, 0), sh(-1, 0)))
    n2 = (_abs(c) * torch.where(cp, sh(0, -1), sh(0, 1))
          + _abs(s) * torch.where(sp, sh(-1, 0), sh(1, 0)))
    denom = _abs(c) + _abs(s) + 1e-12
    keep = torch.sigmoid(SHARPNESS * (mag - n1 / denom)) * \
        torch.sigmoid(SHARPNESS * (mag - n2 / denom))
    edge = mag * keep
    q = edge / HIGH
    return torch.sigmoid(SHARPNESS * (edge - LOW)) * torch.minimum(
        torch.maximum(q, q.new_zeros(())), q.new_ones(()))


# csrc/canny.cu's geometry: output rows and columns a tile, threads a CTA,
# and the length of a tile's list of pixels tied at the max
TILE_H, TILE_W, THREADS, TIES = 32, 90, 192, 16
SMEM_CTA = 227 * 1024  # sm_90's shared memory a CTA
# each kernel's gray halo: its other stages' halos follow from it (the
# gaussian 2 less, the Sobel 3 less); the input kernel's is the reach of
# its folds, ``input_ties`` that of its recompute where a tile holds a tie
HALOS = {"max": 3, "map": 4, "local": 5, "input": 4, "input_ties": 6}


def _region(h: int) -> int:
    """Floats of a tile grown by ``h`` on every side."""
    return (TILE_H + 2 * h) * (TILE_W + 2 * h)


# shared-memory bytes of each kernel: two areas, each reused in turn
SMEM = {"max": 4 * (_region(3) + _region(1)),
        "map": 4 * (max(_region(4), _region(1)) + _region(2)),
        "local": 4 * (max(_region(5), _region(2)) + _region(3)),
        "input": 4 * (max(2 * _region(3), _region(6), _region(0))
                      + max(_region(4), _region(2)))}


@dataclass(frozen=True)
class Plan:
    """K19's launch for (n, h, w): a grid of ``tiles_x`` × ``tiles_y`` × n
    CTAs of ``THREADS``, each owning the outputs ``box(ty, tx)``; one slot a
    tile (the forward's max, the backward's sum and tie count)."""
    n: int
    h: int
    w: int
    tiles_y: int
    tiles_x: int

    @property
    def slots(self) -> int:
        """Slots an image."""
        return self.tiles_y * self.tiles_x

    @property
    def grid(self):
        return self.tiles_x, self.tiles_y, self.n

    def box(self, ty: int, tx: int):
        """The output rows and columns ``[r0, r1) × [c0, c1)`` of a tile,
        clipped to the image."""
        r0, c0 = ty * TILE_H, tx * TILE_W
        return r0, min(r0 + TILE_H, self.h), c0, min(c0 + TILE_W, self.w)

    def edge(self, ty: int, tx: int, halo: int) -> bool:
        """Whether the tile grown by ``halo`` reaches past the image: such a
        tile takes the kernels' reflect, mask and fold code, any other the
        straight stencils."""
        r0, c0 = ty * TILE_H, tx * TILE_W
        return (r0 < halo or c0 < halo or r0 + TILE_H + halo > self.h
                or c0 + TILE_W + halo > self.w)

    def scratch_bytes(self) -> int:
        """The backward's scratch beyond dx: two planes, and a tile's sum,
        tie count and list of ties (a position and two floats each)."""
        return 4 * (2 * self.n * self.h * self.w
                    + (2 + 3 * TIES) * self.n * self.slots)


def plan(n: int, h: int, w: int) -> Plan:
    if h < 3 or w < 3 or not 1 <= n <= 65535:
        raise ValueError(f"canny_soft: no plan for (n={n}, h={h}, w={w}): "
                         f"H, W ≥ 3 and 1 ≤ N ≤ 65535")
    return Plan(n, h, w, -(-h // TILE_H), -(-w // TILE_W))


@functools.lru_cache(maxsize=None)
def check_geometry() -> None:
    """Raise unless the built kernels' geometry is this module's; once a
    process, before the first launch."""
    import ctypes
    out = (ctypes.c_int * 8)()
    _lib.load().vwfd_canny_geometry(out)
    want = (TILE_H, TILE_W, THREADS, TIES, SMEM["max"], SMEM["map"],
            SMEM["local"], SMEM["input"])
    if tuple(out) != want:
        raise RuntimeError(f"canny kernels' geometry {tuple(out)} is not "
                           f"the host plan's {want}")


_SCRATCH = {}  # per device and stream: the kernels' per-image counters


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """4·n int32, zero between calls: the forward's pair of per-image
    counts, then the backward's (``csrc/canny.cu``: each direction's second
    kernel waits for its image's tiles of the first and sets them back)."""
    (done,) = _lib.stream_scratch(_SCRATCH, dev, [(4 * n, torch.int32,
                                                   True)])
    return done


class _CannyKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n, h, w, _ = x.shape
        p = plan(n, h, w)
        check_geometry()
        mslot = torch.empty(n * p.slots, device=x.device, dtype=torch.int32)
        y = torch.empty((n, h, w, 1), device=x.device, dtype=torch.float32)
        done = _counters(x.device, n)
        _lib.launch("vwfd_canny_fwd", x.device, x.data_ptr(),
                    mslot.data_ptr(), y.data_ptr(), done.data_ptr(), n, h, w,
                    p.tiles_y, p.tiles_x)
        COUNT.n += 1
        ctx.save_for_backward(x, mslot)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mslot = ctx.saved_tensors
        n, h, w, _ = x.shape
        p = plan(n, h, w)
        g = g.contiguous()
        dev = x.device
        psum = torch.empty(n * p.slots, device=dev, dtype=torch.float32)
        pcnt = torch.empty(n * p.slots, device=dev, dtype=torch.int32)
        tie_pos = torch.empty(n * p.slots * TIES, device=dev,
                              dtype=torch.int32)
        tie_g = torch.empty(2 * n * p.slots * TIES, device=dev,
                            dtype=torch.float32)
        planes = torch.empty((2, n, h, w), device=dev, dtype=torch.float32)
        dx = torch.empty((n, h, w, 3), device=dev, dtype=torch.float32)
        done = _counters(dev, n)
        _lib.launch("vwfd_canny_bwd", dev, x.data_ptr(), g.data_ptr(),
                    mslot.data_ptr(), psum.data_ptr(), pcnt.data_ptr(),
                    tie_pos.data_ptr(), tie_g.data_ptr(),
                    planes[0].data_ptr(), planes[1].data_ptr(),
                    dx.data_ptr(), done[2 * n:].data_ptr(), n, h, w,
                    p.tiles_y, p.tiles_x)
        COUNT.n += 1
        return dx


def canny_soft(img: torch.Tensor) -> torch.Tensor:
    """Soft canny edge map of (N, H, W, 3) float32 images in [0, 1] →
    (N, H, W, 1), differentiable in img: the CUDA kernels (forward and
    backward) for a CUDA tensor, the plain version for a CPU tensor."""
    _check(img)
    if not _lib.on_cuda(img):
        return canny_soft_plain(img)
    return _CannyKernel.apply(img)
