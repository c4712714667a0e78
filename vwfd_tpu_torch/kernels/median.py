"""K6 `median3`: the attack pool's 3×3 median filter, forward and backward.

Replaces ``vwfd_tpu/ops/filters.py::_median3`` (:48-114): the median of the
nine views of the reflect-padded neighbourhood (the edge pixel is not
repeated) by the Paeth network, 19 min/max, bit-exact; its backward sends
each output cotangent to the input pixel of the FIRST of the nine views, in
raster order (dy, then dx), whose value equals the median, followed through
the reflect padding. Attack inputs are quantised to 1/255 levels, so ties
are common and the rule must be exact; ``torch.median``/``sort`` autograd
routes ties otherwise.

Bound: bytes. At the training shape (64 frames of 256²×3 f32) the forward
moves 100.7 MB (x read, y written), about 0.030 ms at 3.35 TB/s; the
backward reads x and g and writes gx, 151 MB, 0.045 ms.

Design (``csrc/median.cu``): a CTA per 32×8-pixel tile stages the
reflect-padded halo in shared memory; one thread per pixel runs the network
for the three channels. The backward is a deterministic gather (no float
atomics): each output's choice is kept as a code 0..8, the offset of its
source pixel from it, and each input pixel adds the cotangents of the
outputs that chose it, visiting its 3×3 neighbours in raster order. The
plain version below computes the same codes and sums in the same order, so
kernel and plain agree bit for bit, forward and backward.
"""

import torch
import torch.nn.functional as F

from . import _lib

__all__ = ["median3", "median3_plain", "median_views", "COUNT"]

COUNT = _lib.LaunchCount("median3")

# vwfd_tpu/ops/filters.py::_PAETH_SWAPS
_PAETH_SWAPS = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                (2, 5), (4, 7), (4, 2), (6, 4), (4, 2))


def _check(x: torch.Tensor) -> None:
    _lib.check_nhwc(x, "median3 input")
    if x.dtype != torch.float32:
        raise TypeError(f"median3 takes float32, got {x.dtype}")
    n, h, w, c = x.shape
    if c != 3 or h < 2 or w < 2:
        raise ValueError(f"median3: expected (N, H≥2, W≥2, 3), got "
                         f"{tuple(x.shape)}")


def _reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → (N, H+2, W+2, C), reflect padding by one."""
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], 1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], 2)


def median_views(x: torch.Tensor):
    """The nine 3×3 views of the reflect-padded ``x``, raster order."""
    h, w = x.shape[1], x.shape[2]
    xp = _reflect_pad1(x)
    return [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def _paeth(views):
    v = list(views)
    for i, j in _PAETH_SWAPS:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def _refl(i: torch.Tensor, n: int) -> torch.Tensor:
    i = i.abs()
    return torch.where(i >= n, 2 * n - 2 - i, i)


def _codes(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Per output: (sy+1)·3 + (sx+1), the offset (sy, sx) ∈ {-1,0,1}² of the
    input pixel that the first view equal to the median reads."""
    n, h, w, c = x.shape
    k = torch.full(m.shape, 8, dtype=torch.long, device=x.device)
    claimed = torch.zeros(m.shape, dtype=torch.bool, device=x.device)
    for idx, v in enumerate(median_views(x)[:8]):
        hit = (v == m) & ~claimed
        k = torch.where(hit, idx, k)
        claimed |= hit
    oy = torch.arange(h, device=x.device).view(1, h, 1, 1)
    ox = torch.arange(w, device=x.device).view(1, 1, w, 1)
    sy = _refl(oy + k // 3 - 1, h) - oy
    sx = _refl(ox + k % 3 - 1, w) - ox
    return (sy + 1) * 3 + sx + 1


def _gather(codes: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """gx[p] = Σ over the outputs o = p + (dy, dx), (dy, dx) in raster
    order, that chose p (code of offset (−dy, −dx)), of g[o]."""
    h, w = g.shape[1], g.shape[2]
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    cp = F.pad(codes, (0, 0, 1, 1, 1, 1), value=-1)
    gx = torch.zeros_like(g)
    for d in range(9):
        dy, dx = d // 3 - 1, d % 3 - 1
        sl = (slice(None), slice(1 + dy, 1 + dy + h), slice(1 + dx, 1 + dx + w))
        gx = gx + torch.where(cp[sl] == (1 - dy) * 3 + 1 - dx, gp[sl], 0.0)
    return gx


class _Median3Plain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        m = _paeth(median_views(x))
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        return _gather(_codes(x, m), g)


class _Median3Kernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n, h, w, _ = x.shape
        y = torch.empty_like(x)
        _lib.launch("vwfd_median3_fwd", x.device, x.data_ptr(), y.data_ptr(),
                    n, h, w)
        COUNT.n += 1
        ctx.save_for_backward(x)
        return y

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g = g.contiguous()
        gx = torch.empty_like(x)
        n, h, w, _ = x.shape
        _lib.launch("vwfd_median3_bwd", x.device, x.data_ptr(), g.data_ptr(),
                    gx.data_ptr(), n, h, w)
        COUNT.n += 1
        return gx


def median3_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the Paeth network on the nine reflect-padded
    views, with the first-match backward as an autograd function."""
    _check(x)
    return _Median3Plain.apply(x)


def median3(x: torch.Tensor) -> torch.Tensor:
    """3×3 median of an NHWC float32 RGB batch, differentiable in x: the
    CUDA kernels (forward and backward) for a CUDA tensor, the plain version
    for a CPU tensor."""
    _check(x)
    if not _lib.on_cuda(x):
        return median3_plain(x)
    return _Median3Kernel.apply(x)
