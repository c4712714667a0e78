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
The design (``csrc/canny.cu``) and why it sits above that: two forward
launches through gx, gy and mag0 in device memory (the per-image max sits
between the stencil and the NMS), four backward ones (the max's cotangent
is a per-image sum between the NMS's transpose and the stencils').
"""

import functools

import torch
import torch.nn.functional as F

from . import _lib
from ..ops.filters import gaussian_kernel_2d

__all__ = ["canny_soft", "canny_soft_plain", "sobel_edges", "gray", "GRAY",
           "COUNT", "SHARPNESS", "LOW", "HIGH"]

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


@functools.lru_cache(maxsize=None)
def _gauss_taps():
    import ctypes
    k = gaussian_kernel_2d(5, SIGMA).reshape(-1)
    return (ctypes.c_float * 25)(*[float(v) for v in k])


class _CannyKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n, h, w, _ = x.shape
        gx, gy, mag0 = (torch.empty((n, h, w), device=x.device,
                                    dtype=torch.float32) for _ in range(3))
        mbits = torch.zeros(n, device=x.device, dtype=torch.int32)
        y = torch.empty((n, h, w, 1), device=x.device, dtype=torch.float32)
        _lib.launch("vwfd_canny_fwd", x.device, x.data_ptr(), gx.data_ptr(),
                    gy.data_ptr(), mag0.data_ptr(), mbits.data_ptr(),
                    y.data_ptr(), n, h, w, _gauss_taps())
        COUNT.n += 1
        ctx.save_for_backward(gx, gy, mag0, mbits)
        return y

    @staticmethod
    def backward(ctx, g):
        gx, gy, mag0, mbits = ctx.saved_tensors
        n, h, w = gx.shape
        g = g.contiguous()
        dev = gx.device
        blocks = (h * w + 255) // 256
        scratch = torch.empty(8 * n * h * w, device=dev, dtype=torch.float32)
        partials = torch.empty(2 * n * blocks, device=dev,
                               dtype=torch.float32)
        totals = torch.empty(2 * n, device=dev, dtype=torch.float32)
        dx = torch.empty((n, h, w, 3), device=dev, dtype=torch.float32)
        _lib.launch("vwfd_canny_bwd", dev, g.data_ptr(), gx.data_ptr(),
                    gy.data_ptr(), mag0.data_ptr(), mbits.data_ptr(),
                    scratch.data_ptr(), partials.data_ptr(),
                    totals.data_ptr(), dx.data_ptr(), n, h, w, _gauss_taps())
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
