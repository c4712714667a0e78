"""K22 `ssim_grad`: the gradient of the windowed SSIM with respect to its
first image, the backward of K8 (``kernels/ssim.py``) under autograd.

Replaces the VJP that JAX's autodiff takes of
``vwfd_tpu/metrics/metrics.py::ssim`` (:65-79) in CLR's loss term
``0.1·(1 − ssim(fwd_rgb, img))`` (``vwfd_tpu/models/image_model.py:398``).
K8 writes its windowed sums into ``torch.empty`` buffers, so without this
backward an SSIM on the card would give its value and no gradient. With
the map's partial derivatives α = ∂S/∂μ1, β = ∂S/∂E[x1²] and γ =
∂S/∂E[x1·x2] (``csrc/ssim_grad.cu``), ``dx1 = s_n·(Wα + 2·x1·Wβ +
x2·Wγ)``, W the 11-tap gaussian window (zero "same" padding) and s_n the
cotangent of image n's share of the mean: ``scale`` (N,), ``ḡ/(N·H·W·C) +
ḡ_n/(H·W·C)`` for the cotangents of the mean and of the per-image means.
No gradient flows into the second image (the model's is data).

Bound: the larger of bytes (x1 and x2 read, dx written: 18.9 MB at CLR's
(8, 256, 256, 3), 5.6 µs at 3.35 TB/s) and operations (``OPS`` a value,
8.1 µs at 67 TFLOP/s; H100 SXM data sheet, 700 W).

Design (``csrc/ssim_grad.cu``): one launch with K8's structure run twice
over, α, β and γ kept in shared memory. A CTA of 256 threads (one an SM)
walks a strip of 64 output columns (all three channels) down ``plan``'s
segment of rows, 13 a chunk: the forward's four vertical sums roll in registers, its
horizontal sums read float4 from shared memory (12 outputs a thread) and
form α, β, γ on the strip and a 5-pixel halo, the transposed window's
vertical sums roll in registers 5 rows behind, and its horizontal sums
combine with x1 and x2 (the rows staged a chunk back) into dx. Inputs
arrive by ``cp.async``; nothing but dx is written to device memory and the
wrapper allocates nothing else. The
plain version is the autograd of ``ssim.ssim_map`` (``ssim_grad_plain``);
the kernel sums in another order and σ² = E[x²] − μ² cancels in flat
windows, so it is held to the plain gradient's max (``RTOL``), not per
value.
"""

from typing import Tuple

import torch

from . import _lib
from .ssim import _TAPS, ssim_map

__all__ = ["ssim_grad", "ssim_grad_plain", "scale_of", "plan",
           "segment_walk", "SMEM_BYTES", "RTOL", "OPS", "COUNT"]

COUNT = _lib.LaunchCount("ssim_grad")
RTOL = 1e-3  # kernel vs plain: max |Δ| within this of the plain max
# per value, the least work of the function (FMA = 2):
# - the forward's windowed sums, as K8's bound counts them: 2 passes × 4
#   sums (μ1, μ2, E[x1² + x2²], E[x1·x2]; the map takes E[x1²] and E[x2²]
#   only as a sum) × 11 FMA = 176, and the products x1², x2², x1·x2 summed 4;
# - the map S 15 (A1, A2, B1, B2, S as K8's bound counts it) and its
#   derivatives 13 (α: 2μ1, 2μ2, four quotients, three sums, the product
#   by S; β one quotient; γ 2S and its quotient);
# - the transposed window over α, β, γ: 2 passes × 3 sums × 11 FMA = 132;
# - the combine s·(Wα + 2·x1·Wβ + x2·Wγ): 6.
OPS = 2 * 4 * 11 * 2 + 4 + 15 + 13 + 2 * 3 * 11 * 2 + 6  # 346

_HALO = 5      # the window's half width
_TW = 64       # csrc/ssim_grad.cu kTW: output columns of a strip
_RC = 13       # kRC: rows of a chunk
_BLOCK = 256   # kBlock: threads of a CTA, one CTA an SM
# kSmemFloats: three chunks' raw rows (3 × 2 × kRC × kBlock), the vertical
# sums (4 × kRC × kVStride, kVStride = 12·18 + 44: the forward's, then the
# transpose's in the same place) and α, β, γ (3 × kRC × 12·19), float32
SMEM_BYTES = 4 * _RC * (3 * 2 * _BLOCK + 4 * 260 + 3 * 228)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, h: int, w: int, sms: int) -> Tuple[int, int, int]:
    """``(strips, segments, rows)``: the grid is ``(strips, segments, n)``,
    a CTA writes a strip of 64 columns and ``rows`` rows (13·chunks − 10)
    of one image. The split minimises the waves of CTAs (one an SM) times
    the x rows each walks (its chunks' and the 10 that fill the window);
    ties keep fewer segments."""
    strips = _cdiv(w, _TW)
    best = None
    for chunks in range(1, _cdiv(h + 2 * _HALO, _RC) + 1):
        rows = _RC * chunks - 2 * _HALO
        segments = _cdiv(h, rows)
        if segments > 65535:
            continue
        waves = _cdiv(strips * segments * n, sms)
        cost = waves * (_RC * chunks + 2 * _HALO)
        if best is None or cost < best[0]:
            best = (cost, segments, rows)
    return strips, best[1], best[2]


def segment_walk(h: int, rows: int, s: int):
    """What CTA row ``s`` of the grid covers (``csrc/ssim_grad.cu``): its
    output rows ``[r0, r1)``, the x rows it stages ``[r0 − 10, r0 +
    13·chunks)`` (the first 10 fill the window) and the α rows it forms
    ``[r0 − 5, r0 − 5 + 13·chunks)``."""
    r0 = s * rows
    r1 = min(h, r0 + rows)
    chunks = _cdiv(r1 - r0 + 2 * _HALO, _RC)
    return ((r0, r1), (r0 - 2 * _HALO, r0 + _RC * chunks),
            (r0 - _HALO, r0 - _HALO + _RC * chunks))


def scale_of(g_means: torch.Tensor, g_mean: torch.Tensor, shape
             ) -> torch.Tensor:
    """Per-image scale (N,) float32 from the cotangents of the per-image
    means (N,) and of the mean (0-dim), summed in float64."""
    n, h, w, c = shape
    s = g_mean.double() / (n * h * w * c) + g_means.double() / (h * w * c)
    return s.float().contiguous()


def ssim_grad_plain(img1: torch.Tensor, img2: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: autograd of ``Σ_n scale_n·Σ_p S_n(p)``."""
    with torch.enable_grad():
        x1 = img1.detach().requires_grad_(True)
        m = ssim_map(x1, img2.detach()).double()
        total = (m.sum(dim=(1, 2, 3)) * scale.double()).sum()
        return torch.autograd.grad(total, x1)[0]


def ssim_grad(img1: torch.Tensor, img2: torch.Tensor, scale: torch.Tensor
              ) -> torch.Tensor:
    """d/d img1 of ``Σ_n scale_n·Σ_p S_n(p)`` for (N, H, W, 3) float32
    images: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _lib.check_nhwc(img1, "ssim_grad img1")
    _lib.check_nhwc(img2, "ssim_grad img2")
    if img1.shape != img2.shape or tuple(scale.shape) != (img1.shape[0],):
        raise ValueError(f"ssim_grad: shapes {tuple(img1.shape)}, "
                         f"{tuple(img2.shape)}, scale {tuple(scale.shape)}")
    if not _lib.on_cuda(img1, img2, scale):
        return ssim_grad_plain(img1, img2, scale)
    if img1.dtype != torch.float32 or img2.dtype != torch.float32 \
            or scale.dtype != torch.float32:
        raise TypeError("the ssim_grad kernel takes float32")
    n, h, w, c = img1.shape
    if c != 3 or n > 65535:
        raise ValueError(f"ssim_grad kernel: at most 65535 images of three "
                         f"channels, got {n} of {c}")
    _, segments, rows = plan(n, h, w, _lib.sm_count(img1.device))
    dx = torch.empty_like(img1)
    _lib.launch("vwfd_ssim_grad", img1.device, img1.data_ptr(),
                img2.data_ptr(), scale.data_ptr(), _TAPS, dx.data_ptr(), n, h,
                w, segments, rows)
    COUNT.n += 1
    return dx
