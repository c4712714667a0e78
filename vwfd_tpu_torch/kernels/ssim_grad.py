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
H100 SXM data sheet, 700 W).

Design (first version): two launches over 32×32 tiles of one channel with
a 5-pixel halo in shared memory. The first recomputes K8's five windowed
sums (vertical then horizontal 11-tap passes) and writes α, β, γ as three
planes; the second applies the window to the planes and combines with x1
and x2. The plain version is the autograd of ``ssim.ssim_map``
(``ssim_grad_plain``); the kernel sums in another order and σ² = E[x²] −
μ² cancels in flat windows, so it is held to the plain gradient's max
(``RTOL``), not per value.
"""

import torch

from . import _lib
from .ssim import _TAPS, ssim_map

__all__ = ["ssim_grad", "ssim_grad_plain", "scale_of", "RTOL", "OPS",
           "COUNT"]

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
    """d/d img1 of ``Σ_n scale_n·Σ_p S_n(p)`` for (N, H, W, C) float32
    images: the CUDA kernels for CUDA tensors, the plain version for CPU
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
    if n * c > 65535:
        raise ValueError(f"ssim_grad kernel: at most 65535 image channels, "
                         f"got {n * c}")
    planes = torch.empty((3,) + tuple(img1.shape), device=img1.device)
    dx = torch.empty_like(img1)
    _lib.launch("vwfd_ssim_grad", img1.device, img1.data_ptr(),
                img2.data_ptr(), scale.data_ptr(), _TAPS,
                planes[0].data_ptr(), planes[1].data_ptr(),
                planes[2].data_ptr(), dx.data_ptr(), n, h, w, c)
    COUNT.n += 1
    return dx
