"""K8 `ssim`: windowed SSIM of two NHWC RGB batches, reduced to the mean of
each image and the mean of all.

Replaces ``vwfd_tpu/metrics/metrics.py:41-79``: ``_ssim_window`` (11×11
gaussian, σ = 1.5), ``_depthwise_same_conv`` (zero padding) five times, the
SSIM map with c1 = 0.01², c2 = 0.03², and its mean. Returns ``(means,
mean)``: float32 (N,) and a 0-dim float32.

Bound: operations. At the flagship eval step (64 frames of 256²×3 f32)
about 243 f32 flops a value (two 11-tap passes of five sums, the products
and the map), 3.1 GFLOP: 0.046 ms at 67 TFLOP/s, against 0.030 ms for the
100.7 MB the inputs hold (H100 SXM data sheet, 700 W).

Design (``csrc/ssim.cu``): the window is the outer product of the 1-D
gaussian, so each windowed sum is a horizontal and then a vertical 11-tap
pass. A CTA stages a 32×32 tile of one image (all three channels) plus a
5-pixel zero halo in shared memory with 16-byte loads where rows allow; a
thread walks one column's 26 staged rows, keeps the last 11 rows'
horizontal sums in registers and forms each vertical sum and map value as
soon as its window is complete. The map is summed in double per thread,
warp and block; the last block (integer ticket, no float atomics) adds the
blocks' partials per image in tile order and the images in order, so the
means repeat bit for bit. The ticket and partials live in scratch kept per
device and stream; the last block leaves the ticket at 0.

Accuracy against the plain version: the separable sums run in another
order than the reference's 121-term chain, and σ² = E[x²] − μ² cancels, so
a single map value may move by up to about 1e-4 where a window is flat
(σ² near 0; c2 = 9e-4 bounds the denominator); the means average such
errors away. ``chip_smoke.py`` holds every mean within ``ATOL`` of the
plain version's.
"""

import ctypes
import math
from typing import Tuple

import torch

from . import _lib

__all__ = ["ssim", "ssim_plain", "window_1d", "window_2d", "ATOL", "COUNT"]

COUNT = _lib.LaunchCount("ssim")
WINDOW = 11   # csrc/ssim.cu kWin
SIGMA = 1.5
ATOL = 1e-5   # kernel vs plain, on each per-image mean and on the mean
_TILE = 32    # csrc/ssim.cu kTile
_SCRATCH: dict = {}  # per (device, stream): ticket, partials, image sums


def _gauss(window_size: int, sigma: float):
    """The normalised 1-D gaussian in float64 (python floats)."""
    g = [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
         for x in range(window_size)]
    total = sum(g)
    return [v / total for v in g]


def window_2d(window_size: int = WINDOW, sigma: float = SIGMA
              ) -> torch.Tensor:
    """``vwfd_tpu/metrics/metrics.py::_ssim_window``: the outer product of
    the gaussian in float64, cast to float32."""
    g = torch.tensor(_gauss(window_size, sigma), dtype=torch.float64)
    return torch.outer(g, g).float()


def window_1d(window_size: int = WINDOW, sigma: float = SIGMA
              ) -> torch.Tensor:
    """The kernel's taps: the 1-D gaussian cast to float32."""
    return torch.tensor(_gauss(window_size, sigma), dtype=torch.float32)


def _check(img1: torch.Tensor, img2: torch.Tensor) -> None:
    if img1.shape != img2.shape:
        raise ValueError(f"ssim: shapes {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)} differ")
    _lib.check_nhwc(img1, "ssim img1")
    _lib.check_nhwc(img2, "ssim img2")
    if img1.dtype != torch.float32 or img2.dtype != torch.float32:
        raise TypeError(f"ssim takes float32, got {img1.dtype} and "
                        f"{img2.dtype}")
    if img1.shape[0] < 1:
        raise ValueError("ssim: empty batch")


def depthwise_same_conv(x: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """``_depthwise_same_conv``: zero padding on (..., H, W, C), the
    products summed in the reference's (dy, dx) order."""
    ks = k2d.shape[0]
    pad = ks // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    h, w = x.shape[-3], x.shape[-2]
    out = torch.zeros_like(x)
    for dy in range(ks):
        for dx in range(ks):
            out = out + float(k2d[dy, dx]) * xp[..., dy:dy + h, dx:dx + w, :]
    return out


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = WINDOW) -> torch.Tensor:
    """The SSIM map of ``vwfd_tpu/metrics/metrics.py::ssim`` (float32)."""
    w = window_2d(window_size)
    mu1 = depthwise_same_conv(img1, w)
    mu2 = depthwise_same_conv(img2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = depthwise_same_conv(img1 * img1, w) - mu1_sq
    sigma2_sq = depthwise_same_conv(img2 * img2, w) - mu2_sq
    sigma12 = depthwise_same_conv(img1 * img2, w) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor,
               window_size: int = WINDOW
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(means, mean)`` of the SSIM map, per image
    and over the batch, each summed in double."""
    _check(img1, img2)
    m = ssim_map(img1, img2, window_size).double()
    return m.mean(dim=(1, 2, 3)).float(), m.mean().float()


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = WINDOW
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSIM ``(means, mean)`` of two (N, H, W, 3) float32 batches in
    [0, 1]: the CUDA kernel for CUDA tensors (11×11 window, three
    channels), the plain version for CPU tensors."""
    _check(img1, img2)
    if not _lib.on_cuda(img1, img2):
        return ssim_plain(img1, img2, window_size)
    n, h, w, c = img1.shape
    if window_size != WINDOW or c != 3:
        raise ValueError(f"ssim kernel: 11×11 window on 3 channels, got "
                         f"window {window_size} on {c}")
    if n > 65535:
        raise ValueError(f"ssim kernel: at most 65535 images, got {n}")
    dev = img1.device
    tiles = -(-h // _TILE) * -(-w // _TILE)
    ticket, partial, img_sum = _lib.stream_scratch(
        _SCRATCH, dev, [(1, torch.int32, True),
                        (n * tiles, torch.float64, False),
                        (n, torch.float64, False)])
    means = torch.empty(n, device=dev, dtype=torch.float32)
    mean = torch.empty((), device=dev, dtype=torch.float32)
    taps = (ctypes.c_float * WINDOW)(*window_1d().tolist())
    _lib.launch("vwfd_ssim", dev, img1.data_ptr(), img2.data_ptr(), n, h, w,
                taps, partial.data_ptr(), img_sum.data_ptr(),
                ticket.data_ptr(), means.data_ptr(), mean.data_ptr())
    COUNT.n += 1
    return means, mean
