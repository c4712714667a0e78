"""Optical-flow warping (port of vwfd_tpu/ops/warp.py; the reference's
models/modules/module_util.py:75-99 ``flow_warp``).

x sampled at grid + flow, ``F.grid_sample(align_corners=True)`` semantics on
the unnormalised grid: bilinear or nearest, ``"zeros"`` or ``"border"``
padding. NHWC; the four corners (or the nearest pixel) gathered from the
flattened plane with clamped indices, as the JAX package does, and the
same products and sums in the same order.
"""

import torch

__all__ = ["flow_warp"]


def _gather(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor
            ) -> torch.Tensor:
    b, h, w, c = x.shape
    yi = torch.clamp(yi, 0, h - 1).to(torch.int64)
    xi = torch.clamp(xi, 0, w - 1).to(torch.int64)
    idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
    return torch.gather(x.reshape(b, h * w, c), 1, idx).reshape(b, h, w, c)


def _inside(yi, xi, h, w):
    ok = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
    return ok[..., None].to(torch.float32)


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interp_mode: str = "bilinear",
              padding_mode: str = "zeros") -> torch.Tensor:
    """x (B, H, W, C); flow (B, H, W, 2), (dx, dy) in pixels. Returns
    (B, H, W, C) warped, out-of-frame samples per ``padding_mode``
    (``"zeros"`` or ``"border"``); ``interp_mode`` ``"bilinear"`` or
    ``"nearest"`` (half-way rounds to even, as ``jnp.round``)."""
    b, h, w, c = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=flow.dtype,
                                         device=flow.device),
                            torch.arange(w, dtype=flow.dtype,
                                         device=flow.device), indexing="ij")
    sx = gx[None] + flow[..., 0]
    sy = gy[None] + flow[..., 1]
    if interp_mode == "nearest":
        out = _gather(x, torch.round(sy), torch.round(sx))
        if padding_mode == "zeros":
            valid = ((sx >= -0.5) & (sx <= w - 0.5) &
                     (sy >= -0.5) & (sy <= h - 0.5))
            out = out * valid[..., None].to(x.dtype)
        return out
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    tx = (sx - x0)[..., None]
    ty = (sy - y0)[..., None]
    v00 = _gather(x, y0, x0)
    v01 = _gather(x, y0, x0 + 1)
    v10 = _gather(x, y0 + 1, x0)
    v11 = _gather(x, y0 + 1, x0 + 1)
    if padding_mode == "zeros":
        v00 = v00 * _inside(y0, x0, h, w)
        v01 = v01 * _inside(y0, x0 + 1, h, w)
        v10 = v10 * _inside(y0 + 1, x0, h, w)
        v11 = v11 * _inside(y0 + 1, x0 + 1, h, w)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty
