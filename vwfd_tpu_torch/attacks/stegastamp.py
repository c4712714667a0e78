"""StegaStamp-style distortions (port of vwfd_tpu/attacks/stegastamp.py;
the reference's utils/JPEG.py:18-94 ``random_blur_kernel``,
``get_rand_transform_matrix``, ``get_rnd_brightness_torch``).

A random blur kernel (identity, an oriented line or a gaussian), a random
projective warp of the image corners (the 8×8 homography solved on the
device, bilinear sampling with edge clamp) and random brightness and hue
shifts. Every draw is an explicit tensor of uniforms in [0, 1): a draw in
[lo, hi) is ``max(lo, u·(hi − lo) + lo)`` in float32, the form of
``jax.random.uniform(key, shape, minval=lo, maxval=hi)`` (F4: the tests
take the uniforms from the JAX keys). ``sample_uniforms`` makes them from a
``torch.Generator``.
"""

import math

import torch

__all__ = ["sample_uniforms", "random_blur_kernel", "apply_blur_kernel",
           "random_perspective", "random_brightness_hue"]


def sample_uniforms(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniforms in [0, 1), float32, on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device)


def _span(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo_t = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def random_blur_kernel(u: torch.Tensor, n_blur: int = 7, probs=(0.25, 0.25),
                       sigrange_gauss=(1.0, 3.0), sigrange_line=(0.25, 1.0),
                       wmin_line: float = 3.0) -> torch.Tensor:
    """(N, N) normalised kernel: a gaussian with probability ``probs[0]``,
    an oriented line with ``probs[1]``, else the identity. ``u`` (5,):
    the uniforms of σ_gauss, the angle, σ_line, the line's width and the
    choice (the JAX function's ``split(key, 5)`` in order)."""
    dev = u.device
    ax = torch.arange(n_blur, dtype=torch.float32, device=dev)
    coords = torch.stack(torch.meshgrid(ax, ax, indexing="ij"), -1) \
        - 0.5 * (n_blur - 1)
    manhat = torch.sum(torch.abs(coords), -1)
    vals_nothing = (manhat < 0.5).to(torch.float32)
    sig_g = _span(u[0], *sigrange_gauss)
    vals_gauss = torch.exp(-torch.sum(coords ** 2, -1) / (2 * sig_g ** 2))
    theta = _span(u[1], 0.0, 1.0) * 2 * math.pi
    v = torch.stack([torch.cos(theta), torch.sin(theta)])
    dists = torch.sum(coords * v, -1)
    sig_l = _span(u[2], *sigrange_line)
    w_line = _span(u[3], 0.0, 1.0) * (0.5 * (n_blur - 1) + 0.1 - wmin_line) \
        + wmin_line
    vals_line = torch.exp(-dists ** 2 / (2 * sig_l ** 2)) * (manhat < w_line)
    t = _span(u[4], 0.0, 1.0)
    vals = torch.where(t < probs[0], vals_gauss,
                       torch.where(t < probs[0] + probs[1], vals_line,
                                   vals_nothing))
    return vals / torch.sum(vals)


def apply_blur_kernel(img: torch.Tensor, kernel: torch.Tensor
                      ) -> torch.Tensor:
    """Depthwise (N, N) ``kernel`` over (..., H, W, C), zero padding: the
    N² shifted views summed in raster order."""
    n = kernel.shape[0]
    pad = n // 2
    h, w = img.shape[-3], img.shape[-2]
    xp = torch.nn.functional.pad(img, (0, 0, pad, pad, pad, pad))
    out = torch.zeros_like(img)
    for dy in range(n):
        for dx in range(n):
            out = out + kernel[dy, dx] * xp[..., dy:dy + h, dx:dx + w, :]
    return out


def _solve_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The 3×3 homography taking the four ``src`` corners to ``dst`` (its
    last entry 1): the 8×8 system of the JAX function, solved by LU."""
    rows, rhs = [], []
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    one = torch.ones((), dtype=src.dtype, device=src.device)
    for i in range(4):
        x, y = src[i, 0], src[i, 1]
        u, v = dst[i, 0], dst[i, 1]
        rows.append(torch.stack([x, y, one, zero, zero, zero, -u * x,
                                 -u * y]))
        rhs.append(u)
        rows.append(torch.stack([zero, zero, zero, x, y, one, -v * x,
                                 -v * y]))
        rhs.append(v)
    h8 = torch.linalg.solve(torch.stack(rows), torch.stack(rhs))
    return torch.cat([h8, one[None]]).reshape(3, 3)


def random_perspective(img: torch.Tensor, u: torch.Tensor, d: float = 8.0
                       ) -> torch.Tensor:
    """Random projective warp of (B, H, W, C), corners jittered by up to
    ±d pixels (``u`` (4, 2): the jitter's uniforms), bilinear with edge
    clamp, one transform for the batch."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    jitter = _span(u, -d, d)
    dst = torch.tensor([[0.0, 0.0], [w, 0.0], [w, h], [0.0, h]],
                       dtype=torch.float32, device=dev)
    m = _solve_homography(dst, dst + jitter)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, -1)
    warped = m @ pts
    wx = warped[0] / (warped[2] + 1e-8)
    wy = warped[1] / (warped[2] + 1e-8)
    x0 = torch.floor(wx)
    y0 = torch.floor(wy)
    tx = (wx - x0).reshape(h, w, 1)
    ty = (wy - y0).reshape(h, w, 1)
    x0 = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0 = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    flat = img.reshape(img.shape[0], h * w, img.shape[-1])

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(-1)
        return flat[:, idx, :].reshape(img.shape[0], h, w, img.shape[-1])

    return ((1 - ty) * ((1 - tx) * gather(y0, x0) + tx * gather(y0, x1))
            + ty * ((1 - tx) * gather(y1, x0) + tx * gather(y1, x1)))


def random_brightness_hue(img: torch.Tensor, u_hue: torch.Tensor,
                          u_bri: torch.Tensor, rnd_bri: float = 0.3,
                          rnd_hue: float = 0.1) -> torch.Tensor:
    """An additive per-channel hue and a global brightness shift of
    (B, H, W, C), clamped to [0, 1]: ``u_hue`` (B, 1, 1, C) and ``u_bri``
    (B, 1, 1, 1) the uniforms of shifts in ±``rnd_hue`` and ±``rnd_bri``."""
    hue = _span(u_hue, -rnd_hue, rnd_hue)
    bri = _span(u_bri, -rnd_bri, rnd_bri)
    return torch.clamp(img + hue + bri, 0.0, 1.0)
