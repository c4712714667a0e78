"""K23 `film_residual`: the FiLM epilogue of FBCNN's QF-attention blocks,
forward and backward.

Replaces ``vwfd_tpu/nets/fbcnn.py:40`` (``_QFAttention``: ``x + (γ·h +
β)`` with γ, β per image and channel), an op XLA fuses on the TPU and
PyTorch runs as separate passes. On NCHW float32 ``x``, ``h`` (B, C, H,
W) and ``γ``, ``β`` (B, C):

* forward ``out = x + (γ[b, c]·h + β[b, c])``, each product and sum
  rounded on its own as the plain version's (``__fmul_rn`` /
  ``__fadd_rn``: ``torch.equal`` to it);
* backward ``gh = γ·g`` (``torch.equal``), ``gx = g`` itself (no copy),
  ``gγ[b, c] = Σ g·h`` and ``gβ[b, c] = Σ g`` over the plane, summed in a
  fixed order without float atomics (bit-identical from call to call, not
  the plain version's order: within 1e-5 of the plain Σ|g·h| and Σ|g|).
  The backward reads ``ctx.needs_input_grad``: without a gradient for γ
  and β (the JPEG simulator's frozen attack branch) it skips the sums and
  does not read h.

Bound: bytes. The forward reads x and h and writes out, the backward reads
g and h and writes gh, 12 bytes a value each way: at KD-JPEG's 256² b6 a
generator forward's 12 launches move 1.06 GB, 0.315 ms at 3.35 TB/s, and
its backward the same. The plain version moves about 7 tensor passes each
way.

Design (``csrc/film.cu``): a CTA of 256 threads takes one plane and a run
of it, γ and β two scalar loads a CTA, four 16-byte loads a thread issued
before it computes. The backward splits each plane into ``segments``
runs (``segments(planes, hw, sms)``, so that the grid fills the card at
every FBCNN level, with the sums or without), each CTA reduces its run to a
partial, and the CTA that takes the plane's last integer ticket adds the
partials in run order (stream scratch: the partials and one zeroed ticket a
plane, left at 0).
"""

import torch

from . import _lib

__all__ = ["film_residual", "film_residual_plain", "film_backward",
           "segments", "COUNT"]

COUNT = _lib.LaunchCount("film_residual")
BLOCK = 256       # threads a CTA (csrc/film.cu kBlock)
UNROLL = 4        # vectors a thread loads before it computes (kUnroll)
CTAS_PER_SM = 8   # the backward's grid target: 8 CTAs of 256 threads an SM
_SCRATCH: dict = {}


def _check(x, h, gamma, beta) -> None:
    if x.dim() != 4 or h.shape != x.shape:
        raise ValueError(f"film_residual: x and h must be one (B, C, H, W) "
                         f"shape, got {tuple(x.shape)} and {tuple(h.shape)}")
    if gamma.shape != x.shape[:2] or beta.shape != x.shape[:2]:
        raise ValueError(f"film_residual: gamma and beta must be (B, C) = "
                         f"{tuple(x.shape[:2])}, got {tuple(gamma.shape)} "
                         f"and {tuple(beta.shape)}")


def segments(planes: int, hw: int, sms: int) -> int:
    """Runs a plane in the backward: enough CTAs for ``CTAS_PER_SM`` an SM
    over ``planes`` planes, each run at least one full sweep of the CTA
    (``UNROLL·BLOCK`` vectors of 4 floats, or floats where ``hw`` is not a
    multiple of 4)."""
    nv = hw // 4 if hw % 4 == 0 else hw
    want = -(-CTAS_PER_SM * sms // planes)
    return max(1, min(want, nv // (UNROLL * BLOCK), 65535))


def film_residual_plain(x: torch.Tensor, h: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version: ``x + (γ·h + β)`` with γ, β broadcast over
    the plane, differentiated by autograd."""
    _check(x, h, gamma, beta)
    return x + (gamma[:, :, None, None] * h + beta[:, :, None, None])


def film_backward(g: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                  want_gh: bool = True, want_sums: bool = True):
    """The backward kernel on CUDA float32 tensors: ``(gh, gγ, gβ)``, each
    None where not wanted (gx is g)."""
    planes, hw = g.shape[0] * g.shape[1], g.shape[2] * g.shape[3]
    dev = g.device
    gh = torch.empty_like(g) if want_gh else None
    gg = gb = None
    part = ticket = None
    segs = segments(planes, hw, _lib.sm_count(dev))
    if want_sums:
        gg = torch.empty_like(gamma)
        gb = torch.empty_like(gamma)
        if segs > 1:
            ticket, part = _lib.stream_scratch(
                _SCRATCH, dev, [(planes, torch.int32, True),
                                (2 * planes * segs, torch.float32, False)])

    def ptr(t):
        return None if t is None else t.data_ptr()
    _lib.launch("vwfd_film_bwd", dev, g.data_ptr(), h.data_ptr(),
                gamma.data_ptr(), ptr(gh), ptr(gg), ptr(gb), ptr(part),
                ptr(ticket), planes, hw, segs)
    COUNT.n += 1
    return gh, gg, gb


class _FilmKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, gamma, beta):
        out = torch.empty_like(x)
        planes, hw = x.shape[0] * x.shape[1], x.shape[2] * x.shape[3]
        _lib.launch("vwfd_film_fwd", x.device, x.data_ptr(), h.data_ptr(),
                    gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                    planes, hw)
        COUNT.n += 1
        ctx.save_for_backward(h, gamma)
        return out

    @staticmethod
    def backward(ctx, g):
        h, gamma = ctx.saved_tensors
        need_x, need_h, need_g, need_b = ctx.needs_input_grad
        want_sums = need_g or need_b
        if not (need_h or want_sums):
            return g if need_x else None, None, None, None
        g = g.contiguous()
        gh, gg, gb = film_backward(g, h, gamma, need_h, want_sums)
        return (g if need_x else None, gh, gg if need_g else None,
                gb if need_b else None)


def film_residual(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor) -> torch.Tensor:
    """``x + (γ[b, c]·h + β[b, c])`` of NCHW ``x``, ``h`` and (B, C) ``γ``,
    ``β``, differentiable in all four: K23 (forward and backward) for CUDA
    float32 tensors (any other dtype raises), the plain version for CPU
    tensors."""
    _check(x, h, gamma, beta)
    if not _lib.on_cuda(x, h, gamma, beta):
        return film_residual_plain(x, h, gamma, beta)
    for t in (x, h, gamma, beta):
        if t.dtype != torch.float32:
            raise TypeError(f"film_residual takes float32, got {t.dtype}")
    return _FilmKernel.apply(x.contiguous(), h.contiguous(),
                             gamma.contiguous(), beta.contiguous())
