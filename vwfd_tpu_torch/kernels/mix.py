"""K9 `attack_mix`: the attack pool's α-mix with its gaussian blur and the
post-attack epilogue, forward and backward.

Replaces ``vwfd_tpu/attacks/combined.py:52`` (the per-frame α-mix),
``ops/filters.py:38-45`` (the 3×3, σ = 2 depthwise gaussian with zero
padding) and the epilogue after the pool: ``ste_quantize_255 ∘
clamp_with_grad`` in the train step (``models/video_model.py:198``), a clip
to [0, 1] in the eval step (``:264``) and the montage (``:369``). Per frame
n of (N, H, W, 3) float32 tensors, with ``(α0..α4) = alpha[n]``::

    out = epilogue(((α0·a0 + a_jpeg) + α3·a3) + α4·blur(x))

``x`` is the spliced clip, ``a0`` the resize round trip, ``a_jpeg`` K5's
pair (α1 and α2 already in it), ``a3`` K6's median. ``epilogue`` is
``"none"``, ``"clamp"`` or ``"quantize"`` (clamp, then ``round(·255)/255``
half to even); both are straight-through, so the backward is the mix's:
``dx = α4·blurᵀ(g)`` (the gaussian is symmetric: the same zero-padded 3×3),
``da0 = α0·g``, ``da3 = α3·g`` and ``g`` itself for ``a_jpeg``. ``alpha``
takes no gradient (the draws are data).

Bound: bytes. At the training shape (64 frames of 256²×3 f32, 50.3 MB a
tensor) the forward reads four tensors and writes one, 251.7 MB, 0.075 ms
at 3.35 TB/s; the backward reads one and writes three, 201.3 MB, 0.060 ms.

Design (``csrc/mix.cu``): one thread per float4 of an image row, which
loads the float4 before, at and after its own in each of the window's
three rows (zero outside the image: the padding) and blurs its four floats
from them; one float per thread where rows are no whole 16-byte words. The
forward is every operation of the plain version below in its order, each
one IEEE rounding (no FMA contraction, an IEEE division by 255), so the two
agree bit for bit; the backward's blur sums the same nine products as
autograd in another order.
"""

import ctypes

import torch

from ..ops.filters import gaussian_blur, gaussian_kernel_2d
from ..ops.quantize import clamp_with_grad, ste_quantize_255
from . import _lib

__all__ = ["attack_mix", "attack_mix_plain", "EPILOGUES", "COUNT"]

COUNT = _lib.LaunchCount("attack_mix")
EPILOGUES = ("none", "clamp", "quantize")  # csrc/mix.cu: Epilogue codes


def _check(x, a0, a_jpeg, a3, alpha, epilogue):
    for name, t in (("x", x), ("a0", a0), ("a_jpeg", a_jpeg), ("a3", a3)):
        _lib.check_nhwc(t, f"attack_mix {name}")
        if t.dtype != torch.float32 or t.shape != x.shape:
            raise ValueError(f"attack_mix {name}: expected float32 "
                             f"{tuple(x.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if x.shape[-1] != 3:
        raise ValueError(f"attack_mix: expected (N, H, W, 3), got "
                         f"{tuple(x.shape)}")
    if (alpha.dtype != torch.float32 or alpha.shape != (x.shape[0], 5)
            or not alpha.is_contiguous()):
        raise ValueError(f"attack_mix alpha: expected contiguous float32 "
                         f"({x.shape[0]}, 5), got {alpha.dtype} "
                         f"{tuple(alpha.shape)}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"attack_mix epilogue {epilogue!r} not in "
                         f"{EPILOGUES}")
    if x.numel() >= 2 ** 31:
        raise ValueError("attack_mix: the kernels index in 32 bits (fewer "
                         "than 2^31 elements a tensor)")


def attack_mix_plain(x, a0, a_jpeg, a3, alpha, epilogue="none"):
    """Plain PyTorch version: ``ops.filters.gaussian_blur``, the mix in the
    order of ``attacks/combined.py``, then the epilogue (autograd through
    all of it)."""
    _check(x, a0, a_jpeg, a3, alpha, epilogue)
    a = [alpha[:, i].view(-1, 1, 1, 1) for i in range(5)]
    out = a[0] * a0 + a_jpeg + a[3] * a3 + a[4] * gaussian_blur(x)
    if epilogue == "none":
        return out
    out = clamp_with_grad(out)
    return ste_quantize_255(out) if epilogue == "quantize" else out


def _taps():
    k = gaussian_kernel_2d(3, 2.0).reshape(-1)
    return (ctypes.c_float * 9)(*(float(v) for v in k))


class _MixKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a0, a_jpeg, a3, alpha, epilogue):
        n, h, w, _ = x.shape
        out = torch.empty_like(x)
        _lib.launch("vwfd_attack_mix_fwd", x.device, x.data_ptr(),
                    a0.data_ptr(), a_jpeg.data_ptr(), a3.data_ptr(),
                    alpha.data_ptr(), out.data_ptr(), _taps(), n, h, w,
                    EPILOGUES.index(epilogue))
        COUNT.n += 1
        ctx.save_for_backward(alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        g = g.contiguous()
        n, h, w, _ = g.shape
        dx, da0, da3 = (torch.empty_like(g) for _ in range(3))
        _lib.launch("vwfd_attack_mix_bwd", g.device, g.data_ptr(),
                    alpha.data_ptr(), dx.data_ptr(), da0.data_ptr(),
                    da3.data_ptr(), _taps(), n, h, w)
        COUNT.n += 1
        return dx, da0, g, da3, None, None


def attack_mix(x, a0, a_jpeg, a3, alpha, epilogue="none"):
    """The pool's mix of (N, H, W, 3) float32 frames with ``alpha`` (N, 5),
    differentiable in ``x``, ``a0``, ``a_jpeg`` and ``a3``: the CUDA kernels
    for CUDA tensors, the plain version for CPU tensors."""
    _check(x, a0, a_jpeg, a3, alpha, epilogue)
    if not _lib.on_cuda(x, a0, a_jpeg, a3, alpha):
        return attack_mix_plain(x, a0, a_jpeg, a3, alpha, epilogue)
    return _MixKernel.apply(x, a0, a_jpeg, a3, alpha, epilogue)
