"""Quantization / rounding primitives (port of vwfd_tpu/ops/quantize.py).

``ste_quantize_255`` and ``clamp_with_grad`` are autograd functions whose
backward is the identity, the `stop_gradient` spelling of the JAX package
(reference: models/modules/Quantization.py:4-21 and
models/IRNcrop_model.py:320-322). ``diff_round`` and ``round_only_at_0``
are plain tensor code: ``torch.round`` carries a zero gradient, as
``jnp.round`` does, so autograd gives the reference's gradients.
"""

import torch

__all__ = ["ste_quantize_255", "clamp_with_grad", "diff_round",
           "round_only_at_0", "jpeg_scale_factor"]


class _SteQuantize255(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, one ulp off x / 255 for 126 of the
        # 256 levels (F14); the JAX package and K9/K10 divide
        return torch.round(x * 255.0) / torch.full((), 255.0, dtype=x.dtype,
                                                     device=x.device)

    @staticmethod
    def backward(ctx, g):
        return g


class _ClampWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ste_quantize_255(x: torch.Tensor) -> torch.Tensor:
    """8-bit straight-through quantizer: fwd `round(x·255)/255` (half to
    even, as `jnp.round`), bwd identity."""
    return _SteQuantize255.apply(x)


def clamp_with_grad(x: torch.Tensor, lo: float = 0.0, hi: float = 1.0
                    ) -> torch.Tensor:
    """Clamp in the forward pass, identity gradient in the backward pass."""
    return _ClampWithGrad.apply(x, lo, hi)


def diff_round(x: torch.Tensor) -> torch.Tensor:
    """`round(x) + (x − round(x))³`: gradient 3(x − round(x))²
    (utils/JPEG.py:472-479)."""
    r = torch.round(x)
    return r + (x - r) ** 3


def round_only_at_0(x: torch.Tensor) -> torch.Tensor:
    """`x³` where |x| < 0.5, else `x` (utils/JPEG.py:482-484; jpeg.py:255-257
    round_ss)."""
    return torch.where(x.abs() < 0.5, x ** 3, x)


def jpeg_scale_factor(quality):
    """Standard JPEG table scale: Q ≥ 50 → 2 − 0.02·Q, else 50/Q
    (noise_layers/jpeg.py:221). A float for a number, elementwise for a
    float32 tensor of qualities."""
    if isinstance(quality, torch.Tensor):
        return torch.where(quality >= 50, 2.0 - quality * 0.02, 50.0 / quality)
    return 2.0 - quality * 0.02 if quality >= 50 else 50.0 / quality
