"""Straight-through quantization primitives (port of vwfd_tpu/ops/quantize.py).

Both are autograd functions whose backward is the identity, the
`stop_gradient` spelling of the JAX package (reference:
models/modules/Quantization.py:4-21 and models/IRNcrop_model.py:320-322).
"""

import torch

__all__ = ["ste_quantize_255", "clamp_with_grad"]


class _SteQuantize255(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x * 255.0) / 255.0

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
