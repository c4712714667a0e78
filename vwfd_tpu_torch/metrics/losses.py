"""Training losses (port of vwfd_tpu/metrics/losses.py:19-37).

``absolute`` is |x| with the gradient +1 at 0, as ``jnp.abs`` has
(``torch.abs`` gives 0 there), so that the losses' gradients match the JAX
package's where the argument is exactly 0.
"""

import torch

__all__ = ["absolute", "bce_with_logits", "l1_loss", "l2_loss"]


def absolute(x: torch.Tensor) -> torch.Tensor:
    """|x|, gradient sign(x) with +1 at 0."""
    return torch.where(x >= 0, x, -x)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor
                    ) -> torch.Tensor:
    """nn.BCEWithLogitsLoss, the JAX package's formula
    ``mean(max(x, 0) − x·t + log1p(exp(−|x|)))`` (models/IRNcrop_model.py:
    108, 378-393)."""
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * target
                      + torch.log1p(torch.exp(-absolute(logits))))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(absolute(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``mean((pred − target)²)`` (losses.py:36-37)."""
    return torch.mean((pred - target) ** 2)
