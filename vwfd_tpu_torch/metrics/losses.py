"""Training losses (port of vwfd_tpu/metrics/losses.py:13-37).

``absolute`` is |x| with the gradient +1 at 0, as ``jnp.abs`` has
(``torch.abs`` gives 0 there), so that the losses' gradients match the JAX
package's where the argument is exactly 0.
"""

import torch

__all__ = ["absolute", "bce_loss", "bce_with_logits", "l1_loss", "l2_loss"]


def absolute(x: torch.Tensor) -> torch.Tensor:
    """|x|, gradient sign(x) with +1 at 0."""
    return torch.where(x >= 0, x, -x)


def bce_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7
             ) -> torch.Tensor:
    """nn.BCELoss on probabilities (losses.py:13-16): ``p = clip(pred, eps,
    1 − eps)`` as ``jnp.clip`` (in the prediction's dtype: 1 − 1e-7 is
    0.99999988 in float32; gradient ½ at either end), then
    ``−mean(t·log p + (1 − t)·log(1 − p))``."""
    p = torch.minimum(torch.maximum(pred, pred.new_tensor(eps)),
                      pred.new_tensor(1.0 - eps))
    return -torch.mean(target * torch.log(p)
                       + (1.0 - target) * torch.log(1.0 - p))


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
