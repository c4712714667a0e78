"""Training losses (port of vwfd_tpu/metrics/losses.py:13-37).

``absolute`` is |x| with the gradient +1 at 0, as ``jnp.abs`` has
(``torch.abs`` gives 0 there), so that the losses' gradients match the JAX
package's where the argument is exactly 0.

``gan_loss`` and ``adversarial_loss`` (``losses.py:77-111``) are the
reference's GAN criteria (models/modules/loss.py:41-109); the image
family's ``with_gan`` option takes the nsgan form.
"""

import torch

__all__ = ["absolute", "bce_loss", "bce_with_logits", "l1_loss", "l2_loss",
           "gan_loss", "adversarial_loss"]


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


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             gan_type: str = "gan") -> torch.Tensor:
    """``GANLoss`` (loss.py:77-109): gan / ragan (BCE with logits), lsgan
    (L2), wgan-gp (∓ mean)."""
    if gan_type in ("gan", "ragan", "lsgan"):
        t = torch.ones_like(logits) if target_is_real \
            else torch.zeros_like(logits)
        return (bce_with_logits(logits, t) if gan_type != "lsgan"
                else l2_loss(logits, t))
    if gan_type == "wgan-gp":
        return -torch.mean(logits) if target_is_real else torch.mean(logits)
    raise ValueError(gan_type)


def adversarial_loss(outputs: torch.Tensor, is_real: bool,
                     is_disc: bool = False, loss_type: str = "nsgan",
                     mask=None) -> torch.Tensor:
    """``AdversarialLoss`` (loss.py:41-88): nsgan (BCE on probabilities),
    lsgan (L2) or hinge; ``mask`` (N, H, W, 1) weights the fake labels by
    ``1 − mask`` resized bilinearly to the outputs."""
    if loss_type == "hinge":
        if is_disc:
            o = -outputs if is_real else outputs
            return torch.mean(torch.relu(1 + o))
        return torch.mean(-outputs)
    labels = torch.ones_like(outputs)
    if not is_real:
        if mask is None:
            labels = torch.zeros_like(outputs)
        else:
            from ..ops.resize import resize_bilinear
            m = resize_bilinear(mask, tuple(outputs.shape[-3:-1]))
            labels = labels * (1.0 - m)
    if loss_type == "nsgan":
        return bce_loss(outputs, labels)
    if loss_type == "lsgan":
        return l2_loss(outputs, labels)
    raise ValueError(loss_type)
