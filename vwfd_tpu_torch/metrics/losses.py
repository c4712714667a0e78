"""Training losses (port of vwfd_tpu/metrics/losses.py).

``absolute`` is |x| with the gradient +1 at 0, as ``jnp.abs`` has
(``torch.abs`` gives 0 there), so that the losses' gradients match the JAX
package's where the argument is exactly 0.

``gan_loss`` and ``adversarial_loss`` (``losses.py:77-111``) are the
reference's GAN criteria (models/modules/loss.py:41-109); the image
family's ``with_gan`` option takes the nsgan form.

The rest of the library (``losses.py:26-61,113-206``): ``smooth_l1``,
``reconstruction_loss``, ``ssim_loss_map``, ``gradient_penalty`` (per-sample
input gradients with ``create_graph=True``; the interpolation's ε an
explicit (B, 1, …) tensor), ``exclusion_loss``, ``gradient_loss``,
``grayscale_loss``, ``extended_l1_loss``, ``non_blurry_loss``, ``std_loss``,
``dice_loss`` and ``cw_loss``, each the JAX function's ops in its order;
clips take JAX's tie gradient (½ at a bound, ``torch.minimum`` /
``torch.maximum``), absolute values ``absolute``'s.
"""

from typing import Callable

import torch

from ..ops.filters import avg_pool_2x2
from ..ops.quantize import clip_ties_half

__all__ = ["absolute", "bce_loss", "bce_with_logits", "l1_loss", "l2_loss",
           "gan_loss", "adversarial_loss", "smooth_l1",
           "reconstruction_loss", "ssim_loss_map", "gradient_penalty",
           "exclusion_loss", "gradient_loss", "grayscale_loss",
           "extended_l1_loss", "non_blurry_loss", "std_loss", "dice_loss",
           "cw_loss"]


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


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0
              ) -> torch.Tensor:
    """nn.SmoothL1Loss (models/IRNcrop_model.py:107)."""
    d = absolute(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d ** 2 / beta,
                                  d - 0.5 * beta))


def reconstruction_loss(x: torch.Tensor, target: torch.Tensor,
                        losstype: str = "l_char", eps: float = 1e-6
                        ) -> torch.Tensor:
    """``ReconstructionLoss`` (models/modules/loss.py:5-22): the per-sample
    sum over every axis but the first, then the batch mean; ``"l2"``,
    ``"l_char"`` (√(d² + ε)) or ``"l1"`` (|d|, as the JAX package: the
    reference's signed sum is a bug it does not copy)."""
    axes = tuple(range(1, x.dim()))
    d = x - target
    if losstype == "l2":
        return torch.mean(torch.sum(d ** 2, axes))
    if losstype == "l_char":
        return torch.mean(torch.sum(torch.sqrt(d * d + eps), axes))
    if losstype == "l1":
        return torch.mean(torch.sum(absolute(d), axes))
    raise ValueError(f"reconstruction loss type {losstype!r}")


def _box(z: torch.Tensor, k: int) -> torch.Tensor:
    """The valid k×k mean of (..., H, W, C): the k² shifted views times
    1/k² (float32), summed in raster order from zero (the JAX package's
    zero-padded depthwise conv, cropped)."""
    w = float(torch.tensor(1.0 / (k * k), dtype=torch.float32))
    h, wd = z.shape[-3] - k + 1, z.shape[-2] - k + 1
    out = torch.zeros(z.shape[:-3] + (h, wd, z.shape[-1]), dtype=z.dtype,
                      device=z.device)
    for dy in range(k):
        for dx in range(k):
            out = out + w * z[..., dy:dy + h, dx:dx + wd, :]
    return out


def _reflect1(z: torch.Tensor) -> torch.Tensor:
    z = torch.cat([z[..., 1:2, :, :], z, z[..., -2:-1, :, :]], -3)
    return torch.cat([z[..., 1:2, :], z, z[..., -2:-1, :]], -2)


def ssim_loss_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``SSIM_Loss`` (loss.py:9-39): 3×3 mean SSIM under reflect padding,
    the per-pixel map ``clip((1 − SSIM)/2, 0, 1)``."""
    def pool3(z):
        return _box(_reflect1(z), 3)

    mu_x, mu_y = pool3(x), pool3(y)
    sigma_x = pool3(x ** 2) - mu_x ** 2
    sigma_y = pool3(y ** 2) - mu_y ** 2
    sigma_xy = pool3(x * y) - mu_x * mu_y
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return clip_ties_half((1 - n / d) / 2, 0.0, 1.0)


def gradient_penalty(disc_fn: Callable, eps: torch.Tensor,
                     real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """WGAN-GP (models/modules/loss.py:112-131 ``GradientPenaltyLoss``):
    ``E[(‖∇ₓ D(x̂)‖₂ − 1)²]`` at ``x̂ = ε·real + (1 − ε)·fake``, ``eps`` the
    explicit (B, 1, …) uniforms. Each sample's gradient is of
    ``sum(D(x̂ᵢ[None]))`` alone (the JAX function's ``vmap`` of a
    one-sample ``grad``), with ``create_graph=True`` so that the penalty
    is differentiable in D's weights."""
    interp = eps * real + (1 - eps) * fake
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    total = sum(torch.sum(disc_fn(interp[i:i + 1]))
                for i in range(interp.shape[0]))
    grads = torch.autograd.grad(total, interp, create_graph=True)[0]
    norms = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2, -1)
                       + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def exclusion_loss(img1: torch.Tensor, img2: torch.Tensor, level: int = 3
                   ) -> torch.Tensor:
    """Gradient-decorrelation loss (loss.py:309-360), NHWC."""
    gradx_loss, grady_loss = [], []
    for _ in range(level):
        gx1 = img1[..., 1:, :, :] - img1[..., :-1, :, :]
        gy1 = img1[..., :, 1:, :] - img1[..., :, :-1, :]
        gx2 = img2[..., 1:, :, :] - img2[..., :-1, :, :]
        gy2 = img2[..., :, 1:, :] - img2[..., :, :-1, :]
        sx1 = torch.sigmoid(gx1) * 2 - 1
        sy1 = torch.sigmoid(gy1) * 2 - 1
        sx2 = torch.sigmoid(gx2) * 2 - 1
        sy2 = torch.sigmoid(gy2) * 2 - 1
        c1, c2 = img1.shape[-1], img2.shape[-1]
        for i in range(c2):
            for j in range(c1):
                gradx_loss.append(torch.mean(
                    (sx1[..., j] ** 2) * (sx2[..., i] ** 2)) ** 0.25)
                grady_loss.append(torch.mean(
                    (sy1[..., j] ** 2) * (sy2[..., i] ** 2)) ** 0.25)
        img1 = avg_pool_2x2(img1)
        img2 = avg_pool_2x2(img2)
    n = level * 9
    return (sum(gradx_loss) / n + sum(grady_loss) / n) / 2.0


def gradient_loss(a: torch.Tensor) -> torch.Tensor:
    """L1 of the spatial gradients (loss.py:413-424)."""
    gx = absolute(a[..., :, :-1, :] - a[..., :, 1:, :])
    gy = absolute(a[..., :-1, :, :] - a[..., 1:, :, :])
    return torch.mean(gx) + torch.mean(gy)


def _gray(x: torch.Tensor) -> torch.Tensor:
    g = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return x @ g


def grayscale_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MSE of the grayscale projections (loss.py:391-401)."""
    return l2_loss(_gray(x), _gray(y))


def extended_l1_loss(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """Mask-normalised L1 (loss.py:363-376)."""
    normalizer = torch.mean(absolute(mask))
    return l1_loss(mask * a, mask * b) / (normalizer + 1e-12)


def non_blurry_loss(x: torch.Tensor) -> torch.Tensor:
    """1 − MSE(x, 0.5) (loss.py:379-388)."""
    return 1.0 - l2_loss(x, torch.full_like(x, 0.5))


def std_loss(x: torch.Tensor) -> torch.Tensor:
    """MSE between the centre tap and the 5×5 box blur of the grayscale
    image, inside the border (loss.py:286-306)."""
    g = _gray(x)[..., None]
    return l2_loss(g[..., 2:-2, 2:-2, :], _box(g, 5))


def dice_loss(pred: torch.Tensor, target: torch.Tensor, smooth: float = 1.0,
              p: float = 2.0) -> torch.Tensor:
    """BinaryDiceLoss (dice_loss.py:24-55)."""
    b = pred.shape[0]
    pf = pred.reshape(b, -1)
    tf = target.reshape(b, -1)
    num = 2 * torch.sum(pf * tf, 1) + smooth
    den = torch.sum(pf ** p + tf ** p, 1) + smooth
    return torch.mean(1 - num / den)


def cw_loss(logits: torch.Tensor, target: torch.Tensor, is_targeted: bool,
            num_classes: int = 1000, kappa: float = 0.0) -> torch.Tensor:
    """Carlini-Wagner margin loss (models/modules/loss.py:24-42)."""
    one_hot = torch.nn.functional.one_hot(
        target.to(torch.int64), num_classes).to(logits.dtype)
    real = torch.sum(one_hot * logits, 1)
    other = torch.amax((1 - one_hot) * logits - one_hot * 10000.0, 1)
    margin = other - real if is_targeted else real - other
    return torch.sum(torch.maximum(margin, margin.new_tensor(kappa)))
