"""Adversarial examples and the victims of the JPEG-vs-adversarial study
(port of vwfd_tpu/adversarial.py).

``fgsm``, ``igsm``, ``jpeg_resistant_fgsm`` and ``igsm_targeted`` take a
differentiable ``loss_fn(image) -> scalar`` and ascend (the targeted one
descends) its gradient's sign, projecting onto the ε-ball around the image
and onto [0, 1] after each step; the JAX package's ``fori_loop`` is a
Python loop of the same steps. ``jpeg_resistant_fgsm`` differentiates the
loss of the DiffJPEG-compressed image (``attacks.diffjpeg``: K24 forward and
backward on every step on a card). ``sign(0) = 0`` in both packages.

``VictimA``/``B``/``C`` are target_models.py's Model_A/B/C as the JAX
package builds them (dropout omitted: the study runs eval-mode forwards).
They take NHWC images like the flax modules, convolve in NCHW and flatten
each feature map in flax's (H, W, C) order before the first Dense layer, so
the converted weights (``convert.victim_from_jax``) need no permutation.
The submodules carry flax's auto-names (``Conv_0``, ``Dense_0``, ...).
"""

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attacks.jpeg import diffjpeg

__all__ = ["fgsm", "igsm", "jpeg_resistant_fgsm", "igsm_targeted",
           "VictimA", "VictimB", "VictimC", "VICTIMS", "cross_entropy_of"]


def _grad(loss_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(loss_fn(x), x)[0]


def _project(x: torch.Tensor, orig: torch.Tensor, epsilon: float
             ) -> torch.Tensor:
    """``clip(clip(x, orig − ε, orig + ε), 0, 1)`` (``jnp.clip``: max, then
    min)."""
    x = torch.minimum(torch.maximum(x, orig - epsilon), orig + epsilon)
    return torch.clamp(x, 0.0, 1.0)


def fgsm(loss_fn: Callable, image: torch.Tensor, epsilon: float = 0.03
         ) -> torch.Tensor:
    """Fast Gradient Sign Method (AE_methods/fgsm.py)."""
    g = _grad(loss_fn, image)
    return torch.clamp(image + epsilon * torch.sign(g), 0.0, 1.0)


def igsm_step(loss_fn: Callable, x: torch.Tensor, orig: torch.Tensor,
              epsilon: float, step_size: float, descend: bool = False
              ) -> torch.Tensor:
    """One step of ``igsm`` (``descend``: of ``igsm_targeted``) from the
    iterate ``x``."""
    s = step_size * torch.sign(_grad(loss_fn, x))
    return _project(x - s if descend else x + s, orig, epsilon)


def igsm(loss_fn: Callable, image: torch.Tensor, epsilon: float = 0.03,
         step_size: float = 0.005, steps: int = 10) -> torch.Tensor:
    """Iterative FGSM / BIM with an ε-ball projection (jpegadv/attack.py)."""
    x = image
    for _ in range(steps):
        x = igsm_step(loss_fn, x, image, epsilon, step_size)
    return x


def jpeg_resistant_fgsm(loss_fn: Callable, image: torch.Tensor,
                        epsilon: float = 0.03, step_size: float = 0.005,
                        steps: int = 10, quality: int = 75, kernels=None
                        ) -> torch.Tensor:
    """JPEG-resistant iterative attack (resistAE.py:20-80): each step
    ascends the loss of ``diffjpeg(x, quality)`` (``kernels``' K24, default
    ``kernels.KERNELS``), so that the perturbation survives compression."""
    def through_jpeg(x):
        return loss_fn(diffjpeg(x, quality, kernels=kernels))

    x = image
    for _ in range(steps):
        x = igsm_step(through_jpeg, x, image, epsilon, step_size)
    return x


def igsm_targeted(loss_fn: Callable, image: torch.Tensor,
                  epsilon: float = 0.03, step_size: float = 0.005,
                  steps: int = 10) -> torch.Tensor:
    """Targeted IGSM (jpegadv/targeted_compress.py ``my_IGSM_T``): DESCEND
    the target class's loss."""
    x = image
    for _ in range(steps):
        x = igsm_step(loss_fn, x, image, epsilon, step_size, descend=True)
    return x


def cross_entropy_of(model: nn.Module, label: int) -> Callable:
    """The study's loss: the mean softmax cross-entropy of ``model``'s logits
    of an image (H, W, 3) or a batch against ``label``
    (``optax.softmax_cross_entropy_with_integer_labels``)."""
    def loss(x):
        lg = model(x[None] if x.dim() == 3 else x)
        target = torch.full((lg.shape[0],), label, dtype=torch.int64,
                            device=lg.device)
        return F.cross_entropy(lg, target)
    return loss


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW map flattened in flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class VictimA(nn.Module):
    """Model_A: 5×5/s2 conv → 5×5 conv → FC128 → FC (VALID padding)."""

    def __init__(self, num_classes: int = 10, size: int = 32):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 5, stride=2)
        self.Conv_1 = nn.Conv2d(64, 64, 5)
        s = (size - 5) // 2 + 1 - 4
        self.Dense_0 = nn.Linear(64 * s * s, 128)
        self.Dense_1 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        return self.Dense_1(F.relu(self.Dense_0(_flatten_hwc(x))))


class VictimB(nn.Module):
    """Model_B: 8×8 → 6×6 → 5×5 convs → FC (VALID padding)."""

    def __init__(self, num_classes: int = 10, size: int = 32):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 8)
        self.Conv_1 = nn.Conv2d(64, 128, 6)
        self.Conv_2 = nn.Conv2d(128, 128, 5)
        s = size - 7 - 5 - 4
        self.Dense_0 = nn.Linear(128 * s * s, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(conv(x))
        return self.Dense_0(_flatten_hwc(x))


class VictimC(nn.Module):
    """Model_C: VGG-style 2×(conv, conv, 2×2 max-pool) → FC200 → FC."""

    def __init__(self, num_classes: int = 10, size: int = 32):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 32, 3, padding=1)
        self.Conv_2 = nn.Conv2d(32, 64, 3, padding=1)
        self.Conv_3 = nn.Conv2d(64, 64, 3, padding=1)
        s = size // 4
        self.Dense_0 = nn.Linear(64 * s * s, 200)
        self.Dense_1 = nn.Linear(200, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        x = F.max_pool2d(x, 2)
        x = F.relu(self.Conv_3(F.relu(self.Conv_2(x))))
        x = F.max_pool2d(x, 2)
        return self.Dense_1(F.relu(self.Dense_0(_flatten_hwc(x))))


VICTIMS = {"A": VictimA, "B": VictimB, "C": VictimC}
