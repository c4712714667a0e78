"""Per-net optimizer (port of vwfd_tpu/models/state.py:37-64).

``AdamW`` is ``optax.chain(clip_by_global_norm(clip), adamw(lr, b1, b2,
weight_decay))`` with optax's arithmetic: the clip scales by
``(g / ‖g‖)·clip`` only where ‖g‖ ≥ clip, with no ε (``clip_grad_norm_``
adds 1e-6); the moments are ``(1−b)·g + b·m``; the bias corrections divide
by ``1 − b^t``; the update is ``m̂ / (√v̂ + ε) + wd·p``, times −lr. Each net
owns one, so each is clipped on its own (models/video_model.py:241-244).

The state (moments and step count) lives in tensors on the parameters'
device, and ``step`` takes a 0-dim bool ``good``: where it is False every
parameter, moment and the count keep their values (``torch.where``, no host
sync), as the JAX step's non-finite guard does.
"""

from typing import Callable, List, Optional, Sequence, Union

import torch

from ..config import TrainConfig
from .schedules import cosine_restart, multistep_restart, with_warmup

__all__ = ["AdamW", "make_optimizer"]

_EPS = 1e-8  # optax.adamw's eps (eps_root 0)

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class AdamW:
    def __init__(self, params: Sequence[torch.Tensor], lr: Schedule,
                 beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 1e-5, clip: Optional[float] = 1.0):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2 = lr, beta1, beta2
        self.wd, self.clip = weight_decay, clip
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def _lr(self) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(self.count).float()
        return torch.tensor(self.lr, dtype=torch.float32,
                            device=self.count.device)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             good: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (one per parameter, in order)."""
        grads = list(grads)
        if self.clip:
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
            trigger = norm < self.clip
            grads = [torch.where(trigger, g, g / norm * self.clip)
                     for g in grads]
        lr = self._lr()
        count = self.count + 1
        bc1 = 1 - torch.pow(torch.tensor(self.b1, device=count.device),
                            count.float())
        bc2 = 1 - torch.pow(torch.tensor(self.b2, device=count.device),
                            count.float())
        for p, m, v, g in zip(self.params, self.mu, self.nu, grads):
            m_new = (1 - self.b1) * g + self.b1 * m
            v_new = (1 - self.b2) * g ** 2 + self.b2 * v
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + _EPS)
            u = u + self.wd * p
            p_new = p + (-lr) * u
            for dst, new in ((p, p_new), (m, m_new), (v, v_new)):
                dst.copy_(new if good is None else torch.where(good, new, dst))
        self.count.copy_(count if good is None
                         else torch.where(good, count, self.count))


def make_optimizer(params: Sequence[torch.Tensor], tc: TrainConfig
                   ) -> AdamW:
    """``AdamW`` from a ``TrainConfig``, with its LR schedule: constant,
    multistep with restarts or cosine with restarts, each optionally warmed
    up (models/IRNcrop_model.py:263-282 + base_model.py:51-75)."""
    if tc.lr_scheme == "multistep" and tc.lr_milestones:
        lr = multistep_restart(tc.lr, tc.lr_milestones, tc.lr_gamma,
                               tc.lr_restarts or None,
                               tc.lr_restart_weights or None)
    elif tc.lr_scheme == "cosine" and tc.lr_periods:
        lr = cosine_restart(tc.lr, tc.lr_periods, tc.eta_min,
                            tc.lr_restart_weights or None)
    else:
        lr = tc.lr
    lr = with_warmup(lr, tc.warmup_steps)
    return AdamW(params, lr, tc.beta1, tc.beta2, tc.weight_decay,
                 tc.gradient_clipping)
