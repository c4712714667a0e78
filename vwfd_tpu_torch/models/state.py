"""Per-net optimizer and checkpoints (port of vwfd_tpu/models/state.py).

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

Checkpoints (``save_checkpoint`` / ``restore_checkpoint`` / ``latest_step``,
``state.py:116-147``) are torch-native: one directory per step, named by
the step's digits, holding every net's parameters and buffers (the
BatchNorm running statistics) and each net's AdamW moments and step count,
so a restored model continues bit for bit. Reading the JAX package's orbax
checkpoints needs orbax, which the port does not import.
"""

import os
import shutil
from typing import Callable, List, Optional, Sequence, Union

import torch

from ..config import TrainConfig
from .schedules import cosine_restart, multistep_restart, with_warmup

__all__ = ["AdamW", "make_optimizer", "save_checkpoint",
           "restore_checkpoint", "latest_step", "CKPT_FILE"]

_EPS = 1e-8  # optax.adamw's eps (eps_root 0)
CKPT_FILE = "state.pt"  # the file in each step's directory

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


def save_checkpoint(ckpt_dir: str, step: int, model) -> str:
    """Write ``model``'s state (a ``VideoWatermarkModel``: its nets'
    state dicts and its optimizers' ``mu``, ``nu`` and ``count``) to
    ``ckpt_dir/<step>/``, replacing a checkpoint of the same step. The
    directory appears whole or not at all. Returns its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, str(step)))
    payload = {
        "step": int(step),
        "nets": {name: {k: v.detach().cpu()
                        for k, v in net.state_dict().items()}
                 for name, net in model.nets().items()},
        "optimizers": {name: {"mu": [t.cpu() for t in opt.mu],
                              "nu": [t.cpu() for t in opt.nu],
                              "count": opt.count.cpu()}
                       for name, opt in model.optimizers.items()},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    torch.save(payload, os.path.join(tmp, CKPT_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, step: int, model) -> None:
    """Load ``ckpt_dir/<step>/`` into ``model`` in place: parameters,
    buffers and optimizer state, each of the same shape as the model's
    (raises otherwise)."""
    payload = torch.load(os.path.join(ckpt_dir, str(step), CKPT_FILE),
                         map_location="cpu", weights_only=True)
    model.load_states(payload["nets"])
    with torch.no_grad():
        for name, opt in model.optimizers.items():
            saved = payload["optimizers"][name]
            for key in ("mu", "nu"):
                dst, src = getattr(opt, key), saved[key]
                if [t.shape for t in dst] != [t.shape for t in src]:
                    raise ValueError(f"checkpoint {step}: {name}.{key} "
                                     f"does not fit the model")
                for d, s in zip(dst, src):
                    d.copy_(s)
            opt.count.copy_(saved["count"])


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step with a checkpoint directory in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return max(steps) if steps else None
