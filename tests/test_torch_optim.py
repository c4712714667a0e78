"""Parity of the port's optimizer (``models/state.py``) and LR schedules
(``models/schedules.py``) with optax and the JAX package's schedules.

Tolerance 1e-6 absolute on parameters and moments after three steps
(float32; the update is the same chain of operations, only summation order
in the global norm differs) and 1e-7 relative on learning rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vwfd_tpu.models import schedules as jsch
from vwfd_tpu.models import state as jstate
from vwfd_tpu_torch.config import TrainConfig
from vwfd_tpu_torch.models import schedules
from vwfd_tpu_torch.models.state import AdamW, make_optimizer

_SHAPES = [(4, 3, 3, 3), (16,), (7, 5)]


def _params_and_grads(seed, scale):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in _SHAPES]
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32)
              for s in _SHAPES] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("scale,clipped", [(0.05, False), (3.0, True)])
def test_adamw_matches_optax_over_three_steps(scale, clipped):
    """``optax.chain(clip_by_global_norm(1), adamw(1e-3, ...))`` and the
    port's AdamW from the same params and gradients, with the clip
    inactive (‖g‖ < 1) and active (‖g‖ ≫ 1)."""
    params, grads = _params_and_grads(0, scale)
    norms = [np.sqrt(sum(float((g ** 2).sum()) for g in gs)) for gs in grads]
    assert all((n > 1.0) == clipped for n in norms)
    tx = jstate.adamw_chain(1e-3, 0.9, 0.999, 1e-2, 1.0)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = AdamW(tp, 1e-3, 0.9, 0.999, 1e-2, 1.0)
    for gs in grads:
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g) for g in gs])
    adam = st[1][0]
    for ours, ref in zip(tp + opt.mu + opt.nu,
                         list(jp) + list(adam.mu) + list(adam.nu)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    assert int(opt.count) == int(adam.count) == 3


def test_adamw_guard_keeps_every_tensor():
    """``good`` False: parameters, moments and the count keep their values
    (the train step's non-finite guard)."""
    params, grads = _params_and_grads(1, 0.1)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = AdamW(tp, 1e-3)
    opt.step([torch.from_numpy(g) for g in grads[0]])
    before = [t.clone() for t in tp + opt.mu + opt.nu + [opt.count]]
    bad = [torch.full_like(t, float("nan")) for t in tp]
    opt.step(bad, good=torch.tensor(False))
    after = tp + opt.mu + opt.nu + [opt.count]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    opt.step([torch.from_numpy(g) for g in grads[1]], good=torch.tensor(True))
    assert int(opt.count) == 2 and not torch.equal(tp[0], before[0])


_SCHEDULES = [
    ("multistep", lambda m: m.multistep_restart(1e-3, (3, 6), 0.5, (8,),
                                                (0.5,))),
    ("cosine", lambda m: m.cosine_restart(1e-3, (5, 7), 1e-5, (1.0, 0.5))),
    ("warmup", lambda m: m.with_warmup(m.cosine_restart(1e-3, (12,)), 4)),
    ("constant_warmup", lambda m: m.with_warmup(2e-4, 3)),
]


@pytest.mark.parametrize("name,make", _SCHEDULES)
def test_schedules_match_jax(name, make):
    ours, ref = make(schedules), make(jsch)
    for step in range(14):
        got = float(ours(torch.tensor(step)))
        want = float(ref(jnp.asarray(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} step {step}")


def test_make_optimizer_follows_config():
    """A warmed-up multistep config: three steps of the port's optimizer
    equal ``vwfd_tpu.models.state.make_optimizer`` of the same config."""
    kw = dict(lr=1e-3, lr_scheme="multistep", lr_milestones=(1, 2),
              lr_gamma=0.5, warmup_steps=2, weight_decay=1e-3)
    from vwfd_tpu.config import TrainConfig as JTrainConfig
    params, grads = _params_and_grads(2, 0.3)
    tx = jstate.make_optimizer(JTrainConfig(**kw))
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = make_optimizer(tp, TrainConfig(**kw))
    for gs in grads:
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g) for g in gs])
    for ours, ref in zip(tp, jp):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    jax.block_until_ready(jp)
