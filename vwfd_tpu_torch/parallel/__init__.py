"""Data parallelism over ``torch.distributed`` (port of
vwfd_tpu/parallel/__init__.py).

The JAX package runs one SPMD program over a ``("data",)`` mesh: the
global batch is sharded on its leading axis, the parameters are replicated
and XLA inserts the all-reduces. The port keeps PyTorch's idiom instead:
one process per card (``torchrun``), NCCL between cards and gloo on the
CPU, and the collectives written out where the JAX program has them
implicitly:

* the gradient all-reduce (``all_reduce_grads``: one flat bucket per net,
  summed, divided by the world size);
* every mean over the global batch (``global_mean`` / ``global_sum``:
  the PSNR's MSE, BatchNorm's moments, the eval counts; ``global_means``:
  a step's loss terms in one all-reduce), differentiable where a gradient
  flows through them.

A step computed this way on each rank's rows equals the one-process step
on the concatenated batch up to float rounding, as the JAX mesh step
equals its one-device step. Every rank holds the global loss, so each
rank's gradients are ``world`` times its share of the global gradient (the
backward of a differentiable all-reduce is an all-reduce): summing them
and dividing by ``world`` gives the global gradient, that of the moments
included.

``Mesh`` is the 1-D ``"data"`` group that the models and the loader take.
A model without one (``mesh=None``) computes exactly what it computes in a
single process; with one, every collective runs, also at world size 1.
Each rank's rows of a global batch are a contiguous block
(``local_batch_slice``), as the JAX package's process-major mesh gives.
Every collective has a finite timeout: a rank that fails or hangs makes
the others raise, and no rank continues alone.
"""

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "DEFAULT_TIMEOUT_S", "local_device",
           "maybe_init_distributed", "is_main_process", "process_index",
           "process_count", "make_mesh", "local_batch_slice", "local_rows",
           "replicate", "replicas_equal", "all_reduce_grads", "global_sum",
           "global_mean", "global_means", "barrier", "world_size_from_env"]

DEFAULT_TIMEOUT_S = 600.0  # a collective that waits longer raises


@dataclass(frozen=True)
class Mesh:
    """The 1-D ``"data"`` process group: ``group`` (None: the default
    group), this process's ``rank`` in it and its ``size``."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int


def world_size_from_env() -> int:
    """``WORLD_SIZE`` as ``torchrun`` sets it (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(device=None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for ``None`` or a bare
    ``"cuda"`` (``LOCAL_RANK`` as ``torchrun`` sets it, 0 when unset), the
    named device otherwise (``"cpu"``, ``"cuda:1"``). Raises without a
    card unless the CPU is named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def maybe_init_distributed(device=None, backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the default process group when ``WORLD_SIZE`` is above 1 (the
    rendezvous from ``torchrun``'s ``RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``): ``backend`` or NCCL for a card, gloo for the CPU,
    every collective bounded by ``timeout_s``. On a card,
    ``torch.cuda.set_device(local_device(device))`` comes first. Returns
    the rank: 0, with nothing done, in a single process."""
    if world_size_from_env() <= 1:
        return 0
    if not dist.is_initialized():
        dev = local_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0: the process that logs, writes checkpoints and montages."""
    return process_index() == 0


def make_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The ``"data"`` mesh over ``group`` (default: every rank). Raises
    when no process group was initialised: a single process takes
    ``mesh=None``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call maybe_init_distributed() "
                           "under torchrun, or pass mesh=None")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group))


def local_batch_slice(global_batch_size: int,
                      mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """This rank's contiguous rows ``[lo, hi)`` of a global batch (the
    JAX package's ``local_batch_slice``): rank r of P owns ``[r·B/P,
    (r+1)·B/P)``. ``mesh`` None: the default group, or every row without
    one. A global batch that does not divide by the world size raises."""
    rank, size = ((mesh.rank, mesh.size) if mesh is not None
                  else (process_index(), process_count()))
    if global_batch_size % size:
        raise ValueError(f"global batch {global_batch_size} does not divide "
                         f"by the world size {size}")
    per = global_batch_size // size
    return rank * per, (rank + 1) * per


def local_rows(x, mesh: Optional[Mesh]):
    """This rank's block of the leading axis of ``x`` (a tensor, an array
    or a NamedTuple of them, e.g. ``AttackDraws``); ``x`` itself without a
    mesh."""
    if mesh is None:
        return x
    if isinstance(x, tuple):  # a NamedTuple of tensors
        return type(x)(*(local_rows(t, mesh) for t in x))
    lo, hi = local_batch_slice(x.shape[0], mesh)
    return x[lo:hi]


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` whose backward is ``all_reduce(SUM)`` of the
    incoming gradient (every rank's loss depends on every rank's
    summand)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` rounded once: a tensor divisor, since PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal (F14)."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the ranks (differentiable); ``x`` itself without
    a mesh."""
    if mesh is None:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, mesh.group)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def global_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean ``x`` (each rank's rows
    are equally many, so this is the mean over the global batch);
    differentiable; ``x`` itself without a mesh. Gloo has no
    ``ReduceOp.AVG``: a sum, then a division by the world size (exact at
    world size 1)."""
    if mesh is None:
        return x
    return _div(global_sum(x, mesh), mesh.size)


class _Global(torch.autograd.Function):
    """The global value ``g`` of a per-rank term ``x``, whose backward hands
    the cotangent to ``x`` unchanged."""

    @staticmethod
    def forward(ctx, x, g):
        return g.clone()

    @staticmethod
    def backward(ctx, c):
        return c, None


def global_means(xs: Sequence[torch.Tensor], mesh: Optional[Mesh]
                 ) -> Tuple[torch.Tensor, ...]:
    """``global_mean`` of a step's 0-dim per-rank loss terms (means over
    equally many rows) through ONE all-reduce of their stacked vector; the
    tensors themselves without a mesh. Every rank computes the loss from
    these global values alike, so each term's cotangent is the same on
    every rank, and the backward of ``global_mean`` (an all-reduce of those
    equal cotangents over ``world`` ranks, divided by ``world``) is that
    cotangent: here it is handed to each term as it is, with no backward
    collective. Each term keeps its own node in the graph, so autograd
    accumulates the gradients in the order it does without a mesh (a
    world-1 step equals the step without a group bit for bit). Not for a
    value whose cotangent differs between ranks (BatchNorm's moments take
    ``global_mean``)."""
    if mesh is None:
        return tuple(xs)
    with torch.no_grad():
        g = global_mean(torch.stack([x.detach() for x in xs]), mesh)
    return tuple(_Global.apply(x, gi) for x, gi in zip(xs, g.unbind()))


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing without a mesh)."""
    if mesh is not None:
        dist.barrier(group=mesh.group)


def _buckets(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


# each gradient's slot in an all-reduce bucket starts on a multiple of this
# many elements (256 bytes in float32), so that a slot is aligned as a fresh
# tensor is
_ALIGN = 64


def _memory_order(t: torch.Tensor) -> List[int]:
    """``t``'s dimensions by decreasing stride: the order its elements lie
    in memory (a convolution's weight gradient may be channels-last)."""
    return sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))


def all_reduce_grads(grads: Sequence[torch.Tensor],
                     mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """One net's gradients summed over the ranks and divided by the world
    size, through one flat bucket per dtype; the list itself without a
    mesh. Each gradient is packed in its memory order into an aligned slot
    (``_ALIGN``) and comes back as a view with its own strides, so what
    reads it after (AdamW's clip norm, a reduction whose order follows the
    strides) sums in the order it does without a mesh: a world-1 step
    equals the step without a group bit for bit."""
    grads = list(grads)
    if mesh is None:
        return grads
    out = list(grads)
    for idx in _buckets(grads).values():
        zeros = grads[idx[0]].new_zeros(_ALIGN)
        parts, offsets, at = [], [], 0
        for i in idx:
            g = grads[i]
            parts.append(g.permute(_memory_order(g)).reshape(-1))
            offsets.append(at)
            pad = -g.numel() % _ALIGN
            if pad:
                parts.append(zeros[:pad])
            at += g.numel() + pad
        flat = torch.cat(parts)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat = _div(flat, mesh.size)
        for i, at in zip(idx, offsets):
            g = grads[i]
            order = _memory_order(g)
            packed = flat[at:at + g.numel()].view([g.shape[d] for d in order])
            out[i] = packed.permute([order.index(d) for d in range(g.dim())])
    return out


def _state_tensors(model) -> List[torch.Tensor]:
    """Every tensor that a train step reads and writes, and every one a
    rank would otherwise hold on its own: each net's parameters and buffers
    (BatchNorm's running statistics, the spectral-norm vectors ``u``), the
    frozen nets' (``model.frozen_nets()`` where the model has it: the image
    family's VGG trunk), then each optimizer's moments and step count."""
    nets = list(model.nets().values())
    if hasattr(model, "frozen_nets"):
        nets += list(model.frozen_nets().values())
    out = [t for net in nets
           for t in list(net.parameters()) + list(net.buffers())]
    for opt in model.optimizers.values():
        out += list(opt.mu) + list(opt.nu) + [opt.count]
    return out


@torch.no_grad()
def replicate(model, mesh: Optional[Mesh]) -> None:
    """Broadcast rank 0's state into every rank's ``model`` in place: each
    net's parameters and buffers, the frozen nets', each optimizer's
    moments and count (``_state_tensors``; one flat bucket per dtype). Call it after ``init_states``, a restore or a
    ``pretrain_path``. Nothing without a mesh."""
    if mesh is None:
        return
    ts = _state_tensors(model)
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None \
        else 0
    for idx in _buckets(ts).values():
        flat = torch.cat([ts[i].reshape(-1) for i in idx])
        dist.broadcast(flat, src=src, group=mesh.group)
        at = 0
        for i in idx:
            n = ts[i].numel()
            ts[i].copy_(flat[at:at + n].view_as(ts[i]))
            at += n


@torch.no_grad()
def replicas_equal(model, mesh: Optional[Mesh]) -> bool:
    """Whether every rank's state (``replicate``'s tensors) is bit-equal
    to rank 0's, the same answer on every rank. True without a mesh."""
    if mesh is None:
        return True
    ts = _state_tensors(model)
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None \
        else 0
    differ = torch.zeros((), dtype=torch.int64, device=ts[0].device)
    for idx in _buckets(ts).values():
        mine = torch.cat([ts[i].reshape(-1) for i in idx])
        ref = mine.clone()
        dist.broadcast(ref, src=src, group=mesh.group)
        differ += (mine.view(torch.uint8) != ref.view(torch.uint8)).sum()
    dist.all_reduce(differ, op=dist.ReduceOp.SUM, group=mesh.group)
    return int(differ) == 0
