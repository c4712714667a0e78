"""K1 `transition`: the packed INN's fixed orthogonal transitions.

Replaces ``vwfd_tpu/nets/inn_packed.py``'s ``_entry_kernel`` /
``_p2p_kernel`` / ``_p2u_kernel`` (:75-119) evaluated as fixed-weight
convolutions by ``_fixed_conv`` / ``_fixed_conv_t`` (:122-133, :236-257).
Three kinds, each with its exact transpose (the maps are orthogonal, so the
transpose is the inverse):

* ``entry``: 4×4/s4, unpacked (H,W,C) → packed (H/4,W/4,16C);
* ``p2p``: 2×2/s2, packed (r,r,4C) → packed (r/2,r/2,16C);
* ``p2u``: 1×1, packed (r,r,4C) → unpacked (r,r,4C).

Bound: bytes. Every output is a ±0.5 sum of four gathered inputs (about 8
operations per output), so the least time is the input read once plus the
output written once over the card's memory rate: at the flagship serving
shapes (batch 16, 256², bf16) 25.2 MB in and 25.2 MB out, about 15 µs at
3.35 TB/s (H100 SXM data sheet, 700 W).

Design (``csrc/transition.cu``): a tiled Walsh–Hadamard butterfly, not a
conv. One thread per (position on the packed side, channel c) reads its 16
inputs (4 for p2u) once, computes the bands with 4-point butterflies
(a±b)±(c±d) in f32 with one rounding per output, and writes its 16 outputs,
adjacent under the c-major order, as 16-byte stores. entry's 12-channel
unpacked side is staged through shared memory with 16-byte copies. p2u is
its own transpose (½·S is symmetric and orthogonal). The flagship's channel
counts are template parameters; other widths take a runtime-C path. The
plain version below is the JAX package's own spelling: ``F.conv2d`` /
``F.conv_transpose2d`` with the dense fixed kernel built in numpy.

Under autograd each map is linear and K1 computes its exact transpose, so
the backward of a launch is K1 itself with ``transpose`` flipped
(``_TransitionFn``). A train step launches the six maps forward and five
backward: the entry map's input, the clip, takes no gradient.
"""

import torch
import torch.nn.functional as F

from . import _lib

__all__ = ["transition", "transition_plain", "out_shape", "KINDS", "COUNT"]

KINDS = ("entry", "p2p", "p2u")
COUNT = _lib.LaunchCount("transition")
# kind → (spatial stride, output channels per input channel of the forward
# map, channel multiple the forward input must have)
_GEOMETRY = {"entry": (4, 16, 1), "p2p": (2, 4, 4), "p2u": (1, 1, 4)}
_STRIDE = {k: g[0] for k, g in _GEOMETRY.items()}


def out_shape(shape, kind: str, transpose: bool = False):
    """Output shape of one transition on an NHWC input ``shape``."""
    if kind not in _GEOMETRY:
        raise ValueError(f"unknown transition kind {kind!r}")
    n, h, w, c = shape
    s, grow, _ = _GEOMETRY[kind]
    if transpose:
        return (n, h * s, w * s, c // grow)
    return (n, h // s, w // s, c * grow)


def _check(x: torch.Tensor, kind: str, transpose: bool) -> None:
    _lib.check_nhwc(x, "transition input")
    _lib.dtype_code(x)
    if kind not in _GEOMETRY:
        raise ValueError(f"unknown transition kind {kind!r}")
    _, h, w, c = x.shape
    s, grow, mult = _GEOMETRY[kind]
    fits = (c % (grow * mult) == 0 if transpose
            else c % mult == 0 and h % s == 0 and w % s == 0)
    if not fits:
        raise ValueError(f"{kind}{'ᵀ' if transpose else ''}: shape "
                         f"{tuple(x.shape)} does not fit the map")


def _fixed_weight(kind: str, x: torch.Tensor, transpose: bool
                  ) -> torch.Tensor:
    """The dense fixed kernel of the forward map, OIHW, on x's device."""
    from ..nets import inn_packed
    _, grow, mult = _GEOMETRY[kind]
    level = x.shape[-1] // (mult * grow if transpose else mult)
    build = {"entry": inn_packed._entry_kernel, "p2p": inn_packed._p2p_kernel,
             "p2u": inn_packed._p2u_kernel}[kind]
    w = build(level, False)
    return torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(
        device=x.device, dtype=x.dtype)


def transition_plain(x: torch.Tensor, kind: str, transpose: bool = False
                     ) -> torch.Tensor:
    """Plain PyTorch version: the fixed map as a (transposed) convolution."""
    _check(x, kind, transpose)
    w = _fixed_weight(kind, x, transpose)
    s = _STRIDE[kind]
    xc = x.permute(0, 3, 1, 2)
    y = (F.conv_transpose2d(xc, w, stride=s) if transpose
         else F.conv2d(xc, w, stride=s))
    return y.permute(0, 2, 3, 1).contiguous()


def _launch(x: torch.Tensor, kind: str, transpose: bool) -> torch.Tensor:
    _check(x, kind, transpose)
    _lib.check_aligned(x, "transition input")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"transition: {x.numel()} elements; the kernel "
                         f"indexes in 32 bits (fewer than 2^31)")
    y = torch.empty(out_shape(x.shape, kind, transpose), device=x.device,
                    dtype=x.dtype)
    _lib.launch("vwfd_transition", x.device, x.data_ptr(), y.data_ptr(),
                KINDS.index(kind), int(transpose), _lib.dtype_code(x),
                x.shape[0], *x.shape[1:], *y.shape[1:])
    COUNT.n += 1
    return y


class _TransitionFn(torch.autograd.Function):
    """K1 under autograd: the backward is the flipped map, also K1."""

    @staticmethod
    def forward(ctx, x, kind, transpose):
        ctx.kind, ctx.transpose = kind, transpose
        return _launch(x, kind, transpose)

    @staticmethod
    def backward(ctx, g):
        return _launch(g.contiguous(), ctx.kind, not ctx.transpose), None, \
            None


def transition(x: torch.Tensor, kind: str, transpose: bool = False
               ) -> torch.Tensor:
    """One transition (or its transpose) on an NHWC f32/bf16 tensor,
    differentiable: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    _check(x, kind, transpose)
    if not _lib.on_cuda(x):
        return transition_plain(x, kind, transpose)
    return _TransitionFn.apply(x, kind, transpose)
