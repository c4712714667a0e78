"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

* K1 ``transition``      — packed INN Haar/packing maps (kernels/transition.py)
* K2 ``coupling_head``   — coupling head GEMM + bias + RealNVP affine (kernels/coupling.py)
* K3 ``wire``            — uint8 wire format + relayouts (kernels/wire.py)
* K4 ``mask_pack``       — detect epilogue, bits + tamper fraction (kernels/mask.py)

Each wrapper launches its kernel for CUDA tensors and takes its plain version
only for CPU tensors. ``KERNELS`` routes through the wrappers; ``PLAIN``
calls the plain versions on any device, so that a caller (the chip smoke
script, a test) can run the same model through both and compare.
"""

from typing import Callable, Dict, NamedTuple

from . import coupling, mask, transition, wire

__all__ = ["KernelSet", "KERNELS", "PLAIN", "launch_counts",
           "reset_launch_counts", "MODULES"]

MODULES = (transition, coupling, wire, mask)


class KernelSet(NamedTuple):
    transition: Callable
    coupling_head: Callable
    wire_to_channels: Callable
    wire_to_u8: Callable
    wire_to_s2d: Callable
    wire_to_u8_s2d: Callable
    mask_pack: Callable


KERNELS = KernelSet(transition.transition, coupling.coupling_head,
                    wire.to_channels, wire.to_u8, wire.to_s2d, wire.to_u8_s2d,
                    mask.mask_pack)
PLAIN = KernelSet(transition.transition_plain, coupling.coupling_head_plain,
                  wire.to_channels_plain, wire.to_u8_plain, wire.to_s2d_plain,
                  wire.to_u8_s2d_plain, mask.mask_pack_plain)


def launch_counts() -> Dict[str, int]:
    return {m.COUNT.name: m.COUNT.n for m in MODULES}


def reset_launch_counts() -> None:
    for m in MODULES:
        m.COUNT.n = 0
