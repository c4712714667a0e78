"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

* K1 ``transition``      — packed INN Haar/packing maps (kernels/transition.py)
* K2 ``coupling_head``   — coupling head GEMM + bias + RealNVP affine (kernels/coupling.py)
* K3 ``wire``            — uint8 wire format + relayouts (kernels/wire.py)
* K4 ``mask_pack``       — detect epilogue, bits + tamper fraction (kernels/mask.py)
* K5 ``jpeg_pair``       — the attack pool's two fused JPEG draws, forward
  and backward (kernels/jpeg.py)
* K6 ``median3``         — 3×3 median filter, forward and first-match
  backward (kernels/median.py)
* K7 ``f1_sweep``        — the eval step's confusion counts at every F1
  threshold, in one read (kernels/f1.py)
* K8 ``ssim``            — windowed SSIM reduced to per-image means and the
  mean (kernels/ssim.py)

Each wrapper launches its kernel for CUDA tensors and takes its plain version
only for CPU tensors. Under autograd K1 and K2 are ``torch.autograd.Function``s
(K1's backward is K1 with ``transpose`` flipped); K5 and K6 launch their own
backward kernels. ``KERNELS`` routes through the wrappers; ``PLAIN`` calls
the plain versions on any device, so that a caller (the chip smoke script, a
test) can run the same model, serving, training or evaluating, through both
and compare.
"""

from typing import Callable, Dict, NamedTuple

from . import coupling, f1, jpeg, mask, median, ssim, transition, wire

__all__ = ["KernelSet", "KERNELS", "PLAIN", "launch_counts",
           "reset_launch_counts", "MODULES"]

MODULES = (transition, coupling, wire, mask, jpeg, median, f1, ssim)


class KernelSet(NamedTuple):
    transition: Callable
    coupling_head: Callable
    wire_to_channels: Callable
    wire_to_u8: Callable
    wire_to_s2d: Callable
    wire_to_u8_s2d: Callable
    mask_pack: Callable
    jpeg_pair: Callable
    median3: Callable
    f1_sweep: Callable
    ssim: Callable


KERNELS = KernelSet(transition.transition, coupling.coupling_head,
                    wire.to_channels, wire.to_u8, wire.to_s2d, wire.to_u8_s2d,
                    mask.mask_pack, jpeg.jpeg_pair, median.median3,
                    f1.f1_sweep, ssim.ssim)
PLAIN = KernelSet(transition.transition_plain, coupling.coupling_head_plain,
                  wire.to_channels_plain, wire.to_u8_plain, wire.to_s2d_plain,
                  wire.to_u8_s2d_plain, mask.mask_pack_plain,
                  jpeg.jpeg_pool_pair_plain, median.median3_plain,
                  f1.f1_sweep_plain, ssim.ssim_plain)


def launch_counts() -> Dict[str, int]:
    return {m.COUNT.name: m.COUNT.n for m in MODULES}


def reset_launch_counts() -> None:
    for m in MODULES:
        m.COUNT.n = 0
