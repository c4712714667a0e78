"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

* K1 ``transition``      — packed INN Haar/packing maps (kernels/transition.py)
* K2 ``coupling_head``   — coupling head GEMM + bias + RealNVP affine (kernels/coupling.py)
* K3 ``wire``            — uint8 wire format + relayouts (kernels/wire.py)
* K4 ``mask_pack``       — detect epilogue, bits + tamper fraction (kernels/mask.py)
* K5 ``jpeg_pair``       — the attack pool's two fused JPEG draws, forward
  and backward (kernels/jpeg.py); MBRS's ``jpeg_basic`` is one draw of it
* K6 ``median3``         — 3×3 median filter, forward and first-match
  backward (kernels/median.py)
* K7 ``f1_sweep``        — the eval step's confusion counts at every F1
  threshold, in one read (kernels/f1.py)
* K8 ``ssim``            — windowed SSIM reduced to per-image means and the
  mean (kernels/ssim.py)
* K9 ``attack_mix``      — the attack pool's α-mix with its gaussian blur and
  the post-attack epilogue, forward and backward (kernels/mix.py)
* K10 ``splice``         — the embed's clamp and quantizer with the splice
  tamper and the frames relayout, forward and backward (kernels/splice.py)
* K11 ``qconv``          — int8 3×3 / 1×1 convolution, exact int32 sums on
  the tensor cores, with its requant epilogue and pool / quantize prologue
  (kernels/qconv.py)
* K12 ``qconv_t``        — int8 2×2 / stride-2 transposed convolution with
  its requant, stored depth-to-space (kernels/qconv_t.py)
* K13 ``qcoupling_head`` — the int8 embed's split coupling head and RealNVP
  affine (kernels/qcoupling.py)
* K14 ``haar``           — the INN module path's Haar squeeze and its inverse
  (kernels/haar.py)
* K15 ``coupling_affine`` — the INN module path's RealNVP affine, forward and
  backward (kernels/affine.py)
* K16 ``zigzag_jpeg``    — HiDDeN's zig-zag JPEG-mask compression with its
  clip, forward and backward (kernels/zigzag.py)
* K17 ``crop_resize``    — HiDDeN's crop: a window resampled bilinearly back
  to the full grid, forward and backward, rows of any width (column tiles
  past a CTA's whole rows) (kernels/crop_resize.py)
* K18 ``window_attention`` — SUNet's shifted-window attention between its
  qkv and proj Dense layers, forward and backward, the bias table's
  gradient summed deterministically (kernels/window_attention.py)
* K19 ``canny_soft``     — the image family's soft canny edge map of the
  attacked copies, forward and backward (kernels/canny.py)
* K20 ``crop_cubic``     — CLR's crop tamper: a window resampled bicubically
  back to the full grid, forward and backward (kernels/crop_cubic.py)
* K21 ``rectify``        — CLR's scale-back rectification of the attacked
  copies before the reverse pass, forward and backward (kernels/rectify.py)
* K22 ``ssim_grad``      — the SSIM's gradient in its first image, K8's
  backward under autograd (kernels/ssim_grad.py)
* K23 ``film_residual``  — the FiLM epilogue of FBCNN's QF-attention
  blocks, x + (γ·h + β), forward and backward (kernels/film.py)
* K24 ``diffjpeg``       — the reference's DiffJPEG (4:2:0 chroma, centred
  DCT, soft round, JAX's clip), forward and backward (kernels/diffjpeg.py)

K25 ``blockdct``, the DCT-domain data's blockwise DCT, is a host kernel
(``vwfd_tpu_torch/native.py``), outside this set.

K3 also writes the int8 extractor's detect stem (``wire_to_s2d_i8``,
``wire_to_u8_s2d_i8``), under K3's launch count.

Each wrapper launches its kernel for CUDA tensors and takes its plain version
only for CPU tensors. Under autograd K1 and K2 are ``torch.autograd.Function``s
(K1's backward is K1 with ``transpose`` flipped), and so are K14 (its
backward is K14 in the other direction) and K15; K5, K6, K9, K10, K15,
K16, K17, K18, K19, K20 (one launch, no scratch), K21, K23 and K24 launch
their own backward kernels, and K8's is K22. ``KERNELS``
routes through the wrappers; ``PLAIN`` calls the plain versions on any device, so that a
caller (the chip smoke script, a test) can run the same model, serving,
training or evaluating, through both and compare. ``PLAIN``'s
``canny_soft`` is the plain version with ``exact_border`` (F24), which K19
is held to; the wrapper's CPU path is the JAX form as it is.
"""

import functools
from typing import Callable, Dict, NamedTuple

from . import (affine, canny, coupling, crop_cubic, crop_resize, diffjpeg,
               f1, film, haar, jpeg, mask, median, mix, qconv, qconv_t,
               qcoupling, rectify, splice, ssim, ssim_grad, transition, wire,
               window_attention, zigzag)

__all__ = ["KernelSet", "KERNELS", "PLAIN", "launch_counts",
           "reset_launch_counts", "MODULES"]

MODULES = (transition, coupling, wire, mask, jpeg, median, f1, ssim, mix,
           splice, qconv, qconv_t, qcoupling, haar, affine, zigzag,
           crop_resize, window_attention, canny, crop_cubic, rectify,
           ssim_grad, film, diffjpeg)


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
    attack_mix: Callable
    splice: Callable
    qconv: Callable
    qconv_t: Callable
    qcoupling_head: Callable
    wire_to_s2d_i8: Callable
    wire_to_u8_s2d_i8: Callable
    haar: Callable
    coupling_affine: Callable
    zigzag_jpeg: Callable
    crop_resize: Callable
    window_attention: Callable
    canny_soft: Callable
    crop_cubic: Callable
    rectify: Callable
    film_residual: Callable
    diffjpeg: Callable


KERNELS = KernelSet(transition.transition, coupling.coupling_head,
                    wire.to_channels, wire.to_u8, wire.to_s2d, wire.to_u8_s2d,
                    mask.mask_pack, jpeg.jpeg_pair, median.median3,
                    f1.f1_sweep, ssim.ssim, mix.attack_mix, splice.splice,
                    qconv.qconv, qconv_t.qconv_t, qcoupling.qcoupling_head,
                    wire.to_s2d_i8, wire.to_u8_s2d_i8, haar.haar,
                    affine.coupling_affine, zigzag.zigzag_jpeg,
                    crop_resize.crop_resize,
                    window_attention.window_attention, canny.canny_soft,
                    crop_cubic.crop_cubic, rectify.rectify,
                    film.film_residual, diffjpeg.diffjpeg)
PLAIN = KernelSet(transition.transition_plain, coupling.coupling_head_plain,
                  wire.to_channels_plain, wire.to_u8_plain, wire.to_s2d_plain,
                  wire.to_u8_s2d_plain, mask.mask_pack_plain,
                  jpeg.jpeg_pool_pair_plain, median.median3_plain,
                  f1.f1_sweep_plain, ssim.ssim_plain, mix.attack_mix_plain,
                  splice.splice_plain, qconv.qconv_plain,
                  qconv_t.qconv_t_plain, qcoupling.qcoupling_head_plain,
                  wire.to_s2d_i8_plain, wire.to_u8_s2d_i8_plain,
                  haar.haar_plain, affine.coupling_affine_plain,
                  zigzag.zigzag_jpeg_plain, crop_resize.crop_resize_plain,
                  window_attention.window_attention_plain,
                  functools.partial(canny.canny_soft_plain,
                                    exact_border=True),
                  crop_cubic.crop_cubic_plain, rectify.rectify_plain,
                  film.film_residual_plain, diffjpeg.diffjpeg_plain)


def launch_counts() -> Dict[str, int]:
    return {m.COUNT.name: m.COUNT.n for m in MODULES}


def reset_launch_counts() -> None:
    for m in MODULES:
        m.COUNT.n = 0
