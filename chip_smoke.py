#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``vwfd_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, ``sm_90a``) and ``nvcc``; exits non-zero, with
no result line, on any failure or without a card. Drives the port only: it
imports nothing of JAX and nothing of ``vwfd_tpu``. Phases:

1. the card: name and power limit as ``nvidia-smi`` reports them;
2. build: one ``nvcc`` call compiles every ``vwfd_tpu_torch/csrc/*.cu``;
3. per-kernel checks at the flagship serving shapes (batch 16, T=4, 256²),
   in bf16 and f32, each kernel against its plain PyTorch version on the
   card, with the tolerances stated in ``TOL`` below; each kernel is timed
   beside its plain version with CUDA events, warm and with a cold L2: K1
   per map beside the single ``F.conv2d`` / ``F.conv_transpose2d`` call
   that computes the same map, K2
   ``coupling_head`` at both coupling levels, forward and inverse, f32 and
   bf16, beside ``torch.cat`` + ``torch.matmul`` of the same shapes (the
   unfused path's yardstick; no single call computes the fused function);
   K3's four maps exact on the tiled and the general path, each timed warm
   and with a cold L2, (a)-(c) beside a one-call ``Tensor.copy_`` between
   the same layouts (a yardstick: no single call computes them); K4 warm
   and cold; then the training kernels at the training shape (64 frames of
   256²×3 f32): K5 ``jpeg_pair`` with draws covering all 5 qualities × 3
   modes and K6 ``median3`` on 8-bit inputs full of ties, each forward and
   input gradient against its plain version (K6 exact; K5 to 1e-4 except in
   8×8 blocks where a coefficient's rounding flipped, counted), K6 also on
   a small input with NaN pixels (NaN outputs at the same places), each
   timed forward + backward, warm and with a cold L2, beside its plain
   version; then the eval kernels at the eval shape: K7 ``f1_sweep``
   (64 frames of 256² f32, every k/255 boundary and NaN pixels) with counts
   EQUAL to the plain version's for each compiled level count (1, 9 and the
   generic 16 with unsorted, duplicate and out-of-range levels), there and
   on 100,003 pixels off the 16-byte grid, and K8 ``ssim`` (64 frames of
   256²×3 f32, with a flat patch) within ``ssim.ATOL`` on every per-image
   mean and the mean, bit-identical over calls, on ragged shapes and with
   a NaN pixel (NaN means where the plain version's are), each timed warm
   and with a cold L2 beside its plain version, K8 also beside a depthwise
   11×11 ``F.conv2d`` yardstick; then K9 ``attack_mix`` at the training
   shape (64 frames of 256²×3 f32, inputs outside [0, 1], half the frames
   exact quantizer ties) with each epilogue, forward EQUAL to its plain
   version and every input gradient within 1e-6 of the plain gradient's
   max, timed forward + backward warm and cold beside its plain version
   and a depthwise 3×3 ``F.conv2d`` yardstick (the blur alone); and K10
   ``splice`` at the training shape (bf16 INN output, and f32 with exact
   ties; a mask of 0/1 rectangles), both outputs and the gradient EQUAL to
   its plain version, timed the same way; then the int8 serving kernels at
   the flagship int8 roundtrip's shapes, each EQUAL to its plain version
   (exact int32 sums in float64) and timed warm and cold beside it: K11
   ``qconv`` at the UNet's twelve launches (Cin 12, the pool prologue, the
   dual epilogue, the f32 head) and the INN trunk's (a bf16 quantize
   prologue writing ``xi`` and the ELU requant) beside cuDNN's bf16
   convolution of the same shape and ``torch._int_mm`` on the im2col'd
   operands, plus ragged shapes (signed, a float32 prologue), each
   launch's plan printed (``kernels/qconv.py::plan``: loaders, BN, ring
   stages, grid); K12 ``qconv_t`` at the four upsamples, each plan printed,
   beside cuDNN's bf16 transposed convolution and ``torch._int_mm``, plus
   ragged shapes and tiles across images; K13 ``qcoupling_head`` at
   both coupling levels, bf16 and f32, on ``xi`` and quantizing itself
   (outputs that differ counted: 0 expected), beside K2 at the same shape;
   K11's, K12's and K13's registers, local memory and ``wgmma`` s8 /
   ``mma.sync`` counts read from the built library (``kernel_report``;
   local memory, where spills go, or an ``mma.sync`` fails); K3's int8
   stem (``to_s2d_i8``, ``to_u8_s2d_i8``) on every byte level, tiled and
   general;
4. the slice: ``WatermarkServer`` from the port's ``configs/video.yaml`` (bf16,
   random weights from a seed with the zero-init heads perturbed) serves one
   roundtrip with the launch counts at 0 just before and read just after
   (K1 ×6, K2 ``coupling_head`` ×10, K3 ×2: ``to_channels`` and the
   one-pass ``to_u8_s2d``, K4 ×1), then embed, detect and roundtrip requests
   compared with the same server running the plain versions, and a small
   f32 clip compared with the CPU plain path;
5. roundtrip latency (p50 ms) and streaming throughput (frames/s);
6. training at full width: the same model with a synthetic loader takes one
   ``train_step`` through ``KERNELS`` with the launch counts at 0 just
   before and read just after (K1 ×11: six maps forward, five backward,
   the clip taking no gradient; K2 ×10; K5, K6, K9 and K10 ×2 each), after
   the loss and
   gradients of one step through ``KERNELS`` and through ``PLAIN`` from the
   same weights, batch, previous batch and draws are compared (loss terms
   within 1e-2 relative, each net's gradient with cosine ≥ 0.999); then 2
   warm-up and 10 timed steps (p50 ms, frames/s), the finiteness of every
   loss, a batch with a NaN pixel that must leave every parameter, moment,
   step count and running statistic as it was, and the peak memory;
7. evaluation at full width: the same model takes one ``eval_step``
   through ``KERNELS`` with the launch counts at 0 just before and read
   just after (K1 ×6, K2 ×10, K5 to K10 ×1 each), compared with
   ``PLAIN`` on the same batch, previous batch and draws (PSNR and SSIM
   within ``EVAL_PSNR_ATOL`` / ``EVAL_SSIM_ATOL``, each F1 within the
   bound its pixels that cross a level between the two paths allow); then
   2 warm-up and 10 timed eval steps (p50 ms, frames/s) and the peak memory;
8. the trainer at full width: a model's states written as the JAX
   package's npz pretrain trees (``convert.params_to_jax``) and loaded into
   a fresh model through ``model.pretrain_path`` (every tensor and the
   embed EQUAL to the source's); ``fit`` for 4 steps with a
   ``ScalarLogger`` and a montage every 2 steps (one finite JSONL record a
   step; each PNG decodes, with the standard library, to the canvas
   ``stitch_images`` made); then a checkpoint, served through
   ``WatermarkServer(ckpt_dir=...)``: one roundtrip EQUAL to a server
   built from the same weights. Its files live under ``build/`` and are
   removed;
9. int8 serving at full width on phase 4's weights, calibrated on an
   explicit clip: the launch counts of an int8 detect (K3's int8 stem ×1,
   K11 ×12, K12 ×4, K4 ×1), of a roundtrip with ``int8_extract`` and of
   one with both int8 paths (K1 ×6, K11 ×32, K12 ×4, K13 ×10, K3 ×2, K4
   ×1, no K2), each with the counts at 0 just before and read just after;
   the same trees through the plain versions (mask bits EQUAL, tamper
   fraction within ``MEAN_ATOL``, watermarked bytes within 1 level on ≥
   99.99 %); the int8 extractor against the bf16 net on the same bytes
   (mean |Δp| and threshold agreement held to the JAX package's bounds);
   a self-calibrated server; detect and roundtrip p50, streaming frames/s
   and a roundtrip's peak memory beside the bf16 server's;
10. the convergence runner (``vwfd_tpu_torch.run_convergence``) at full
   width, batch 8, from phase 4's weights: 20 steps with an eval at the
   last, with the launch counts at 0 just before and read just after (20
   train steps' and one eval step's); the same run stopped at step 10 and
   resumed, its clips, masks, previous clips and attack draws at steps
   11-20 EQUAL to the unbroken run's and its records finite; then
   ``vwfd_tpu_torch.int8_eval`` on the unbroken run's checkpoint, 2
   batches, without and with ``--int8-embed``, each kernel of its path
   launched (K1, K2, K5-K7, K9-K12, and K13 with the int8 embed), its
   means finite and mean |Δprob| within phase 9's bound;
11. the reference-shaped model (``configs/refshape.yaml``: the INN module
   path with res subnets and the lifting Haar, the reference UNet, f 32)
   at full width: a b16 roundtrip with the launch counts at 0 just before
   and read just after (K14 ×6, K15 ×10, K3 ×2, K4 ×1) held to the plain
   server within F7's rule; one b8 ``train_step`` (K14 ×11, K15 ×20) with
   its loss terms and gradients held to ``PLAIN`` as phase 6's; one
   ``eval_step``; p50 of the roundtrip, the train step and the eval step.
   Phase 3 also holds K14 ``haar`` (EQUAL to its plain version, at the
   refshape's three levels and at 3072 channels; up(down(x)) within one
   f32 ulp) and K15 ``coupling_affine`` (its five coupling shapes, fused and
   split, forward and inverse, within one ulp; gradients within 1e-6 of the
   plain max in f32, one bf16 ulp in bf16), each timed warm and cold beside
   its plain version and, for K14, the grouped ``F.conv2d`` with the ±½
   bank; K3 at s = 1 and K4 at s = 1 (the reference UNet's stem and
   logits); and the packed INN at ``down_num`` 4 (K14 at its 3072-channel
   level, K2 on that level's head in f32 and bf16, its W streamed through
   the ring in bf16: F20 repaired), with K2 alone on that head in bf16,
   timed at M = 4096;
12. HiDDeN at full width (message 30, 64 channels, 4 / 7 / 3 blocks, 128²,
   b8, f32): one ``train_step`` per noise member through ``KERNELS`` and
   ``PLAIN`` from the same state and draws (loss terms within 1e-5
   relative, gradient cosines ≥ 0.9999), each with the launch counts at 0
   just before and read just after (K16 ``zigzag_jpeg`` ×2 on jpeg_mask,
   K17 ``crop_resize`` ×2 on crop, forward and backward); a NaN batch that
   moves nothing; ``infer`` of every member on the committed step-23,000
   nets (``checkpoints_hidden_r5_torch``), decoded bits equal to
   ``PLAIN``'s except within 1e-5 of 0.5; p50 of train steps and of an
   ``infer``, images/s and peak memory. Phase 3 holds K16 (forward within
   2e-6, gradients within 1e-6 of the plain max, the clip's ½ tie) at
   (8, 128, 128, 3), a ragged shape and one 8×8 block, and K17 (forward
   EQUAL, gradients within 1e-6 of the plain max and bit-identical over
   two calls) at (8, 128, 128, 3), a ragged shape, rows of 120 bytes (its
   element-wise copies) and another output size; both with NaN and Inf
   pixels and a NaN cotangent (NaN where the plain version's are); each
   timed forward + backward warm and cold beside its plain version, K16's
   JAX form
   (yardstick) or K17's ``F.interpolate`` of the sliced window (library),
   and the copy yardsticks of the launch floor (``Tensor.copy_``,
   ``torch.add(out=)``); K16's and K17's kernels spill-free
   (``kernel_report``). K17 also past its whole-row width (F22, repaired:
   column tiles) at (1, 8, 2·``max_width``, 3) and on a 3840 × 2160 RGB
   frame with an off-centre window, forward EQUAL, gradient within 1e-6 of
   the plain max and bit-identical over two calls, each timed beside the
   plain version and ``F.interpolate``;
13. MBRS at full width (128², b16, message 30, 64 channels, 4 SE blocks,
   diffusion 256, f32, random weights from a seed): one ``train_step`` per
   noise mode (identity; hard JPEG at Q50 with its straight-through
   gradient; soft JPEG at Q90) through ``KERNELS`` and ``PLAIN`` from the
   same state, batch, messages and draws (the JPEG's flipped 8×8 blocks
   between K5 and the plain DCT counted; loss terms within 1e-5 relative
   and gradient cosines ≥ 0.9999 where none flipped, 1e-3 and 0.99 a
   flipped block where some did), each with the launch counts at 0 just
   before and read just after (K5 ``jpeg_pair`` ×0, ×1, ×2); an Inf pixel that moves
   nothing; ``infer`` of each mode (K5 ×0, ×1, ×1); p50 of 10 train steps
   after 2 warm-up, images/s, ``infer`` p50 and peak memory; the runner
   (``run_family_convergence --task mbrs``) for 20 steps with an eval at
   the last (PIL's libjpeg at QF 50, 70, 90), and the same run stopped at
   step 10 and resumed, its images, messages and draws at steps 11-20
   EQUAL to the unbroken run's. Phase 3 holds K5 as MBRS's ``jpeg_basic``
   (weights (1, 0)) at (16, 128, 128, 3): modes 0 and 1 at Q50, 70 and 90,
   forward and gradient within 1e-4 outside flipped blocks (counted); with
   a NaN and an Inf pixel forward and gradient NaN where the plain
   version's are (F23); timed forward + backward warm and cold beside the
   plain version. Phase 3 also holds K18 ``window_attention`` on the map
   (forward, dqkv and the bias table's gradient within 1e-5 of the plain
   max, outputs bit-identical over two calls) at SUNet's four stage
   shapes of 256² b8, shifted and not, at N = 16, 25 and 49, d = 16 and
   d = 64, and on a non-square map whose shift wraps both edges; a NaN
   and an Inf in q give NaN where the plain version has it; shapes it
   does not take raise; each stage timed forward + backward warm and cold
   beside the plain version and ``F.scaled_dot_product_attention`` with
   the additive bias + mask (library), with its share of the bound; its
   kernels spill-free;
14. serving's remainder: ``serve --root --out`` on a PNG tree (OpenCV's
   reader and writer where it imports, else PIL's on PNGs written at the
   serving size), its frames, masks and ``verdicts.json`` under the CPU
   test's names; ``--stream 8``'s lines at windows 1, 2 and 4; a roundtrip
   at ``extractor_s2d`` 4 (K3 and K4 at s = 4) with the launch counts at 0
   just before and read just after, held to the plain server by F7's
   rule;
15. Tianchi at the published widths (SUNet embed 96, depths 2/2/2/2, heads
   3/6/12/24, window 8; 256², b8, f32, random weights from a seed): one
   ``train_step`` per JPEG mode through ``KERNELS`` and ``PLAIN`` from the
   same state, batch and draws (CE and CE1 within 1e-5 relative, both
   updates' gradient cosines ≥ 0.9999, or MBRS's per-flip rule where K5
   flips a block), each with the launch counts at 0 just before and read
   just after (K18 ×56: 28 forward, 28 backward; K5 ×1); an ``eval_step``
   (K18 ×14, K7 ×1); an Inf pixel that moves nothing; one step at 512²
   b4, where every stage shifts; the p50 of train and eval steps,
   images/s and the peak memory;
16. PAMI and ImugeV2 at ``configs/pami.yaml``'s width (``run_image``);
17. CLR at ``configs/clr.yaml``'s width and the image family's options
   (``run_clr``);
18. KD-JPEG at its published widths (FBCNN nc (32, 64, 128, 256), nb 4;
   256², one source × 6 classes; ``run_kdjpeg``): a ``train_step`` at
   ``aux_ramp`` 0 and 1 through ``KERNELS`` and ``PLAIN`` (logs within
   1e-5 relative, PSSIMU within 1e-3 dB, gradient cosines ≥ 0.9999; K23
   ×24), an Inf pixel that moves no state, ``simulate``, the step's p50,
   images/s and peak memory; one PAMI step at 512² b3 with
   ``with_jpeg_simulator`` through both (K5 ×1 more than PAMI's, K23 ×12).
   Phase 3 holds K23 ``film_residual`` (forward and gh EQUAL to the plain
   version, the sums within 1e-5 of the plain Σ|·|, bit-identical over
   calls, NaN where the plain version's are, 0 bytes beyond the outputs)
   at KD-JPEG's three up levels and the simulator's three at 512² b3,
   timed warm and cold beside the plain version and ``torch.addcmul``;
19. data parallelism and multi-card serving of the flagship
   (``run_parallel``): (a) one NCCL rank in this process (a ``FileStore``
   under ``build/``): a data-parallel ``train_step`` at phase 6's shape
   and weights, every loss term, parameter, moment, count and running
   statistic ``torch.equal`` to the step without a group from the same
   batch, previous batch and draws, the launch counts at 0 just before
   and read just after (phase 6's), then one ``eval_step`` the same way
   (phase 7's counts); the p50 of 10 data-parallel steps beside 10 plain
   ones, interleaved, and the bytes all-reduced a step; (b) two gloo
   ranks on ``cuda:0`` (this script as ``--dp-child DIR``, 8 of the 16
   clips each): their losses bit-equal over two steps and their states
   bit-equal, the loss terms within ``TRAIN_LOSS_RTOL`` and each net's
   all-reduced gradient within ``TRAIN_GRAD_COS`` of the one-process
   step on the global batch, and an Inf pixel in rank 1's rows alone
   leaving every state on both ranks as it was; (c)
   ``WatermarkServer(devices=("cuda:0", "cuda:0"))`` on phase 4's
   weights, each request launching phase 4's counts twice: with both int8
   paths embed, detect and roundtrip EQUAL to one device, in bf16 within
   ``DP_EMBED_MAX_LEVELS`` and mask bits differing only within
   ``DP_MASK_NEAR`` of the threshold (cuDNN takes other kernels for the
   half batch), each roundtrip's p50 beside one device's; (d) where there are
   two cards, two NCCL ranks (``dryrun_multiprocess``) and a two-card
   server, otherwise a line saying they were not run;
20. data parallelism of every other family (``run_parallel_families``):
   (a) one NCCL rank in this process per task (HiDDeN on crop, MBRS soft
   Q90, Tianchi, PAMI, ImugeV2 with the VGG loss, CLR with the GAN and the
   JPEG simulator, KD-JPEG) at its family phase's shape: a train step
   over the world-1 group against the step without one from the same
   state, batch and draws, every log and state tensor ``torch.equal``,
   the launch counts at 0 just before and read just after each and
   equal; for Tianchi, PAMI and CLR an eval step the same way; each
   step's all-reduce calls and bytes and the p50 of 4 steps of each,
   interleaved; (b) two gloo ranks on ``cuda:0`` (this script as
   ``--dpf-child DIR``), MBRS then CLR on half the global batch each:
   their logs and states bit-equal over two steps, the loss terms within
   ``DPF_LOSS_RTOL`` and each net's all-reduced gradient cosine ≥
   ``DPF_GRAD_COS`` against the one-process step (MBRS's with flax's
   variance; with phase 13's per-block rule where the soft JPEG flipped a
   block between the two encodings, counted), an Inf pixel in rank 1's
   rows keeping every state on both ranks, the first updates' cosines
   printed. It prints one ``{"parallel_families": ...}`` line;
21. the JPEG-vs-adversarial study and its library (``run_library``): (a)
   K24 ``diffjpeg`` against its plain version forward and backward at the
   study's (1, 32, 32, 3), at 64 frames of 256² and at a ragged (3, 48,
   80, 3) (``DIFFJPEG_ATOL``: every macroblock at the study's and the
   ragged shape, at 256² every one but those where the plain version sits
   within rounding of a step, ``kernels/diffjpeg.py::tie_macroblocks``),
   with NaN and Inf pixels (NaN where the plain version's are), timed warm
   (cold at 256²) beside the plain version; K5's 4:2:0 mode against its plain
   version at MBRS's shape, timed beside its 4:4:4 mode; (b) ``python -m
   vwfd_tpu_torch.jpegadv_experiment``'s ``main`` at the study's defaults
   (32², 10 classes, n 16, Q 90…10) for each victim A, B, C and each of
   FGSM, IGSM, targeted IGSM and the JPEG-resistant attack, the launch
   counts at 0 just before and read just after each run (K24 ×20 an image
   on ``jpeg_resistant``, nothing else), the summary's rates checked, K24's
   device time inside victim A's ``jpeg_resistant`` run under
   ``torch.profiler`` (the row's ``ms``; its ``plain_ms`` the same run's
   with ``PLAIN``'s K24, by the difference of the two runs' device time),
   and each ``jpeg_resistant`` run again with ``PLAIN``'s K24 (at most
   ``STUDY_ROWS_APART`` image apart); (c) K25 ``blockdct`` on the host at
   256² against its numpy plain version and ``scipy.fft.dctn``, timed,
   a ``DCTDomainDataset`` item (K25 ×2) and the cvtransforms train and val
   pipelines on it; (d) the library's ops and losses on the card against
   the CPU (``LIB_RTOL``). It prints one ``{"study": ...}`` line.

TF32 is off for cuDNN and cuBLAS throughout (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32``), so that the float32 checks
compare full-float32 paths.

The line before the last is a JSON object with one entry per kernel (its
launches on its main path and on each path, its error against the plain
version, its time warm and with a cold L2, the plain time, the bound, the
library time and a yardstick's; the bound is the sum of each launch's
bound: per roundtrip for K1-K4, per train step for
K5, K6, K9 and K10, per eval step for K7 and K8, per int8 roundtrip for
K11-K13, per int8 detect for K3's int8 stem, ``wire_i8``, per refshape
roundtrip for K14 and K15, and per HiDDeN train step of the member that
runs it for K16 and K17, per Tianchi train step for K18, per PAMI train
step for K19, per CLR train step for K20-K22, per KD-JPEG train step for
K23, per study run (16 images × 10 attack steps) of ``jpeg_resistant`` for
K24, per ``DCTDomainDataset`` item at 256² for K25 (``route`` ``host``: its
ms are the host's clock);
``launches_by_path`` holds every phase's paths (phase 20's
``dp_<task>_train_step`` and ``dp_<task>_eval_step`` among them), K5's
entry an ``mbrs`` timing at MBRS's shape and K17's a ``wide`` one past its
whole-row width); the last
line is
``{"ok": true,
"device": {...}}``.
"""

import collections
import contextlib
import dataclasses
import datetime
import functools
import gc
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vwfd_tpu_torch import (FLAGSHIP_CONFIG, PAMI_CONFIG, REFSHAPE_CONFIG,
                            kernel_report, load_config, parallel)
from vwfd_tpu_torch.attacks import quant_tables
from vwfd_tpu_torch.attacks.spatial import rect_mask
from vwfd_tpu_torch.data import Loader, SyntheticVideoDataset
from vwfd_tpu_torch.attacks import attack_pool_video
from vwfd_tpu_torch.convert import params_to_jax
from vwfd_tpu_torch.kernels import (KERNELS, PLAIN, _lib, affine, canny,
                                    coupling, crop_cubic, crop_resize,
                                    diffjpeg, f1,
                                    film, haar, jpeg, launch_counts, mask,
                                    median, mix, qconv, qconv_t, qcoupling,
                                    rectify,
                                    reset_launch_counts, splice, ssim,
                                    ssim_grad, transition, window_attention,
                                    wire, zigzag)
from vwfd_tpu_torch.metrics import DEFAULT_THRESHOLDS, threshold_level
from vwfd_tpu_torch.models import video_model
from vwfd_tpu_torch.models.state import save_checkpoint, save_npz_tree
from vwfd_tpu_torch.models.video_model import VideoWatermarkModel
from vwfd_tpu_torch.nets import unet_int8
from vwfd_tpu_torch.kernels.coupling import affine_e
from vwfd_tpu_torch.ops import haar as ops_haar
from vwfd_tpu_torch.ops.filters import gaussian_kernel_2d
from vwfd_tpu_torch.ops.squeeze import depth_to_space
from vwfd_tpu_torch.parallel.spawn import LocalRanks, RankFailure
from vwfd_tpu_torch.serving import WatermarkServer, unpack_mask_bits
from vwfd_tpu_torch.utils import ScalarLogger, read_png

# H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # non-tensor-core f32: the kernels' arithmetic
BF16_TC_OPS_PER_S = 989e12  # bf16 tensor-core flops: coupling_head's GEMM
INT8_TC_OPS_PER_S = 1979e12  # int8 tensor-core operations: K11-K13

# kernel vs plain tolerances, |kernel − plain| ≤ rtol·|plain| + atol·max|plain|
TOL = {torch.bfloat16: (2.0 ** -7, 1e-6),   # one bf16 ulp relative
       torch.float32: (1e-5, 1e-6)}
MASK_NEAR = 1e-6         # mask bits may differ only where |p − thr| < this
MEAN_ATOL = 1e-5         # tamper fraction
# slice vs the plain server (bf16, full width). Observed on an H100 SXM at
# 700 W: at most 1 level, 1 − 8e-8 of pixels equal, 2.6e-6 of mask bits
# differing (bf16 rounding differences amplified through the nets).
EMBED_MAX_LEVELS = 1     # watermarked uint8 within 1 level ...
EMBED_FRAC_EXACT = 0.9999  # ... and equal on ≥ 99.99% of pixels
MASK_DISAGREE = 1e-4     # mask bits disagreeing on < 0.01%
# int8 extract vs the bf16 net on the same weights and bytes: the JAX
# package's own bounds (tests/test_unet_int8.py:52-57)
INT8_MEAN_DP = 0.05      # mean |p_int8 − p_bf16|
INT8_AGREE = 0.95        # agreement of p > 0.5

B, T, S = 16, 4, 256
COLD_BYTES = 100e6       # cold-L2 timing: working set of twice the L2
ROUNDTRIP_WIRE = ("to_channels", "to_u8_s2d")  # K3's launches per roundtrip
KERNEL_SOURCES = {
    "transition": ("vwfd_tpu_torch/csrc/transition.cu",
                   "vwfd_tpu/nets/inn_packed.py:75"),
    "coupling_head": ("vwfd_tpu_torch/csrc/coupling.cu",
                      "vwfd_tpu/nets/inn_packed.py:186"),
    "wire": ("vwfd_tpu_torch/csrc/wire.cu", "vwfd_tpu/serving.py:377"),
    "mask_pack": ("vwfd_tpu_torch/csrc/mask.cu", "vwfd_tpu/serving.py:82"),
    "jpeg_pair": ("vwfd_tpu_torch/csrc/jpeg.cu",
                  "vwfd_tpu/attacks/jpeg.py:183"),
    "median3": ("vwfd_tpu_torch/csrc/median.cu",
                "vwfd_tpu/ops/filters.py:76"),
    "f1_sweep": ("vwfd_tpu_torch/csrc/f1.cu",
                 "vwfd_tpu/metrics/metrics.py:96"),
    "ssim": ("vwfd_tpu_torch/csrc/ssim.cu", "vwfd_tpu/metrics/metrics.py:65"),
    "attack_mix": ("vwfd_tpu_torch/csrc/mix.cu",
                   "vwfd_tpu/attacks/combined.py:52"),
    "splice": ("vwfd_tpu_torch/csrc/splice.cu",
               "vwfd_tpu/models/video_model.py:186"),
    "qconv": ("vwfd_tpu_torch/csrc/qconv.cu",
              "vwfd_tpu/nets/unet_int8.py:235"),
    "qconv_t": ("vwfd_tpu_torch/csrc/qconv_t.cu",
                "vwfd_tpu/nets/unet_int8.py:257"),
    "qcoupling_head": ("vwfd_tpu_torch/csrc/qcoupling.cu",
                       "vwfd_tpu/nets/inn_int8.py:257"),
    "wire_i8": ("vwfd_tpu_torch/csrc/wire.cu",
                "vwfd_tpu/nets/unet_int8.py:244"),
    "haar": ("vwfd_tpu_torch/csrc/haar.cu", "vwfd_tpu/ops/haar.py:20"),
    "coupling_affine": ("vwfd_tpu_torch/csrc/affine.cu",
                        "vwfd_tpu/nets/inn.py:235"),
    "zigzag_jpeg": ("vwfd_tpu_torch/csrc/zigzag.cu",
                    "vwfd_tpu/attacks/jpeg.py:249"),
    "crop_resize": ("vwfd_tpu_torch/csrc/crop_resize.cu",
                    "vwfd_tpu/ops/resize.py:135"),
    "window_attention": ("vwfd_tpu_torch/csrc/window_attention.cu",
                         "vwfd_tpu/nets/sunet.py:32"),
    "canny_soft": ("vwfd_tpu_torch/csrc/canny.cu",
                   "vwfd_tpu/ops/canny.py:39"),
    "crop_cubic": ("vwfd_tpu_torch/csrc/crop_cubic.cu",
                   "vwfd_tpu/ops/resize.py:135"),
    "rectify": ("vwfd_tpu_torch/csrc/rectify.cu",
                "vwfd_tpu/attacks/spatial.py:191"),
    "ssim_grad": ("vwfd_tpu_torch/csrc/ssim_grad.cu",
                  "vwfd_tpu/metrics/metrics.py:65"),
    "film_residual": ("vwfd_tpu_torch/csrc/film.cu",
                      "vwfd_tpu/nets/fbcnn.py:40"),
    "diffjpeg": ("vwfd_tpu_torch/csrc/diffjpeg.cu",
                 "vwfd_tpu/attacks/jpeg.py:114"),
    "blockdct": ("vwfd_tpu_torch/csrc/blockdct_host.cpp",
                 "csrc/blockdct.cpp:35"),
}
# K25 runs on the host (the DCT-domain dataset's items), built with g++
ROUTES = {"blockdct": "host"}
# a row counted under another kernel's launch count: K3's int8 stem
COUNT_OF = {"wire_i8": "wire"}
# one PyTorch call beside a kernel that computes a related, not the same,
# function (no single call computes the kernel's)
YARDSTICKS = {"coupling_head": "torch.cat + torch.matmul (the unfused head)",
              "wire": "Tensor.copy_ between the layouts of to_channels, "
                      "to_u8 and to_s2d",
              "ssim": "one depthwise 11x11 F.conv2d over the five stacked "
                      "windowed quantities",
              "attack_mix": "one depthwise 3x3 F.conv2d (groups 3, NCHW "
                            "input): the blur alone",
              "qconv": "cuDNN bf16 F.conv2d of the same shape (TF32 off); "
                       "int_mm_ms: torch._int_mm on the im2col'd operands "
                       "where its shape rules allow",
              "qconv_t": "cuDNN bf16 F.conv_transpose2d of the same shape; "
                         "int_mm_ms: torch._int_mm of the same GEMM",
              "qcoupling_head": "K2 coupling_head at the same shape (the "
                                "bf16 embed's head)",
              "coupling_affine": "torch.addcmul(t, affine_e(s), x) (the "
                                 "forward in two calls)",
              "zigzag_jpeg": "the JAX package's form: the analog colour "
                             "maps, two dense block-diagonal torch.matmul "
                             "(I⊗C8) per direction, the mask and the clip, "
                             "forward and backward",
              "canny_soft": "one depthwise 5x5 F.conv2d on the gray image "
                            "(the gaussian alone), forward and backward",
              "ssim_grad": "the input gradient of one depthwise 11x11 "
                           "F.conv2d over the stacked windowed maps",
              "film_residual": "torch.addcmul(x + beta, gamma, h) (the "
                               "forward in two calls)"}
# K14 and K15 run on the INN module path only (the refshape phase), K16
# and K17 on HiDDeN's (phase 12)
NO_INT8 = {"qconv": 0, "qconv_t": 0, "qcoupling_head": 0, "haar": 0,
           "coupling_affine": 0, "zigzag_jpeg": 0, "crop_resize": 0,
           "window_attention": 0, "canny_soft": 0, "crop_cubic": 0,
           "rectify": 0, "ssim_grad": 0, "film_residual": 0,
           "diffjpeg": 0}
ROUNDTRIP_LAUNCHES = {"transition": 6, "coupling_head": 10, "wire": 2,
                      "mask_pack": 1, "jpeg_pair": 0, "median3": 0,
                      "f1_sweep": 0, "ssim": 0, "attack_mix": 0,
                      "splice": 0, **NO_INT8}
# K1: six maps forward and five backward (the entry map's input, the clip,
# takes no gradient)
TRAIN_LAUNCHES = {"transition": 11, "coupling_head": 10, "wire": 0,
                  "mask_pack": 0, "jpeg_pair": 2, "median3": 2,
                  "f1_sweep": 0, "ssim": 0, "attack_mix": 2, "splice": 2,
                  **NO_INT8}
# the eval step: the embed's six maps, the attack pool's forward only
EVAL_LAUNCHES = {"transition": 6, "coupling_head": 10, "wire": 0,
                 "mask_pack": 0, "jpeg_pair": 1, "median3": 1,
                 "f1_sweep": 1, "ssim": 1, "attack_mix": 1, "splice": 1,
                 **NO_INT8}
# the int8 detect (K3's int8 stem, K11 ×12, K12 ×4, K4) and the int8
# roundtrip with both int8 paths (K1 ×6; K11 twice and K13 once per subnet
# evaluation, 10 evaluations, where the bf16 embed launches K2 ×10)
INT8_DETECT_LAUNCHES = {"wire": 1, "mask_pack": 1, "qconv": 12, "qconv_t": 4}
INT8_ROUNDTRIP_LAUNCHES = {**ROUNDTRIP_LAUNCHES, "coupling_head": 0,
                           "qconv": 32, "qconv_t": 4, "qcoupling_head": 10}
# the rows' main paths: each row is timed per launch of its path
ROW_PATH = {"jpeg_pair": "train_step", "median3": "train_step",
            "f1_sweep": "eval_step", "ssim": "eval_step",
            "attack_mix": "train_step", "splice": "train_step",
            "qconv": "int8_roundtrip", "qconv_t": "int8_roundtrip",
            "qcoupling_head": "int8_roundtrip", "wire_i8": "int8_detect",
            "haar": "refshape_roundtrip",
            "coupling_affine": "refshape_roundtrip",
            "zigzag_jpeg": "hidden_train_jpeg_mask",
            "crop_resize": "hidden_train_crop",
            "window_attention": "tianchi_train_step",
            "canny_soft": "pami_train_step",
            "crop_cubic": "clr_train_step", "rectify": "clr_train_step",
            "ssim_grad": "clr_train_step",
            "film_residual": "kdjpeg_train_step",
            "diffjpeg": "study_jpeg_resistant",
            "blockdct": "dct_dataset_item"}
# per value, the least work of the function: 2 passes x 4 sums (mu1, mu2,
# E[x²+y²], E[xy]; the map takes σ1² + σ2² only as a sum) x 11 FMA = 176,
# the products x², y² and xy summed 4, the map 15 (its division one), the
# mean's add 1
SSIM_FLOPS = 196
# eval step, KERNELS vs PLAIN (bf16, full width): PSNR and SSIM within these
# (the embed differs by one level on < 0.01 % of pixels, F7; K8 sums the
# windows in another order); each F1 within 4·n/(2·tp + fp + fn), n the
# pixels whose prediction lies on the other side of that level's boundary
# on the two paths (each such pixel moves tp, fp or fn by one)
EVAL_PSNR_ATOL = 0.01
EVAL_SSIM_ATOL = 1e-4
JPEG_FLIP_ATOL = 1e-4    # K5 vs plain, outside flipped blocks ...
JPEG_FLIP_SHARE = 1e-4   # ... which are at most this share of all blocks
JPEG_FLIP_BOUND = 1.0    # and differ by at most this anywhere
TRAIN_LOSS_RTOL = 1e-2   # train step, KERNELS vs PLAIN, bf16
TRAIN_GRAD_COS = 0.999
FUSED_GRAD_RTOL = 1e-6   # K9/K10 gradients vs plain, of the plain max
# operations per value (the bound's second term; bytes bound both): K9
# forward 9 taps × 2 + the mix 6 + the quantizing epilogue 5, backward 9 ×
# 2 + 3; K10 forward clamp 2, quantizer 3, splice 4, backward 3
MIX_OPS = (29, 21)
SPLICE_OPS = (9, 3)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call: CUDA events around ``iters`` calls
    queued behind a ~50 ms device sleep, so that the host has enqueued them
    all before the first starts and a short kernel is not timed at the
    host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved, ops, ops_per_s=F32_OPS_PER_S):
    """Least time (ms) for the work: bytes over the memory rate vs
    operations over their type's peak rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want, dtype):
    """Max abs error and whether every element is within TOL[dtype]."""
    rtol, atol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max()) or 1.0
    ok = not bool((err > rtol * want.abs() + atol * scale).any())
    return float(err.max()), ok


class Row:
    """Per-kernel totals over one roundtrip's launches."""

    def __init__(self, name):
        self.name = name
        self.err = 0.0
        self.ms = self.plain_ms = 0.0
        self.library_ms = self.yardstick_ms = None
        self.cold_ms = self.int_mm_ms = None
        # the sum over launches of each launch's bound, and the part of it
        # from launches that bytes bound
        self.bound_ms = self.bytes_bound_ms = 0.0
        self.extra = {}  # further keys of the row's JSON entry

    def add(self, ms, plain_ms, bytes_moved, ops, library_ms=None,
            ops_per_s=F32_OPS_PER_S, yardstick_ms=None, cold_ms=None):
        self.ms += ms
        self.plain_ms += plain_ms
        b, by = bound(bytes_moved, ops, ops_per_s)
        self.bound_ms += b
        if by == "bytes":
            self.bytes_bound_ms += b
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms
        if yardstick_ms is not None:
            self.yardstick_ms = (self.yardstick_ms or 0.0) + yardstick_ms
        if cold_ms is not None:
            self.cold_ms = (self.cold_ms or 0.0) + cold_ms

    def json(self, by_path):
        b = self.bound_ms
        by = "bytes" if 2 * self.bytes_bound_ms >= b else "operations"
        src, rep = KERNEL_SOURCES[self.name]
        path = ROW_PATH.get(self.name, "roundtrip")
        count = COUNT_OF.get(self.name, self.name)
        out = {"name": self.name, "route": ROUTES.get(self.name, "cuda"),
               "source": src, "replaces": rep,
               "launches": by_path[path][count],
               "launches_by_path": {k: v.get(count, 0)
                                    for k, v in by_path.items()},
               "timed_per": path,
               "max_abs_err": self.err, "ms": self.ms,
               "cold_ms": self.cold_ms,
               "plain_ms": self.plain_ms, "bound_ms": b, "bound_by": by,
               "library_ms": self.library_ms,
               "yardstick_ms": self.yardstick_ms,
               "yardstick": YARDSTICKS.get(self.name)}
        if self.int_mm_ms is not None:
            out["int_mm_ms"] = self.int_mm_ms
        out.update(self.extra)
        return out


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 3


def check_transition(rows, card):
    row = rows["transition"]
    dev = torch.device("cuda")
    g = torch.Generator("cuda").manual_seed(0)
    # the six maps of one flagship embed: entry, p2p, p2u and transposes
    walk = [("entry", (B, S, S, 3 * T)), ("p2p", (B, S // 4, S // 4, 192)),
            ("p2u", (B, S // 8, S // 8, 768))]
    for kind, shape in walk:
        for transpose in (False, True):
            src = transition.out_shape(shape, kind) if transpose else shape
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(src, device=dev, generator=g).to(dt)
                y = transition.transition(x, kind, transpose)
                ref = transition.transition_plain(x, kind, transpose)
                torch.cuda.synchronize()
                err, ok = rel_err(y, ref, dt)
                check(ok, f"transition {kind} T={transpose} {dt}: {err}")
                back = transition.transition(y, kind, not transpose)
                inv_err, inv_ok = rel_err(back, x, dt)
                check(inv_ok or (dt == torch.bfloat16
                                 and inv_err <= 2.0 ** -6 * float(x.abs().max())),
                      f"transition {kind} T={transpose} {dt} does not invert: "
                      f"{inv_err}")
                if dt != torch.bfloat16:
                    print(f"check transition {kind}{'T' if transpose else ''} "
                          f"f32 max_abs_err={err} inverse_err={inv_err}")
                    continue
                row.err = max(row.err, err)
                w = transition._fixed_weight(kind, x, transpose)
                s = transition._STRIDE[kind]
                xc = x.permute(0, 3, 1, 2)
                lib = (lambda: F.conv_transpose2d(xc, w, stride=s)) \
                    if transpose else (lambda: F.conv2d(xc, w, stride=s))
                ms = time_ms(lambda: transition.transition(x, kind, transpose))
                cold = time_cold_ms(
                    lambda v: transition.transition(v, kind, transpose),
                    cold_sets(lambda i: (torch.randn(
                        src, device=dev, generator=g).to(dt),), nbytes(x, y)))
                pms = time_ms(
                    lambda: transition.transition_plain(x, kind, transpose))
                lms = time_ms(lib)
                row.add(ms, pms, nbytes(x, y), 3 * y.numel(), lms,
                        cold_ms=cold)
                bms = bound(nbytes(x, y), 3 * y.numel())[0]
                print(f"check transition {kind}{'T' if transpose else ''} "
                      f"bf16 {tuple(x.shape)}->{tuple(y.shape)} "
                      f"max_abs_err={err} inverse_err={inv_err} ms={ms:.4f} "
                      f"cold_ms={cold:.4f} plain_ms={pms:.4f} "
                      f"library_ms={lms:.4f} bound_ms={bms:.4f} "
                      f"share_of_bound={bms / ms:.3f} [{card}]")


def check_coupling(rows, card):
    row = rows["coupling_head"]
    dev = torch.device("cuda")
    g = torch.Generator("cuda").manual_seed(1)
    # (spatial, channels of z, launches per roundtrip): level 48 packed
    # (2 couplings), levels 192 packed and 768 unpacked (3 couplings); the
    # trunk width is 128
    levels = [((S // 4), 192, 4), ((S // 8), 768, 6)]
    for hw, cz, launches in levels:
        c = cz // 2
        k = c + 128
        for dt in (torch.float32, torch.bfloat16):
            z = torch.randn(B, hw, hw, cz, device=dev, generator=g).to(dt)
            h = torch.randn(B, hw, hw, 128, device=dev, generator=g).to(dt)
            p = {"wh": (torch.randn(cz, k, device=dev, generator=g)
                        / k ** 0.5).to(dt),
                 "bh": 0.1 * torch.randn(cz, device=dev, generator=g)}
            xin, x = z[..., c:], z[..., :c]
            for inverse in (False, True):
                out = torch.empty_like(z)
                ref = torch.empty_like(z)
                coupling.coupling_head(xin, h, p, x, out=out[..., :c],
                                       inverse=inverse)
                coupling.coupling_head_plain(xin, h, p, x, out=ref[..., :c],
                                             inverse=inverse)
                torch.cuda.synchronize()
                err, ok = rel_err(out[..., :c], ref[..., :c], dt)
                check(ok, f"coupling_head z={cz} inverse={inverse} {dt}: "
                      f"{err}")
                print(f"check coupling_head z={cz} inverse={inverse} {dt} "
                      f"max_abs_err={err}")
                if dt != torch.bfloat16:
                    continue
                row.err = max(row.err, err)
                if inverse:  # serving runs the forward only
                    continue
                o = out[..., :c]
                ms = time_ms(lambda: coupling.coupling_head(xin, h, p, x,
                                                            out=o))
                cold = time_cold_ms(
                    lambda zz, hh, oo: coupling.coupling_head(
                        zz[..., c:], hh, p, zz[..., :c], out=oo[..., :c]),
                    cold_sets(lambda i: (
                        torch.randn(B, hw, hw, cz, device=dev,
                                    generator=g).to(dt),
                        torch.randn(B, hw, hw, 128, device=dev,
                                    generator=g).to(dt),
                        torch.empty_like(z)), nbytes(z, h, z)))
                pms = time_ms(lambda: coupling.coupling_head_plain(
                    xin, h, p, x, out=o))
                cat_mm = time_ms(lambda: torch.matmul(
                    torch.cat([xin, h], -1).reshape(-1, k), p["wh"].t()))
                m = B * hw * hw
                moved = nbytes(xin, h, x, o, p["wh"], p["bh"])
                flops = 2 * m * k * cz
                row.add(launches * ms, launches * pms, launches * moved,
                        launches * flops, ops_per_s=BF16_TC_OPS_PER_S,
                        yardstick_ms=launches * cat_mm,
                        cold_ms=launches * cold)
                bms, by = bound(moved, flops, BF16_TC_OPS_PER_S)
                print(f"check coupling_head z={cz} bf16 M={m} K={k} N={cz} "
                      f"ms={ms:.4f} cold_ms={cold:.4f} plain_ms={pms:.4f} "
                      f"cat_matmul_ms="
                      f"{cat_mm:.4f} bound_ms={bms:.4f} ({by}) "
                      f"share_of_bound={bms / ms:.3f} (x{launches} per "
                      f"roundtrip) [{card}]")


def time_cold_ms(fn, input_sets, iters=None):
    """Mean device time of one call with a cold L2: the calls rotate over
    ``input_sets`` (together at least ``COLD_BYTES``, twice the H100's
    50 MB L2) and each call's outputs stay alive until its set comes round
    again, so no call finds its inputs or its output memory in L2."""
    n = len(input_sets)
    keep = collections.deque(maxlen=n - 1)
    iters = iters or max(20, 4 * n)

    def step(k):
        keep.append(fn(*input_sets[k % n]))
    for k in range(n):
        step(k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for k in range(iters):
        step(k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_sets(make, bytes_per_call):
    """Enough input sets from ``make(i)`` for ``time_cold_ms``."""
    return [make(i) for i in range(max(2, math.ceil(COLD_BYTES
                                                     / bytes_per_call)))]


def wire_inputs(b, h, w, dt, g):
    """A u8 clip and an INN output (b,h,w,3T) in [-0.2, 1.2] whose first
    quarter holds exact .5 ties x = fl((k + .5)/255) (their product with
    255 often rounds to k + .5 exactly in f32)."""
    clip = torch.randint(0, 256, (b, T, h, w, 3), device="cuda", generator=g,
                         dtype=torch.uint8)
    x = torch.rand(b, h, w, 3 * T, device="cuda", generator=g) * 1.4 - 0.2
    k = torch.arange(x.numel() // 4, device="cuda") % 255
    x.view(-1)[: k.numel()] = (k + 0.5) / 255.0
    return clip, x.to(dt)


def check_wire(rows, card):
    """K3: every map exact against its plain version, in f32 and bf16, on
    the tiled path (the flagship) and the general path (rows of 300 bytes);
    then each map timed at the flagship in bf16, warm and with a cold L2,
    beside its plain version and, for (a)-(c), a one-call copy yardstick."""
    row = rows["wire"]
    g = torch.Generator("cuda").manual_seed(2)
    for b, h, w in ((B, S, S), (2, 100, 100)):
        path = "tiled" if (3 * w) % 16 == 0 else "general"
        for dt in (torch.float32, torch.bfloat16):
            clip, x = wire_inputs(b, h, w, dt, g)
            flat = clip.reshape(b * T, h, w, 3)
            check(torch.equal(wire.to_channels(clip, dt),
                              wire.to_channels_plain(clip, dt)),
                  f"wire to_channels {path} {dt} differs")
            check(torch.equal(wire.to_u8(x, T), wire.to_u8_plain(x, T)),
                  f"wire to_u8 {path} {dt} differs")
            # s = 2: the flagship's stem; s = 1: the reference UNet's
            for sf in (2, 1):
                check(torch.equal(wire.to_s2d(flat, sf, dt),
                                  wire.to_s2d_plain(flat, sf, dt)),
                      f"wire to_s2d s={sf} {path} {dt} differs")
                u8, xs = wire.to_u8_s2d(x, T, sf)
                u8_ref, xs_ref = wire.to_u8_s2d_plain(x, T, sf)
                check(torch.equal(u8, u8_ref) and torch.equal(xs, xs_ref),
                      f"wire to_u8_s2d s={sf} {path} {dt} differs")
            ties = int(((x.float().clamp(0, 1) * 255.0) % 1 == 0.5).sum())
            check(ties > 0, "no exact ties in the to_u8 input")
            print(f"check wire {path} {(b, T, h, w)} {dt} exact: to_channels "
                  f"to_u8 to_s2d to_u8_s2d at s = 2 and 1 (to_u8 inputs with "
                  f"{ties} exact .5 ties)")

    dt = torch.bfloat16
    clip, x = wire_inputs(B, S, S, dt, g)
    flat = clip.reshape(B * T, S, S, 3)
    a = torch.empty(B, S, S, 3 * T, device="cuda", dtype=dt)
    u8 = torch.empty(B, T, S, S, 3, device="cuda", dtype=torch.uint8)
    c = torch.empty(B * T, S // 2, S // 2, 12, device="cuda", dtype=dt)
    maps = [
        ("to_channels", wire.to_channels, wire.to_channels_plain, (clip, dt),
         lambda: a.view(B, S, S, T, 3).copy_(clip.permute(0, 2, 3, 1, 4)),
         nbytes(clip, a), lambda i: wire_inputs(B, S, S, dt, g)[:1] + (dt,)),
        ("to_u8", wire.to_u8, wire.to_u8_plain, (x, T),
         lambda: u8.permute(0, 2, 3, 1, 4).copy_(x.view(B, S, S, T, 3)),
         nbytes(x, u8), lambda i: (wire_inputs(B, S, S, dt, g)[1], T)),
        ("to_s2d", wire.to_s2d, wire.to_s2d_plain, (flat, 2, dt),
         lambda: c.view(B * T, S // 2, S // 2, 2, 2, 3).copy_(
             flat.view(B * T, S // 2, 2, S // 2, 2, 3).permute(
                 0, 1, 3, 2, 4, 5)),
         nbytes(flat, c), lambda i: (wire_inputs(B, S, S, dt, g)[0].reshape(
             B * T, S, S, 3), 2, dt)),
        ("to_u8_s2d", wire.to_u8_s2d, wire.to_u8_s2d_plain, (x, T, 2),
         None, nbytes(x, u8, c),
         lambda i: (wire_inputs(B, S, S, dt, g)[1], T, 2)),
    ]
    for name, fn, plain, args, copy, moved, make in maps:
        ms = time_ms(lambda: fn(*args))
        cold = time_cold_ms(fn, cold_sets(make, moved))
        pms = time_ms(lambda: plain(*args))
        bms = bound(moved, 0)[0]
        copy_ms = time_ms(copy) if copy else None
        if name in ROUNDTRIP_WIRE:
            row.add(ms, pms, moved, 3 * x.numel(), cold_ms=cold)
        if copy_ms is not None:
            row.yardstick_ms = (row.yardstick_ms or 0.0) + copy_ms
        yard = (f" copy_yardstick_ms={copy_ms:.4f}" if copy else "")
        print(f"check wire {name} bf16 ms={ms:.4f} cold_ms={cold:.4f} "
              f"plain_ms={pms:.4f}{yard} bound_ms={bms:.4f} "
              f"share_of_bound={bms / ms:.3f} cold_share={bms / cold:.3f} "
              f"({'roundtrip' if name in ROUNDTRIP_WIRE else 'embed/detect-only'}"
              f" path) [{card}]")


def check_mask(rows, card):
    row = rows["mask_pack"]
    g = torch.Generator("cuda").manual_seed(3)

    def make_logits(dt):
        z = torch.randn(B * T, S // 2, S // 2, 4, device="cuda", generator=g)
        z.view(-1)[::97] = 0.0  # p == threshold exactly
        return z.to(dt)

    for dt in (torch.float32, torch.bfloat16):
        logits = make_logits(dt)
        m, frac = mask.mask_pack(logits, T, 2, 0.5)
        m_ref, frac_ref = mask.mask_pack_plain(logits, T, 2, 0.5)
        torch.cuda.synchronize()
        p = torch.sigmoid(depth_to_space(logits.float(), 2)).reshape(
            B, T, S, S, 1)
        near = ((p - 0.5).abs() < MASK_NEAR).cpu().numpy()
        differ = (unpack_mask_bits(m.cpu().numpy())
                  != unpack_mask_bits(m_ref.cpu().numpy()))
        check(not (differ & ~near).any(),
              f"mask_pack {dt}: bits differ away from the threshold")
        mean_err = float((frac - frac_ref).abs().max())
        check(mean_err <= MEAN_ATOL, f"mask_pack {dt}: mean err {mean_err}")
        again = mask.mask_pack(logits, T, 2, 0.5)[1]
        check(torch.equal(again, frac), f"mask_pack {dt}: tamper fraction "
              f"not repeatable")
        print(f"check mask_pack {dt} bits_differ={int(differ.sum())} "
              f"near_threshold={int(near.sum())} mean_err={mean_err} "
              f"(fraction bit-identical over repeated calls)")
        if dt == torch.bfloat16:
            row.err = mean_err
            moved = nbytes(logits, m, frac)
            ms = time_ms(lambda: mask.mask_pack(logits, T, 2, 0.5))
            cold = time_cold_ms(
                lambda z: mask.mask_pack(z, T, 2, 0.5),
                cold_sets(lambda i: (make_logits(dt),), moved))
            pms = time_ms(lambda: mask.mask_pack_plain(logits, T, 2, 0.5))
            row.add(ms, pms, moved, 6 * 4 * logits.numel(), cold_ms=cold)
            bms = bound(moved, 0)[0]
            print(f"check mask_pack bf16 ms={ms:.4f} cold_ms={cold:.4f} "
                  f"plain_ms={pms:.4f} bound_ms={bms:.4f} "
                  f"share_of_bound={bms / ms:.3f} cold_share={bms / cold:.3f}"
                  f" [{card}]")

    # s = 1, the reference UNet's full-resolution logits (the refshape
    # detect): K4's general path, one thread per output byte
    logits = torch.randn(B * T, S, S, 1, device="cuda", generator=g).to(
        torch.bfloat16)
    logits.view(-1)[::97] = 0.0
    m, frac = mask.mask_pack(logits, T, 1, 0.5)
    m_ref, frac_ref = mask.mask_pack_plain(logits, T, 1, 0.5)
    torch.cuda.synchronize()
    p = torch.sigmoid(logits.float()).reshape(B, T, S, S, 1)
    near = ((p - 0.5).abs() < MASK_NEAR).cpu().numpy()
    differ = (unpack_mask_bits(m.cpu().numpy())
              != unpack_mask_bits(m_ref.cpu().numpy()))
    mean_err = float((frac - frac_ref).abs().max())
    check(not (differ & ~near).any() and mean_err <= MEAN_ATOL,
          f"mask_pack s=1: bits differ away from the threshold or mean err "
          f"{mean_err}")
    moved = nbytes(logits, m, frac)
    ms = time_ms(lambda: mask.mask_pack(logits, T, 1, 0.5))
    pms = time_ms(lambda: mask.mask_pack_plain(logits, T, 1, 0.5))
    bms = bound(moved, 0)[0]
    print(f"check mask_pack s=1 bf16 {tuple(logits.shape)} bits_differ="
          f"{int(differ.sum())} mean_err={mean_err} ms={ms:.4f} "
          f"plain_ms={pms:.4f} bound_ms={bms:.4f} share_of_bound="
          f"{bms / ms:.3f} (the refshape detect's, general path) [{card}]")


def train_shape_input(g, levels=256):
    """64 frames of 256²×3 f32 on the 8-bit grid (``levels`` levels: few
    levels make ties common), as the attack pool sees them."""
    return torch.randint(0, levels, (B * T, S, S, 3), device="cuda",
                         generator=g).float() / 255.0


def fwd_bwd_ms(fn, x, cot):
    """Device ms of one forward and of one backward of ``fn`` at x."""
    xg = x.clone().requires_grad_(True)
    fwd = time_ms(lambda: fn(xg))
    y = fn(xg)
    bwd = time_ms(lambda: torch.autograd.grad(y, xg, cot,
                                              retain_graph=True))
    return fwd, bwd


def fwd_bwd_cold_ms(fn, make):
    """Device ms of one forward and of one backward of ``fn`` with a cold
    L2 (``time_cold_ms``), on fresh inputs ``make(i)`` -> (x, cotangent)."""
    xs = [make(i) for i in range(2)]  # each call moves ≥ 100 MB
    fwd = time_cold_ms(lambda v, c: fn(v), xs)
    graphs = []
    for v, c in xs:
        vg = v.clone().requires_grad_(True)
        graphs.append((fn(vg), vg, c))
    bwd = time_cold_ms(lambda y, vg, c: torch.autograd.grad(
        y, vg, c, retain_graph=True)[0], graphs)
    return fwd, bwd


def flipped_blocks(got, want, atol):
    """8×8 blocks (all channels) of NHWC frames where |got − want| > atol."""
    n, h, w, c = got.shape
    d = (got - want).abs().reshape(n, h // 8, 8, w // 8, 8, c)
    return int((d.amax(dim=(2, 4, 5)) > atol).sum()), n * (h // 8) * (w // 8)


def check_jpeg(rows, card):
    """K5 at the training shape: forward and input gradient against the
    plain version (autograd through the torch ops); every quality × mode
    pair among the 128 draws."""
    row = rows["jpeg_pair"]
    g = torch.Generator("cuda").manual_seed(4)
    n = B * T
    pairs = torch.arange(2 * n, device="cuda") % 15
    qt = quant_tables((pairs % 5).view(n, 2)).contiguous()
    mode = (pairs // 5).view(n, 2).to(torch.int32).contiguous()
    w = torch.softmax(torch.randn(n, 5, device="cuda", generator=g),
                      -1)[:, 1:3].contiguous()
    x = train_shape_input(g)
    cot = torch.randn(x.shape, device="cuda", generator=g)
    outs = []
    for fn in (jpeg.jpeg_pair, jpeg.jpeg_pool_pair_plain):
        xg = x.clone().requires_grad_(True)
        y = fn(xg, qt, mode, w)
        outs.append((y.detach(), torch.autograd.grad(y, xg, cot)[0]))
    torch.cuda.synchronize()
    (yk, gk), (yp, gp) = outs
    gscale = float(gp.abs().max())
    fb, blocks = flipped_blocks(yk, yp, JPEG_FLIP_ATOL)
    gfb, _ = flipped_blocks(gk, gp, JPEG_FLIP_ATOL * gscale)
    ok_y = (yk - yp).abs()
    err = float(ok_y.max())
    check(fb <= JPEG_FLIP_SHARE * blocks and gfb <= JPEG_FLIP_SHARE * blocks,
          f"jpeg_pair: {fb} / {gfb} of {blocks} blocks differ (forward / "
          f"gradient)")
    check(err <= JPEG_FLIP_BOUND, f"jpeg_pair: max err {err}")
    d = ok_y.reshape(n, S // 8, 8, S // 8, 8, 3).amax(dim=(2, 4, 5))
    calm = float(d[d <= JPEG_FLIP_ATOL].max()) if fb < blocks else 0.0
    row.err = err
    fn = lambda v: jpeg.jpeg_pair(v, qt, mode, w)  # noqa: E731
    pfn = lambda v: jpeg.jpeg_pool_pair_plain(v, qt, mode, w)  # noqa: E731
    kf, kb = fwd_bwd_ms(fn, x, cot)
    cf, cb = fwd_bwd_cold_ms(fn, lambda i: (
        train_shape_input(g), torch.randn(x.shape, device="cuda",
                                          generator=g)))
    pf, pb = fwd_bwd_ms(pfn, x, cot)
    fwd_bytes = nbytes(x, yk, qt, mode, w)
    bwd_bytes = nbytes(x, cot, gk, qt, mode, w)
    vals = x.numel()
    # per value: forward 2 transforms × 2 passes × 8 FMA + ~20 for colour,
    # quantisation and mix; backward 3 transforms + ~30
    fwd_ops, bwd_ops = vals * (64 + 20), vals * (96 + 30)
    row.add(kf + kb, pf + pb, fwd_bytes + bwd_bytes, fwd_ops + bwd_ops,
            cold_ms=cf + cb)
    bms = bound(fwd_bytes + bwd_bytes, fwd_ops + bwd_ops)[0]
    print(f"check jpeg_pair {tuple(x.shape)} f32 modes 0/1/2 x qualities "
          f"50..90: forward flipped_blocks={fb} gradient flipped_blocks="
          f"{gfb} of {blocks} (tol {JPEG_FLIP_ATOL}, share "
          f"{JPEG_FLIP_SHARE}); max_abs_err={err} (outside flipped blocks "
          f"{calm}); gradient max_abs_err={float((gk - gp).abs().max())} of "
          f"max {gscale}")
    print(f"check jpeg_pair ms fwd={kf:.4f} bwd={kb:.4f} cold fwd={cf:.4f} "
          f"bwd={cb:.4f} plain fwd={pf:.4f} bwd={pb:.4f} bound_ms={bms:.4f} "
          f"(fwd {bound(fwd_bytes, 0)[0]:.4f} + bwd "
          f"{bound(bwd_bytes, 0)[0]:.4f}) share_of_bound={bms / (kf + kb):.3f}"
          f" cold_share={bms / (cf + cb):.3f} [{card}]")


MBRS_B, MBRS_S = 16, 128         # MBRS's path: b16, 128², f32
MBRS_SHAPE = (MBRS_B, MBRS_S, MBRS_S, 3)
# K5 as jpeg_basic vs plain at MBRS's shape: 1e-4 outside flipped 8×8
# blocks, which are at most this share of the 4,096 blocks (its inputs are
# continuous, not 8-bit levels: more coefficients lie within rounding of a
# .5 boundary than at the flagship's)
MBRS_FLIP_SHARE = 1e-3


def jpeg_basic_fns(q, rounding):
    from vwfd_tpu_torch.attacks import jpeg_basic
    return (lambda v: jpeg_basic(v, q, rounding),
            lambda v: jpeg_basic(v, q, rounding, kernels=PLAIN))


def k5_against_plain(what, fn, plain, x, cot):
    """Forward and gradient of K5 (``fn``) and its plain version at x: NaN
    where the plain version's are, 1e-4 (of the gradient's max) outside
    flipped blocks, at most ``MBRS_FLIP_SHARE`` of them; returns the
    flipped blocks (forward, gradient) and the largest difference outside
    them."""
    (yk,), (gk,) = grads_of(fn, [x], [True], cot)
    (yp,), (gp,) = grads_of(plain, [x], [True], cot)
    torch.cuda.synchronize()
    for name, k, p in (("forward", yk, yp), ("gradient", gk, gp)):
        check(torch.equal(k.isnan(), p.isnan()),
              f"{what} {name}: NaN at other places than the plain version's "
              f"({int(k.isnan().sum())} vs {int(p.isnan().sum())})")
    yk, yp, gk, gp = (torch.nan_to_num(t, nan=0.0) for t in (yk, yp, gk, gp))
    gscale = float(gp.abs().max())
    fb, blocks = flipped_blocks(yk, yp, JPEG_FLIP_ATOL)
    gfb, _ = flipped_blocks(gk, gp, JPEG_FLIP_ATOL * gscale)
    check(max(fb, gfb) <= max(1, MBRS_FLIP_SHARE * blocks),
          f"{what}: {fb} / {gfb} of {blocks} blocks differ (forward / "
          f"gradient)")
    check(float((yk - yp).abs().max()) <= JPEG_FLIP_BOUND, f"{what}: max err")
    n, h, w, c = yk.shape
    d = (yk - yp).abs().reshape(n, h // 8, 8, w // 8, 8, c).amax(
        dim=(2, 4, 5))
    calm = float(d[d <= JPEG_FLIP_ATOL].max()) if fb < blocks else 0.0
    return fb, gfb, calm


def check_jpeg_basic(rows, card):
    """K5 as MBRS's ``jpeg_basic`` (weights (1, 0)) at MBRS's shape: modes
    0 ("round") and 1 ("ss") at each of MBRS's three qualities, forward and
    input gradient against the plain ``jpeg_basic`` (``k5_against_plain``),
    then with a NaN and an Inf pixel; timed forward + backward (the soft
    mode's two launches) warm and with a cold L2 beside the plain version,
    with its bound."""
    from vwfd_tpu_torch.models.mbrs_model import QUALITY_INDICES
    row = rows["jpeg_pair"]
    g = torch.Generator("cuda").manual_seed(70)
    x = torch.rand(MBRS_SHAPE, device="cuda", generator=g)
    cot = torch.randn(MBRS_SHAPE, device="cuda", generator=g)
    flips, calm = {}, 0.0
    for rounding in ("round", "ss"):
        for q in QUALITY_INDICES:
            what = f"jpeg_basic {rounding} q_idx {q}"
            fb, gfb, c = k5_against_plain(what, *jpeg_basic_fns(q, rounding),
                                          x, cot)
            flips[f"{rounding}_{q}"] = [fb, gfb]
            calm = max(calm, c)
    bad = x.clone()
    bad[0, 5, 9, 1] = float("nan")
    bad[3, 70, 33, 0] = float("inf")
    for rounding in ("round", "ss"):
        k5_against_plain(f"jpeg_basic {rounding} non-finite",
                         *jpeg_basic_fns(2, rounding), bad, cot)
    print(f"check jpeg_basic (K5, w = (1, 0)) {MBRS_SHAPE} f32 round/ss x "
          f"Q50/70/90: flipped blocks (forward, gradient) of "
          f"{MBRS_B * (MBRS_S // 8) ** 2} {json.dumps(flips)}; max_abs_err "
          f"outside them {calm:.3g}; with NaN and Inf pixels NaN where the "
          f"plain version's are, forward and gradient")
    # the soft mode's two launches at Q90, on the draws jpeg_basic passes
    n = MBRS_B
    qt = quant_tables(torch.full((n, 2), 4, device="cuda")).contiguous()
    mode = torch.ones((n, 2), dtype=torch.int32, device="cuda")
    w = torch.tensor([[1.0, 0.0]], device="cuda").expand(n, 2).contiguous()
    fn = lambda v: jpeg.jpeg_pair(v, qt, mode, w)  # noqa: E731
    pfn = lambda v: jpeg.jpeg_pool_pair_plain(v, qt, mode, w)  # noqa: E731
    nb = nbytes(x)
    sets = cold_sets(lambda i: (torch.rand(MBRS_SHAPE, device="cuda",
                                           generator=g),
                                torch.randn(MBRS_SHAPE, device="cuda",
                                            generator=g)), 3 * nb)
    kf, kb, cf, cb = fused_times(fn, sets, [True])
    pf, pb, _, _ = fused_times(pfn, sets[:1], [True])
    # forward x and y, backward x, g and gx; per value the flagship's ops
    moved, ops = 5 * nb, x.numel() * (64 + 20 + 96 + 30)
    bms, by = bound(moved, ops)
    row.extra["mbrs"] = {
        "shape": list(MBRS_SHAPE), "mode": "ss (fwd + bwd)",
        "ms": kf + kb, "fwd_ms": kf, "bwd_ms": kb, "cold_ms": cf + cb,
        "plain_ms": pf + pb, "bound_ms": bms, "bound_by": by,
        "flipped_blocks": flips, "max_abs_err_outside_flips": calm}
    print(f"check jpeg_basic {MBRS_SHAPE} ms fwd={kf:.5f} bwd={kb:.5f} cold "
          f"fwd={cf:.5f} bwd={cb:.5f} plain fwd={pf:.4f} bwd={pb:.4f} "
          f"bound_ms={bms:.5f} ({by}) share_of_bound={bms / (kf + kb):.3f} "
          f"[{card}]")


def median_both(x, cot):
    """(output, input gradient) of K6 and of its plain version at x."""
    outs = []
    for fn in (median.median3, median.median3_plain):
        xg = x.clone().requires_grad_(True)
        y = fn(xg)
        outs.append((y.detach(), torch.autograd.grad(y, xg, cot)[0]))
    torch.cuda.synchronize()
    return outs


def check_median(rows, card):
    """K6 at the training shape on inputs of 4 levels (ties everywhere):
    forward and input gradient EQUAL to the plain version's; then a small
    input with NaN pixels: NaN outputs at the same places, every other
    value and the whole gradient equal."""
    row = rows["median3"]
    g = torch.Generator("cuda").manual_seed(5)
    x = train_shape_input(g, levels=4)
    cot = torch.randn(x.shape, device="cuda", generator=g)
    (yk, gk), (yp, gp) = median_both(x, cot)
    check(torch.equal(yk, yp), "median3 forward differs from plain")
    check(torch.equal(gk, gp), "median3 gradient differs from plain")
    routed = float((gk != cot).float().mean())

    xn = torch.randint(0, 8, (2, 64, 64, 3), device="cuda",
                       generator=g).float() / 255.0
    xn.view(-1)[torch.randperm(xn.numel(), device="cuda",
                               generator=g)[:5]] = float("nan")
    cn = torch.randn(xn.shape, device="cuda", generator=g)
    (ynk, gnk), (ynp, gnp) = median_both(xn, cn)
    nan = torch.isnan(ynp)
    check(bool(nan.any()) and torch.equal(torch.isnan(ynk), nan)
          and torch.equal(ynk[~nan], ynp[~nan]),
          "median3 forward on NaN input differs from plain")
    check(torch.equal(gnk, gnp),
          "median3 gradient on NaN input differs from plain")
    print(f"check median3 {tuple(xn.shape)} f32 with 5 NaN values: "
          f"{int(nan.sum())} NaN outputs at the plain version's places, "
          f"other values and the gradient equal")

    kf, kb = fwd_bwd_ms(median.median3, x, cot)
    cf, cb = fwd_bwd_cold_ms(median.median3, lambda i: (
        train_shape_input(g, levels=4), torch.randn(x.shape, device="cuda",
                                                    generator=g)))
    pf, pb = fwd_bwd_ms(median.median3_plain, x, cot)
    fwd_bytes, bwd_bytes = nbytes(x, yk), nbytes(x, cot, gk)
    # 19 min/max pairs per value forward; recomputed + 9 compares and
    # up to 9 adds backward
    fwd_ops, bwd_ops = x.numel() * 38, x.numel() * (38 + 27)
    row.add(kf + kb, pf + pb, fwd_bytes + bwd_bytes, fwd_ops + bwd_ops,
            cold_ms=cf + cb)
    bms = bound(fwd_bytes + bwd_bytes, fwd_ops + bwd_ops)[0]
    print(f"check median3 {tuple(x.shape)} f32 4-level input: forward and "
          f"gradient equal to plain (gradient routed off the pixel itself "
          f"for {routed:.3f} of values); ms fwd={kf:.4f} bwd={kb:.4f} cold "
          f"fwd={cf:.4f} bwd={cb:.4f} plain fwd={pf:.4f} bwd={pb:.4f} "
          f"bound_ms={bms:.4f} share_of_bound={bms / (kf + kb):.3f} "
          f"cold_share={bms / (cf + cb):.3f} [{card}]")


LEVELS = [threshold_level(t) for t in np.float32(DEFAULT_THRESHOLDS)]
# K7's generic 16-level variant: one level (mask_confusion), and unsorted,
# duplicate and out-of-range levels
F1_LEVEL_SETS = ([127.0], [204.0, 25.0, 127.0, 127.0, -1.0],
                 [229.0, 0.0, 255.0, 51.0, 76.0, 300.0, 102.0, 153.0, 178.0,
                  25.0, 25.0, 127.5, 204.0, -0.5, 254.0, 128.0])


def eval_pred(g):
    """A prediction at the eval shape (64 frames of 256², f32) holding every
    k/255, its float32 neighbours and NaN pixels; the rest uniform."""
    p = torch.rand(B * T, S, S, 1, device="cuda", generator=g)
    k = torch.arange(256, device="cuda", dtype=torch.float32) / 255.0
    special = torch.cat([k, torch.nextafter(k, torch.full_like(k, 2.0)),
                         torch.nextafter(k, torch.full_like(k, -1.0)),
                         torch.full((64,), float("nan"), device="cuda")])
    idx = torch.randperm(p.numel(), device="cuda", generator=g)
    p.view(-1)[idx[:special.numel()]] = special
    return p


def eval_mask(g):
    return (torch.rand(B * T, S, S, 1, device="cuda", generator=g)
            < 0.3).float()


def check_f1(rows, card):
    """K7 at the eval shape: the counts EQUAL the plain version's (every
    k/255 boundary and NaN pixels), repeated calls equal; timed warm and
    with a cold L2 beside the plain version."""
    row = rows["f1_sweep"]
    g = torch.Generator("cuda").manual_seed(6)
    pred, gt = eval_pred(g), eval_mask(g)
    counts = f1.f1_sweep(pred, gt, LEVELS)
    ref = f1.f1_sweep_plain(pred, gt, LEVELS)
    torch.cuda.synchronize()
    check(torch.equal(counts, ref), f"f1_sweep counts {counts} plain {ref}")
    check(torch.equal(f1.f1_sweep(pred, gt, LEVELS), counts),
          "f1_sweep counts not repeatable")
    # an odd size off the 16-byte grid takes the scalar path
    odd_p, odd_g = pred.view(-1)[1:1 + 100_003], gt.view(-1)[1:1 + 100_003]
    for levels in (LEVELS, *F1_LEVEL_SETS):  # each compiled level count
        for p, m in ((pred, gt), (odd_p, odd_g)):
            check(torch.equal(f1.f1_sweep(p, m, levels),
                              f1.f1_sweep_plain(p, m, levels)),
                  f"f1_sweep counts differ: {len(levels)} levels, "
                  f"{p.numel()} pixels")
    row.err = 0.0
    moved = nbytes(pred, gt, counts)
    ms = time_ms(lambda: f1.f1_sweep(pred, gt, LEVELS))
    cold = time_cold_ms(lambda p, m: f1.f1_sweep(p, m, LEVELS),
                        cold_sets(lambda i: (eval_pred(g), eval_mask(g)),
                                  moved))
    pms = time_ms(lambda: f1.f1_sweep_plain(pred, gt, LEVELS))
    ops = pred.numel() * (4 + 2 * len(LEVELS))  # 2 mul, 2 trunc, compares
    row.add(ms, pms, moved, ops, cold_ms=cold)
    bms, by = bound(moved, ops)
    print(f"check f1_sweep {tuple(pred.shape)} f32 x{len(LEVELS)} levels: "
          f"counts equal to plain (tp of the 0.5 level {int(counts[4, 0])}, "
          f"{int(torch.isnan(pred).sum())} NaN pixels); ms={ms:.4f} "
          f"cold_ms={cold:.4f} plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) "
          f"share_of_bound={bms / ms:.3f} cold_share={bms / cold:.3f} "
          f"[{card}]")


def ssim_pair(g):
    x = torch.rand(B * T, S, S, 3, device="cuda", generator=g)
    y = (x + 0.05 * torch.randn(x.shape, device="cuda", generator=g)).clamp(
        0, 1)
    y[:, :40, :40] = x[:, :40, :40] = 0.25  # flat: σ² cancels to ~0
    return x, y


def check_ssim(rows, card):
    """K8 at the eval shape: per-image means and the mean within
    ``ssim.ATOL`` of the plain version's, bit-identical over repeated calls;
    ragged shapes (strips cut by the frame, split rows, a frame shorter than
    the halo); a NaN pixel gives NaN means where the plain version does;
    timed
    warm and with a cold L2 beside the plain version and the depthwise
    ``F.conv2d`` yardstick."""
    row = rows["ssim"]
    g = torch.Generator("cuda").manual_seed(7)
    x, y = ssim_pair(g)
    means, mean = ssim.ssim(x, y)
    pmeans, pmean = ssim.ssim_plain(x, y)
    torch.cuda.synchronize()
    err = max(float((means - pmeans).abs().max()), abs(float(mean - pmean)))
    check(err <= ssim.ATOL, f"ssim: err {err} > {ssim.ATOL}")
    again = ssim.ssim(x, y)
    check(torch.equal(again[0], means) and torch.equal(again[1], mean),
          "ssim not repeatable")
    rerr = 0.0
    for n, h, w in ((3, 37, 45), (2, 5, 300), (1, 11, 11)):  # ragged strips
        xr, yr = x[:n, :h, :w].contiguous(), y[:n, :h, :w].contiguous()
        rerr = max(rerr, float((ssim.ssim(xr, yr)[0]
                                - ssim.ssim_plain(xr, yr)[0]).abs().max()))
    check(rerr <= ssim.ATOL, f"ssim ragged: err {rerr}")
    xn = x[:2, :40, :40].clone()
    xn[1, 17, 3, 1] = float("nan")
    yn = y[:2, :40, :40].contiguous()
    check(torch.equal(ssim.ssim(xn, yn)[0].isnan(),
                      ssim.ssim_plain(xn, yn)[0].isnan()),
          "ssim: NaN means differ from plain")
    row.err = err
    moved = nbytes(x, y, means, mean)
    ms = time_ms(lambda: ssim.ssim(x, y))
    cold = time_cold_ms(ssim.ssim, cold_sets(lambda i: ssim_pair(g), moved))
    pms = time_ms(lambda: ssim.ssim_plain(x, y), iters=3, warmup=1)
    stacked = torch.cat([x, y, x * x, y * y, x * y], -1).permute(
        0, 3, 1, 2).contiguous()
    w = ssim.window_2d().to("cuda").expand(15, 1, 11, 11).contiguous()
    yard = time_ms(lambda: F.conv2d(stacked, w, padding=5, groups=15))
    ops = x.numel() * SSIM_FLOPS
    row.add(ms, pms, moved, ops, yardstick_ms=yard, cold_ms=cold)
    bms, by = bound(moved, ops)
    print(f"check ssim {tuple(x.shape)} f32: mean {float(mean):.6f}, max "
          f"abs err vs plain {err:.3g} (ragged shapes: {rerr:.3g}; tol "
          f"{ssim.ATOL}), bit-identical over repeated calls; ms={ms:.4f} "
          f"cold_ms={cold:.4f} plain_ms={pms:.4f} conv2d_yardstick_ms="
          f"{yard:.4f} bound_ms={bms:.4f} ({by}) share_of_bound="
          f"{bms / ms:.3f} cold_share={bms / cold:.3f} [{card}]")


def ties_input(g, shape):
    """Values in [-0.2, 1.2) with a quarter of them exact (k + 0.5)/255
    ties of the 8-bit quantizer and a few exactly 0 and 1."""
    x = -0.2 + 1.4 * torch.rand(shape, device="cuda", generator=g)
    k = torch.randint(0, 255, shape, device="cuda", generator=g)
    pick = torch.rand(shape, device="cuda", generator=g)
    x = torch.where(pick < 0.25, (k.float() + 0.5) / 255.0, x)
    return torch.where(pick > 0.97, (pick > 0.985).float(), x)


def grads_of(fn, ins, needs, cot):
    """(outputs, input gradients) of ``fn(*ins)`` for the inputs flagged in
    ``needs``, with cotangent(s) ``cot``."""
    ins = [t.clone().requires_grad_(True) if n else t
           for t, n in zip(ins, needs)]
    y = fn(*ins)
    ys = y if isinstance(y, tuple) else (y,)
    gs = torch.autograd.grad(ys, [t for t, n in zip(ins, needs) if n], cot)
    return [t.detach() for t in ys], list(gs)


def fused_times(fn, sets, needs):
    """Device ms of ``fn``'s forward and backward, warm (on ``sets[0]``) and
    with a cold L2 (rotating over ``sets``, each ``(*inputs, cotangent)``
    and together ≥ ``COLD_BYTES``): (fwd, bwd, cold fwd, cold bwd)."""
    graphs = []
    for *ins, cot in sets:
        ins = [t.clone().requires_grad_(True) if n else t
               for t, n in zip(ins, needs)]
        y = fn(*ins)
        graphs.append((y if isinstance(y, tuple) else (y,),
                       [t for t, n in zip(ins, needs) if n], cot))
    ins0 = [t for t in sets[0][:-1]]
    fwd = time_ms(lambda: fn(*ins0))

    def back(ys, xs, cot):
        return torch.autograd.grad(ys, xs, cot, retain_graph=True)
    bwd = time_ms(lambda: back(*graphs[0]))
    cfwd = time_cold_ms(lambda *a: fn(*a[:-1]), sets)
    cbwd = time_cold_ms(back, graphs)
    return fwd, bwd, cfwd, cbwd


def check_mix(rows, card):
    """K9 at the training shape: forward EQUAL to the plain version with
    each epilogue, every input gradient within ``FUSED_GRAD_RTOL`` of the
    plain gradient's max; timed with the train step's epilogue."""
    row = rows["attack_mix"]
    g = torch.Generator("cuda").manual_seed(8)
    n = B * T
    shape = (n, S, S, 3)

    def inputs():
        x, a0, aj, a3 = (ties_input(g, shape) for _ in range(4))
        alpha = torch.softmax(torch.randn(n, 5, device="cuda", generator=g),
                              -1)
        # half the frames: α0 = α3 = α4 = 0 and x = 0, so the mix is a_jpeg
        # itself and the quantizer meets its exact ties
        half = torch.arange(n, device="cuda") >= n // 2
        alpha[half] *= torch.tensor([0.0, 1, 1, 0, 0], device="cuda")
        x[half] = 0.0
        return [x, a0, aj, a3, alpha.contiguous()]

    ins = inputs()
    cot = torch.randn(shape, device="cuda", generator=g)
    needs = (True, True, True, True, False)
    err = 0.0
    for epi in mix.EPILOGUES:
        (yk,), gk = grads_of(lambda *a: mix.attack_mix(*a, epi), ins, needs,
                             cot)
        (yp,), gp = grads_of(lambda *a: mix.attack_mix_plain(*a, epi), ins,
                             needs, cot)
        torch.cuda.synchronize()
        check(torch.equal(yk, yp), f"attack_mix {epi}: forward differs")
        for name, a, b in zip(("x", "a0", "a_jpeg", "a3"), gk, gp):
            d = float((a - b).abs().max())
            check(d <= FUSED_GRAD_RTOL * float(b.abs().max()),
                  f"attack_mix {epi} d{name}: {d}")
            err = max(err, d)
        print(f"check attack_mix {shape} f32 epilogue {epi}: forward equal "
              f"to plain; gradient max_abs_err dx "
              f"{float((gk[0] - gp[0]).abs().max()):.3g} (da0, da_jpeg, da3 "
              f"{'equal' if all(torch.equal(a, b) for a, b in zip(gk[1:], gp[1:])) else 'within tol'})")
    row.err = err
    fn = lambda *a: mix.attack_mix(*a, "quantize")  # noqa: E731
    pfn = lambda *a: mix.attack_mix_plain(*a, "quantize")  # noqa: E731
    sets = [(*inputs(), torch.randn(shape, device="cuda", generator=g))
            for _ in range(2)]  # each set moves ≥ 250 MB
    kf, kb, cf, cb = fused_times(fn, sets, needs)
    pf, pb, _, _ = fused_times(pfn, sets[:1], needs)
    xc = ins[0].permute(0, 3, 1, 2).contiguous()
    w = torch.from_numpy(gaussian_kernel_2d(3, 2.0)).to("cuda").expand(
        3, 1, 3, 3).contiguous()
    yard = time_ms(lambda: F.conv2d(xc, w, padding=1, groups=3))
    fwd_bytes = nbytes(*ins[:4], ins[0]) + nbytes(ins[4])
    bwd_bytes = nbytes(cot, *ins[:3]) + nbytes(ins[4])
    ops = ins[0].numel() * sum(MIX_OPS)
    row.add(kf + kb, pf + pb, fwd_bytes + bwd_bytes, ops, yardstick_ms=yard,
            cold_ms=cf + cb)
    bf, bb = bound(fwd_bytes, 0)[0], bound(bwd_bytes, 0)[0]
    print(f"check attack_mix ms fwd={kf:.4f} bwd={kb:.4f} cold fwd={cf:.4f} "
          f"bwd={cb:.4f} plain fwd={pf:.4f} bwd={pb:.4f} conv2d_yardstick_ms"
          f"={yard:.4f} bound_ms fwd={bf:.4f} bwd={bb:.4f} share_of_bound "
          f"fwd={bf / kf:.3f} bwd={bb / kb:.3f} cold fwd={bf / cf:.3f} "
          f"bwd={bb / cb:.3f} [{card}]")


def rect_masks(g, b, t):
    """(B, T, S, S, 1) masks of one random 0/1 rectangle per frame."""
    m = torch.zeros((b, t, S, S, 1), device="cuda")
    lo = torch.randint(0, S // 2, (b, t, 2), generator=g, device="cuda")
    size = torch.randint(8, S // 2, (b, t, 2), generator=g, device="cuda")
    for i in range(b):
        for j in range(t):
            y0, x0 = lo[i, j].tolist()
            h, w = size[i, j].tolist()
            m[i, j, y0:y0 + h, x0:x0 + w] = 1.0
    return m


def check_splice(rows, card):
    """K10 at the training shape: both outputs and the INN output's
    gradient EQUAL to the plain version's, bf16 (the flagship) and f32
    (exact ties); the embed's form too; timed in bf16."""
    row = rows["splice"]
    g = torch.Generator("cuda").manual_seed(9)
    shape5 = (B, T, S, S, 3)

    def inputs(dt):
        return [ties_input(g, (B, S, S, 3 * T)).to(dt), rect_masks(g, B, T),
                torch.rand(shape5, device="cuda", generator=g)]

    needs = (True, False, False)
    for dt in (torch.bfloat16, torch.float32):
        ins = inputs(dt)
        cot = tuple(torch.randn(shape5, device="cuda", generator=g)
                    for _ in range(2))
        yk, (gk,) = grads_of(lambda x, m, p: splice.splice(x, T, m, p), ins,
                             needs, cot)
        yp, (gp,) = grads_of(lambda x, m, p: splice.splice_plain(x, T, m, p),
                             ins, needs, cot)
        ek, ep = splice.splice(ins[0], T), splice.splice_plain(ins[0], T)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(yk, yp))
              and torch.equal(ek, ep), f"splice {dt}: forward differs")
        d = float((gk.float() - gp.float()).abs().max())
        check(d <= FUSED_GRAD_RTOL * float(gp.float().abs().max()),
              f"splice {dt}: gradient {d}")
        print(f"check splice {tuple(ins[0].shape)} {dt}: fwd_video, "
              f"attacked_fwd and the embed form equal to plain; gradient "
              f"max_abs_err {d:.3g} ({'equal' if torch.equal(gk, gp) else 'within tol'})")
        row.err = max(row.err, d)
    fn = lambda x, m, p: splice.splice(x, T, m, p)  # noqa: E731
    pfn = lambda x, m, p: splice.splice_plain(x, T, m, p)  # noqa: E731
    sets = [(*inputs(torch.bfloat16),
             tuple(torch.randn(shape5, device="cuda", generator=g)
                   for _ in range(2))) for _ in range(2)]
    kf, kb, cf, cb = fused_times(fn, sets, needs)
    pf, pb, _, _ = fused_times(pfn, sets[:1], needs)
    x, m, p = sets[0][:3]
    fwd_bytes = nbytes(x, m, p) + 2 * nbytes(p)
    bwd_bytes = 2 * nbytes(p) + nbytes(m, x)
    ops = p.numel() * sum(SPLICE_OPS)
    row.add(kf + kb, pf + pb, fwd_bytes + bwd_bytes, ops, cold_ms=cf + cb)
    bf, bb = bound(fwd_bytes, 0)[0], bound(bwd_bytes, 0)[0]
    print(f"check splice ms fwd={kf:.4f} bwd={kb:.4f} cold fwd={cf:.4f} "
          f"bwd={cb:.4f} plain fwd={pf:.4f} bwd={pb:.4f} bound_ms "
          f"fwd={bf:.4f} bwd={bb:.4f} share_of_bound fwd={bf / kf:.3f} "
          f"bwd={bb / kb:.3f} cold fwd={bf / cf:.3f} bwd={bb / cb:.3f} "
          f"[{card}]")


# ------------------------------------------------------------ phase 3, int8


def i8(g, shape, lo=-127):
    return torch.randint(lo, 128, shape, device="cuda", generator=g,
                         dtype=torch.int8)


def qscale(g, n, k, spread):
    """Per-channel multipliers that put float(acc)·m near ±spread (the sum
    of k products of uniform int8 values has a spread of 5376·√k)."""
    base = spread / (5376.0 * k ** 0.5)
    return (base * (0.5 + torch.rand(n, device="cuda", generator=g))).float()


def qconv_inputs(g, case):
    """Inputs of one K11 launch: ``(x, w, m, b, epilogue, kwargs)``."""
    _, _, n, h, w, cin, cout, k, epi, pool, cin2, xdt = case
    kw = {"pool": pool}
    if xdt is None:
        hin, win = (2 * h, 2 * w) if pool else (h, w)
        x = i8(g, (n, hin, win, cin), lo=0 if epi != "elu" else -127)
    else:  # the coupling half, a channel slice of the coupling's input,
        # quantized once into xi for K13 (the trunk's first conv)
        full = torch.randn((n, h, w, 2 * cin), device="cuda", generator=g)
        x = full.to(xdt)[..., cin:]
        kw["x_scale"] = torch.tensor(0.02, device="cuda")
        kw["xi_out"] = torch.empty(x.shape, device="cuda", dtype=torch.int8)
    wt = i8(g, (cout, k, k, cin))
    m = qscale(g, cout, k * k * cin, 1.0 if epi == "elu" else 80.0)
    b = torch.randn(cout, device="cuda", generator=g)
    if epi == "elu":
        kw["out_scale"] = torch.tensor(0.015, device="cuda")
    if cin2:
        kw.update(x2=i8(g, (n, h, w, cin2), lo=0),
                  w2=i8(g, (cout, k, k, cin2)),
                  m2=qscale(g, cout, k * k * cin2, 80.0))
    return x, wt, m, b, epi, kw


def qconv_cases():
    """K11's launches of one int8 roundtrip at the flagship (batch 16, T=4,
    256²): the UNet's twelve (f = 64, s2d 2, plan (2, 2, 1, 1, 1), 64 frames
    of 128²×12) and the INN trunk's two per subnet evaluation (the level-48
    couplings' four evaluations at 64², the level-192/768 ones' six at 32²),
    as (name, launches, N, H, W, Cin, Cout, k, epilogue, pool, Cin2, float
    input dtype)."""
    n, h, f = B * T, S // 2, 64
    unet = [("enc1.0", 1, n, h, h, 12, f, 3, "relu", False, 0, None),
            ("enc1.1", 1, n, h, h, f, f, 3, "relu", False, 0, None),
            ("enc2.0", 1, n, h // 2, h // 2, f, 2 * f, 3, "relu", True, 0,
             None),
            ("enc2.1", 1, n, h // 2, h // 2, 2 * f, 2 * f, 3, "relu", False,
             0, None)]
    for lv, (name, cin) in enumerate((("enc3", 2 * f), ("enc4", 4 * f),
                                      ("bottleneck", 8 * f)), start=2):
        unet.append((name, 1, n, h >> lv, h >> lv, cin, 2 * cin, 3, "relu",
                     True, 0, None))
    for lv, c in ((3, 8 * f), (2, 4 * f), (1, 2 * f), (0, f)):
        unet.append((f"dec{lv + 1}", 1, n, h >> lv, h >> lv, c, c, 3, "relu",
                     False, c, None))
    unet.append(("head", 1, n, h, h, f, 4, 1, "f32", False, 0, None))
    inn = []
    for reps, hw, c in ((4, S // 4, 96), (6, S // 8, 384)):
        inn += [(f"inn.{c}.conv0", reps, B, hw, hw, c, 128, 3, "elu", False,
                 0, torch.bfloat16),
                (f"inn.{c}.conv1", reps, B, hw, hw, 128, 128, 3, "elu", False,
                 0, None)]
    return unet + inn


def im2col_i8(x, k):
    """(N, H, W, C) int8 → (N·H·W, k²·C), SAME padding, tap-major."""
    if k == 1:
        return x.reshape(-1, x.shape[-1])
    n, h, w, c = x.shape
    xp = torch.zeros((n, h + 2, w + 2, c), device=x.device, dtype=x.dtype)
    xp[:, 1:-1, 1:-1] = x
    cols = [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.stack(cols, 3).reshape(n * h * w, 9 * c)


def int_mm_ok(m, k, n):
    """torch._int_mm's shape rules on CUDA."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def qconv_yardsticks(x, wt, kw):
    """(cuDNN bf16 F.conv2d ms, torch._int_mm ms or None) of the same
    products: the conv's input pooled where K11 pools, the dual epilogue's
    two operands as one conv over their concatenation."""
    if kw.get("pool"):
        x = qconv.max_pool2(x)
    if x.dtype != torch.int8:
        x = qconv.quantize_input(x, kw["x_scale"])
    w = wt
    if "x2" in kw:
        x = torch.cat([x, kw["x2"]], -1)
        w = torch.cat([wt, kw["w2"]], -1)
    k = w.shape[1]
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    conv_ms = time_ms(lambda: F.conv2d(xb, wb, padding=k // 2))
    a = im2col_i8(x.contiguous(), k)
    bmat = w.reshape(w.shape[0], -1).t()
    mm_ms = (time_ms(lambda: torch._int_mm(a, bmat))
             if int_mm_ok(a.shape[0], a.shape[1], bmat.shape[1]) else None)
    return conv_ms, mm_ms


def qconv_work(x, wt, out, kw):
    """(bytes, operations) of one K11 launch: each input read once, the
    output written once; 2 operations per multiply-add."""
    n, h, w, cout = out.shape
    moved = nbytes(x, wt, out) + 12 * cout
    if "xi_out" in kw:
        moved += nbytes(kw["xi_out"])
    macs = n * h * w * cout * wt[0].numel()
    if "x2" in kw:
        moved += nbytes(kw["x2"], kw["w2"])
        macs += n * h * w * cout * kw["w2"][0].numel()
    return moved, 2 * macs


def plan_line(pl):
    return (f"plan bn={pl.bn} kc={pl.kc} stages={pl.stages} grid={pl.grid} "
            f"smem={pl.smem} loaders={'/'.join('+'.join(o) for o in pl.loaders)}")


def equal_plain(fn, plain, x, wt, m, b, epi, kw):
    """K11 and its plain version on the same inputs, each writing its own
    ``xi_out``: (kernel output, whether outputs and xi are equal)."""
    kp = dict(kw)
    if "xi_out" in kw:
        kp["xi_out"] = torch.empty_like(kw["xi_out"])
    got = fn(x, wt, m, b, epi, **kw)
    want = plain(x, wt, m, b, epi, **kp)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    if "xi_out" in kw:
        same = same and torch.equal(kw["xi_out"], kp["xi_out"])
    return got, want, same


def check_qconv(rows, card):
    """K11 at every launch of the flagship int8 roundtrip: EQUAL to its
    plain version (every epilogue and prologue: relu with Cin 12 and with
    the pool, dual, f32 head, ELU with a bf16 quantize prologue writing
    ``xi`` and with an int8 input), each launch's plan printed, timed warm
    and with a cold L2 beside its plain version,
    cuDNN's bf16 convolution of the same shape (TF32 off) and torch._int_mm
    on the im2col'd operands; then ragged shapes (H, W, Cout off the tiles,
    Cin 12, a signed requant, a float32 prologue) equal too."""
    row = rows["qconv"]
    g = torch.Generator("cuda").manual_seed(20)
    for case in qconv_cases():
        name, reps = case[:2]
        x, wt, m, b, epi, kw = qconv_inputs(g, case)
        got, want, same = equal_plain(qconv.qconv, qconv.qconv_plain, x, wt,
                                      m, b, epi, kw)
        check(same, f"qconv {name}: {int((got != want).sum())} outputs "
              f"differ from the plain (or xi does)")
        pl = qconv.plan_of(x, wt, epi, pool=kw["pool"], x2=kw.get("x2"),
                           w2=kw.get("w2"))
        ms = time_ms(lambda: qconv.qconv(x, wt, m, b, epi, **kw))
        moved, ops = qconv_work(x, wt, got, kw)
        cold = time_cold_ms(
            lambda xx: qconv.qconv(xx, wt, m, b, epi, **kw),
            cold_sets(lambda i: (qconv_inputs(g, case)[0],), moved))
        pms = time_ms(lambda: qconv.qconv_plain(x, wt, m, b, epi, **kw),
                      iters=2, warmup=1)
        conv_ms, mm_ms = qconv_yardsticks(x, wt, kw)
        row.add(reps * ms, reps * pms, reps * moved, reps * ops,
                ops_per_s=INT8_TC_OPS_PER_S, yardstick_ms=reps * conv_ms,
                cold_ms=reps * cold)
        if mm_ms is not None:
            row.int_mm_ms = (row.int_mm_ms or 0.0) + reps * mm_ms
        bms, by = bound(moved, ops, INT8_TC_OPS_PER_S)
        mm = f"{mm_ms:.4f}" if mm_ms is not None else "n/a"
        print(f"check qconv {name} {epi}{' pool' if kw['pool'] else ''}"
              f"{' dual' if 'x2' in kw else ''} {tuple(x.shape)}->"
              f"{tuple(got.shape)} equal ms={ms:.4f} cold_ms={cold:.4f} "
              f"plain_ms={pms:.4f} cudnn_bf16_ms={conv_ms:.4f} "
              f"int_mm_ms={mm} bound_ms={bms:.4f} ({by}) "
              f"share_of_bound={bms / ms:.3f} (x{reps} per roundtrip) "
              f"{plan_line(pl)} [{card}]")
    ragged = [("ragged.relu", 1, 3, 13, 21, 12, 70, 3, "relu", False, 0,
               None),
              ("ragged.pool", 1, 2, 9, 17, 64, 96, 3, "relu", True, 0, None),
              ("ragged.dual", 1, 2, 7, 11, 64, 40, 3, "relu", False, 32,
               None),
              ("ragged.signed", 1, 1, 7, 9, 32, 70, 3, "signed", False, 0,
               None),
              ("ragged.elu_f32", 1, 2, 10, 12, 40, 72, 3, "elu", False, 0,
               torch.float32),
              ("ragged.1x1", 1, 3, 5, 6, 20, 24, 1, "relu", False, 0, None)]
    for case in ragged:
        x, wt, m, b, epi, kw = qconv_inputs(g, case)
        if kw["pool"]:  # an odd input: the pool drops the last row/column
            x = i8(g, (x.shape[0], x.shape[1] + 1, x.shape[2] + 1,
                       x.shape[3]), lo=0)
        _, _, same = equal_plain(qconv.qconv, qconv.qconv_plain, x, wt, m, b,
                                 epi, kw)
        check(same, f"qconv {case[0]} differs")
        pl = qconv.plan_of(x, wt, epi, pool=kw["pool"], x2=kw.get("x2"),
                           w2=kw.get("w2"))
        print(f"check qconv {case[0]} {tuple(x.shape)} equal {plan_line(pl)}")
    print(f"check qconv ragged shapes equal: {[c[0] for c in ragged]}")


def qconv_t_plan_line(x, wt):
    pl = qconv_t.plan_of(x, wt)
    return (f"{plan_line(pl)} "
            f"store={qconv_t.store_route(wt.shape[2], pl.bn)}")


def check_qconv_t(rows, card):
    """K12 at the four decoder upsamples of the flagship int8 detect, EQUAL
    to its plain version, each launch's plan printed, timed warm and cold
    beside its plain version, cuDNN's bf16 F.conv_transpose2d and
    torch._int_mm of the same GEMM; then ragged shapes (odd h and w, Cin off
    the 16-byte grid, Cout off the 8-column grid: byte stores, BN 64, TMA
    stores clipped at odd h and w) and 16-row tiles across images of 8 × 8
    equal too."""
    row = rows["qconv_t"]
    g = torch.Generator("cuda").manual_seed(21)
    n, f = B * T, 64

    def make(h, cin, cout):
        return (i8(g, (n, h, h, cin), lo=0), i8(g, (2, 2, cout, cin)),
                qscale(g, cout, cin, 80.0),
                torch.randn(cout, device="cuda", generator=g))

    for lv, cin in ((4, 16 * f), (3, 8 * f), (2, 4 * f), (1, 2 * f)):
        h = S // 2 >> lv
        x, wt, m, b = make(h, cin, cin // 2)
        got = qconv_t.qconv_t(x, wt, m, b)
        want = qconv_t.qconv_t_plain(x, wt, m, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"qconv_t up{lv} differs")
        ms = time_ms(lambda: qconv_t.qconv_t(x, wt, m, b))
        moved = nbytes(x, wt, got) + 8 * (cin // 2)
        ops = 2 * x.numel() * 2 * cin
        cold = time_cold_ms(lambda xx: qconv_t.qconv_t(xx, wt, m, b),
                            cold_sets(lambda i: (make(h, cin, cin // 2)[0],),
                                      moved))
        pms = time_ms(lambda: qconv_t.qconv_t_plain(x, wt, m, b), iters=2,
                      warmup=1)
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        conv_ms = time_ms(lambda: F.conv_transpose2d(xb, wb, stride=2))
        a, bmat = x.reshape(-1, cin), wt.reshape(-1, cin).t()
        mm_ms = time_ms(lambda: torch._int_mm(a, bmat))
        row.add(ms, pms, moved, ops, ops_per_s=INT8_TC_OPS_PER_S,
                yardstick_ms=conv_ms, cold_ms=cold)
        row.int_mm_ms = (row.int_mm_ms or 0.0) + mm_ms
        bms, by = bound(moved, ops, INT8_TC_OPS_PER_S)
        print(f"check qconv_t up{lv} {tuple(x.shape)}->{tuple(got.shape)} "
              f"equal ms={ms:.4f} cold_ms={cold:.4f} plain_ms={pms:.4f} "
              f"cudnn_bf16_ms={conv_ms:.4f} int_mm_ms={mm_ms:.4f} "
              f"bound_ms={bms:.4f} ({by}) share_of_bound={bms / ms:.3f} "
              f"{qconv_t_plan_line(x, wt)} [{card}]")
    # (name, N, h, w, Cin, Cout)
    for name, n, h, w, cin, cout in (("ragged", 3, 5, 7, 40, 24),
                                     ("cout20", 3, 5, 7, 40, 20),
                                     ("bn64", 2, 3, 3, 24, 12),
                                     ("tma_clipped", 3, 5, 7, 128, 64),
                                     ("across_images", 3, 8, 8, 1024, 512)):
        x = i8(g, (n, h, w, cin), lo=0)
        wt, m = i8(g, (2, 2, cout, cin)), qscale(g, cout, cin, 80.0)
        b = torch.randn(cout, device="cuda", generator=g)
        got = qconv_t.qconv_t(x, wt, m, b)
        want = qconv_t.qconv_t_plain(x, wt, m, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"qconv_t {name}: "
              f"{int((got != want).sum())} outputs differ from the plain")
        print(f"check qconv_t {name} {tuple(x.shape)}->{tuple(got.shape)} "
              f"equal {qconv_t_plan_line(x, wt)}")


def check_qcoupling(rows, card):
    """K13 at the flagship couplings (level 48: 64², C 96, four launches a
    roundtrip; levels 192/768: 32², C 384, six), bf16 and f32, on the int8
    ``xi`` K11's trunk conv writes (the main path) and quantizing the half
    itself, EQUAL to its plain version (the count of outputs that differ is
    stated), each plan printed; timed in bf16 on ``xi``, warm and cold,
    beside its plain version and K2 at the same shape (the bf16 embed's
    coupling head); a ragged width equal too."""
    row = rows["qcoupling_head"]
    g = torch.Generator("cuda").manual_seed(22)

    def make(n, hw, c, f, dt):
        z = torch.randn((n, hw, hw, 2 * c), device="cuda", generator=g).to(dt)
        p = {"w2x": i8(g, (2 * c, 1, 1, c)), "w2h": i8(g, (2 * c, 1, 1, f)),
             "m2x": qscale(g, 2 * c, c + f, 1.0),
             "m2h": qscale(g, 2 * c, c + f, 1.0),
             "b2": 0.1 * torch.randn(2 * c, device="cuda", generator=g),
             "s_x": torch.tensor(0.02, device="cuda")}
        xi = qconv.quantize_input(z[..., c:], p["s_x"]).contiguous()
        return z, i8(g, (n, hw, hw, f)), p, xi

    for reps, hw, c, f, n in ((4, S // 4, 96, 128, B), (6, S // 8, 384, 128, B),
                              (1, 5, 40, 24, 2)):
        for dt in (torch.float32, torch.bfloat16):
            z, h1i, p, xi = make(n, hw, c, f, dt)
            xin, x = z[..., c:], z[..., :c]
            want = torch.zeros_like(z)
            qcoupling.qcoupling_head_plain(xin, h1i, p, x, out=want[..., :c])
            for src in (xi, None):
                got = torch.zeros_like(z)
                qcoupling.qcoupling_head(xin, h1i, p, x, out=got[..., :c],
                                         xi=src)
                torch.cuda.synchronize()
                off = int((got != want).sum())
                check(off == 0, f"qcoupling_head C={c} {dt} "
                      f"{'xi' if src is not None else 'quantizing'}: {off} "
                      f"outputs differ from the plain")
            print(f"check qcoupling_head C={c} {dt} outputs_differing=0 on "
                  f"xi and quantizing "
                  f"{plan_line(qcoupling.plan_of(xin, h1i, p, x, xi))}")
            if dt == torch.float32 or reps == 1:
                continue
            o = got[..., :c]
            ms = time_ms(lambda: qcoupling.qcoupling_head(xin, h1i, p, x,
                                                          out=o, xi=xi))
            moved = nbytes(xi, h1i, x, o, p["w2x"], p["w2h"]) + 12 * 2 * c
            ops = 2 * n * hw * hw * 2 * c * (c + f)

            def cold_set(i):
                zz, hh, _, xx = make(n, hw, c, f, dt)
                return zz, hh, xx, torch.empty_like(zz)
            cold = time_cold_ms(
                lambda zz, hh, xx, oo: qcoupling.qcoupling_head(
                    zz[..., c:], hh, p, zz[..., :c], out=oo[..., :c], xi=xx),
                cold_sets(cold_set, moved))
            pms = time_ms(lambda: qcoupling.qcoupling_head_plain(
                xin, h1i, p, x, out=o, xi=xi), iters=3, warmup=1)
            hb = torch.randn((n, hw, hw, f), device="cuda",
                             generator=g).to(dt)
            pk = {"wh": (torch.randn(2 * c, c + f, device="cuda",
                                     generator=g) / (c + f) ** 0.5).to(dt),
                  "bh": 0.1 * torch.randn(2 * c, device="cuda", generator=g)}
            k2 = time_ms(lambda: coupling.coupling_head(xin, hb, pk, x,
                                                        out=o))
            row.add(reps * ms, reps * pms, reps * moved, reps * ops,
                    ops_per_s=INT8_TC_OPS_PER_S, yardstick_ms=reps * k2,
                    cold_ms=reps * cold)
            bms, by = bound(moved, ops, INT8_TC_OPS_PER_S)
            print(f"check qcoupling_head C={c} bf16 M={n * hw * hw} "
                  f"K={c}+{f} N={2 * c} ms={ms:.4f} cold_ms={cold:.4f} "
                  f"plain_ms={pms:.4f} k2_same_shape_ms={k2:.4f} "
                  f"bound_ms={bms:.4f} ({by}) share_of_bound={bms / ms:.3f} "
                  f"(x{reps} per roundtrip) [{card}]")


def check_int8_build(card):
    """Registers, local memory (spills and stack) and the int8 tensor-core
    instructions (IGMMA: ``wgmma`` s8; IMMA: ``mma.sync``) of K11's, K12's
    and K13's kernels in the built library (``kernel_report.library_report``:
    ``cuobjdump``, nothing compiled); fails on local memory or an
    ``mma.sync``, or without ``wgmma``."""
    rows = kernel_report.library_report(
        _lib.library_path(), ("qconv_wgmma", "qconv_t_wgmma",
                              "qcoupling_wgmma"))
    check(len(rows) == 10, f"expected 10 K11/K12/K13 kernels, found "
          f"{len(rows)}")
    for r in rows:
        ops = r["ops"]
        print(f"kernel_report {r['kernel']} registers={r['registers']} "
              f"local_bytes={r['local_bytes']} stack_bytes={r['stack_bytes']} "
              f"IGMMA={ops['IGMMA']} IMMA={ops['IMMA']} [{card}]")
        check(ops["IGMMA"] > 0 and ops["IMMA"] == 0,
              f"{r['kernel']}: expected wgmma s8 and no mma.sync")
        check(r["local_bytes"] == 0 and r["stack_bytes"] == 0,
              f"{r['kernel']} spills (local memory)")


def check_stem(rows, card):
    """K3's int8 stem (``to_s2d_i8``, and ``to_u8_s2d_i8``, the int8
    roundtrip's hand-over) at the flagship, EQUAL to the plain versions,
    tiled and general paths; timed warm and cold beside the plain
    version."""
    row = rows["wire_i8"]
    g = torch.Generator("cuda").manual_seed(23)
    for b, h, w in ((B, S, S), (2, 100, 100)):
        clip, x = wire_inputs(b, h, w, torch.bfloat16, g)
        flat = clip.reshape(b * T, h, w, 3)
        flat.view(-1)[:256] = torch.arange(256, device="cuda",
                                           dtype=torch.uint8)
        check(torch.equal(wire.to_s2d_i8(flat, 2),
                          wire.to_s2d_i8_plain(flat, 2)),
              f"wire to_s2d_i8 {w} differs")
        (u8, zi), (u8p, zip_) = (fn(x, T, 2) for fn in (
            wire.to_u8_s2d_i8, wire.to_u8_s2d_i8_plain))
        check(torch.equal(u8, u8p) and torch.equal(zi, zip_),
              f"wire to_u8_s2d_i8 {w} differs")
    print("check wire int8 stem exact: to_s2d_i8 to_u8_s2d_i8, tiled (256) "
          "and general (100) paths, all 256 byte levels")
    clip, x = wire_inputs(B, S, S, torch.bfloat16, g)
    flat = clip.reshape(B * T, S, S, 3)
    for name, fn, plain, args, make in (
            ("to_s2d_i8", wire.to_s2d_i8, wire.to_s2d_i8_plain, (flat, 2),
             lambda i: (wire_inputs(B, S, S, torch.bfloat16, g)[0].reshape(
                 B * T, S, S, 3), 2)),
            ("to_u8_s2d_i8", wire.to_u8_s2d_i8, wire.to_u8_s2d_i8_plain,
             (x, T, 2), lambda i: (wire_inputs(B, S, S, torch.bfloat16,
                                               g)[1], T, 2))):
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        moved = nbytes(args[0], *outs)
        ms = time_ms(lambda: fn(*args))
        cold = time_cold_ms(fn, cold_sets(make, moved))
        pms = time_ms(lambda: plain(*args))
        if name == "to_s2d_i8":  # the int8 detect's launch
            row.add(ms, pms, moved, 3 * flat.numel(), cold_ms=cold)
        bms = bound(moved, 0)[0]
        print(f"check wire {name} ms={ms:.4f} cold_ms={cold:.4f} "
              f"plain_ms={pms:.4f} bound_ms={bms:.4f} "
              f"share_of_bound={bms / ms:.3f} [{card}]")


# ------------------------------------------------------------ phase 3, INN
# module path


# the refshape embed's Haar levels, each with one down and one up per
# roundtrip, by their full-resolution side (batch 16): 12 channels at 256²,
# 48 at 128², 192 at 64²; and down_num 4's 768 → 3072 level at a small
# N·H·W
HAAR_LEVELS = [(B, S, S, 3 * T), (B, S // 2, S // 2, 12 * T),
               (B, S // 4, S // 4, 48 * T)]
HAAR_WIDE = (2, 16, 16, 768)
HAAR_OPS = 5  # per output: four adds or subtractions and the product by ½


def ulp_f32(x):
    """One float32 ulp at max|x|."""
    return 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 23)


def check_haar(rows, card):
    """K14 at the refshape serving shapes and at 3072 channels: down and up,
    f32 and bf16, EQUAL to the plain version; up(down(x)) within one f32
    ulp of max|x|; bf16 timed warm and with a cold L2 beside the plain
    version and the library call, one grouped ``F.conv2d`` /
    ``F.conv_transpose2d`` with the fixed ±½ bank."""
    row = rows["haar"]
    dev = torch.device("cuda")
    g = torch.Generator("cuda").manual_seed(31)
    for full in HAAR_LEVELS + [HAAR_WIDE]:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(full, device=dev, generator=g).to(dt)
            y = haar.haar(x)
            back = haar.haar(y, transpose=True)
            yp, bp = haar.haar_plain(x), haar.haar_plain(y, transpose=True)
            torch.cuda.synchronize()
            check(torch.equal(y, yp) and torch.equal(back, bp),
                  f"haar {full} {dt} differs from its plain version")
            if dt == torch.float32:
                inv, ulp = float((back - x).abs().max()), ulp_f32(x)
                check(inv <= ulp, f"haar {full}: up(down(x)) off by {inv}, "
                      f"more than one ulp ({ulp})")
                print(f"check haar {full} f32 equal (down and up); "
                      f"|up(down(x)) - x| max {inv:.3g} <= ulp {ulp:.3g}")
                continue
            c = full[-1]
            w = torch.from_numpy(ops_haar._bank(c)).to(dev, dt)
            for transpose, src, out in ((False, x, y), (True, y, back)):
                xc = src.permute(0, 3, 1, 2)
                lib = ((lambda: F.conv_transpose2d(xc, w, stride=2, groups=c))
                       if transpose else
                       (lambda: F.conv2d(xc, w, stride=2, groups=c)))
                ms = time_ms(lambda: haar.haar(src, transpose))
                cold = time_cold_ms(
                    lambda v: haar.haar(v, transpose),
                    cold_sets(lambda i: (torch.randn(
                        src.shape, device=dev, generator=g).to(dt),),
                        nbytes(src, out)))
                pms = time_ms(lambda: haar.haar_plain(src, transpose))
                lms = time_ms(lib)
                moved, ops = nbytes(src, out), HAAR_OPS * out.numel()
                if full != HAAR_WIDE:  # the roundtrip's six launches
                    row.add(ms, pms, moved, ops, lms, cold_ms=cold)
                bms = bound(moved, ops)[0]
                print(f"check haar {'up' if transpose else 'down'} bf16 "
                      f"{tuple(src.shape)}->{tuple(out.shape)} equal "
                      f"ms={ms:.4f} cold_ms={cold:.4f} plain_ms={pms:.4f} "
                      f"library_ms={lms:.4f} bound_ms={bms:.4f} "
                      f"share_of_bound={bms / ms:.3f} [{card}]")


# the refshape embed's ten affines: per coupling (batch 16) the spatial
# size and the half's channels, down 24 @128², 96 @64², 384 @32², up 96
# @64², 24 @128²; two launches a coupling
AFFINE_LEVELS = [(S // 2, 24), (S // 4, 96), (S // 8, 384), (S // 4, 96),
                 (S // 2, 24)]
AFFINE_OPS = (20, 24)  # per value: forward, backward
AFFINE_GRAD_RTOL = 1e-6  # f32 gradients, of the plain gradient's max


def within_ulp(got, want, dtype):
    """|got − want| ≤ one ulp of want, elementwise (bf16 keeps 7 stored
    mantissa bits, f32 23)."""
    bits = 7 if dtype == torch.bfloat16 else 23
    want, got = want.float(), got.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), (e - 1 - bits))
    return bool(((got - want).abs() <= ulp).all())


def affine_case(g, hw, c, dt, fused, batch=B):
    """A coupling input z (its first half x) and a subnet output: one head
    tensor (s ‖ t) or two."""
    z = torch.randn(batch, hw, hw, 2 * c, device="cuda", generator=g).to(dt)
    head = torch.randn(batch, hw, hw, 2 * c, device="cuda",
                       generator=g).to(dt)
    st = head if fused else (head[..., :c].contiguous(),
                             head[..., c:].contiguous())
    return z, st


def affine_grads(fn, st, x, inverse, cot):
    """∂x, then ∂head (fused) or ∂s, ∂t, of ``fn``'s output against
    ``cot``."""
    leaves = [x.detach().clone().requires_grad_()]
    if isinstance(st, torch.Tensor):
        leaves.append(st.detach().clone().requires_grad_())
        arg = leaves[1]
    else:
        leaves += [v.detach().clone().requires_grad_() for v in st]
        arg = (leaves[1], leaves[2])
    out = fn(arg, leaves[0], inverse=inverse)
    return torch.autograd.grad(out, leaves, cot)


def check_affine(rows, card):
    """K15 at the five refshape coupling shapes: forward and inverse, fused
    and split (s, t), f32 and bf16, the output within one ulp of the plain
    version and every gradient within ``AFFINE_GRAD_RTOL`` of the plain
    gradient's max (f32) or within ``TOL`` (one bf16 ulp); the bf16 fused
    forward and its backward kernel timed warm and with a cold L2 beside
    the plain version and ``torch.addcmul``."""
    row = rows["coupling_affine"]
    g = torch.Generator("cuda").manual_seed(37)
    seen, bwd_ms, bwd_bound = {}, 0.0, 0.0
    for hw, c in AFFINE_LEVELS:
        if (hw, c) not in seen:
            for dt in (torch.float32, torch.bfloat16):
                for fused in (True, False):
                    z, st = affine_case(g, hw, c, dt, fused)
                    x = z[..., :c]
                    for inverse in (False, True):
                        out, ref = torch.empty_like(z), torch.empty_like(z)
                        affine.coupling_affine(st, x, out=out[..., c:],
                                               inverse=inverse)
                        affine.coupling_affine_plain(st, x, out=ref[..., c:],
                                                     inverse=inverse)
                        cot = torch.randn(x.shape, device="cuda",
                                          generator=g).to(dt)
                        gk = affine_grads(affine.coupling_affine, st, x,
                                          inverse, cot)
                        gp = affine_grads(affine.coupling_affine_plain, st, x,
                                          inverse, cot)
                        torch.cuda.synchronize()
                        what = (f"coupling_affine {(B, hw, hw, c)} {dt} "
                                f"{'fused' if fused else 'split'} "
                                f"{'inverse' if inverse else 'forward'}")
                        check(within_ulp(out[..., c:], ref[..., c:], dt),
                              f"{what}: more than one ulp from plain")
                        err = float((out[..., c:].float()
                                     - ref[..., c:].float()).abs().max())
                        gerr = 0.0
                        for a, b in zip(gk, gp):
                            d = float((a.float() - b.float()).abs().max())
                            scale = float(b.float().abs().max()) or 1.0
                            gerr = max(gerr, d / scale)
                            ok = (d <= AFFINE_GRAD_RTOL * scale
                                  if dt == torch.float32
                                  else rel_err(a, b, dt)[1])
                            check(ok, f"{what}: gradient off by {d} (max "
                                  f"{scale})")
                        if dt == torch.bfloat16:
                            row.err = max(row.err, err)
                        print(f"check {what} max_abs_err={err} "
                              f"grad_err_of_max={gerr:.3g}")
            # timing, bf16, fused (the refshape subnets' heads)
            dt = torch.bfloat16
            z, head = affine_case(g, hw, c, dt, True)
            x, o = z[..., :c], torch.empty_like(z)[..., c:]
            s_, t_ = affine.split_head(head)
            ms = time_ms(lambda: affine.coupling_affine(head, x, out=o))
            cold = time_cold_ms(
                lambda zz, hd, oo: affine.coupling_affine(
                    hd, zz[..., :c], out=oo[..., c:]),
                cold_sets(lambda i: affine_case(g, hw, c, dt, True)
                          + (torch.empty_like(z),), nbytes(z, head)))
            pms = time_ms(lambda: affine.coupling_affine_plain(head, x,
                                                               out=o))
            yms = time_ms(lambda: torch.addcmul(t_, affine_e(s_), x))
            moved = nbytes(s_, t_, x, o)
            cot = torch.randn(x.shape, device="cuda", generator=g).to(dt)
            dhead, dx = torch.empty_like(head), torch.empty_like(x)
            ds_, dt_ = affine.split_head(dhead)
            bms_ = time_ms(lambda: affine._launch_backward(
                cot, s_, t_, x, ds_, dt_, False))
            b_moved = nbytes(cot, s_, x, dx, ds_, dt_)
            seen[(hw, c)] = (ms, pms, moved, cold, yms, bms_, b_moved)
            bd, bb = bound(moved, AFFINE_OPS[0] * x.numel()), bound(
                b_moved, AFFINE_OPS[1] * x.numel())
            print(f"check coupling_affine bf16 fused {(B, hw, hw, c)} "
                  f"ms={ms:.4f} cold_ms={cold:.4f} plain_ms={pms:.4f} "
                  f"addcmul_ms={yms:.4f} bound_ms={bd[0]:.4f} "
                  f"share_of_bound={bd[0] / ms:.3f}; backward ms={bms_:.4f} "
                  f"bound_ms={bb[0]:.4f} share_of_bound={bb[0] / bms_:.3f} "
                  f"[{card}]")
        ms, pms, moved, cold, yms, bms_, b_moved = seen[(hw, c)]
        n = x_numel = B * hw * hw * c
        row.add(2 * ms, 2 * pms, 2 * moved, 2 * AFFINE_OPS[0] * n,
                yardstick_ms=2 * yms, cold_ms=2 * cold)
        bwd_ms += 2 * bms_
        bwd_bound += 2 * bound(b_moved, AFFINE_OPS[1] * x_numel)[0]
    row.extra = {"backward_ms": bwd_ms, "backward_bound_ms": bwd_bound,
                 "backward_timed_per": "refshape_train_step at batch 16"}


def check_down_num_4(rows, card):
    """F20, repaired: the packed INN at down_num 4 (its 768 → 3072-channel
    level is K14, that coupling an unpacked K2 head with K = 1664) at batch
    2, 64², in float32 and bf16, each within ``TOL`` of the plain versions
    with its launch counts; then K2 alone on the 3072-channel head in bf16
    (W streamed through the ring beside A: its column slice does not fit
    shared memory), forward and inverse against the plain version, and
    timed at the level's size for a 256² clip at batch 16 (M = 4096)."""
    from vwfd_tpu_torch.nets import InvertibleNet
    g = torch.Generator("cuda").manual_seed(47)
    x = torch.rand(2, 64, 64, 12, device="cuda", generator=g)
    for dt in (torch.float32, torch.bfloat16):
        cdt = None if dt == torch.float32 else dt
        net = InvertibleNet(12, 4, (1, 1, 1, 1), dtype=cdt)
        net.init_params(torch.Generator().manual_seed(5))
        with torch.no_grad():
            for k, v in net.state_dict().items():
                if ".Conv_2." in k:
                    v.add_(1e-3 * torch.randn(v.shape, generator=torch.
                                              Generator().manual_seed(6)))
        ref = InvertibleNet(12, 4, (1, 1, 1, 1), dtype=cdt, kernels=PLAIN)
        ref.load_state_dict(net.state_dict())
        net, ref = net.cuda(), ref.cuda()
        reset_launch_counts()
        with torch.no_grad():
            y = net(x, out_f32=False)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        with torch.no_grad():
            want = ref(x, out_f32=False)
        err, ok = rel_err(y, want, dt)
        check(ok and counts == {"transition": 6, "coupling_head": 14,
                                "haar": 2},
              f"down_num 4 {dt}: err {err}, launches {counts}")
        print(f"check down_num 4 {dt} (2, 64, 64, 12): max_abs_err={err} "
              f"vs the plain versions; launches {json.dumps(counts)} "
              f"[{card}]")

    row = rows["coupling_head"]
    c, f, hw = 1536, 128, 16
    k = c + f
    dt = torch.bfloat16
    z = torch.randn(B, hw, hw, 2 * c, device="cuda", generator=g).to(dt)
    h = torch.randn(B, hw, hw, f, device="cuda", generator=g).to(dt)
    p = {"wh": (torch.randn(2 * c, k, device="cuda", generator=g)
                / k ** 0.5).to(dt),
         "bh": 0.1 * torch.randn(2 * c, device="cuda", generator=g)}
    xin, xx = z[..., c:], z[..., :c]
    err = 0.0
    for inverse in (False, True):
        out, ref = torch.empty_like(z), torch.empty_like(z)
        coupling.coupling_head(xin, h, p, xx, out=out[..., :c],
                               inverse=inverse)
        coupling.coupling_head_plain(xin, h, p, xx, out=ref[..., :c],
                                     inverse=inverse)
        torch.cuda.synchronize()
        e, ok = rel_err(out[..., :c], ref[..., :c], dt)
        check(ok, f"coupling_head 3072 bf16 inverse={inverse}: {e}")
        err = max(err, e)
    o = out[..., :c]
    ms = time_ms(lambda: coupling.coupling_head(xin, h, p, xx, out=o))
    pms = time_ms(lambda: coupling.coupling_head_plain(xin, h, p, xx, out=o))
    cat_mm = time_ms(lambda: torch.matmul(
        torch.cat([xin, h], -1).reshape(-1, k), p["wh"].t()))
    m = B * hw * hw
    bms, by = bound(nbytes(xin, h, xx, o, p["wh"], p["bh"]),
                    2 * m * k * 2 * c, BF16_TC_OPS_PER_S)
    row.extra["f20_3072_bf16"] = {
        "M": m, "K": k, "N": 2 * c, "max_abs_err": err, "ms": ms,
        "plain_ms": pms, "yardstick_ms": cat_mm, "bound_ms": bms,
        "bound_by": by}
    print(f"check coupling_head z=3072 bf16 (F20, W streamed) M={m} K={k} "
          f"N={2 * c}: max_abs_err={err} ms={ms:.4f} plain_ms={pms:.4f} "
          f"cat_matmul_ms={cat_mm:.4f} bound_ms={bms:.4f} ({by}) "
          f"share_of_bound={bms / ms:.3f} [{card}]")


# ------------------------------------------------------------ phase 3,
# HiDDeN

# K16 vs plain: forward within ZIGZAG_ATOL (the DCT sums in another order
# than torch.matmul), gradients within FUSED_GRAD_RTOL of the plain max
ZIGZAG_ATOL = 2e-6
HID_B, HID_S = 8, 128            # HiDDeN's path: b8, 128², f32
HID_SHAPE = (HID_B, HID_S, HID_S, 3)
# per value: colour 5, four 8-term DCT passes 64, mask 1, colour 5, clip 2
# forward; backward the clip's derivative 1, then the transposed chain 75
ZIGZAG_OPS = (77, 76)
CROP_OPS = (9, 9)                # per output: 6 products, 3 sums


def zigzag_input(g, shape):
    """Values in [-0.1, 1.1) (the clip acts on both sides) with the first
    8×8 block of frame 0 all 0 (z = 0 exactly: the clip's ½ tie) and the
    second all 2 (z far above 1: gradient 0)."""
    x = torch.rand(shape, device="cuda", generator=g) * 1.2 - 0.1
    x[0, :8, :8] = 0.0
    if shape[2] >= 16:
        x[0, :8, 8:16] = 2.0
    return x


def zigzag_jax_form(x, clip=True):
    """The yardstick: the JAX package's own form of the same function, the
    analog colour maps around two dense block-diagonal products (I ⊗ C8)
    per direction, the tiled mask and the clip."""
    from vwfd_tpu_torch.ops.color import rgb_to_yuv_analog, yuv_to_rgb_analog
    from vwfd_tpu_torch.ops.dct import dct_matrix, zigzag_keep_mask
    n, hh, ww, _ = x.shape
    c8 = dct_matrix(x.device)
    dh = torch.kron(torch.eye(hh // 8, device=x.device), c8)
    dw = torch.kron(torch.eye(ww // 8, device=x.device), c8)
    m = torch.from_numpy(np.stack([zigzag_keep_mask(8, kk, hh, ww)
                                   for kk in zigzag.HIDDEN_KEEP])).to(x.device)
    yuv = rgb_to_yuv_analog(x).movedim(-1, -3)
    coeff = torch.matmul(torch.matmul(dh, yuv), dw.t()) * m
    out = torch.matmul(torch.matmul(dh.t(), coeff), dw).movedim(-3, -1)
    rgb = yuv_to_rgb_analog(out)
    return zigzag.clip01(rgb) if clip else rgb


def copy_yardsticks(shape):
    """The launch floor at ``shape`` f32, timed as the kernels are: a
    forward's (``Tensor.copy_``: one read, one write) and a backward's
    (``torch.add(a, b, out=c)``: two reads, one write)."""
    a, b, c = (torch.rand(shape, device="cuda") for _ in range(3))
    return time_ms(lambda: c.copy_(a)), time_ms(
        lambda: torch.add(a, b, out=c))


def nonfinite_input(g, shape, nan_at, inf_at, cot_nan_at, lo=0.0, hi=1.0,
                    out_shape=None):
    """(x, cotangent of ``out_shape``, default x's) with a NaN and an +Inf
    value in x and a NaN in the cotangent."""
    x = lo + (hi - lo) * torch.rand(shape, device="cuda", generator=g)
    cot = torch.randn(out_shape or shape, device="cuda", generator=g)
    x[nan_at] = float("nan")
    x[inf_at] = float("inf")
    cot[cot_nan_at] = float("nan")
    return x, cot


def check_nonfinite(what, fn, plain, x, cot, fwd_atol):
    """Kernel and plain version at a non-finite input: forward and
    gradient NaN at the same places (and ±Inf where the plain version's
    are), the rest within ``fwd_atol`` (0: EQUAL) forward and
    ``FUSED_GRAD_RTOL`` of the plain gradient's finite max backward."""
    (yk,), (gk,) = grads_of(fn, [x], [True], cot)
    (yp,), (gp,) = grads_of(plain, [x], [True], cot)
    torch.cuda.synchronize()
    for name, k, p in (("forward", yk, yp), ("gradient", gk, gp)):
        check(torch.equal(k.isnan(), p.isnan()) and torch.equal(
            k.isinf(), p.isinf()) and torch.equal(k[k.isinf()], p[p.isinf()]),
            f"{what} {name}: NaN or Inf at other places than the plain "
            f"version's ({int(k.isnan().sum())} vs {int(p.isnan().sum())} "
            f"NaN)")
    fin = yp.isfinite()
    fe = float((yk[fin] - yp[fin]).abs().max())
    check(fe <= fwd_atol, f"{what} forward: {fe}")
    fin = gp.isfinite()
    ge = float((gk[fin] - gp[fin]).abs().max())
    gmax = float(gp[fin].abs().max())
    check(ge <= FUSED_GRAD_RTOL * gmax, f"{what} gradient: {ge}")
    print(f"check {what}: NaN {int(yp.isnan().sum())} forward, "
          f"{int(gp.isnan().sum())} gradient, at the plain version's "
          f"places; finite forward max_abs_err={fe:.3g}, gradient "
          f"{ge:.3g} (plain max {gmax:.3g})")
    return max(fe, ge)


def check_zigzag(rows, card):
    """K16: forward within ``ZIGZAG_ATOL`` and the input gradient within
    ``FUSED_GRAD_RTOL`` of the plain max, with and without the clip, at
    HiDDeN's shape, a ragged one and one 8×8 block, the clip's ½ tie and
    its 0 included; NaN / Inf pixels and a NaN cotangent NaN where the
    plain version's are; timed forward + backward (the train step's
    launches) warm and with a cold L2 beside the plain version, the JAX
    form (yardstick) and the copy yardsticks."""
    row = rows["zigzag_jpeg"]
    g = torch.Generator("cuda").manual_seed(61)
    err = 0.0
    for shape in (HID_SHAPE, (3, 40, 24, 3), (1, 8, 8, 3)):
        x = zigzag_input(g, shape)
        cot = torch.randn(shape, device="cuda", generator=g)
        for clip in (False, True):
            (yk,), (gk,) = grads_of(lambda v: zigzag.zigzag_jpeg(
                v, clip=clip), [x], [True], cot)
            (yp,), (gp,) = grads_of(lambda v: zigzag.zigzag_jpeg_plain(
                v, clip=clip), [x], [True], cot)
            torch.cuda.synchronize()
            fe = float((yk - yp).abs().max())
            ge = float((gk - gp).abs().max())
            check(fe <= ZIGZAG_ATOL, f"zigzag {shape} clip={clip}: {fe}")
            check(ge <= FUSED_GRAD_RTOL * float(gp.abs().max()),
                  f"zigzag {shape} clip={clip} gradient: {ge}")
            if clip:
                # the zero block's z is exactly 0 on both paths: its
                # gradient is exactly ½ of the unclipped one (jnp.clip's
                # tie; the block's map is linear and ½ rounds nothing); the
                # block of 2s has none
                for fn, g_ in ((zigzag.zigzag_jpeg, gk),
                               (zigzag.zigzag_jpeg_plain, gp)):
                    _, (free,) = grads_of(fn, [x], [True], cot)
                    check(torch.equal(g_[0, :8, :8], 0.5 * free[0, :8, :8])
                          and not bool(g_[0, :8, 8:16].any()),
                          f"zigzag clip ties: {fn.__name__}")
            err = max(err, fe, ge)
            print(f"check zigzag_jpeg {shape} f32 clip={clip}: forward "
                  f"max_abs_err={fe:.3g} gradient max_abs_err={ge:.3g} "
                  f"(plain max {float(gp.abs().max()):.3g})")
    for clip in (False, True):
        x, cot = nonfinite_input(g, HID_SHAPE, (0, 3, 5, 1), (2, 70, 33, 0),
                                 (5, 100, 17, 2), -0.1, 1.1)
        err = max(err, check_nonfinite(
            f"zigzag_jpeg non-finite clip={clip}",
            lambda v: zigzag.zigzag_jpeg(v, clip=clip),
            lambda v: zigzag.zigzag_jpeg_plain(v, clip=clip), x, cot,
            ZIGZAG_ATOL))
    row.err = err
    nb = nbytes(torch.empty(HID_SHAPE))
    sets = cold_sets(lambda i: (zigzag_input(g, HID_SHAPE), torch.randn(
        HID_SHAPE, device="cuda", generator=g)), 3 * nb)
    fn = lambda v: zigzag.zigzag_jpeg(v, clip=True)  # noqa: E731
    kf, kb, cf, cb = fused_times(fn, sets, [True])
    pf, pb, _, _ = fused_times(lambda v: zigzag.zigzag_jpeg_plain(
        v, clip=True), sets[:1], [True])
    yf, yb, _, _ = fused_times(zigzag_jax_form, sets[:1], [True])
    copy_ms, add_ms = copy_yardsticks(HID_SHAPE)
    # the bytes the design moves: forward x, y and the clip's byte codes
    # (nb / 4); backward the codes, g and gx
    launch_bytes = 2 * nb + nb // 4
    moved = 2 * launch_bytes
    ops = HID_B * HID_S * HID_S * 3 * sum(ZIGZAG_OPS)
    row.add(kf + kb, pf + pb, moved, ops, yardstick_ms=yf + yb,
            cold_ms=cf + cb)
    row.extra.update({"copy_yardstick_ms": {"fwd": copy_ms, "bwd": add_ms},
                      "fwd_ms": kf, "bwd_ms": kb})
    bf = bb = bound(launch_bytes, 0)[0]
    print(f"check zigzag_jpeg {HID_SHAPE} ms fwd={kf:.5f} bwd={kb:.5f} cold "
          f"fwd={cf:.5f} bwd={cb:.5f} plain fwd={pf:.4f} bwd={pb:.4f} "
          f"jax_form_yardstick fwd={yf:.4f} bwd={yb:.4f} copy_yardstick "
          f"fwd={copy_ms:.5f} bwd={add_ms:.5f} bound_ms fwd={bf:.5f} "
          f"bwd={bb:.5f} share_of_bound fwd={bf / kf:.3f} bwd={bb / kb:.3f} "
          f"[{card}]")


CROP_APEXES = [(10.0, 100.0, 3.0, 128.0), (0.0, 128.0, 0.0, 128.0),
               (57.0, 128.0, 0.0, 71.0), (30.0, 31.0, 64.0, 65.0)]
# (shape, apex, out_hw): HiDDeN's shape at each window above; a ragged
# batch and size; rows of 120 bytes (not a multiple of 16: the element-wise
# copies) with the window at the right edge; another output size
CROP_CASES = [(HID_SHAPE, a, None) for a in CROP_APEXES] + [
    ((3, 40, 24, 3), (5.0, 27.0, 0.0, 13.0), None),
    ((2, 24, 10, 3), (3.0, 20.0, 4.0, 10.0), None),
    ((2, 40, 24, 3), (6.0, 38.0, 2.0, 21.0), (32, 48))]


def check_crop_resize(rows, card):
    """K17: forward EQUAL to the plain version and the input gradient
    within ``FUSED_GRAD_RTOL`` of the plain max and bit-identical over two
    calls, at ``CROP_CASES`` (HiDDeN's shape at windows at the edges, the
    whole image and a single pixel; a ragged one; rows off the 16-byte grid;
    another output size); NaN / Inf pixels and a NaN cotangent NaN where
    the plain version's are; timed forward + backward warm and with a cold
    L2 beside the plain version, ``F.interpolate`` of the sliced window
    (the library call of the same function, its window on the host) and
    the copy yardsticks."""
    row = rows["crop_resize"]
    g = torch.Generator("cuda").manual_seed(62)
    err = 0.0
    for shape, apex, out_hw in CROP_CASES:
        x = torch.rand(shape, device="cuda", generator=g)
        oshape = shape if out_hw is None else (shape[0], *out_hw, shape[3])
        cot = torch.randn(oshape, device="cuda", generator=g)
        ap = torch.tensor(apex, device="cuda")
        fn = lambda v: crop_resize.crop_resize(v, ap, out_hw)  # noqa: E731
        (yk,), (gk,) = grads_of(fn, [x], [True], cot)
        (yp,), (gp,) = grads_of(lambda v: crop_resize.crop_resize_plain(
            v, ap, out_hw), [x], [True], cot)
        _, (gk2,) = grads_of(fn, [x], [True], cot)
        torch.cuda.synchronize()
        ge = float((gk - gp).abs().max())
        what = f"crop_resize {shape} apex {apex} out_hw {out_hw}"
        check(torch.equal(yk, yp), f"{what}: forward differs by "
              f"{float((yk - yp).abs().max())}")
        check(ge <= FUSED_GRAD_RTOL * float(gp.abs().max()),
              f"{what} gradient: {ge}")
        check(torch.equal(gk, gk2), f"{what}: gradient not deterministic")
        err = max(err, ge)
        print(f"check {what}: forward equal to plain; gradient "
              f"max_abs_err={ge:.3g} (plain max {float(gp.abs().max()):.3g}),"
              f" equal over two calls")
    for shape, apex, out_hw, at in (
            (HID_SHAPE, CROP_APEXES[0], None,
             ((1, 40, 50, 0), (3, 99, 3, 2), (6, 20, 127, 1))),
            ((2, 40, 24, 3), (6.0, 38.0, 2.0, 21.0), (32, 48),
             ((0, 6, 2, 1), (1, 37, 20, 0), (1, 31, 47, 2)))):
        oshape = shape if out_hw is None else (shape[0], *out_hw, shape[3])
        x, cot = nonfinite_input(g, shape, *at, out_shape=oshape)
        ap = torch.tensor(apex, device="cuda")
        err = max(err, check_nonfinite(
            f"crop_resize non-finite {shape} apex {apex} out_hw {out_hw}",
            lambda v: crop_resize.crop_resize(v, ap, out_hw),
            lambda v: crop_resize.crop_resize_plain(v, ap, out_hw), x, cot,
            0.0))
    row.err = err
    apex = CROP_APEXES[0]
    ap = torch.tensor(apex, device="cuda")
    nb = nbytes(torch.empty(HID_SHAPE))
    sets = cold_sets(lambda i: (torch.rand(HID_SHAPE, device="cuda",
                                           generator=g),
                                torch.randn(HID_SHAPE, device="cuda",
                                            generator=g)), 3 * nb)
    kf, kb, cf, cb = fused_times(lambda v: crop_resize.crop_resize(v, ap),
                                 sets, [True])
    pf, pb, _, _ = fused_times(lambda v: crop_resize.crop_resize_plain(
        v, ap), sets[:1], [True])
    h0, h1, w0, w1 = (int(a) for a in apex)
    lf, lb, _, _ = fused_times(lambda v: F.interpolate(
        v.permute(0, 3, 1, 2)[..., h0:h1, w0:w1], size=(HID_S, HID_S),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1),
        sets[:1], [True])
    copy_ms, add_ms = copy_yardsticks(HID_SHAPE)
    window = nb * (h1 - h0) * (w1 - w0) // (HID_S * HID_S)
    moved = window + nb + 2 * nb  # forward window, y; backward g, gx
    ops = HID_B * HID_S * HID_S * 3 * sum(CROP_OPS)
    row.add(kf + kb, pf + pb, moved, ops, library_ms=lf + lb,
            cold_ms=cf + cb)
    row.extra.update({"copy_yardstick_ms": {"fwd": copy_ms, "bwd": add_ms},
                      "fwd_ms": kf, "bwd_ms": kb})
    bf, bb = bound(window + nb, 0)[0], bound(2 * nb, 0)[0]
    print(f"check crop_resize {HID_SHAPE} apex {apex} ms fwd={kf:.5f} "
          f"bwd={kb:.5f} cold fwd={cf:.5f} bwd={cb:.5f} plain fwd={pf:.4f} "
          f"bwd={pb:.4f} F.interpolate_library fwd={lf:.4f} bwd={lb:.4f} "
          f"copy_yardstick fwd={copy_ms:.5f} bwd={add_ms:.5f} "
          f"bound_ms fwd={bf:.5f} bwd={bb:.5f} share_of_bound "
          f"fwd={bf / kf:.3f} bwd={bb / kb:.3f} [{card}]")
    row.extra["wide"] = check_crop_resize_wide(g, card)


def check_crop_resize_wide(g, card):
    """K17 past the whole-row limit on column tiles (F22): twice the widest
    8-row RGB rows a CTA holds whole and a 3840 × 2160 frame with an
    off-centre window, forward EQUAL, gradient within ``FUSED_GRAD_RTOL``
    of the plain max and bit-identical over two calls; each timed forward +
    backward warm and cold beside the plain version and ``F.interpolate``
    of the sliced window, with its bytes bound."""
    mw = crop_resize.max_width(8, 3, 8)
    out = {}
    for name, shape, apex in (
            ("2*max_width", (1, 8, 2 * mw, 3), (1.0, 7.0, 5.0, 2 * mw - 3.0)),
            ("3840x2160", (1, 2160, 3840, 3), (301.0, 1901.0, 517.0,
                                               3333.0))):
        _, h, w, c = shape
        tw, tq = crop_resize.tiles(h, w, c, h, w)
        x = torch.rand(shape, device="cuda", generator=g)
        cot = torch.randn(shape, device="cuda", generator=g)
        ap = torch.tensor(apex, device="cuda")
        fn = lambda v: crop_resize.crop_resize(v, ap)  # noqa: E731
        pfn = lambda v: crop_resize.crop_resize_plain(v, ap)  # noqa: E731
        (yk,), (gk,) = grads_of(fn, [x], [True], cot)
        (yp,), (gp,) = grads_of(pfn, [x], [True], cot)
        _, (gk2,) = grads_of(fn, [x], [True], cot)
        torch.cuda.synchronize()
        ge = float((gk - gp).abs().max())
        check(torch.equal(yk, yp), f"crop_resize {name}: forward differs")
        check(ge <= FUSED_GRAD_RTOL * float(gp.abs().max()),
              f"crop_resize {name} gradient: {ge}")
        check(torch.equal(gk, gk2), f"crop_resize {name}: gradient not "
              f"deterministic")
        nb = nbytes(x)
        sets = cold_sets(lambda i: (torch.rand(shape, device="cuda",
                                               generator=g),
                                    torch.randn(shape, device="cuda",
                                                generator=g)), 3 * nb)
        kf, kb, cf, cb = fused_times(fn, sets, [True])
        pf, pb, _, _ = fused_times(pfn, sets[:1], [True])
        h0, h1, w0, w1 = (int(a) for a in apex)
        lf, lb, _, _ = fused_times(lambda v: F.interpolate(
            v.permute(0, 3, 1, 2)[..., h0:h1, w0:w1], size=(h, w),
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1),
            sets[:1], [True])
        window = nb * (h1 - h0) * (w1 - w0) // (h * w)
        bms, by = bound(window + 3 * nb, x.numel() * sum(CROP_OPS))
        out[name] = {"shape": list(shape), "apex": list(apex),
                     "tiles": [tw, tq], "ms": kf + kb, "fwd_ms": kf,
                     "bwd_ms": kb, "cold_ms": cf + cb, "plain_ms": pf + pb,
                     "library_ms": lf + lb, "bound_ms": bms, "bound_by": by,
                     "max_abs_err": ge}
        print(f"check crop_resize {name} {shape} apex {apex} column tiles "
              f"fwd {tw} bwd {tq} of {w}: forward equal to plain; gradient "
              f"max_abs_err={ge:.3g} (plain max {float(gp.abs().max()):.3g}),"
              f" equal over two calls; ms fwd={kf:.5f} bwd={kb:.5f} cold "
              f"fwd={cf:.5f} bwd={cb:.5f} plain {pf + pb:.4f} "
              f"F.interpolate_library {lf + lb:.4f} bound_ms={bms:.5f} "
              f"share_of_bound={bms / (kf + kb):.3f} [{card}]")
        del x, cot, yk, yp, gk, gp, gk2, sets
    return out


def check_hidden_build(card):
    """Registers and local memory (spills and stack) of K16's and K17's
    kernels in the built library (``kernel_report.library_report``); fails
    on local memory."""
    found = kernel_report.library_report(
        _lib.library_path(), ("zigzag_kernel", "crop_resize_fwd",
                              "crop_resize_bwd"))
    # K16's two; K17's whole-row forward and backward, each with bulk and
    # element-wise copies, and its two column-tiled kernels
    check(len(found) == 8, f"expected 8 K16/K17 kernels, found {len(found)}")
    for r in found:
        print(f"kernel_report {r['kernel']} registers={r['registers']} "
              f"local_bytes={r['local_bytes']} stack_bytes={r['stack_bytes']} "
              f"[{card}]")
        check(r["local_bytes"] == 0 and r["stack_bytes"] == 0,
              f"{r['kernel']} spills (local memory)")


# ------------------------------------------------------------ phase 3,
# Tianchi's SUNet

# K18 vs plain: forward and every gradient within WINATT_RTOL of the plain
# tensor's max-abs (3xTF32 tensor-core products and float32 sums in
# another order than the plain einsums; tests/test_torch_window_split.py
# models the arithmetic on the CPU: about 4e-7 of the max)
WINATT_RTOL = 1e-5
# SUNet at 256² b8 (published widths): per stage (qkv on the map, window);
# a SUNet pass runs stages 0-2 four times (two encoder, two decoder
# blocks, every second one shifted by 4) and stage 3 twice, unshifted
# (its window covers the 8 × 8 map)
TC_B, TC_S = 8, 256
WINATT_STAGES = [((TC_B, TC_S // 4 >> i, TC_S // 4 >> i, 3, 3 * 2 ** i, 32),
                  8) for i in range(4)]
# further shapes the kernel takes (qkv, window, shift): N = 16 (a 128²
# input's stage 3, and window 4 shifted), d = 16 and d = 64, a shift that
# wraps both edges of a non-square map, and N = 25 and 49 (padded to 32
# and 64 tokens)
WINATT_EXTRA = [((8, 4, 4, 3, 24, 32), 4, 0),
                ((8, 8, 8, 3, 2, 32), 4, 2),
                ((4, 8, 8, 3, 4, 16), 4, 2),
                ((2, 16, 16, 3, 2, 64), 8, 4),
                ((2, 16, 24, 3, 2, 32), 8, 4),
                ((2, 10, 15, 3, 2, 32), 5, 2),
                ((1, 14, 14, 3, 3, 16), 7, 3)]


def winatt_inputs(g, shape, ws):
    b, hm, wm, _, h, d = shape
    qkv = torch.randn(shape, device="cuda", generator=g)
    table = 0.02 * torch.randn(((2 * ws - 1) ** 2, h), device="cuda",
                               generator=g)
    cot = torch.randn((b, hm, wm, h * d), device="cuda", generator=g)
    return qkv, table, cot


def winatt_grads(fn, qkv, table, cot, ws, shift):
    q = qkv.clone().requires_grad_(True)
    t = table.clone().requires_grad_(True)
    y = fn(q, t, ws, shift)
    dq, dt = torch.autograd.grad(y, (q, t), cot)
    return y.detach(), dq, dt


def winatt_check(g, shape, ws, shift):
    """K18 against its plain version at one shape: forward, dqkv and the
    table's gradient within ``WINATT_RTOL`` of the plain max; the
    gradients bit-identical over two calls. Returns the largest error."""
    qkv, table, cot = winatt_inputs(g, shape, ws)
    k = winatt_grads(window_attention.window_attention, qkv, table, cot,
                     ws, shift)
    k2 = winatt_grads(window_attention.window_attention, qkv, table, cot,
                      ws, shift)
    p = winatt_grads(window_attention.window_attention_plain, qkv, table,
                     cot, ws, shift)
    torch.cuda.synchronize()
    errs = []
    for name, a, b in zip(("forward", "dqkv", "dtable"), k, p):
        e = float((a - b).abs().max())
        m = float(b.abs().max())
        check(e <= WINATT_RTOL * m, f"window_attention {shape} ws {ws} shift "
              f"{shift} {name}: max_abs_err {e} (plain max {m})")
        errs.append(e)
    check(all(torch.equal(a, b) for a, b in zip(k, k2)),
          f"window_attention {shape}: outputs differ over two calls")
    print(f"check window_attention qkv {shape} ws {ws} shift {shift}: "
          f"max_abs_err forward {errs[0]:.3g} dqkv {errs[1]:.3g} dtable "
          f"{errs[2]:.3g}; bit-identical over two calls")
    return max(errs)


def winatt_times(g, shape, ws, shift):
    """(K18, plain, SDPA) forward + backward ms warm, K18 cold, at one
    shape. SDPA: ``F.scaled_dot_product_attention(q, k, v,
    attn_mask=B+M)`` on contiguous (nW·B, heads, N, d) q, k, v of the
    rolled, partitioned map with the additive (nW·B, heads, N, N) mask,
    all built outside the timing, its backward to q, k and v (the mask
    takes no gradient)."""
    qkv, table, cot = winatt_inputs(g, shape, ws)
    b, hm, wm, _, h, d = shape
    ms = {}
    for name, fn in (("kernel", window_attention.window_attention),
                     ("plain", window_attention.window_attention_plain)):
        f = lambda q, t, fn=fn: fn(q, t, ws, shift)
        fwd, bwd, _, _ = fused_times(f, [(qkv, table, cot)], [True, True])
        ms[name] = fwd + bwd
    per = nbytes(qkv, cot) * 3
    sets = cold_sets(lambda i: winatt_inputs(g, shape, ws), per)
    f = lambda q, t: window_attention.window_attention(q, t, ws, shift)
    _, _, cf, cb = fused_times(f, sets, [True, True])
    ms["cold"] = cf + cb
    n, grid = ws * ws, (hm // ws, wm // ws)
    bnw = b * grid[0] * grid[1]
    idx = torch.from_numpy(window_attention.relative_index(ws).reshape(-1)
                           ).cuda()
    mask = table[idx].reshape(n, n, h).permute(2, 0, 1)[None]
    if shift:  # (nW, heads, N, N), repeated for the images
        m = torch.from_numpy(window_attention.shift_mask(
            ws, hm, wm, shift)).cuda()
        mask = (mask + m[:, None]).repeat(b, 1, 1, 1)
    else:
        mask = mask.expand(bnw, h, n, n)
    mask = mask.contiguous()
    x = qkv.reshape(b, hm, wm, -1)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    wins = window_attention.window_partition(x, ws).reshape(bnw, n, 3, h, d)
    q, k, v = (wins[:, :, i].transpose(1, 2).contiguous().requires_grad_(True)
               for i in range(3))
    cot4 = torch.randn((bnw, h, n, d), device="cuda", generator=g)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    y = sdpa()
    ms["library"] = time_ms(sdpa) + time_ms(
        lambda: torch.autograd.grad(y, (q, k, v), cot4, retain_graph=True))
    return ms


def check_window_attention(rows, card):
    """K18 at the four SUNet stage shapes of 256² b8 on the map (stages 0-2
    shifted and not, stage 3 not) and at N = 16, 25 and 49, d = 16 and d =
    64 and a non-square map whose shift wraps both edges: forward, dqkv and
    the table's gradient within ``WINATT_RTOL`` of the plain max, outputs
    bit-identical over two calls; a NaN and an Inf in q give NaN where the
    plain version has it, forward and gradients; a shape it does not take
    raises. Timed forward + backward warm and cold beside the plain
    version and SDPA at each stage shape, with each one's share of its
    bound; the row sums a train step's 28 + 28 launches (two SUNet
    passes)."""
    row = rows["window_attention"]
    g = torch.Generator("cuda").manual_seed(18)
    err = 0.0
    cases = [(shape, ws, s) for shape, ws in WINATT_STAGES
             for s in ((0, 4) if shape[1] > ws else (0,))] + WINATT_EXTRA
    for shape, ws, shift in cases:
        err = max(err, winatt_check(g, shape, ws, shift))
    # non-finite q: NaN where the plain version has it, forward and back
    qkv, table, cot = winatt_inputs(g, (2, 16, 16, 3, 3, 32), 8)
    qkv[0, 1, 5, 0, 2, 7] = float("nan")
    qkv[1, 7, 4, 0, 0, 1] = float("inf")
    k = winatt_grads(window_attention.window_attention, qkv, table, cot, 8,
                     4)
    p = winatt_grads(window_attention.window_attention_plain, qkv, table,
                     cot, 8, 4)
    torch.cuda.synchronize()
    for name, a, b in zip(("forward", "dqkv", "dtable"), k, p):
        check(torch.equal(a.isnan(), b.isnan()),
              f"window_attention non-finite q {name}: NaN at "
              f"{int(a.isnan().sum())} places, plain {int(b.isnan().sum())}")
        fin = b.isfinite()
        if bool(fin.any()):
            e = float((a[fin] - b[fin]).abs().max())
            check(e <= WINATT_RTOL * float(b[fin].abs().max()),
                  f"window_attention non-finite q {name}: finite part "
                  f"{e}")
    print(f"check window_attention NaN and Inf in q: NaN forward "
          f"{int(p[0].isnan().sum())}, dqkv {int(p[1].isnan().sum())}, "
          f"dtable {int(p[2].isnan().sum())}, at the plain version's places")
    for bad, ws in (((1, 9, 9, 3, 1, 32), 9), ((1, 8, 8, 3, 1, 48), 8),
                    ((1, 8, 12, 3, 1, 32), 8)):
        t = torch.zeros(((2 * ws - 1) ** 2, 1), device="cuda")
        q = torch.zeros(bad, device="cuda")
        try:
            window_attention.window_attention(q, t, ws, 0)
        except ValueError as e:
            print(f"window_attention refuses qkv {bad} ws {ws}: {e}")
        else:
            raise AssertionError(f"window_attention took qkv {bad} ws {ws}")
    row.err = err
    tot = collections.Counter()
    for i, (shape, ws) in enumerate(WINATT_STAGES):
        for shift in ((0, 4) if i < 3 else (0,)):
            ms = winatt_times(g, shape, ws, shift)
            # launches of this block kind in a train step: two passes,
            # stages 0-2 two blocks of each kind, stage 3 two unshifted
            mult = 2 * 2
            bf, of = window_attention.work(shape, ws)
            bb, ob = window_attention.work(shape, ws, backward=True)
            for _ in range(mult):
                row.add(ms["kernel"], ms["plain"], bf + bb, of + ob,
                        library_ms=ms["library"], cold_ms=ms["cold"])
            tot["pass"] += mult // 2 * ms["kernel"]
            bms = bound(bf + bb, of + ob)[0]
            print(f"window_attention qkv {shape} shift {shift} fwd+bwd: "
                  f"kernel {ms['kernel']:.4f} ms (cold {ms['cold']:.4f}), "
                  f"plain {ms['plain']:.4f}, SDPA {ms['library']:.4f}, bound "
                  f"{bms:.4f} ms, share {100 * bms / ms['kernel']:.1f} % "
                  f"[{card}]")
    print(f"window_attention per SUNet pass at {TC_S}² b{TC_B}, fwd+bwd: "
          f"{tot['pass']:.4f} ms over 14 + 14 launches [{card}]")
    found = kernel_report.library_report(_lib.library_path(),
                                         ("window_attention",))
    check(len(found) == 6, f"expected 6 K18 kernels, found {len(found)}")
    for r in found:
        print(f"kernel_report {r['kernel']} registers={r['registers']} "
              f"local_bytes={r['local_bytes']} stack_bytes={r['stack_bytes']} "
              f"HGMMA={r['ops']['HGMMA']} HMMA={r['ops']['HMMA']} [{card}]")
        check(r["local_bytes"] == 0 and r["stack_bytes"] == 0,
              f"{r['kernel']} spills (local memory)")


# ------------------------------------------------------------ phase 3,
# the image family

# the PAMI step's fan-out at pami.yaml's width: k·B = 6·8 attacked copies
IMG_B, IMG_S, IMG_K = 8, 256, 6
CANNY_SHAPE = (IMG_K * IMG_B, IMG_S, IMG_S, 3)
CANNY_FWD_ATOL = 1e-6     # K19 vs plain, forward
CANNY_GRAD_RTOL = 1e-5    # and the input gradient, of the plain max
# per pixel, the least work: gray 5, gaussian 50, Sobel 12, magnitude 4,
# NMS and the thresholds ~30 forward; the backward about twice that
CANNY_OPS = (100, 200)
# the image INN at batch 48 (the reverse of every copy): Haar levels by
# their full-resolution side, and the couplings' (side, half channels)
IMAGE_HAAR_LEVELS = [(48, 256, 256, 4), (48, 128, 128, 16),
                     (48, 64, 64, 64)]
IMAGE_AFFINE_LEVELS = [(128, 8), (64, 32), (32, 128)]
IMG_BIG = (512, 3, 3)  # the JAX PAMI record's size, batch and reverse_k


# the PAMI-512 record's fan-out: reverse_k · B = 3·3 copies at 512²
CANNY_BIG = (IMG_BIG[1] * IMG_BIG[2], IMG_BIG[0], IMG_BIG[0], 3)


def canny_input(g, kind, shape=CANNY_SHAPE):
    if kind == "levels":   # 8-bit levels: ties in the NMS and the clip
        return torch.randint(0, 256, shape, device="cuda",
                             generator=g).float() / 255.0
    if kind == "flat":     # every pixel tied at the per-image max
        return torch.full(shape, 0.3, device="cuda")
    return torch.rand(shape, device="cuda", generator=g)


def launch_ms(fn, x, cot, reps=10):
    """Device ms a call of each kernel (and memset) that one forward +
    backward of ``fn`` runs, under ``torch.profiler`` (after 3 warm-up
    pairs)."""
    xg = x.clone().requires_grad_(True)
    for _ in range(3):
        torch.autograd.grad(fn(xg), xg, cot)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.autograd.grad(fn(xg), xg, cot)
        torch.cuda.synchronize()
    ms = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            ms[name.split("(")[0].split("::")[-1]] += \
                e.time_range.elapsed_us() / 1e3 / reps
    return dict(ms)


def check_canny(rows, card):
    """K19 at the PAMI step's (48, 256, 256, 3) and the PAMI-512 record's
    (9, 512, 512, 3) on 8-bit, continuous and flat inputs: forward within
    ``CANNY_FWD_ATOL`` and the input gradient within ``CANNY_GRAD_RTOL`` of
    the plain version's max (the plain version with ``exact_border``, F24;
    the JAX form's own corner noise is printed beside it), the same bits
    over two calls; the kernels' geometry the host plan's; NaN and Inf
    pixels and a NaN cotangent NaN where the plain version's are; timed
    forward + backward (a train step's two launches) at both shapes warm
    and with a cold L2, each device launch's time beside the total, beside
    the plain version and a depthwise 5×5 ``F.conv2d`` on the gray image
    (yardstick). The bound counts x and y forward, x, the cotangent and
    dx backward, at the step's shape."""
    row = rows["canny_soft"]
    canny.check_geometry()
    g = torch.Generator("cuda").manual_seed(71)
    exact = functools.partial(canny.canny_soft_plain, exact_border=True)
    for shape in (CANNY_SHAPE, CANNY_BIG):
        for kind in ("levels", "rand", "flat"):
            x = canny_input(g, kind, shape)
            cot = torch.randn(shape[:3] + (1,), device="cuda", generator=g)
            (yk,), (gk,) = grads_of(canny.canny_soft, [x], [True], cot)
            (yk2,), (gk2,) = grads_of(canny.canny_soft, [x], [True], cot)
            (yp,), (gp,) = grads_of(exact, [x], [True], cot)
            (_,), (gj,) = grads_of(canny.canny_soft_plain, [x], [True], cot)
            torch.cuda.synchronize()
            fe = float((yk - yp).abs().max())
            gmax = float(gp.abs().max()) or 1.0
            ge = float((gk - gp).abs().max())
            check(fe <= CANNY_FWD_ATOL,
                  f"canny_soft {shape} {kind} forward: {fe}")
            check(ge <= CANNY_GRAD_RTOL * gmax,
                  f"canny_soft {shape} {kind} gradient: {ge} (plain max "
                  f"{gmax})")
            check(torch.equal(yk, yk2) and torch.equal(gk, gk2),
                  f"canny_soft {shape} {kind}: two calls differ")
            row.err = max(row.err, fe)
            print(f"check canny_soft {shape} {kind}: forward max_abs_err="
                  f"{fe:.3g}, gradient {ge:.3g} of plain max {gmax:.3g}, "
                  f"bit-identical over calls; the JAX form's gradient "
                  f"(exact_border off) {float((gj - gp).abs().max()) / gmax:.3g}"
                  f" of the max from the exact-border one (F24)")
    nshape = (4, 64, 64, 3)
    x, cot = nonfinite_input(g, nshape, (1, 5, 6, 0), (2, 30, 31, 2),
                             (3, 10, 10, 0), out_shape=nshape[:3] + (1,))
    check_nonfinite("canny_soft", canny.canny_soft, exact, x, cot,
                    CANNY_FWD_ATOL)
    times = {}
    for shape in (CANNY_SHAPE, CANNY_BIG):
        x = canny_input(g, "levels", shape)
        cot = torch.randn(shape[:3] + (1,), device="cuda", generator=g)
        kf, kb = fwd_bwd_ms(canny.canny_soft, x, cot)
        cf, cb = fwd_bwd_cold_ms(canny.canny_soft, lambda i: (
            canny_input(g, "levels", shape),
            torch.randn(cot.shape, device="cuda", generator=g)))
        launches = launch_ms(canny.canny_soft, x, cot)
        times[shape] = (kf, kb, cf, cb, launches, x, cot)
        print(f"check canny_soft {shape} f32: ms fwd={kf:.4f} bwd={kb:.4f} "
              f"total={kf + kb:.4f} cold fwd={cf:.4f} bwd={cb:.4f}; device "
              f"ms a launch: " + ", ".join(f"{k}={v:.4f}" for k, v in
                                           launches.items()) + f" [{card}]")
    kf, kb, cf, cb, launches, x, cot = times[CANNY_SHAPE]
    pf, pb = fwd_bwd_ms(exact, x, cot)
    gray = canny.gray(x)[:, None]
    w = torch.from_numpy(gaussian_kernel_2d(5, 1.0)).to("cuda")[None, None]
    yf, yb = fwd_bwd_ms(lambda v: F.conv2d(v, w, padding=2), gray,
                        torch.randn(gray.shape, device="cuda", generator=g))
    y = torch.empty(CANNY_SHAPE[:3] + (1,), device="cuda")
    fwd_bytes, bwd_bytes = nbytes(x, y), nbytes(x, cot, x)
    px = y.numel()
    ops = px * (CANNY_OPS[0] + CANNY_OPS[1])
    row.add(kf + kb, pf + pb, fwd_bytes + bwd_bytes, ops,
            yardstick_ms=yf + yb, cold_ms=cf + cb)
    bf, bb = (bound(fwd_bytes, px * CANNY_OPS[0])[0],
              bound(bwd_bytes, px * CANNY_OPS[1])[0])
    big = times[CANNY_BIG]
    row.extra = {"forward_ms": kf, "backward_ms": kb,
                 "forward_bound_ms": bf, "backward_bound_ms": bb,
                 "launch_ms": launches,
                 "pami512": {"shape": list(CANNY_BIG), "ms": big[0] + big[1],
                             "forward_ms": big[0], "backward_ms": big[1],
                             "cold_ms": big[2] + big[3],
                             "launch_ms": big[4]}}
    print(f"check canny_soft {CANNY_SHAPE} f32: ms fwd={kf:.4f} "
          f"bwd={kb:.4f} cold fwd={cf:.4f} bwd={cb:.4f} plain fwd={pf:.4f} "
          f"bwd={pb:.4f} yardstick (5x5 conv on gray) fwd={yf:.4f} "
          f"bwd={yb:.4f} bound fwd={bf:.4f} bwd={bb:.4f} share_of_bound="
          f"{(bf + bb) / (kf + kb):.3f} [{card}]")


def check_image_inn_shapes(card):
    """K14 and K15 at the image INN's shapes (4 → 16 → 64 → 256 channels,
    batch 48: the reverse of every attacked copy), f32 and bf16: K14 EQUAL
    to its plain version down and up; K15 (fused s ‖ t, forward and
    inverse) within one ulp and its gradients within
    ``AFFINE_GRAD_RTOL`` of the plain max (f32) or ``TOL`` (bf16); the
    8-channel halves are one 16-byte word in bf16."""
    g = torch.Generator("cuda").manual_seed(73)
    for full in IMAGE_HAAR_LEVELS:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(full, device="cuda", generator=g).to(dt)
            y = haar.haar(x)
            back = haar.haar(y, transpose=True)
            check(torch.equal(y, haar.haar_plain(x)) and torch.equal(
                back, haar.haar_plain(y, transpose=True)),
                f"haar {full} {dt} differs from its plain version")
    print(f"check haar at the image INN's levels {IMAGE_HAAR_LEVELS} f32 "
          f"and bf16: down and up equal to plain")
    worst = 0.0
    for hw, c in IMAGE_AFFINE_LEVELS:
        for dt in (torch.float32, torch.bfloat16):
            z, st = affine_case(g, hw, c, dt, True, batch=48)
            x = z[..., :c]
            for inverse in (False, True):
                out, ref = torch.empty_like(z), torch.empty_like(z)
                affine.coupling_affine(st, x, out=out[..., c:],
                                       inverse=inverse)
                affine.coupling_affine_plain(st, x, out=ref[..., c:],
                                             inverse=inverse)
                cot = torch.randn(x.shape, device="cuda", generator=g).to(dt)
                gk = affine_grads(affine.coupling_affine, st, x, inverse,
                                  cot)
                gp = affine_grads(affine.coupling_affine_plain, st, x,
                                  inverse, cot)
                torch.cuda.synchronize()
                what = (f"coupling_affine {(48, hw, hw, c)} {dt} "
                        f"{'inverse' if inverse else 'forward'}")
                check(within_ulp(out[..., c:], ref[..., c:], dt),
                      f"{what}: more than one ulp from plain")
                for a, b in zip(gk, gp):
                    d = float((a.float() - b.float()).abs().max())
                    scale = float(b.float().abs().max()) or 1.0
                    worst = max(worst, d / scale)
                    check(d <= AFFINE_GRAD_RTOL * scale
                          if dt == torch.float32 else rel_err(a, b, dt)[1],
                          f"{what}: gradient off by {d} (max {scale})")
    print(f"check coupling_affine at the image INN's couplings "
          f"{IMAGE_AFFINE_LEVELS} (batch 48) f32 and bf16, forward and "
          f"inverse: within one ulp; gradients within {worst:.3g} of the "
          f"plain max")


# ------------------------------------------------------------ phase 3, CLR

# CLR's train step at clr.yaml's width: the crop of 8 images of 256², the
# rectification of its 6·8 copies; the JAX record's 512² b3, reverse_k 3
CLR_B, CLR_S, CLR_K = 8, 256, 6
CLR_BIG = (512, 3, 3)
CUBIC_GRAD_RTOL = 1e-5   # K20's gradient vs plain, of the plain max
RECT_GRAD_RTOL = 1e-6    # K21's (PyTorch ops) gradient into clean
# per output value: the row pass 16 products and 12 sums, the column pass
# 4 and 3 (K20 forward, K21's paste, which adds the clip, the window's two
# products and the straight-through sum: 6); K20's backward the same
# products and sums in transpose
CUBIC_OPS = (35, 35)
RECT_OPS = 41
# windows at CLR's 256²: inside, one pixel, on three edges, the image
CUBIC_APEXES = [(10.0, 230.0, 3.0, 256.0), (100.0, 101.0, 7.0, 8.0),
                (0.0, 200.0, 56.0, 256.0), (0.0, 256.0, 0.0, 256.0)]


def cubic_inputs(g, shape):
    return torch.rand(shape, device="cuda", generator=g) * 1.2 - 0.1


def window_bytes(shape, apex):
    """Bytes of the window a crop reads (its pixels, every channel)."""
    n, h, w, c = shape
    h0, h1, w0, w1 = (int(v) for v in apex)
    return n * (h1 - h0) * (w1 - w0) * c * 4


def check_crop_cubic(rows, card):
    """K20 at CLR's (8, 256, 256, 3) over four windows (one pixel, the
    edges, the image), at the 512² record's (3, 512, 512, 3), downsampled
    to (128, 96) and (200, 160), and wide: (1, 2160, 3840, 3) (15 column
    tiles) and a 20,000-pixel row (240 KB, past a CTA's shared memory)
    down to (8, 300) (forward tiles of 75 pixels); rows downsampled 5 and
    5.12 times ((2, 40, 70, 3) to (8, 48), 512² to (100, 100): output
    rows skip input rows); a 300-column window to 1,000 (150 pixels of a
    tile with more column terms than registers hold): forward EQUAL to the
    plain version, the gradient within ``CUBIC_GRAD_RTOL`` of the plain
    max, both bit-identical over two calls; NaN and Inf pixels and a NaN
    cotangent NaN where the plain version's are; the bytes a forward and a
    backward allocate beyond y and gx (none); timed forward and backward
    apart, warm and with a cold L2, beside the plain version and
    ``F.interpolate(bicubic, align_corners=False)`` of the sliced window
    (library: the same function, which the port never calls). The bound
    counts the window read and y written forward, g read and gx written
    backward."""
    row = rows["crop_cubic"]
    g = torch.Generator("cuda").manual_seed(75)
    shape = (CLR_B, CLR_S, CLR_S, 3)
    big = (CLR_BIG[1], CLR_BIG[0], CLR_BIG[0], 3)
    cases = [(shape, a, None) for a in CUBIC_APEXES] + [
        (big, (31.0, 480.0, 0.0, 400.0), None),
        (shape, CUBIC_APEXES[0], (128, 96)),
        (big, (31.0, 480.0, 0.0, 400.0), (200, 160)),
        ((1, 2160, 3840, 3), (100.0, 2000.0, 37.0, 3801.0), None),
        ((1, 8, 20000, 3), (1.0, 7.0, 123.0, 19877.0), (8, 300)),
        ((2, 40, 70, 3), (0.0, 40.0, 0.0, 70.0), (8, 48)),
        ((3, 512, 512, 3), (0.0, 512.0, 0.0, 512.0), (100, 100)),
        ((1, 32, 1000, 3), (0.0, 32.0, 100.0, 400.0), (32, 1000))]
    worst = 0.0
    for shp, apex, out_hw in cases:
        oshape = shp if out_hw is None else (shp[0], *out_hw, shp[3])
        x = cubic_inputs(g, shp)
        cot = torch.randn(oshape, device="cuda", generator=g)
        ap = torch.tensor(apex, device="cuda")

        def fn(v, ap=ap, out_hw=out_hw):
            return crop_cubic.crop_cubic(v, ap, out_hw)

        def pl(v, ap=ap, out_hw=out_hw):
            return crop_cubic.crop_cubic_plain(v, ap, out_hw)
        (yk,), (gk,) = grads_of(fn, [x], [True], cot)
        (yk2,), (gk2,) = grads_of(fn, [x], [True], cot)
        (yp,), (gp,) = grads_of(pl, [x], [True], cot)
        torch.cuda.synchronize()
        gmax = float(gp.abs().max())
        ge = float((gk - gp).abs().max())
        check(torch.equal(yk, yp), f"crop_cubic {shp} {apex} {out_hw}: "
              f"forward differs from plain "
              f"({float((yk - yp).abs().max())})")
        check(ge <= CUBIC_GRAD_RTOL * gmax, f"crop_cubic {shp} {apex} "
              f"{out_hw}: gradient {ge} (plain max {gmax})")
        check(torch.equal(yk, yk2) and torch.equal(gk, gk2),
              f"crop_cubic {shp} {apex} {out_hw}: two calls differ")
        worst = max(worst, ge / gmax)
        print(f"check crop_cubic {shp} window {apex} out_hw {out_hw}: "
              f"forward equal to plain, gradient max_abs_err={ge:.3g} of "
              f"plain max {gmax:.3g}, bit-identical over calls")
        del x, cot, yk, gk, yk2, gk2, yp, gp
    x, cot = nonfinite_input(g, (4, 64, 64, 3), (1, 30, 12, 0),
                             (0, 6, 3, 2), (1, 31, 20, 1))
    ap = torch.tensor((5.0, 60.0, 2.0, 50.0), device="cuda")
    (yk,), (gk,) = grads_of(lambda v: crop_cubic.crop_cubic(v, ap), [x],
                            [True], cot)
    (yp,), (gp,) = grads_of(lambda v: crop_cubic.crop_cubic_plain(v, ap),
                            [x], [True], cot)
    torch.cuda.synchronize()
    for name, k, p in (("forward", yk, yp), ("gradient", gk, gp)):
        check(torch.equal(k.isnan(), p.isnan()) and torch.equal(
            k.isinf(), p.isinf()), f"crop_cubic non-finite {name}: NaN or "
              f"Inf at other places than the plain version's")
    fin = gp.isfinite()
    check(torch.equal(yk[yp.isfinite()], yp[yp.isfinite()])
          and float((gk[fin] - gp[fin]).abs().max())
          <= CUBIC_GRAD_RTOL * float(gp[fin].abs().max()),
          "crop_cubic non-finite: finite values differ")
    print(f"check crop_cubic non-finite: NaN {int(yp.isnan().sum())} "
          f"forward, {int(gp.isnan().sum())} gradient, at the plain "
          f"version's places")
    row.err = worst
    times = {}
    for shp, apex in ((shape, CUBIC_APEXES[0]), (big, cases[4][1])):
        x = cubic_inputs(g, shp)
        cot = torch.randn(shp, device="cuda", generator=g)
        ap = torch.tensor(apex, device="cuda")
        # the bytes a call allocates beyond its output (none: the backward
        # keeps no (N, OH, W, C) plane)
        xg = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = crop_cubic.crop_cubic(xg, ap)
        torch.cuda.synchronize()
        fwd_extra = torch.cuda.max_memory_allocated() - base - nbytes(y)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (gx,) = torch.autograd.grad(y, xg, cot)
        torch.cuda.synchronize()
        bwd_extra = torch.cuda.max_memory_allocated() - base - nbytes(gx)
        del xg, y, gx
        check(fwd_extra == 0 and bwd_extra == 0, f"crop_cubic {shp}: "
              f"{fwd_extra} bytes beyond y, {bwd_extra} beyond gx")
        kf, kb = fwd_bwd_ms(lambda v: crop_cubic.crop_cubic(v, ap), x, cot)
        cf, cb = fwd_bwd_cold_ms(
            lambda v: crop_cubic.crop_cubic(v, ap), lambda i: (
                cubic_inputs(g, shp), torch.randn(shp, device="cuda",
                                                  generator=g)))
        pf, pb = fwd_bwd_ms(lambda v: crop_cubic.crop_cubic_plain(v, ap), x,
                            cot)
        h0, h1, w0, w1 = (int(v) for v in apex)

        def lib(v):
            win = v[:, h0:h1, w0:w1].permute(0, 3, 1, 2)
            return F.interpolate(win, size=shp[1:3], mode="bicubic",
                                 align_corners=False)
        lf, lb = fwd_bwd_ms(lib, x, cot.permute(0, 3, 1, 2))
        fwd_bytes = window_bytes(shp, apex) + nbytes(x)
        bwd_bytes = 2 * nbytes(x)
        ops = x.numel() * sum(CUBIC_OPS)
        bf, bb = (bound(fwd_bytes, x.numel() * CUBIC_OPS[0])[0],
                  bound(bwd_bytes, x.numel() * CUBIC_OPS[1])[0])
        times[shp] = dict(kf=kf, kb=kb, cf=cf, cb=cb, pf=pf, pb=pb, lf=lf,
                          lb=lb, bytes=fwd_bytes + bwd_bytes, ops=ops,
                          bf=bf, bb=bb, fwd_extra=fwd_extra,
                          bwd_extra=bwd_extra)
        print(f"check crop_cubic {shp} window {apex}: ms fwd={kf:.4f} "
              f"bwd={kb:.4f} cold fwd={cf:.4f} bwd={cb:.4f} plain fwd="
              f"{pf:.4f} bwd={pb:.4f} library (F.interpolate bicubic of the "
              f"window) fwd={lf:.4f} bwd={lb:.4f} bound fwd={bf:.4f} bwd="
              f"{bb:.4f} share_of_bound={(bf + bb) / (kf + kb):.3f}; bytes "
              f"allocated beyond y {fwd_extra}, beyond gx {bwd_extra} "
              f"[{card}]")
    t = times[shape]
    row.add(t["kf"] + t["kb"], t["pf"] + t["pb"], t["bytes"], t["ops"],
            library_ms=t["lf"] + t["lb"], cold_ms=t["cf"] + t["cb"])
    b512 = times[big]
    row.extra = {"forward_ms": t["kf"], "backward_ms": t["kb"],
                 "forward_cold_ms": t["cf"], "backward_cold_ms": t["cb"],
                 "forward_bound_ms": t["bf"], "backward_bound_ms": t["bb"],
                 "bytes_beyond_outputs": t["fwd_extra"] + t["bwd_extra"],
                 "grad_rtol_of_plain_max": worst,
                 "clr512": {"shape": list(big), "ms": b512["kf"] + b512["kb"],
                            "cold_ms": b512["cf"] + b512["cb"],
                            "plain_ms": b512["pf"] + b512["pb"],
                            "library_ms": b512["lf"] + b512["lb"],
                            "bound_ms": b512["bf"] + b512["bb"]}}


def rect_inputs(g, reps, shape):
    att = torch.rand((shape[0] * reps,) + shape[1:], device="cuda",
                     generator=g) * 1.2 - 0.1
    return att, torch.rand(shape, device="cuda", generator=g)


def check_rectify(rows, card):
    """K21 at CLR's train step (48 copies of 256² against 8 clean images)
    and the 512² record's reverse (9 copies against 3), over windows of
    one pixel's height, on the edges and the image, and a W·C that is not
    a multiple of 4 (the scalar path): output EQUAL to the plain version,
    the gradient into the clean images (K21's backward kernel) within
    ``RECT_GRAD_RTOL`` of the plain max, both bit-identical over calls; an
    Inf attacked pixel outside the window and a NaN inside give NaN where
    the plain version's are, and so does a NaN cotangent outside the window
    in the backward. Each launch timed apart, warm and with a cold L2: the
    forward beside the plain version and ``F.interpolate`` of the copies to
    the window's size then ``F.pad`` to its place (library; the port never
    calls it), the backward beside its plain version (the PyTorch ops it
    replaces) and one ``torch.einsum`` of the same sum (library). The
    forward's bound counts the copies and the clean images read and the
    output written, the backward's g read and dclean
    written."""
    row = rows["rectify"]
    g = torch.Generator("cuda").manual_seed(76)
    shape = (CLR_B, CLR_S, CLR_S, 3)
    big = (CLR_BIG[1], CLR_BIG[0], CLR_BIG[0], 3)
    cases = [(CLR_K, shape, a) for a in (CUBIC_APEXES[0], (100.0, 101.0,
                                                           7.0, 200.0),
                                         CUBIC_APEXES[2], CUBIC_APEXES[3])]
    cases += [(CLR_BIG[2], big, (31.0, 480.0, 0.0, 400.0)),
              (2, (2, 40, 71, 3), (6.0, 40.0, 30.0, 71.0))]
    worst = 0.0
    for reps, shp, apex in cases:
        att, clean = rect_inputs(g, reps, shp)
        cot = torch.randn(att.shape, device="cuda", generator=g)
        ap = torch.tensor(apex, device="cuda")
        (yk,), (gk,) = grads_of(lambda c: rectify.rectify(att, c, ap),
                                [clean], [True], cot)
        (yk2,), (gk2,) = grads_of(lambda c: rectify.rectify(att, c, ap),
                                  [clean], [True], cot)
        (yp,), (gp,) = grads_of(lambda c: rectify.rectify_plain(att, c, ap),
                                [clean], [True], cot)
        torch.cuda.synchronize()
        ge = float((gk - gp).abs().max())
        gmax = float(gp.abs().max()) or 1.0
        check(torch.equal(yk, yp), f"rectify {reps}x{shp} {apex}: differs "
              f"from plain ({float((yk - yp).abs().max())})")
        check(ge <= RECT_GRAD_RTOL * gmax, f"rectify gradient {ge}")
        check(torch.equal(yk, yk2) and torch.equal(gk, gk2),
              "rectify: two calls differ")
        worst = max(worst, ge / gmax)
        print(f"check rectify {reps}x{shp} window {apex}: equal to plain, "
              f"gradient into clean max_abs_err={ge:.3g} of {gmax:.3g}, "
              f"bit-identical over calls")
    att, clean = rect_inputs(g, 2, (2, 64, 64, 3))
    att[0, 1, 1, 0] = float("inf")
    att[3, 30, 30, 2] = float("nan")
    ap = torch.tensor((5.0, 60.0, 2.0, 50.0), device="cuda")
    cot = torch.randn(att.shape, device="cuda", generator=g)
    cot[1, 62, 1, 1] = float("nan")  # outside the window
    (yk,), (gk,) = grads_of(lambda c: rectify.rectify(att, c, ap), [clean],
                            [True], cot)
    (yp,), (gp,) = grads_of(lambda c: rectify.rectify_plain(att, c, ap),
                            [clean], [True], cot)
    torch.cuda.synchronize()
    for what, k, p in (("forward", yk, yp), ("gradient", gk, gp)):
        fin = p.isfinite()
        check(torch.equal(k.isnan(), p.isnan()) and bool(p.isnan().any())
              and float((k[fin] - p[fin]).abs().max())
              <= RECT_GRAD_RTOL * float(p[fin].abs().max()),
              f"rectify non-finite {what}: differs from plain")
    check(torch.equal(yk[yp.isfinite()], yp[yp.isfinite()]),
          "rectify non-finite: finite outputs differ")
    print(f"check rectify non-finite: NaN {int(yp.isnan().sum())} forward, "
          f"{int(gp.isnan().sum())} gradient, at the plain version's places")
    row.err = worst
    out = {}
    for reps, shp, apex in (cases[0], cases[4]):
        att, clean = rect_inputs(g, reps, shp)
        ap = torch.tensor(apex, device="cuda")
        cot = torch.randn(att.shape, device="cuda", generator=g)
        fwd_bytes = nbytes(att, clean, att)
        bwd_bytes = nbytes(cot, clean)
        t = {"f": time_ms(lambda: rectify.rectify(att, clean, ap)),
             "b": time_ms(lambda: rectify.rectify_backward(cot, ap, reps)),
             "pb": time_ms(lambda: rectify.rectify_backward_plain(cot, ap,
                                                                  reps))}
        t["cf"] = time_cold_ms(
            lambda a, c: rectify.rectify(a, c, ap),
            cold_sets(lambda i: rect_inputs(g, reps, shp), fwd_bytes))
        t["cb"] = time_cold_ms(
            lambda gv: rectify.rectify_backward(gv, ap, reps),
            cold_sets(lambda i: (torch.randn(att.shape, device="cuda",
                                             generator=g),), bwd_bytes))
        t["pf"] = time_ms(lambda: rectify.rectify_plain(att, clean, ap),
                          iters=5, warmup=1)
        h0, h1, w0, w1 = (int(v) for v in apex)
        a_nchw = att.permute(0, 3, 1, 2)

        def lib():
            win = F.interpolate(a_nchw, size=(h1 - h0, w1 - w0),
                                mode="bicubic", align_corners=False)
            return F.pad(win, (w0, shp[2] - w1, h0, shp[1] - h1))
        t["lf"] = time_ms(lib)
        inside = rect_mask(shp[1:3], ap.unbind())[..., None].expand(shp[1:])
        g5 = cot.view(reps, *shp)
        t["lb"] = time_ms(lambda: torch.einsum("rbhwc,hwc->bhwc", g5,
                                               inside))
        t["bf"], t["bb"] = (bound(fwd_bytes, att.numel() * RECT_OPS)[0],
                            bound(bwd_bytes, att.numel() * 2)[0])
        t["fwd"] = (fwd_bytes, att.numel() * RECT_OPS)
        t["bwd"] = (bwd_bytes, att.numel() * 2)
        out[shp] = t
        print(f"check rectify {reps}x{shp}: forward ms={t['f']:.4f} "
              f"cold_ms={t['cf']:.4f} plain_ms={t['pf']:.4f} library "
              f"(F.interpolate + F.pad) ms={t['lf']:.4f} bound_ms="
              f"{t['bf']:.4f} share={t['bf'] / t['f']:.3f}; backward kernel "
              f"ms={t['b']:.4f} cold_ms={t['cb']:.4f} PyTorch ops ms="
              f"{t['pb']:.4f} einsum ms={t['lb']:.4f} bound_ms="
              f"{t['bb']:.4f} share={t['bb'] / t['b']:.3f} [{card}]")
    t = out[shape]
    row.add(t["f"], t["pf"], *t["fwd"], library_ms=t["lf"],
            cold_ms=t["cf"])
    row.add(t["b"], t["pb"], *t["bwd"], library_ms=t["lb"],
            cold_ms=t["cb"])
    b = out[big]
    row.extra = {"forward_ms": t["f"], "forward_cold_ms": t["cf"],
                 "forward_bound_ms": t["bf"], "backward_ms": t["b"],
                 "backward_cold_ms": t["cb"], "backward_bound_ms": t["bb"],
                 "backward_pytorch_ops_ms": t["pb"],
                 "clr512": {"copies": CLR_BIG[1] * CLR_BIG[2],
                            "shape": list(big), "forward_ms": b["f"],
                            "forward_cold_ms": b["cf"],
                            "forward_bound_ms": b["bf"],
                            "backward_ms": b["b"], "backward_cold_ms": b["cb"],
                            "backward_bound_ms": b["bb"],
                            "backward_pytorch_ops_ms": b["pb"],
                            "plain_ms": b["pf"] + b["pb"],
                            "library_ms": b["lf"] + b["lb"]}}


def ssim_grad_inputs(g, shape, flat=False):
    """``fwd_rgb`` near ``img`` (the embed is ~50 dB from it), with a flat
    patch on request."""
    img = torch.rand(shape, device="cuda", generator=g)
    x1 = (img + 0.01 * torch.randn(shape, device="cuda", generator=g)).clamp(
        0, 1)
    if flat:
        x1[:, 40:120, 30:200] = img[:, 40:120, 30:200] = 0.25
    return x1, img


def check_ssim_grad(rows, card):
    """K22 at CLR's (8, 256, 256, 3) (with and without a flat patch, where
    σ² cancels), the 512² record's (3, 512, 512, 3) and ragged shapes (one
    past a 64-column strip and a segment of ``ssim_grad.plan``'s rows in
    each dimension, and smaller than the window): within ``ssim_grad.RTOL``
    of the plain gradient's max (autograd of ``ssim_plain``), bit-identical
    over calls, through ``metrics.ssim`` under autograd (K8 + K22); a NaN
    pixel gives NaN where the plain version's gradient has it; the launch
    allocates nothing beyond dx; timed warm and with a cold L2 at both
    shapes beside the plain version and the input gradient of one
    depthwise 11×11 ``F.conv2d`` over the five stacked maps (yardstick).
    The bound counts x1 and x2 read and dx written, and ``ssim_grad.OPS``
    a value."""
    from vwfd_tpu_torch.metrics import ssim as metrics_ssim
    row = rows["ssim_grad"]
    g = torch.Generator("cuda").manual_seed(77)
    shape = (CLR_B, CLR_S, CLR_S, 3)
    big = (CLR_BIG[1], CLR_BIG[0], CLR_BIG[0], 3)
    worst = 0.0
    for shp, flat in ((shape, False), (shape, True), (big, False),
                      ((3, 37, 45, 3), False), ((2, 5, 300, 3), False),
                      ((1, 11, 11, 3), False), ((1, 69, 65, 3), False),
                      ((2, 69, 129, 3), False)):
        x1, img = ssim_grad_inputs(g, shp, flat)
        xk = x1.clone().requires_grad_(True)
        before = (launch_counts()["ssim"], launch_counts()["ssim_grad"])
        gk, = torch.autograd.grad(metrics_ssim(xk, img), xk)
        check((launch_counts()["ssim"], launch_counts()["ssim_grad"])
              == (before[0] + 1, before[1] + 1),
              "metrics.ssim under autograd: not K8 + K22")
        gk2, = torch.autograd.grad(metrics_ssim(xk, img), xk)
        xp = x1.clone().requires_grad_(True)
        gp, = torch.autograd.grad(ssim.ssim_plain(xp, img)[1], xp)
        torch.cuda.synchronize()
        ge = float((gk - gp).abs().max())
        gmax = float(gp.abs().max())
        check(ge <= ssim_grad.RTOL * gmax, f"ssim_grad {shp} flat={flat}: "
              f"{ge} (plain max {gmax})")
        check(torch.equal(gk, gk2), f"ssim_grad {shp}: two calls differ")
        worst = max(worst, ge / gmax)
        print(f"check ssim_grad {shp} flat patch={flat}: max_abs_err={ge:.3g}"
              f" of plain max {gmax:.3g} ({ge / gmax:.3g}; tol "
              f"{ssim_grad.RTOL}), bit-identical over calls")
    x1, img = ssim_grad_inputs(g, (2, 40, 40, 3))
    x1[1, 17, 3, 1] = float("nan")
    xk, xp = (x1.clone().requires_grad_(True) for _ in range(2))
    gk, = torch.autograd.grad(metrics_ssim(xk, img), xk)
    gp, = torch.autograd.grad(ssim.ssim_plain(xp, img)[1], xp)
    torch.cuda.synchronize()
    check(torch.equal(gk.isnan(), gp.isnan()) and bool(gp.isnan().any()),
          f"ssim_grad non-finite: NaN {int(gk.isnan().sum())} vs plain "
          f"{int(gp.isnan().sum())}")
    print(f"check ssim_grad non-finite: NaN {int(gp.isnan().sum())} at the "
          f"plain version's places")
    row.err = worst
    out = {}
    for shp in (shape, big):
        x1, img = ssim_grad_inputs(g, shp, True)
        sc = ssim_grad.scale_of(torch.zeros(shp[0], device="cuda"),
                                torch.ones((), device="cuda"), shp)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dx = ssim_grad.ssim_grad(x1, img, sc)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - nbytes(dx)
        del dx
        check(extra <= 1 << 20, f"ssim_grad {shp}: {extra} bytes beyond dx")
        moved = 3 * nbytes(x1)
        t = {"ms": time_ms(lambda: ssim_grad.ssim_grad(x1, img, sc)),
             "cold": time_cold_ms(
                 lambda a, b: ssim_grad.ssim_grad(a, b, sc),
                 cold_sets(lambda i: ssim_grad_inputs(g, shp), moved)),
             "plain": time_ms(lambda: ssim_grad.ssim_grad_plain(x1, img, sc),
                              iters=3, warmup=1),
             "moved": moved, "ops": x1.numel() * ssim_grad.OPS,
             "extra": extra}
        if shp == shape:
            stacked = torch.cat([x1, img, x1 * x1, img * img, x1 * img],
                                -1).permute(0, 3, 1, 2).contiguous(
                                ).requires_grad_(True)
            w = ssim.window_2d().to("cuda").expand(15, 1, 11, 11).contiguous()
            yconv = F.conv2d(stacked, w, padding=5, groups=15)
            ycot = torch.randn(yconv.shape, device="cuda", generator=g)
            t["yard"] = time_ms(lambda: torch.autograd.grad(
                yconv, stacked, ycot, retain_graph=True))
        t["bound"], t["by"] = bound(moved, t["ops"])
        out[shp] = t
        print(f"check ssim_grad {shp} f32: ms={t['ms']:.4f} cold_ms="
              f"{t['cold']:.4f} plain_ms={t['plain']:.4f} yardstick (11x11 "
              f"depthwise conv input gradient) ms={t.get('yard', 0):.4f} "
              f"bound_ms={t['bound']:.4f} ({t['by']}) share_of_bound="
              f"{t['bound'] / t['ms']:.3f}; bytes beyond dx {extra} "
              f"[{card}]")
    t = out[shape]
    row.add(t["ms"], t["plain"], t["moved"], t["ops"], yardstick_ms=t["yard"],
            cold_ms=t["cold"])
    b = out[big]
    row.extra = {"grad_rtol_of_plain_max": worst,
                 "bytes_beyond_dx": t["extra"],
                 "clr512": {"shape": list(big), "ms": b["ms"],
                            "cold_ms": b["cold"], "plain_ms": b["plain"],
                            "bound_ms": b["bound"],
                            "bytes_beyond_dx": b["extra"]}}


# ------------------------------------------------------------ phase 4


HEAD_PERTURB = 5e-4  # moves pixels by about 2 levels: a faint watermark


def perturbed_states(cfg, seed):
    """Random weights from ``seed`` with the zero-init coupling heads (each
    subnet's last conv, the INN's convs whose weights are all zero)
    perturbed (``HEAD_PERTURB``·N(0,1)), so that the INN is not the
    identity. Larger heads saturate the random INN and turn the output
    into noise."""
    model = VideoWatermarkModel(cfg)
    states = model.init_states(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    heads = {k.rsplit(".", 1)[0] for k, v in states["netG"].items()
             if k.endswith(".weight") and not v.any()}
    netG = {}
    for k, v in states["netG"].items():
        if k.rsplit(".", 1)[0] in heads:
            v = v + HEAD_PERTURB * torch.randn(v.shape, generator=gen).to(
                v.device)
        netG[k] = v
    return {"netG": netG, "generator": states["generator"]}


def compare(got, want, what):
    """Kernel-served vs plain-served outputs of one request."""
    out = {}
    if "watermarked" in got.keys():
        d = np.abs(got.watermarked.astype(int) - want.watermarked.astype(int))
        exact = float((d == 0).mean())
        check(d.max() <= EMBED_MAX_LEVELS and exact >= EMBED_FRAC_EXACT,
              f"{what}: watermark differs by up to {d.max()} levels, "
              f"{exact:.6f} exact")
        out.update(embed_max_levels=int(d.max()), embed_exact=exact)
    if "mask_bits" in got.keys():
        dis = float((got.mask != want.mask).mean())
        check(dis < MASK_DISAGREE, f"{what}: mask bits disagree on {dis}")
        ferr = float(np.abs(got.tamper_fraction
                            - want.tamper_fraction).max())
        out.update(mask_disagree=dis, tamper_fraction_err=ferr)
    return out


def run_slice(card):
    cfg = load_config(FLAGSHIP_CONFIG)
    check((cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size,
           cfg.train.dtype) == (B, T, S, "bfloat16"), "flagship config")
    modes = ("embed", "detect", "roundtrip")
    states = perturbed_states(cfg, seed=7)
    server = WatermarkServer(cfg, weights=states, modes=modes)
    plain = WatermarkServer(cfg, weights=states, modes=modes, kernels=PLAIN)
    rng = np.random.default_rng(0)
    clips = [rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
             for _ in range(3)]
    server.serve(clips[0], "roundtrip").prefetch()  # warm up cuDNN/cuBLAS
    torch.cuda.synchronize()

    # the main path, with the launch counts at 0 just before
    reset_launch_counts()
    res = server.serve(clips[0], "roundtrip")
    res.prefetch()
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path launches per roundtrip: {json.dumps(launches)}")
    check(launches == ROUNDTRIP_LAUNCHES, f"launch counts {launches}")

    wm = res.watermarked
    check(wm.shape == (B, T, S, S, 3) and wm.dtype == np.uint8, "wm shape")
    check(res.mask_bits.shape == (B, T, S, S // 8), "mask shape")
    frac = res.tamper_fraction
    check(frac.shape == (B,) and np.isfinite(frac).all()
          and ((frac >= 0) & (frac <= 1)).all(), f"tamper_fraction {frac}")
    moved = np.abs(wm.astype(int) - clips[0].astype(int))
    print(f"slice roundtrip: watermark moves pixels by mean "
          f"{moved.mean():.4f} max {moved.max()} levels; tamper_fraction "
          f"{np.round(frac, 4).tolist()}")
    check(moved.max() > 0, "the perturbed INN left the clip unchanged")

    stats = {
        "roundtrip": compare(res, plain.serve(clips[0], "roundtrip"),
                             "roundtrip"),
        "roundtrip_2": compare(server.serve(clips[1], "roundtrip"),
                               plain.serve(clips[1], "roundtrip"),
                               "roundtrip 2"),
        "embed": compare(server.serve(clips[2], "embed"),
                         plain.serve(clips[2], "embed"), "embed"),
    }
    det = server.serve(wm, "detect")
    stats["detect"] = compare(det, plain.serve(wm, "detect"), "detect")
    check(np.array_equal(det.mask_bits, res.mask_bits),
          "detect(watermarked) differs from the roundtrip's mask")
    print(f"slice vs plain server: {json.dumps(stats)}")

    # a small f32 clip against the CPU plain path (the CPU tests' reference)
    small = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, gt_size=64),
        train=dataclasses.replace(cfg.train, dtype="float32"))
    w_small = perturbed_states(small, seed=11)
    clip = rng.integers(0, 256, (2, T, 64, 64, 3), dtype=np.uint8)
    gpu = WatermarkServer(small, weights=w_small, modes=("roundtrip",))
    cpu = WatermarkServer(small, device="cpu", weights=w_small,
                          modes=("roundtrip",))
    small_stats = compare(gpu.serve(clip, "roundtrip"),
                          cpu.serve(clip, "roundtrip"), "f32 card vs CPU")
    print(f"slice f32 64² card vs CPU plain path: {json.dumps(small_stats)}")
    return server, plain, clips, launches


# ------------------------------------------------------------ phase 5


def run_timing(server, plain, clips, card):
    def one(srv):
        r = srv.serve(clips[0], "roundtrip")
        return r.watermarked, r.mask_bits, r.tamper_fraction

    p50 = {}
    for name, srv in (("kernels", server), ("plain", plain)):
        for _ in range(3):
            one(srv)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            one(srv)
            times.append((time.perf_counter() - t0) * 1e3)
        p50[name] = float(np.percentile(times, 50))
    n = 24
    t0 = time.perf_counter()
    for r in server.serve_stream((clips[i % 3] for i in range(n)),
                                 "roundtrip", window=2):
        r.watermarked, r.mask_bits, r.tamper_fraction
    wall = time.perf_counter() - t0
    fps = n * B * T / wall
    print(f"roundtrip latency p50_ms={p50['kernels']:.3f} (plain versions "
          f"p50_ms={p50['plain']:.3f}); stream window=2 frames_per_s="
          f"{fps:.1f} over {n} requests of {B}x{T}x{S}x{S} [{card}]")
    print(json.dumps({"serving": {
        "roundtrip_p50_ms": p50["kernels"], "plain_roundtrip_p50_ms":
        p50["plain"], "stream_frames_per_s": fps, "batch": B, "frames": T,
        "size": S, "card": card}}))


# ------------------------------------------------------------ phase 6


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def snapshot(model):
    out = [t.clone() for net in model.nets().values()
           for t in list(net.parameters()) + list(net.buffers())]
    for opt in model.optimizers.values():
        out += [t.clone() for t in opt.mu + opt.nu + [opt.count]]
    return out


def run_train(card):
    cfg = load_config(FLAGSHIP_CONFIG)
    gc.collect()  # the peak counts this phase, not what earlier ones left
    torch.cuda.reset_peak_memory_stats()
    states = perturbed_states(cfg, seed=7)
    model = VideoWatermarkModel(cfg)
    model.load_states(states)
    plain = VideoWatermarkModel(cfg, kernels=PLAIN)
    plain.load_states(states)
    loader = Loader(SyntheticVideoDataset(size=S, frames=T, length=16 * B,
                                          seed=cfg.train.seed), B,
                    seed=cfg.train.seed)
    batches = [model.to_device(v, m) for v, m in loader]  # 16 batches
    prev, (video, mask_) = batches[0][0], batches[1]
    draws = model.sample_draws(B, T)

    # KERNELS vs PLAIN: loss terms and gradients from the same state
    res = {}
    for name, m in (("kernels", model), ("plain", plain)):
        loss, aux, grads, _ = m.loss_and_grads(video, mask_, prev, draws)
        res[name] = ({"loss": float(loss), "lF": float(aux["lF"]),
                      "lB": float(aux["lB"]), "PF": float(aux["PF"])}, grads)
    (lk, gk), (lp, gp) = res["kernels"], res["plain"]
    for k in ("loss", "lF", "lB"):
        check(abs(lk[k] - lp[k]) <= TRAIN_LOSS_RTOL * abs(lp[k]),
              f"train {k}: kernels {lk[k]} plain {lp[k]}")
    grad_stats = {}
    for net in gk:
        cos = cosine(torch.cat([t.flatten() for t in gk[net]]),
                     torch.cat([t.flatten() for t in gp[net]]))
        rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(gk[net], gp[net]))
        grad_stats[net] = {"cosine": cos, "max_rel_err_per_tensor": rel}
        check(cos >= TRAIN_GRAD_COS, f"train {net} gradient cosine {cos}")
    print(f"train step bf16 {B}x{T}x{S}x{S}: kernels {json.dumps(lk)} plain "
          f"{json.dumps(lp)}; gradients kernels vs plain "
          f"{json.dumps(grad_stats)}")

    # the main path, with the launch counts at 0 just before
    torch.cuda.synchronize()
    reset_launch_counts()
    logs = model.train_step(video, mask_, prev, draws)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path launches per train step: {json.dumps(launches)}")
    check(launches == TRAIN_LAUNCHES, f"train launch counts {launches}")
    first = {k: float(v) for k, v in logs.items()}
    check(all(math.isfinite(v) for v in first.values()), f"train {first}")
    check(first["PF"] > 30.0, f"train PF {first['PF']}")

    # 2 warm-up and 10 timed steps, each on the batch after its prev
    times, all_logs = [], [first]
    for i in range(2, 14):
        p, (v, m) = batches[i - 1][0], batches[i]
        t0 = time.perf_counter()
        out = model.train_step(v, m, p)
        torch.cuda.synchronize()
        if i >= 4:
            times.append((time.perf_counter() - t0) * 1e3)
        all_logs.append({k: float(x) for k, x in out.items()})
    finite = all(math.isfinite(x) for lg in all_logs for x in lg.values())
    check(finite, f"train losses {all_logs}")
    p50 = float(np.percentile(times, 50))
    fps = B * T / p50 * 1e3
    print(f"train steps: {len(all_logs)} finite losses, last "
          f"{json.dumps(all_logs[-1])}")

    # the non-finite guard: a NaN pixel leaves every state as it was
    before = snapshot(model)
    bad = batches[14][0].clone()
    bad[0, 0, 5, 7, 1] = float("nan")
    logs = model.train_step(bad, batches[14][1], batches[13][0])
    torch.cuda.synchronize()
    kept = all(torch.equal(a, b) for a, b in zip(snapshot(model), before))
    check(not math.isfinite(float(logs["loss"])) and kept,
          f"guard: loss {float(logs['loss'])}, state kept {kept}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train guard: a batch with a NaN pixel gives loss "
          f"{float(logs['loss'])} and keeps every parameter, moment, step "
          f"count and running statistic ({len(before)} tensors)")
    print(f"train step p50_ms={p50:.3f} frames_per_s={fps:.1f} over "
          f"{len(times)} timed steps of {B}x{T}x{S}x{S} bf16 (2 warm-up); "
          f"peak memory {peak:.2f} GiB [{card}]")
    print(json.dumps({"training": {
        "train_step_p50_ms": p50, "frames_per_s": fps,
        "timed_steps": len(times), "peak_memory_gib": peak, "batch": B,
        "frames": T, "size": S, "loss_terms": {"kernels": lk, "plain": lp},
        "gradients": grad_stats, "card": card}}))
    return launches


# ------------------------------------------------------------ phase 7


def eval_preds(model, video, mask_, prev, draws):
    """The eval step's prediction, rebuilt from its public parts."""
    with torch.no_grad():
        fwd = model.embed(video)
        attacked = attack_pool_video(fwd * (1.0 - mask_) + prev * mask_,
                                     draws, model.attack_ratios,
                                     model.kernels).clamp(0.0, 1.0)
        return model.predict_mask(attacked)


def f1_bounds(pk, pp, gt):
    """Per level, ``4·n/(2·tp + fp + fn)`` with ``n`` the pixels whose
    predictions lie on the two sides of the level on the two paths; and the
    ``n``."""
    pkl, ppl = torch.trunc(pk * 255.0), torch.trunc(pp * 255.0)
    g = gt > 0.5
    out, flips = [], []
    for t in LEVELS:
        on = pkl > t
        n = int(((pkl > t) != (ppl > t)).sum())
        denom = 2 * int((on & g).sum()) + int((on ^ g).sum())
        out.append(4.0 * n / max(denom, 1))
        flips.append(n)
    return out, flips


def run_eval(card):
    """The flagship eval step at full width through KERNELS, with the
    launch counts at 0 just before and read just after; KERNELS against
    PLAIN on the same weights, batch, previous batch and draws; then 2
    warm-up and 10 timed steps."""
    cfg = load_config(FLAGSHIP_CONFIG)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    states = perturbed_states(cfg, seed=7)
    model = VideoWatermarkModel(cfg)
    model.load_states(states)
    plain = VideoWatermarkModel(cfg, kernels=PLAIN)
    plain.load_states(states)
    loader = Loader(SyntheticVideoDataset(size=S, frames=T, length=14 * B,
                                          seed=cfg.train.seed), B,
                    seed=cfg.train.seed)
    batches = [model.to_device(v, m) for v, m in loader]  # 14 batches
    prev, (video, mask_) = batches[0][0], batches[1]
    draws = model.sample_draws(B, T)
    model.eval_step(video, mask_, prev, draws)  # warm up cuDNN/cuBLAS
    torch.cuda.synchronize()

    # the main path, with the launch counts at 0 just before
    reset_launch_counts()
    out_k = model.eval_step(video, mask_, prev, draws)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path launches per eval step: {json.dumps(launches)}")
    check(launches == EVAL_LAUNCHES, f"eval launch counts {launches}")

    out_p = plain.eval_step(video, mask_, prev, draws)
    mk = {k: v.tolist() for k, v in out_k.items()}
    mp = {k: v.tolist() for k, v in out_p.items()}
    check(all(np.isfinite(np.asarray(v)).all() for v in mk.values()),
          f"eval metrics {mk}")
    check(mk["psnr_forward"] > 30.0 and 0.0 < mk["ssim_forward"] <= 1.0
          and 0.0 <= mk["f1_best"] <= 1.0, f"eval metrics {mk}")
    dpsnr = abs(mk["psnr_forward"] - mp["psnr_forward"])
    dssim = abs(mk["ssim_forward"] - mp["ssim_forward"])
    check(dpsnr <= EVAL_PSNR_ATOL, f"eval psnr kernels {mk} plain {mp}")
    check(dssim <= EVAL_SSIM_ATOL, f"eval ssim kernels {mk} plain {mp}")
    bounds, flips = f1_bounds(eval_preds(model, video, mask_, prev, draws),
                              eval_preds(plain, video, mask_, prev, draws),
                              mask_)
    df1 = [abs(a - b) for a, b in zip(mk["f1_sweep"], mp["f1_sweep"])]
    check(all(d <= b + 1e-6 for d, b in zip(df1, bounds)),
          f"eval f1 kernels {mk['f1_sweep']} plain {mp['f1_sweep']} "
          f"bounds {bounds}")
    print(f"eval step bf16 {B}x{T}x{S}x{S}: kernels {json.dumps(mk)} plain "
          f"{json.dumps(mp)}; |dpsnr| {dpsnr:.3g} dB (tol "
          f"{EVAL_PSNR_ATOL}), |dssim| {dssim:.3g} (tol {EVAL_SSIM_ATOL}), "
          f"|df1| per level {[round(d, 8) for d in df1]} within "
          f"{[round(b, 8) for b in bounds]} (pixels across a level "
          f"between the paths {flips} of {video.numel() // 3})")

    times, psnrs = [], []
    for i in range(2, 14):
        p, (v, m) = batches[i - 1][0], batches[i]
        t0 = time.perf_counter()
        out = model.eval_step(v, m, p)
        torch.cuda.synchronize()
        if i >= 4:
            times.append((time.perf_counter() - t0) * 1e3)
        psnrs.append(float(out["psnr_forward"]))
    check(all(math.isfinite(x) for x in psnrs), f"eval psnr {psnrs}")
    p50 = float(np.percentile(times, 50))
    fps = B * T / p50 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"eval step p50_ms={p50:.3f} frames_per_s={fps:.1f} over "
          f"{len(times)} timed steps of {B}x{T}x{S}x{S} bf16 (2 warm-up); "
          f"peak memory {peak:.2f} GiB [{card}]")
    print(json.dumps({"eval": {
        "eval_step_p50_ms": p50, "frames_per_s": fps,
        "timed_steps": len(times), "peak_memory_gib": peak, "batch": B,
        "frames": T, "size": S, "metrics": {"kernels": mk, "plain": mp},
        "f1_flips_per_level": flips, "card": card}}))
    return launches


# ------------------------------------------------------------ phase 8


def run_trainer(card):
    """The trainer at full width: npz pretrain, ``fit`` with telemetry and
    montages, a checkpoint served through ``WatermarkServer(ckpt_dir=)``."""
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_trainer"
    shutil.rmtree(root, ignore_errors=True)
    try:
        _run_trainer(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run_trainer(root, card):
    base = load_config(FLAGSHIP_CONFIG)
    steps = 4
    src = VideoWatermarkModel(base)
    src.load_states(perturbed_states(base, seed=7))
    netg, gen, stats = params_to_jax(src.inn.state_dict(),
                                     src.unet.state_dict())
    (root / "pretrain").mkdir(parents=True)
    save_npz_tree(str(root / "pretrain" / "netG.npz"), {"params": netg})
    save_npz_tree(str(root / "pretrain" / "generator.npz"),
                  {"params": gen, "batch_stats": stats})
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model,
                                        pretrain_path=str(root / "pretrain")),
        train=dataclasses.replace(base.train, montage_interval=2))
    model = VideoWatermarkModel(cfg)
    model.init_states(3)
    want = {k: v for net in ("netG", "generator")
            for k, v in src.states()[net].items()
            if not k.endswith("num_batches_tracked")}
    got = {k: v for net in ("netG", "generator")
           for k, v in model.states()[net].items()
           if not k.endswith("num_batches_tracked")}
    check(got.keys() == want.keys()
          and all(torch.equal(got[k], want[k]) for k in want),
          "pretrain: the loaded tensors differ from the source's")
    loader = Loader(SyntheticVideoDataset(size=S, frames=T, length=8 * B,
                                          seed=cfg.train.seed), B,
                    seed=cfg.train.seed)
    video, _ = model.to_device(*next(iter(loader)))
    check(torch.equal(model.embed(video), src.embed(video)),
          "pretrain: the embed differs from the source model's")
    del src

    canvases = []
    stitch = video_model.stitch_images

    def recording(*groups, **kw):
        canvases.append(stitch(*groups, **kw))
        return canvases[-1]
    video_model.stitch_images = recording
    logger = ScalarLogger(str(root / "logs"))
    try:
        t0 = time.perf_counter()
        _, logs = model.fit(loader, steps, scalar_logger=logger,
                            montage_dir=str(root / "montage"))
        fit_s = time.perf_counter() - t0
    finally:
        video_model.stitch_images = stitch
        logger.close()
    recs = [json.loads(line) for line in
            (root / "logs" / "scalars.jsonl").read_text().splitlines()]
    check([r["step"] for r in recs] == list(range(1, steps + 1))
          and all(math.isfinite(v) for r in recs for v in r.values()),
          f"scalar log {recs}")
    pngs = sorted((root / "montage").glob("*.png"))
    check([p.name for p in pngs] == ["00002.png", "00004.png"]
          and len(canvases) == 2, f"montages {pngs}")
    for p, c in zip(pngs, canvases):
        check(c.shape == (B * S, 6 * (S + 5), 3)
              and np.array_equal(read_png(str(p)), c),
              f"{p.name} does not decode to the montage canvas")

    save_checkpoint(str(root / "ckpt"), steps, model)
    clip = np.random.default_rng(3).integers(0, 256, (B, T, S, S, 3),
                                             dtype=np.uint8)
    served = WatermarkServer(cfg, ckpt_dir=str(root / "ckpt"),
                             modes=("roundtrip",)).serve(clip, "roundtrip")
    direct = WatermarkServer(cfg, weights=model.states(),
                             modes=("roundtrip",)).serve(clip, "roundtrip")
    check(all(np.array_equal(getattr(served, k), getattr(direct, k))
              for k in ("watermarked", "mask_bits", "tamper_fraction")),
          "the server from the checkpoint differs from the weights' server")
    print(f"trainer: npz pretrain loaded bit-equal ({len(want)} tensors, "
          f"embed equal); fit {steps} steps in {fit_s:.2f} s, last "
          f"{json.dumps(logs)}; {len(recs)} finite scalar records; montages "
          f"{[p.name for p in pngs]} ({canvases[0].shape}) decode to their "
          f"canvases; the checkpoint's server roundtrip equals the weights' "
          f"[{card}]")


# ------------------------------------------------------------ phase 9


def int8_probs(server, u8):
    """Per-pixel probabilities of a server's detect on ``u8`` (B,T,S,S,3):
    the int8 tree's or the bf16 net's."""
    m = server.model
    flat = torch.from_numpy(u8).to("cuda").reshape(B * T, S, S, 3)
    with torch.no_grad():
        if server._qext is not None:
            logits = unet_int8.body_int8(server._qext,
                                         wire.to_s2d_i8(flat, 2))
        else:
            logits = m.unet.body(wire.to_s2d(flat, 2, m.compute_dtype))
    return torch.sigmoid(depth_to_space(logits, 2).float()).cpu().numpy()


def served_launches(server, clip, mode):
    server.serve(clip, mode).prefetch()
    torch.cuda.synchronize()
    reset_launch_counts()
    res = server.serve(clip, mode)
    res.prefetch()
    torch.cuda.synchronize()
    return launch_counts(), res


def p50_ms(server, clip, mode, n=20):
    def one():
        r = server.serve(clip, mode)
        return [getattr(r, k) for k in r.keys()]
    for _ in range(3):
        one()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        one()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50))


def stream_fps(server, clips, n=24):
    t0 = time.perf_counter()
    for r in server.serve_stream((clips[i % len(clips)] for i in range(n)),
                                 "roundtrip", window=2):
        [getattr(r, k) for k in r.keys()]
    return n * B * T / (time.perf_counter() - t0)


def run_int8(card):
    """Phase 9: int8 serving at full width, on the perturbed random weights
    of phase 4: launch counts of a detect and of roundtrips with the int8
    extractor and with both int8 paths; KERNELS against PLAIN on the same
    trees; int8 against the bf16 server; a self-calibrated server; p50
    latency, streaming frames/s and peak memory beside the bf16 server."""
    cfg = load_config(FLAGSHIP_CONFIG)
    states = perturbed_states(cfg, seed=7)
    rng = np.random.default_rng(9)
    calib = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    clips = [rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
             for _ in range(3)]
    modes = ("embed", "detect", "roundtrip")
    t0 = time.perf_counter()
    bf16 = WatermarkServer(cfg, weights=states, modes=modes)
    ext = WatermarkServer(cfg, weights=states, modes=modes,
                          int8_extract=True, int8_calib=calib)
    both = WatermarkServer(cfg, weights=states, modes=modes,
                           int8_extract=True, int8_embed=True,
                           int8_calib=[calib])
    setup_s = time.perf_counter() - t0

    launches = {}
    launches["int8_detect"], det = served_launches(ext, clips[0], "detect")
    want = dict.fromkeys(launch_counts(), 0)
    check(launches["int8_detect"] == {**want, **INT8_DETECT_LAUNCHES},
          f"int8 detect launches {launches['int8_detect']}")
    launches["int8x_roundtrip"], _ = served_launches(ext, clips[0],
                                                     "roundtrip")
    check(launches["int8x_roundtrip"] == {**ROUNDTRIP_LAUNCHES,
                                          **INT8_DETECT_LAUNCHES,
                                          "wire": 2},
          f"int8-extract roundtrip launches {launches['int8x_roundtrip']}")
    peak = {}  # a roundtrip's memory above what the three servers hold
    for name, srv in (("bf16", bf16), ("int8", both)):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counts, res = served_launches(srv, clips[0], "roundtrip")
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    launches["int8_roundtrip"] = counts
    check(launches["int8_roundtrip"] == INT8_ROUNDTRIP_LAUNCHES,
          f"int8 roundtrip launches {launches['int8_roundtrip']}")
    print(f"main path launches, int8 detect: "
          f"{json.dumps(launches['int8_detect'])}; int8-extract roundtrip: "
          f"{json.dumps(launches['int8x_roundtrip'])}; int8 roundtrip (both "
          f"paths): {json.dumps(launches['int8_roundtrip'])}")
    wm = res.watermarked
    check(wm.shape == (B, T, S, S, 3) and wm.dtype == np.uint8, "int8 wm")
    frac = res.tamper_fraction
    check(frac.shape == (B,) and np.isfinite(frac).all()
          and ((frac >= 0) & (frac <= 1)).all(), f"int8 fraction {frac}")
    moved = np.abs(wm.astype(int) - clips[0].astype(int))
    check(moved.max() > 0, "the int8 embed left the clip unchanged")

    # KERNELS vs PLAIN on the same trees (the f64 plain server: 2 requests)
    plain = WatermarkServer(cfg, weights=states, modes=modes, kernels=PLAIN)
    plain._qext, plain._qemb = both._qext, both._qemb
    pdet = plain.serve(clips[1], "detect")
    kdet = both.serve(clips[1], "detect")
    check(np.array_equal(kdet.mask_bits, pdet.mask_bits),
          "int8 detect: mask bits differ from the plain versions'")
    ferr = float(np.abs(kdet.tamper_fraction - pdet.tamper_fraction).max())
    check(ferr <= MEAN_ATOL, f"int8 detect: tamper fraction err {ferr}")
    prt = plain.serve(clips[0], "roundtrip")
    d = np.abs(wm.astype(int) - prt.watermarked.astype(int))
    exact = float((d == 0).mean())
    check(d.max() <= EMBED_MAX_LEVELS and exact >= EMBED_FRAC_EXACT,
          f"int8 embed: {d.max()} levels, {exact} exact vs plain")
    vs_plain = {"detect_mask_bits_equal": True,
                "detect_tamper_fraction_err": ferr,
                "embed_max_levels": int(d.max()), "embed_exact": exact}
    print(f"int8 vs plain server: {json.dumps(vs_plain)}")
    del plain

    # int8 vs the bf16 server on the same weights and bytes
    ref_wm = bf16.serve(clips[0], "roundtrip").watermarked
    p8, pb = int8_probs(ext, ref_wm), int8_probs(bf16, ref_wm)
    dp = float(np.abs(p8 - pb).mean())
    agree = float(((p8 > 0.5) == (pb > 0.5)).mean())
    bits = float((ext.serve(ref_wm, "detect").mask
                  == bf16.serve(ref_wm, "detect").mask).mean())
    dwm = np.abs(wm.astype(int) - ref_wm.astype(int))
    quality = {"mean_abs_dp": dp, "max_abs_dp": float(np.abs(p8 - pb).max()),
               "threshold_agreement": agree, "served_mask_agreement": bits,
               "embed_vs_bf16_mean_levels": float(dwm.mean()),
               "embed_vs_bf16_max_levels": int(dwm.max()),
               "watermark_mean_levels": float(moved.mean())}
    print(f"int8 vs bf16 server (same weights): {json.dumps(quality)}")
    check(dp < INT8_MEAN_DP and agree > INT8_AGREE,
          f"int8 extract off the bf16 net: {quality}")

    # self-calibration (no clips): serves, finite
    selfcal = WatermarkServer(cfg, weights=states, modes=("roundtrip",),
                              int8_extract=True, int8_embed=True)
    sres = selfcal.serve(clips[0], "roundtrip")
    check(np.isfinite(sres.tamper_fraction).all()
          and sres.watermarked.shape == (B, T, S, S, 3), "self-calibrated")
    del selfcal

    timing = {}
    for name, srv in (("bf16", bf16), ("int8_extract", ext),
                      ("int8_both", both)):
        timing[name] = {"detect_p50_ms": p50_ms(srv, clips[0], "detect"),
                        "roundtrip_p50_ms": p50_ms(srv, clips[0],
                                                   "roundtrip"),
                        "stream_frames_per_s": stream_fps(srv, clips)}
    print(json.dumps({"int8_serving": {
        **timing, "roundtrip_peak_memory_gib_above_servers": peak,
        "setup_s_three_servers": setup_s, "batch": B, "frames": T,
        "size": S, "card": card}}))
    return launches


# ------------------------------------------------------------ phase 10


CONV_B = 8        # the convergence run's batch (the JAX record's)
CONV_STEPS = 20   # steps of each run, with an eval at the last
CONV_STOP = 10    # the segment boundary of the resumed run
# the convergence runner's path per run: CONV_STEPS train steps and one
# eval step (``--libjpeg-batches 0``: no libjpeg line)
CONV_LAUNCHES = {k: CONV_STEPS * TRAIN_LAUNCHES[k] + EVAL_LAUNCHES[k]
                 for k in TRAIN_LAUNCHES}
# int8_eval's kernels: embed, splice, the attack pool, the F1 sweep and the
# int8 UNet; with the int8 embed also the int8 INN's
INT8_EVAL_KERNELS = ("transition", "coupling_head", "splice", "jpeg_pair",
                     "median3", "attack_mix", "f1_sweep", "qconv", "qconv_t")


# the flagship's model options (the runner's defaults are the reference
# shapes)
FLAGSHIP_OPTIONS = ["--subnet", "res_tpu2", "--extractor", "unet_tpu",
                    "--haar", "conv", "--packed", "--econvs", "2,2,1,1,1"]


def conv_args(root, name, *extra):
    return ["--steps", str(CONV_STEPS), "--eval-every", str(CONV_STEPS),
            "--batch", str(CONV_B), *FLAGSHIP_OPTIONS,
            "--init-nets", str(root / "init"),
            "--out", str(root / f"{name}.jsonl"),
            "--ckpt-dir", str(root / name), *extra]


def conv_records(path):
    recs = [json.loads(line) for line in open(path)]
    steps = [r for r in recs if "loss" in r]
    check(list(recs[0]) == ["config"] and [r["step"] for r in steps]
          == [1, CONV_STEPS] and "f1_best" in steps[-1]
          and all(math.isfinite(v) for r in steps for k, v in r.items()
                  if isinstance(v, float)), f"{path}: {recs}")
    return steps


def run_convergence_phase(card):
    """Phase 10: the convergence runner at full width (b8, 256², T4) from
    phase 4's weights, 20 steps with an eval at the last, with the launch
    counts at 0 just before and read just after; the same run in two
    segments (a stop at step 10, then ``--resume``), its clips, masks,
    previous clips and attack draws at steps 11-20 EQUAL to the unbroken
    run's and its logs finite (weights are not compared: cuDNN's backward
    is not deterministic); then ``int8_eval`` on the unbroken run's
    checkpoint, 2 batches, without and with ``--int8-embed``."""
    from vwfd_tpu_torch import int8_eval, run_convergence as rc
    from vwfd_tpu_torch.models.state import save_nets

    root = Path("build") / "chip_smoke_convergence"
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config(FLAGSHIP_CONFIG)
    model = VideoWatermarkModel(cfg)
    model.load_states(perturbed_states(cfg, seed=7))
    save_nets(str(root / "init"), 0, model)
    del model
    gc.collect()

    seen = {"a": {}, "b": {}}

    def recorder(name):
        def on_step(step, video, mask_, prev, draws):
            if step > CONV_STOP:
                seen[name][step] = (video, mask_, prev, *draws)
        return on_step

    launches = {}
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launch_counts()
    check(rc.run(rc.parse_args(conv_args(root, "a", "--libjpeg-batches",
                                         "0")), recorder("a")) == "done",
          "convergence run a")
    torch.cuda.synchronize()
    launches["convergence"] = launch_counts()
    wall_a = time.perf_counter() - t0
    print(f"main path launches, convergence runner ({CONV_STEPS} steps, "
          f"1 eval): {json.dumps(launches['convergence'])}")
    check(launches["convergence"] == CONV_LAUNCHES,
          f"convergence launches {launches['convergence']}")
    steps_a = conv_records(root / "a.jsonl")

    check(rc.run(rc.parse_args(conv_args(
        root, "b", "--stop-at-step", str(CONV_STOP), "--resume")),
        recorder("b")) == "stopped", "segment 1 did not stop")
    check(rc.run(rc.parse_args(conv_args(root, "b", "--resume")),
                 recorder("b")) == "done", "segment 2")
    steps_b = conv_records(root / "b.jsonl")
    want = list(range(CONV_STOP + 1, CONV_STEPS + 1))
    check(sorted(seen["a"]) == want and sorted(seen["b"]) == want,
          f"steps seen {sorted(seen['a'])} {sorted(seen['b'])}")
    same = all(torch.equal(x, y) for k in want
               for x, y in zip(seen["a"][k], seen["b"][k]))
    check(same, "the resumed run's clips or draws differ from the "
          "unbroken run's")
    del seen
    print(f"convergence runner b{CONV_B}x{T}x{S}x{S}: {CONV_STEPS} steps in "
          f"{wall_a:.1f} s with the model's set-up; step {CONV_STEPS} "
          f"unbroken {json.dumps(steps_a[-1])}; resumed at step {CONV_STOP} "
          f"{json.dumps(steps_b[-1])}; clips, masks, previous clips and "
          f"draws at steps {want[0]}-{want[-1]} equal")

    gates = {}
    for name, extra in (("int8_eval", []),
                        ("int8_eval_embed", ["--int8-embed"])):
        torch.cuda.synchronize()
        reset_launch_counts()
        gates[name] = int8_eval.main(
            ["--ckpt-dir", str(root / "a"), *FLAGSHIP_OPTIONS,
             "--calib-batches", "1", "--eval-batches", "2", *extra])
        torch.cuda.synchronize()
        launches[name] = launch_counts()
        need = INT8_EVAL_KERNELS + (("qcoupling_head",) if extra else ())
        idle = [k for k in need if launches[name][k] == 0]
        check(not idle, f"{name} launched none of {idle}")
        g = gates[name]
        check(all(math.isfinite(v) for v in g.values())
              and g["mean_abs_dprob"] < INT8_MEAN_DP, f"{name}: {g}")
    print(f"main path launches, int8_eval: {json.dumps(launches['int8_eval'])}"
          f"; with --int8-embed: {json.dumps(launches['int8_eval_embed'])}")
    print(json.dumps({"convergence": {
        "steps": CONV_STEPS, "batch": CONV_B, "frames": T, "size": S,
        "wall_s_20_steps": wall_a, "unbroken": steps_a[-1],
        "resumed": steps_b[-1], "int8_eval": gates, "card": card}}))
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------------------------ phase 11


REF_TRAIN_B = 8   # the JAX refshape record's batch
ZERO_LAUNCHES = {k: 0 for k in ROUNDTRIP_LAUNCHES}
# the refshape roundtrip: K14 ×6 (three levels down and up), K15 ×10 (five
# couplings, two halves each), K3 ×2 (to_channels, to_u8_s2d at s = 1), K4
REFSHAPE_ROUNDTRIP = {**ZERO_LAUNCHES, "wire": 2, "mask_pack": 1, "haar": 6,
                      "coupling_affine": 10}
# the train step: K14 six forward and five backward (the clip takes no
# gradient), K15 ten forward and ten backward, the attack pool and splice
# as the flagship's
REFSHAPE_TRAIN = {**ZERO_LAUNCHES, "jpeg_pair": 2, "median3": 2,
                  "attack_mix": 2, "splice": 2, "haar": 11,
                  "coupling_affine": 20}
REFSHAPE_EVAL = {**ZERO_LAUNCHES, "jpeg_pair": 1, "median3": 1,
                 "f1_sweep": 1, "ssim": 1, "attack_mix": 1, "splice": 1,
                 "haar": 6, "coupling_affine": 10}


def p50_of(fn, n, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50))


def run_refshape(card):
    """Phase 11: the reference-shaped model (``configs/refshape.yaml``:
    ``ModelConfig()``'s nets, the INN module path with res subnets and the
    lifting Haar, the reference UNet) at full width, random weights with the
    zero-init heads perturbed. A b16 ``WatermarkServer`` roundtrip with the
    launch counts at 0 just before and read just after (K14 ×6, K15 ×10,
    K3 ×2, K4 ×1), held to the same server on ``PLAIN`` (F7's rule); one
    b8 ``train_step`` through ``KERNELS`` with its counts, its loss terms and
    gradients held to ``PLAIN`` as phase 6 holds the flagship's, and K14's
    and K15's forward and backward counts; one ``eval_step`` with its
    counts; p50 of the roundtrip, the train step and the eval step."""
    cfg = load_config(REFSHAPE_CONFIG)
    mc = cfg.model
    check((cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size,
           cfg.train.dtype, mc.inn_subnet, mc.inn_haar, mc.inn_packed,
           mc.extractor) == (B, T, S, "bfloat16", "res", "lift", False,
                             "unet"), "refshape config")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    states = perturbed_states(cfg, seed=7)
    modes = ("embed", "detect", "roundtrip")
    server = WatermarkServer(cfg, weights=states, modes=modes)
    plain = WatermarkServer(cfg, weights=states, modes=modes, kernels=PLAIN)
    rng = np.random.default_rng(3)
    clips = [rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
             for _ in range(2)]
    server.serve(clips[0], "roundtrip").prefetch()
    torch.cuda.synchronize()
    reset_launch_counts()
    res = server.serve(clips[0], "roundtrip")
    res.prefetch()
    torch.cuda.synchronize()
    launches = {"refshape_roundtrip": launch_counts()}
    print(f"main path launches per refshape roundtrip: "
          f"{json.dumps(launches['refshape_roundtrip'])}")
    check(launches["refshape_roundtrip"] == REFSHAPE_ROUNDTRIP,
          f"refshape roundtrip launches {launches['refshape_roundtrip']}")
    wm = res.watermarked
    check(wm.shape == (B, T, S, S, 3) and res.mask_bits.shape
          == (B, T, S, S // 8), "refshape roundtrip shapes")
    frac = res.tamper_fraction
    check(np.isfinite(frac).all() and ((frac >= 0) & (frac <= 1)).all(),
          f"refshape tamper_fraction {frac}")
    moved = np.abs(wm.astype(int) - clips[0].astype(int))
    check(moved.max() > 0, "the perturbed refshape INN left the clip as it "
          "was")
    stats = {"roundtrip": compare(res, plain.serve(clips[0], "roundtrip"),
                                  "refshape roundtrip"),
             "embed": compare(server.serve(clips[1], "embed"),
                              plain.serve(clips[1], "embed"),
                              "refshape embed")}
    det = server.serve(wm, "detect")
    stats["detect"] = compare(det, plain.serve(wm, "detect"),
                              "refshape detect")
    check(np.array_equal(det.mask_bits, res.mask_bits),
          "refshape detect(watermarked) differs from the roundtrip's mask")
    print(f"refshape roundtrip: watermark moves pixels by mean "
          f"{moved.mean():.4f} max {moved.max()} levels; vs the plain "
          f"server {json.dumps(stats)}")
    def one(srv):  # every output, on the host
        r = srv.serve(clips[0], "roundtrip")
        return r.watermarked, r.mask_bits, r.tamper_fraction

    p50 = {name: p50_of(lambda: one(srv), 10)
           for name, srv in (("kernels", server), ("plain", plain))}
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del server, plain, det, res
    gc.collect()

    tcfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=REF_TRAIN_B))
    model = VideoWatermarkModel(tcfg)
    model.load_states(states)
    ref = VideoWatermarkModel(tcfg, kernels=PLAIN)
    ref.load_states(states)
    loader = Loader(SyntheticVideoDataset(size=S, frames=T,
                                          length=8 * REF_TRAIN_B,
                                          seed=cfg.train.seed), REF_TRAIN_B,
                    seed=cfg.train.seed)
    batches = [model.to_device(v, m) for v, m in loader]  # 8 batches
    prev, (video, mask_) = batches[0][0], batches[1]
    draws = model.sample_draws(REF_TRAIN_B, T)
    res_ = {}
    for name, m in (("kernels", model), ("plain", ref)):
        loss, aux, grads, _ = m.loss_and_grads(video, mask_, prev, draws)
        res_[name] = ({"loss": float(loss), "lF": float(aux["lF"]),
                       "lB": float(aux["lB"]), "PF": float(aux["PF"])},
                      grads)
    (lk, gk), (lp, gp) = res_["kernels"], res_["plain"]
    for k in ("loss", "lF", "lB"):
        check(abs(lk[k] - lp[k]) <= TRAIN_LOSS_RTOL * abs(lp[k]),
              f"refshape train {k}: kernels {lk[k]} plain {lp[k]}")
    grad_stats = {}
    for net in gk:
        cos = cosine(torch.cat([t.flatten() for t in gk[net]]),
                     torch.cat([t.flatten() for t in gp[net]]))
        grad_stats[net] = {"cosine": cos}
        check(cos >= TRAIN_GRAD_COS, f"refshape {net} gradient cosine {cos}")
    del ref, res_, gk, gp
    print(f"refshape train step bf16 {REF_TRAIN_B}x{T}x{S}x{S}: kernels "
          f"{json.dumps(lk)} plain {json.dumps(lp)}; gradients kernels vs "
          f"plain {json.dumps(grad_stats)}")

    # K14 and K15 forward and backward
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.enable_grad():
        loss, _, _ = model._loss(video, mask_, prev, draws.to(model.device))
        fwd = launch_counts()
        params = [p for net in model.nets().values()
                  for p in net.parameters()]
        torch.autograd.grad(loss, params, allow_unused=True)
    both = launch_counts()
    split = {k: {"forward": fwd[k], "backward": both[k] - fwd[k]}
             for k in ("haar", "coupling_affine")}
    print(f"refshape train step K14/K15 launches: {json.dumps(split)}")
    check(split == {"haar": {"forward": 6, "backward": 5},
                    "coupling_affine": {"forward": 10, "backward": 10}},
          f"refshape K14/K15 forward/backward launches {split}")

    # the main paths, with the launch counts at 0 just before
    torch.cuda.synchronize()
    reset_launch_counts()
    logs = model.train_step(video, mask_, prev, draws)
    torch.cuda.synchronize()
    launches["refshape_train_step"] = launch_counts()
    print(f"main path launches per refshape train step: "
          f"{json.dumps(launches['refshape_train_step'])}")
    check(launches["refshape_train_step"] == REFSHAPE_TRAIN,
          f"refshape train launches {launches['refshape_train_step']}")
    first = {k: float(v) for k, v in logs.items()}
    check(all(math.isfinite(v) for v in first.values()),
          f"refshape train {first}")
    model.eval_step(video, mask_, prev, draws)
    torch.cuda.synchronize()
    reset_launch_counts()
    ev = model.eval_step(video, mask_, prev, draws)
    torch.cuda.synchronize()
    launches["refshape_eval_step"] = launch_counts()
    print(f"main path launches per refshape eval step: "
          f"{json.dumps(launches['refshape_eval_step'])}")
    check(launches["refshape_eval_step"] == REFSHAPE_EVAL,
          f"refshape eval launches {launches['refshape_eval_step']}")
    mk = {k: v.tolist() for k, v in ev.items()}
    check(all(np.isfinite(np.asarray(v)).all() for v in mk.values())
          and mk["psnr_forward"] > 30.0, f"refshape eval {mk}")

    it = iter(range(10 ** 6))

    def train_one():
        i = 2 + next(it) % (len(batches) - 2)
        return model.train_step(batches[i][0], batches[i][1],
                                batches[i - 1][0])["loss"].item()

    train_p50 = p50_of(train_one, 8)
    eval_p50 = p50_of(lambda: model.eval_step(video, mask_, prev,
                                              draws)["f1_best"].item(), 8)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"roundtrip_p50_ms": p50["kernels"],
           "plain_roundtrip_p50_ms": p50["plain"],
           "train_step_p50_ms": train_p50, "eval_step_p50_ms": eval_p50,
           "serve_batch": B, "train_batch": REF_TRAIN_B, "frames": T,
           "size": S, "peak_memory_gib": peak,
           "serve_peak_memory_gib": serve_peak,
           "loss_terms": {"kernels": lk, "plain": lp},
           "gradients": grad_stats, "eval": mk, "card": card}
    print(f"refshape p50: roundtrip {p50['kernels']:.3f} ms (plain "
          f"{p50['plain']:.3f}) at b{B}; train step {train_p50:.3f} ms and "
          f"eval step {eval_p50:.3f} ms at b{REF_TRAIN_B}; peak memory "
          f"{peak:.2f} GiB [{card}]")
    print(json.dumps({"refshape": out}))
    return launches


# ------------------------------------------------------------ phase 12
# HiDDeN at full width: message 30, 64 channels, 4 / 7 / 3 blocks, 128², b8,
# f32 (TF32 off: HiddenModel runs under device.full_f32)

HID_LOSS_RTOL = 1e-5     # loss terms, KERNELS vs PLAIN
HID_GRAD_COS = 0.9999    # each net's gradient, KERNELS vs PLAIN
HID_BIT_NEAR = 1e-5      # decoded bits may differ only within this of 0.5
HID_CKPT = Path("checkpoints_hidden_r5_torch")  # the step-23,000 nets
# each train step's launches of K16 and K17 by member: forward + backward
HID_TRAIN = {m: {**ZERO_LAUNCHES,
                 **({"zigzag_jpeg": 2} if m == "jpeg_mask" else {}),
                 **({"crop_resize": 2} if m == "crop" else {})}
             for m in ("identity", "crop", "cropout", "dropout", "gaussian",
                       "jpeg_mask")}
# one eval batch through the seven members: one launch of each
HID_EVAL = {**ZERO_LAUNCHES, "zigzag_jpeg": 1, "crop_resize": 1}


def hidden_tensors(model):
    return [t for n in model.nets() for t in model._tensors(n)]


def copy_hidden(dst, src):
    """Every parameter, BatchNorm statistic, Adam moment and count of
    ``src`` into ``dst``."""
    with torch.no_grad():
        for d, s_ in zip(hidden_tensors(dst), hidden_tensors(src)):
            d.copy_(s_)


def run_hidden(card):
    """HiDDeN at full width (message 30, 64 channels, 4 / 7 / 3 blocks,
    128², b8, f32): one ``train_step`` per member through ``KERNELS`` and
    through ``PLAIN`` from the same state, batch, messages and draws (loss
    terms within ``HID_LOSS_RTOL``, each net's gradient cosine ≥
    ``HID_GRAD_COS``), each with the launch counts at 0 just before and
    read just after (K16 ×2 on jpeg_mask, K17 ×2 on crop); a batch with a
    NaN pixel that leaves every tensor as it was; ``infer`` on the
    committed step-23,000 nets with two batches of ``eval_hidden``'s images
    and messages through every member, ``KERNELS`` against ``PLAIN``
    (decoded bits EQUAL except within ``HID_BIT_NEAR`` of 0.5, counted;
    K16 and K17 once a batch); p50 of 10 train steps after 2 warm-up and
    of an ``infer``, images/s, the peak memory."""
    from vwfd_tpu_torch.data import SyntheticImageDataset
    from vwfd_tpu_torch.metrics import bitwise_message_error
    from vwfd_tpu_torch.models.hidden_model import (
        EVAL_MEMBERS, NOISE_POOL, HiddenModel, HiddenSampler, apply_noise)
    from vwfd_tpu_torch.models.state import load_nets
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    model = HiddenModel(image_size=HID_S, encoder_loss_weight=1.0)
    model.init_states(14)
    ref = HiddenModel(image_size=HID_S, encoder_loss_weight=1.0,
                      kernels=PLAIN)
    ds = SyntheticImageDataset(size=HID_S, length=16 * HID_B, seed=10)
    rng = np.random.default_rng(10)
    batches = [(np.stack([ds[i * HID_B + j] for j in range(HID_B)]),
                (rng.random((HID_B, 30)) > 0.5).astype(np.float32))
               for i in range(16)]
    sampler = HiddenSampler(14, "cuda", [0.5, 2, 3, 1, 0.5, 1])
    launches, terms, cosines = {}, {}, {}
    for i, member in enumerate(NOISE_POOL):
        imgs, msgs = batches[i]
        d = sampler(HID_SHAPE, member)
        copy_hidden(ref, model)
        gp_ = {}
        lp = {k: float(v) for k, v in ref.train_step(imgs, msgs, d,
                                                     gp_).items()}
        torch.cuda.synchronize()
        reset_launch_counts()
        gk_ = {}
        logs = model.train_step(imgs, msgs, d, gk_)
        torch.cuda.synchronize()
        launches[f"hidden_train_{member}"] = launch_counts()
        lk = {k: float(v) for k, v in logs.items()}
        check(launches[f"hidden_train_{member}"] == HID_TRAIN[member],
              f"hidden train {member} launches "
              f"{launches[f'hidden_train_{member}']}")
        for k in ("loss", "encoder_mse", "dec_mse", "adversarial_bce",
                  "discr_cover_bce", "discr_encod_bce"):
            check(math.isfinite(lk[k]) and abs(lk[k] - lp[k])
                  <= HID_LOSS_RTOL * abs(lp[k]),
                  f"hidden {member} {k}: kernels {lk[k]} plain {lp[k]}")
        cos = {net: cosine(torch.cat([t.flatten() for t in gk_[net]]),
                           torch.cat([t.flatten() for t in gp_[net]]))
               for net in gk_}
        check(all(c >= HID_GRAD_COS for c in cos.values()),
              f"hidden {member} gradient cosines {cos}")
        terms[member] = {"kernels": lk, "plain": lp}
        cosines[member] = cos
        print(f"hidden train step {member} {HID_SHAPE}: loss kernels "
              f"{lk['loss']:.7g} plain {lp['loss']:.7g}; gradient cosines "
              f"{json.dumps(cos)}; launches K16 "
              f"{launches[f'hidden_train_{member}']['zigzag_jpeg']}, K17 "
              f"{launches[f'hidden_train_{member}']['crop_resize']}")

    # the guard: a NaN pixel leaves every tensor as it was
    imgs = batches[6][0].copy()
    imgs[0, 5, 7, 1] = np.nan
    before = [t.clone() for t in hidden_tensors(model)]
    logs = model.train_step(imgs, batches[6][1], sampler(HID_SHAPE))
    check(not math.isfinite(float(logs["loss"])), "NaN batch: finite loss")
    check(all(torch.equal(a, b) for a, b in zip(before,
                                                hidden_tensors(model))),
          "NaN batch moved a parameter, statistic, moment or count")
    print("hidden guard: a NaN pixel left every parameter, BatchNorm "
          "statistic, Adam moment and count as it was")

    # p50 of train steps (the weighted pool's members)
    it = iter(range(10 ** 6))

    def train_one():
        imgs, msgs = batches[next(it) % len(batches)]
        return model.train_step(imgs, msgs, sampler(HID_SHAPE))[
            "loss"].item()
    train_p50 = p50_of(train_one, 10, warmup=2)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # infer on the committed step-23,000 nets, every member, both paths
    nets = load_nets(str(HID_CKPT), 23000)
    model.load_states(nets)
    ref.load_states(nets)
    eds = SyntheticImageDataset(size=HID_S, length=2 * HID_B, seed=123)
    erng = np.random.default_rng(0)
    esampler = HiddenSampler(42, "cuda", members=EVAL_MEMBERS)
    near, errs = 0, {}
    for bi in range(2):
        imgs = np.stack([eds[bi * HID_B + j] for j in range(HID_B)])
        msgs = (erng.random((HID_B, 30)) > 0.5).astype(np.float32)
        it_, mt_ = model.to_device(imgs, msgs)
        reset_launch_counts()
        enc = model.encode(it_, mt_)
        decs = {}
        draws = {m: esampler(HID_SHAPE, m) for m in EVAL_MEMBERS}
        for m in EVAL_MEMBERS:
            decs[m] = model.decode(apply_noise(enc, it_, draws[m],
                                               model.kernels))
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == HID_EVAL, f"hidden eval launches {counts}")
        launches["hidden_eval"] = counts
        enc_p = ref.encode(it_, mt_)
        check(float((enc - enc_p).abs().max()) <= 1e-5,
              "hidden encode kernels vs plain")
        for m in EVAL_MEMBERS:
            dp = ref.decode(apply_noise(enc, it_, draws[m], PLAIN))
            bk = torch.round(torch.clamp(decs[m], 0, 1))
            bp = torch.round(torch.clamp(dp, 0, 1))
            diff = bk != bp
            close = (dp - 0.5).abs() < HID_BIT_NEAR
            check(not bool((diff & ~close).any()),
                  f"hidden infer {m}: bits differ away from 0.5")
            near += int(diff.sum())
            errs.setdefault(m, []).append(float(bitwise_message_error(
                decs[m], mt_)))
    print(f"hidden infer on step 23000, 2 batches x {len(EVAL_MEMBERS)} "
          f"members: decoded bits equal KERNELS vs PLAIN except {near} "
          f"within {HID_BIT_NEAR} of 0.5; bitwise errors "
          f"{json.dumps({m: float(np.mean(v)) for m, v in errs.items()})}")
    imgs, msgs = batches[0]
    d = esampler(HID_SHAPE, "jpeg_mask")
    infer_p50 = p50_of(lambda: model.infer(imgs, msgs, d)[2].sum().item(),
                       10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"train_step_p50_ms": train_p50,
           "images_per_s": HID_B / train_p50 * 1e3,
           "infer_p50_ms": infer_p50,
           "infer_images_per_s": HID_B / infer_p50 * 1e3,
           "batch": HID_B, "size": HID_S, "train_peak_memory_gib": train_peak,
           "peak_memory_gib": peak,
           "loss": {m: terms[m]["kernels"]["loss"] for m in terms},
           "min_gradient_cosine": min(min(c.values())
                                      for c in cosines.values()),
           "bits_near_half_differing": near, "card": card}
    print(f"hidden p50: train step {train_p50:.3f} ms "
          f"({HID_B / train_p50 * 1e3:.1f} images/s), infer (jpeg_mask) "
          f"{infer_p50:.3f} ms at b{HID_B}, {HID_S}²; peak memory "
          f"{peak:.3f} GiB [{card}]")
    print(json.dumps({"hidden": out}))
    return launches


# ------------------------------------------------------------ phase 13
# MBRS at full width: 128², b16, message 30, 64 channels, 4 SE blocks,
# diffusion 256, f32 (TF32 off: MBRSModel runs under device.full_f32)

MBRS_LOSS_RTOL = 1e-5    # loss terms, KERNELS vs PLAIN
MBRS_GRAD_COS = 0.9999   # each net's gradient, KERNELS vs PLAIN
# ... where no 8×8 block of the step's JPEG flipped between K5 and the
# plain DCT. A flipped block (a coefficient within rounding of a rint .5
# boundary, or of the soft round's ½ step, rounds the other way: a jump of
# up to a table step in one block; clipped encodings hold exact .5 DC
# quotients) moves the untrained decoder's logits: one flipped block of
# 4,096 moved a hard step's message_mse by 4.8e-4 relative and its
# gradient cosines to 0.9963 / 0.9967 (an H100 SXM at 700 W). Then each
# flipped block allows these:
MBRS_FLIP_LOSS_RTOL = 1e-3
MBRS_FLIP_GRAD_COS = 0.99
# one step per noise mode (mode, quality index): identity; hard at Q50;
# soft at Q90. K5 launches: none, the hard JPEG's forward, the soft JPEG's
# forward and backward; an infer with a JPEG mode launches one
MBRS_STEPS = (("identity", 0), ("hard", 0), ("soft", 4))
MBRS_TRAIN = {m: {**ZERO_LAUNCHES, "jpeg_pair": n}
              for m, n in (("identity", 0), ("hard", 1), ("soft", 2))}
MBRS_INFER = {m: {**ZERO_LAUNCHES, "jpeg_pair": int(m != "identity")}
              for m in MBRS_TRAIN}
MBRS_CONV_STEPS, MBRS_CONV_STOP = 20, 10


def mbrs_runner_args(root, name, *extra):
    return ["--task", "mbrs", "--steps", str(MBRS_CONV_STEPS),
            "--eval-every", str(MBRS_CONV_STEPS), "--log-every", "5",
            "--out", str(root / f"{name}.jsonl"),
            "--ckpt-dir", str(root / name), *extra]


def run_mbrs(card):
    """MBRS at full width (128², b16, message 30, 64 channels, 4 blocks,
    diffusion 256, f32, random weights from a seed): one ``train_step`` per
    noise mode (identity; hard at Q50; soft at Q90) through ``KERNELS`` and
    ``PLAIN`` from the same state, batch, messages and draws, cuDNN
    deterministic (the step's JPEG's flipped 8×8 blocks between K5 and the
    plain DCT counted; loss terms within ``MBRS_LOSS_RTOL`` and each net's
    gradient cosine ≥ ``MBRS_GRAD_COS`` where none flipped, else
    ``MBRS_FLIP_LOSS_RTOL`` and 1 − (1 − ``MBRS_FLIP_GRAD_COS``) a flipped
    block), each with the launch counts at 0 just before
    and read just after (K5 ×0, ×1, ×2); a batch with an Inf pixel that
    moves nothing; ``infer`` of each mode (K5 ×0, ×1, ×1); p50 of 10 train
    steps after 2 warm-up, images/s, ``infer`` p50, the peak memory; then
    the runner (``run_family_convergence --task mbrs``), 20 steps with an
    eval at the last, and the same run stopped at step 10 and resumed, its
    images, messages and draws at steps 11-20 EQUAL to the unbroken run's
    and its records finite (weights are not compared: cuDNN's backward is
    not deterministic)."""
    from vwfd_tpu_torch import run_family_convergence as rfc
    from vwfd_tpu_torch.attacks import jpeg_basic
    from vwfd_tpu_torch.data import SyntheticImageDataset
    from vwfd_tpu_torch.device import full_f32
    from vwfd_tpu_torch.kernels.zigzag import clip01
    from vwfd_tpu_torch.models.mbrs_model import (MODES, MBRSDraws,
                                                  MBRSModel, MBRSSampler)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    model = MBRSModel()
    model.init_states(16)
    ref = MBRSModel(kernels=PLAIN)
    ds = SyntheticImageDataset(size=MBRS_S, length=16 * MBRS_B, seed=10)
    rng = np.random.default_rng(10)
    batches = [(np.stack([ds[i * MBRS_B + j] for j in range(MBRS_B)]),
                (rng.random((MBRS_B, 30)) > 0.5).astype(np.float32))
               for i in range(16)]
    launches, terms, cosines = {}, {}, {}
    for i, (mode, q) in enumerate(MBRS_STEPS):
        d = MBRSDraws(MODES.index(mode), q)
        imgs, msgs = batches[i]
        copy_hidden(ref, model)
        flips = None
        if mode != "identity":  # the JPEG of this step's clipped encoding
            rounding = "round" if mode == "hard" else "ss"
            it, mt = model.to_device(imgs, msgs)
            with torch.no_grad(), full_f32():
                enc = clip01(model.encoder(it, mt, train=True)[0])
                hk = jpeg_basic(enc, q, rounding)
                hp = jpeg_basic(enc, q, rounding, kernels=PLAIN)
            flips = flipped_blocks(hk, hp, JPEG_FLIP_ATOL)
        # cuDNN's deterministic algorithms on both paths: only K5 against
        # its plain version may part them
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True):
            gp_ = {}
            lp = {k: float(v) for k, v in ref.train_step(imgs, msgs, d,
                                                         gp_).items()}
            torch.cuda.synchronize()
            reset_launch_counts()
            gk_ = {}
            logs = model.train_step(imgs, msgs, d, gk_)
            torch.cuda.synchronize()
        launches[f"mbrs_train_{mode}"] = launch_counts()
        lk = {k: float(v) for k, v in logs.items()}
        cos = {net: cosine(torch.cat([t.flatten() for t in gk_[net]]),
                           torch.cat([t.flatten() for t in gp_[net]]))
               for net in gk_}
        print(f"mbrs train step {mode} Q{(50, 60, 70, 80, 90)[q]} "
              f"{MBRS_SHAPE}: kernels {json.dumps(lk)} plain "
              f"{json.dumps(lp)}; gradient cosines {json.dumps(cos)}; "
              f"launches K5 {launches[f'mbrs_train_{mode}']['jpeg_pair']}"
              + ("" if flips is None else f"; {mode} JPEG flipped blocks K5 "
                 f"vs plain {flips[0]} of {flips[1]}"))
        check(launches[f"mbrs_train_{mode}"] == MBRS_TRAIN[mode],
              f"mbrs train {mode} launches "
              f"{launches[f'mbrs_train_{mode}']}")
        nflip = flips[0] if flips else 0
        rtol = MBRS_FLIP_LOSS_RTOL * nflip if nflip else MBRS_LOSS_RTOL
        min_cos = 1 - (1 - MBRS_FLIP_GRAD_COS) * nflip if nflip \
            else MBRS_GRAD_COS
        for k in ("loss", "encoder_mse", "message_mse"):
            check(math.isfinite(lk[k]) and abs(lk[k] - lp[k])
                  <= rtol * abs(lp[k]),
                  f"mbrs {mode} {k}: kernels {lk[k]} plain {lp[k]}")
        check(all(c >= min_cos for c in cos.values()),
              f"mbrs {mode} gradient cosines {cos}")
        terms[mode] = {"kernels": lk, "plain": lp, "flipped_blocks": nflip}
        cosines[mode] = cos

    # the guard: an Inf pixel through the soft JPEG leaves every tensor
    imgs = batches[6][0].copy()
    imgs[0, 5, 7, 1] = np.inf
    before = [t.clone() for t in hidden_tensors(model)]
    logs = model.train_step(imgs, batches[6][1], MBRSDraws(2, 2))
    check(not math.isfinite(float(logs["loss"])), "Inf batch: finite loss")
    check(all(torch.equal(a, b) for a, b in zip(before,
                                                hidden_tensors(model))),
          "Inf batch moved a parameter, statistic, moment or count")
    print("mbrs guard: an Inf pixel left every parameter, BatchNorm "
          "statistic, Adam moment and count as it was")

    # infer of each mode, then the p50s
    imgs, msgs = batches[7]
    infer_ms = {}
    for mode, q in MBRS_STEPS:
        d = MBRSDraws(MODES.index(mode), q)
        torch.cuda.synchronize()
        reset_launch_counts()
        out = model.infer(imgs, msgs, d)
        torch.cuda.synchronize()
        launches[f"mbrs_infer_{mode}"] = launch_counts()
        check(launches[f"mbrs_infer_{mode}"] == MBRS_INFER[mode]
              and all(bool(t.isfinite().all()) for t in out),
              f"mbrs infer {mode}: launches "
              f"{launches[f'mbrs_infer_{mode}']}")
        infer_ms[mode] = p50_of(lambda: model.infer(imgs, msgs, d)[2].sum()
                                .item(), 10, warmup=2)
    sampler = MBRSSampler(0)
    it_ = iter(range(10 ** 6))

    def train_one():
        imgs, msgs = batches[next(it_) % len(batches)]
        return model.train_step(imgs, msgs, sampler())["loss"].item()
    train_p50 = p50_of(train_one, 10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"mbrs p50: train step {train_p50:.3f} ms "
          f"({MBRS_B / train_p50 * 1e3:.1f} images/s), infer "
          f"{json.dumps(infer_ms)} ms at b{MBRS_B}, {MBRS_S}²; peak memory "
          f"{peak:.3f} GiB [{card}]")
    del model, ref
    gc.collect()

    # the runner: 20 steps, and the same run stopped at step 10 and resumed
    root = Path("build") / "chip_smoke_mbrs"
    shutil.rmtree(root, ignore_errors=True)
    seen = {"a": {}, "b": {}}

    def recorder(name):
        def on_step(step, imgs, msgs, draws):
            if step > MBRS_CONV_STOP:
                seen[name][step] = (imgs, msgs, draws)
        return on_step
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launch_counts()
    check(rfc.run(rfc.parse_args(mbrs_runner_args(root, "a")),
                  recorder("a")) == "done", "mbrs runner a")
    torch.cuda.synchronize()
    launches["mbrs_runner"] = launch_counts()
    wall_a = time.perf_counter() - t0
    check(rfc.run(rfc.parse_args(mbrs_runner_args(
        root, "b", "--stop-at-step", str(MBRS_CONV_STOP))),
        recorder("b")) == "stopped", "mbrs runner segment 1 did not stop")
    check(rfc.run(rfc.parse_args(mbrs_runner_args(root, "b", "--resume")),
                  recorder("b")) == "done", "mbrs runner segment 2")
    want = list(range(MBRS_CONV_STOP + 1, MBRS_CONV_STEPS + 1))
    check(sorted(seen["a"]) == want and sorted(seen["b"]) == want,
          f"mbrs steps seen {sorted(seen['a'])} {sorted(seen['b'])}")
    check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              and a[2] == b[2] for a, b in ((seen["a"][k], seen["b"][k])
                                            for k in want)),
          "the resumed MBRS run's images, messages or draws differ")
    recs = {}
    for name in ("a", "b"):
        with open(root / f"{name}.jsonl") as f:
            recs[name] = [json.loads(x) for x in f if x.strip()]
        check(all(math.isfinite(v) for r in recs[name] for v in r.values()
                  if isinstance(v, float)), f"mbrs runner {name}: a record "
              f"is not finite")
    evals = [r for r in recs["a"] if r.get("eval")]
    check([r["step"] for r in evals] == [MBRS_CONV_STEPS],
          f"mbrs runner evals {evals}")
    print(f"main path launches, mbrs runner ({MBRS_CONV_STEPS} steps, 1 "
          f"eval): {json.dumps(launches['mbrs_runner'])}")
    print(f"mbrs runner b{MBRS_B}x{MBRS_S}x{MBRS_S}: {MBRS_CONV_STEPS} steps "
          f"in {wall_a:.1f} s with the model's set-up; eval "
          f"{json.dumps(evals[-1])}; resumed at step {MBRS_CONV_STOP}: "
          f"images, messages and draws at steps {want[0]}-{want[-1]} equal")
    check(launches["mbrs_runner"]["jpeg_pair"] > 0,
          "the mbrs runner launched no K5")
    print(json.dumps({"mbrs": {
        "train_step_p50_ms": train_p50,
        "images_per_s": MBRS_B / train_p50 * 1e3,
        "infer_p50_ms": infer_ms, "batch": MBRS_B, "size": MBRS_S,
        "peak_memory_gib": peak, "terms": terms,
        "min_gradient_cosine": min(min(c.values())
                                   for c in cosines.values()),
        "runner_wall_s_20_steps": wall_a, "runner_eval": evals[-1],
        "card": card}}))
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------------------------ phase 14
# serving's remainder: media folders, --stream, --s2d


def pil_io():
    """PIL's PNG reader and writer for a tree written at the serving size
    (no resize: the pixels are the ones OpenCV would read)."""
    from PIL import Image

    def read_image(path, size):
        try:
            img = np.asarray(Image.open(path).convert("RGB"))
        except OSError:
            return None
        check(img.shape == (size, size, 3), f"{path}: {img.shape}")
        return img

    def write_image(path, arr):
        Image.fromarray(arr if arr.shape[-1] == 3 else arr[..., 0]).save(path)
    return read_image, write_image


def run_serving_remainder(card):
    """``serve --root --out`` on a PNG tree (two clips of 9 and 5 frames at
    the serving size, batch 2, T = 4: 3 requests, batches of 2 and 1): its
    frames, masks and ``verdicts.json`` under the CPU test's names, each
    PNG decoding to its shape and the masks to {0, 255}; ``--stream 8``'s
    three lines; a roundtrip at ``--s2d 4`` (K3 at s = 4 ×2, K4 at s = 4
    ×1) held to the plain server by F7's rule."""
    from vwfd_tpu_torch import serve
    try:
        read_image, write_image = serve.cv2_io()
        io = "cv2"
    except ImportError:
        read_image, write_image = pil_io()
        io = "PIL (cv2 does not import on this machine)"
    root = Path("build") / "chip_smoke_media"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(14)
    _, writer = pil_io()
    for clip, n in (("clipA", 9), ("clipB", 5)):
        (root / "in" / clip).mkdir(parents=True)
        for i in range(n):
            writer(str(root / "in" / clip / f"{i:05d}.png"),
                   rng.integers(0, 256, (S, S, 3), dtype=np.uint8))
    out = root / "out"
    reset_launch_counts()
    serve.main(["--mode", "roundtrip", "--root", str(root / "in"), "--out",
                str(out), "--batch", "2"], read_image=read_image,
               write_image=write_image)
    torch.cuda.synchronize()
    served = launch_counts()
    names = ["clipA/00000..00003", "clipA/00004..00007",
             "clipB/00000..00003"]
    want = {"verdicts.json"}
    for name in names:
        safe = name.replace("/", "_")
        want |= {f"{safe}_f{t}{k}.png" for t in range(T)
                 for k in ("", "_mask")}
    got = set(p.name for p in out.iterdir())
    check(got == want, f"served tree {sorted(got ^ want)}")
    with open(out / "verdicts.json") as f:
        verdicts = json.load(f)
    check(sorted(verdicts) == ["clipA/00000..00003#0",
                               "clipA/00004..00007#1",
                               "clipB/00000..00003#0"]
          and all(0.0 <= v <= 1.0 for v in verdicts.values()),
          f"verdicts {verdicts}")
    for p in out.iterdir():
        if p.suffix != ".png":
            continue
        from PIL import Image
        a = np.asarray(Image.open(p))
        if p.name.endswith("_mask.png"):
            check(a.shape == (S, S) and set(np.unique(a)) <= {0, 255},
                  f"{p.name} {a.shape}")
        else:
            check(a.shape == (S, S, 3), f"{p.name} {a.shape}")
    check(served["wire"] == 4 and served["mask_pack"] == 2,
          f"served launches {served}")
    print(f"serve --root --out ({io}): {len(got) - 1} PNGs and "
          f"verdicts.json {json.dumps(verdicts)}; launches K3 "
          f"{served['wire']}, K4 {served['mask_pack']} over 2 batches "
          f"[{card}]")
    shutil.rmtree(root, ignore_errors=True)

    import contextlib
    import io as io_
    buf = io_.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--mode", "roundtrip", "--stream", "8"])
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    check([r["window"] for r in lines] == [1, 2, 4]
          and all(r["clips"] == 8 * B and r["frames_per_s"] > 0
                  for r in lines), f"--stream 8: {lines}")
    for r in lines:
        print(json.dumps({"stream": r, "card": card}))

    cfg = load_config(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, extractor_s2d=4))
    states = perturbed_states(cfg, seed=14)
    server = WatermarkServer(cfg, weights=states, modes=("roundtrip",))
    plain = WatermarkServer(cfg, weights=states, modes=("roundtrip",),
                            kernels=PLAIN)
    check(server.model.unet.s2d == 4, "s2d 4 server")
    clip = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    server.serve(clip, "roundtrip").prefetch()
    torch.cuda.synchronize()
    reset_launch_counts()
    res = server.serve(clip, "roundtrip")
    res.prefetch()
    torch.cuda.synchronize()
    s2d = launch_counts()
    check(s2d == {**ROUNDTRIP_LAUNCHES}, f"s2d 4 roundtrip launches {s2d}")
    stats = compare(res, plain.serve(clip, "roundtrip"), "s2d 4 roundtrip")
    print(f"main path launches, s2d 4 roundtrip: {json.dumps(s2d)}; vs the "
          f"plain server {json.dumps(stats)} [{card}]")
    return {"s2d4_roundtrip": s2d}


# ------------------------------------------------------------ phase 15
# Tianchi at the published widths: SUNet (embed 96, depths 2/2/2/2, heads
# 3/6/12/24, window 8), 256², b8, f32 (TF32 off: TianchiModel runs under
# device.full_f32)

TC_LOSS_RTOL = 1e-5      # CE, CE1: KERNELS vs PLAIN
TC_GRAD_COS = 0.9999     # each update's gradient: KERNELS vs PLAIN
# a train step: two SUNet passes with their backwards, 14 blocks each (K18
# 28 forward + 28 backward), one K5 forward (the robustness image, no
# gradient); an eval step: one pass and the F1 sweep
TC_TRAIN = {**ZERO_LAUNCHES, "window_attention": 56, "jpeg_pair": 1}
TC_EVAL = {**ZERO_LAUNCHES, "window_attention": 14, "f1_sweep": 1}
# one step per JPEG mode: (band index, mode): hard Q45, soft Q40, zonal Q55
TC_DRAWS = ((1, 0), (0, 1), (3, 2))


def tianchi_cfg(size, batch):
    from vwfd_tpu_torch import TIANCHI_CONFIG
    cfg = load_config(TIANCHI_CONFIG)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, gt_size=size, batch_size=batch),
        train=dataclasses.replace(cfg.train, lr=1e-4))


def tianchi_batches(model, n, seed=10):
    from vwfd_tpu_torch.data import SpliceForgeryDataset
    b, s = model.cfg.data.batch_size, model.image_size
    ds = SpliceForgeryDataset(size=s, length=n * b, seed=seed)
    return [[np.stack(x) for x in zip(*[ds[i * b + j] for j in range(b)])]
            for i in range(n)]


def copy_tianchi(dst, src):
    with torch.no_grad():
        for a, b in zip(dst._tensors(), src._tensors()):
            a.copy_(b)


def run_tianchi(card):
    """Tianchi at the published widths, 256² b8, random weights from a
    seed: one ``train_step`` per JPEG mode through ``KERNELS`` and
    ``PLAIN`` from the same state, batch and draws, each with the launch
    counts at 0 just before and read just after (K18 ×56: 28 forward and
    28 backward; K5 ×1); CE and CE1 within ``TC_LOSS_RTOL`` and both
    updates' gradient cosines ≥ ``TC_GRAD_COS`` where no 8×8 block of the
    step's JPEG flipped between K5 and the plain DCT (else MBRS's
    per-flip rule); an ``eval_step`` (K18 ×14, K7 ×1) beside the plain
    one; a batch with an Inf pixel that moves nothing; one step at 512² b4,
    where every stage shifts; the p50 of train and eval steps, images/s
    and the peak memory."""
    from vwfd_tpu_torch.attacks import jpeg_pool_draw
    from vwfd_tpu_torch.device import full_f32
    from vwfd_tpu_torch.models.tianchi_model import (TianchiDraws,
                                                     TianchiModel)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    cfg = tianchi_cfg(TC_S, TC_B)
    model = TianchiModel(cfg)
    model.init_states(17)
    ref = TianchiModel(cfg, kernels=PLAIN)
    batches = tianchi_batches(model, 8)
    launches, terms, cosines = {}, {}, {}
    for i, (q, mode) in enumerate(TC_DRAWS):
        d = TianchiDraws(q, mode)
        imgs, masks = batches[i]
        copy_tianchi(ref, model)
        it = model.to_device(imgs)[0]
        with torch.no_grad(), full_f32():
            qv = model.band[q]
            flips = flipped_blocks(jpeg_pool_draw(it, qv, mode),
                                   jpeg_pool_draw(it, qv, mode,
                                                  kernels=PLAIN),
                                   JPEG_FLIP_ATOL)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True):
            gp_, gk_ = [], []
            lp = {k: float(v) for k, v in ref.train_step(imgs, masks, d,
                                                         gp_).items()}
            torch.cuda.synchronize()
            reset_launch_counts()
            logs = model.train_step(imgs, masks, d, gk_)
            torch.cuda.synchronize()
        key = f"tianchi_train_{('hard', 'soft', 'zonal')[mode]}"
        launches[key] = launch_counts()
        lk = {k: float(v) for k, v in logs.items()}
        cos = [cosine(torch.cat([t.flatten() for t in a]),
                      torch.cat([t.flatten() for t in b]))
               for a, b in zip(gk_, gp_)]
        nflip = flips[0]
        print(f"tianchi train step {key[14:]} Q{model.band[q]} "
              f"(b{TC_B}, {TC_S}²): kernels {json.dumps(lk)} plain "
              f"{json.dumps(lp)}; gradient cosines {cos}; JPEG flipped "
              f"blocks K5 vs plain {flips[0]} of {flips[1]}; launches "
              f"{json.dumps({k: v for k, v in launches[key].items() if v})}")
        check(launches[key] == TC_TRAIN, f"{key} launches {launches[key]}")
        rtol = MBRS_FLIP_LOSS_RTOL * nflip if nflip else TC_LOSS_RTOL
        min_cos = (1 - (1 - MBRS_FLIP_GRAD_COS) * nflip if nflip
                   else TC_GRAD_COS)
        for k in ("CE", "CE1"):
            check(math.isfinite(lk[k]) and abs(lk[k] - lp[k])
                  <= rtol * abs(lp[k]),
                  f"tianchi {key} {k}: kernels {lk[k]} plain {lp[k]}")
        check(all(c >= min_cos for c in cos),
              f"tianchi {key} gradient cosines {cos}")
        terms[key] = {"kernels": lk, "plain": lp, "flipped_blocks": nflip}
        cosines[key] = cos
    launches["tianchi_train_step"] = launches["tianchi_train_hard"]

    # the eval step
    imgs, masks = batches[4]
    copy_tianchi(ref, model)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = model.eval_step(imgs, masks)
    torch.cuda.synchronize()
    launches["tianchi_eval_step"] = launch_counts()
    check(launches["tianchi_eval_step"] == TC_EVAL,
          f"tianchi eval launches {launches['tianchi_eval_step']}")
    outp = ref.eval_step(imgs, masks)
    f1k, f1p = float(out["f1_best"]), float(outp["f1_best"])
    perr = float((out["predicted"] - outp["predicted"]).abs().max())
    check(0.0 <= f1k <= 1.0 and perr <= 1e-4, f"tianchi eval: f1 {f1k} vs "
          f"{f1p}, prediction err {perr}")
    print(f"tianchi eval step: f1_best kernels {f1k} plain {f1p}; "
          f"prediction max_abs_err {perr:.3g}; launches "
          f"{json.dumps({k: v for k, v in launches['tianchi_eval_step'].items() if v})}")

    # the guard: an Inf pixel leaves every tensor
    imgs = batches[5][0].copy()
    imgs[2, 7, 9, 1] = np.inf
    before = [t.clone() for t in model._tensors()]
    logs = model.train_step(imgs, batches[5][1], TianchiDraws(2, 1))
    check(not math.isfinite(float(logs["CE"])), "Inf batch: finite CE")
    check(all(torch.equal(a, b) for a, b in zip(before, model._tensors())),
          "Inf batch moved a parameter, moment or count")
    print("tianchi guard: an Inf pixel left every parameter, Adam moment "
          "and count as it was")

    # p50s and the peak
    sampler = model.sampler(0)
    it_ = iter(range(10 ** 6))

    def train_one():
        imgs, masks = batches[next(it_) % len(batches)]
        return model.train_step(imgs, masks, sampler())["CE"].item()

    def eval_one():
        imgs, masks = batches[next(it_) % len(batches)]
        return model.eval_step(imgs, masks)["f1_best"].item()
    train_p50 = p50_of(train_one, 10, warmup=2)
    eval_p50 = p50_of(eval_one, 10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"tianchi p50 at b{TC_B}, {TC_S}²: train step {train_p50:.3f} ms "
          f"({TC_B / train_p50 * 1e3:.1f} images/s), eval step "
          f"{eval_p50:.3f} ms ({TC_B / eval_p50 * 1e3:.1f} images/s); peak "
          f"memory {peak:.3f} GiB [{card}]")
    del model, ref
    gc.collect()

    # 512² b4 (the runner's default, training.yaml's size): every stage
    # shifts (maps 128, 64, 32, 16)
    cfg512 = tianchi_cfg(512, 4)
    big = TianchiModel(cfg512)
    big.init_states(18)
    imgs, masks = tianchi_batches(big, 1)[0]
    torch.cuda.synchronize()
    reset_launch_counts()
    logs = big.train_step(imgs, masks, TianchiDraws(0, 0))
    torch.cuda.synchronize()
    launches["tianchi_train_512"] = launch_counts()
    lk = {k: float(v) for k, v in logs.items()}
    check(launches["tianchi_train_512"] == TC_TRAIN
          and all(math.isfinite(v) for v in lk.values()),
          f"tianchi 512² step {lk} {launches['tianchi_train_512']}")
    shifted = [blk.attn.rel_pos_bias.shape[0] for name, blk in
               big.net.named_children() if name.endswith("_blk1")]
    train512 = p50_of(lambda: big.train_step(
        imgs, masks, TianchiDraws(1, 1))["CE"].item(), 3, warmup=1)
    print(f"tianchi 512² b4 train step: {json.dumps(lk)}; p50 "
          f"{train512:.3f} ms; shifted blocks' tables {shifted} [{card}]")
    del big
    gc.collect()
    print(json.dumps({"tianchi": {
        "train_step_p50_ms": train_p50,
        "train_images_per_s": TC_B / train_p50 * 1e3,
        "eval_step_p50_ms": eval_p50,
        "eval_images_per_s": TC_B / eval_p50 * 1e3, "batch": TC_B,
        "size": TC_S, "peak_memory_gib": peak, "terms": terms,
        "min_gradient_cosine": min(min(c) for c in cosines.values()),
        "train_step_512_b4_p50_ms": train512, "card": card}}))
    return launches



# ------------------------------------------------------------ phase 16
# the image family's PAMI at pami.yaml's width

IMG_HEAD_PERTURB = 2e-4  # the INN's zero-init heads: the reverse moves
# KERNELS vs PLAIN pooled F1: a fresh localizer's probabilities sit near
# 0.5, and bf16 rounding in the embed (F7) moves pixels across levels
IMG_F1_ATOL = 0.05
# a PAMI train step: the INN forward (6 Haar maps, 5 couplings = 10 affine
# launches), its inverse over every copy (the same), their backwards (the
# entry map's input, the batch, takes no gradient: 5 + 6 Haar, 20 affine),
# the two JPEG branches and the median, forward and backward, K19 once
# each way
IMG_TRAIN = {**ZERO_LAUNCHES, "haar": 23, "coupling_affine": 40,
             "jpeg_pair": 4, "median3": 2, "canny_soft": 2}
# the eval step: the forward passes, the F1 sweep per branch and pooled,
# SSIM
IMG_EVAL = {**ZERO_LAUNCHES, "haar": 12, "coupling_affine": 20,
            "jpeg_pair": 2, "median3": 1, "canny_soft": 1,
            "f1_sweep": IMG_K + 1, "ssim": 1}


def image_cfg(s, b):
    cfg = load_config(PAMI_CONFIG)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, gt_size=s, batch_size=b))


def image_batches(model, n, seed=10):
    """``n`` batches of the runner's synthetic images with their host canny
    maps and stroke masks, on the device."""
    from vwfd_tpu_torch.data import (CannyImages, SyntheticImageDataset,
                                     stroke_masks)
    from vwfd_tpu_torch.models.image_model import ImageBatch
    b, s = model.cfg.data.batch_size, model.cfg.data.gt_size
    ds = CannyImages(SyntheticImageDataset(size=s, length=n * b, seed=seed))
    out = []
    for i in range(n):
        imgs, canny_ = (np.stack(x) for x in zip(*[ds[i * b + j]
                                                   for j in range(b)]))
        out.append(ImageBatch(*model.to_device(
            imgs, canny_, stroke_masks((seed, i), b, (s, s)))))
    return out


def image_model(cfg, seed, kernels=None, **kw):
    from vwfd_tpu_torch.models import ImageImmunizationModel
    model = ImageImmunizationModel(cfg, kernels=kernels or KERNELS, **kw)
    model.init_states(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.netG.named_parameters():
            if ".Conv_4." in name:
                p.add_(IMG_HEAD_PERTURB * torch.randn(
                    p.shape, generator=gen).to(p.device))
    return model


def copy_image(dst, src):
    with torch.no_grad():
        for a, b in zip(dst._tensors(), src._tensors()):
            a.copy_(b)


def run_image(card):
    """Phase 16: PAMI at pami.yaml's width (256², b8, k 6, bf16 INN),
    random weights from a seed with the INN heads perturbed: a
    ``train_step`` for each tamper through ``KERNELS`` and ``PLAIN`` from
    the same state, batch, previous batch and draws (loss terms within
    ``TRAIN_LOSS_RTOL``, each net's gradient cosine ≥ ``TRAIN_GRAD_COS``),
    with the launch counts at 0 just before and read just after; an
    ``eval_step`` with its counts beside the plain one; an ImugeV2 step;
    an Inf pixel that moves nothing; p50s, images/s and the peak memory;
    one PAMI step at 512² b3, ``reverse_k`` 3."""
    from vwfd_tpu_torch.models.image_model import ImageBatch, ImageDraws
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    cfg = image_cfg(IMG_S, IMG_B)
    mc = cfg.model
    check((mc.inn_subnet, mc.inn_haar, mc.inn_down_num, mc.n_attacks,
           mc.localizer_dim, mc.localizer_residual_blocks, cfg.train.dtype)
          == ("res", "mixed", 3, IMG_K, 16, 2, "bfloat16"), "pami config")
    model = image_model(cfg, 31)
    ref = image_model(cfg, 31, kernels=PLAIN)
    batches = image_batches(model, 6)
    sampler = model.sampler(5)
    launches, terms, cosines = {}, {}, {}
    for i, use_cm in enumerate((False, True)):
        d = sampler((IMG_B, IMG_S, IMG_S))
        d = ImageDraws(d.shift, use_cm, ((None, (0, 0), 4, None, None,
                                          (4, 1)) if i == 0 else d.branch))
        batch, prev = batches[i + 1], batches[i].image
        copy_image(ref, model)
        gp_, gk_ = {}, {}
        lp = {k: float(v) for k, v in ref.train_step(batch, prev, d,
                                                     gp_).items()}
        torch.cuda.synchronize()
        reset_launch_counts()
        logs = model.train_step(batch, prev, d, gk_)
        torch.cuda.synchronize()
        key = f"pami_train_{'copymove' if use_cm else 'splice'}"
        launches[key] = launch_counts()
        lk = {k: float(v) for k, v in logs.items()}
        cos = {n: cosine(torch.cat([t.flatten() for t in gk_[n]]),
                         torch.cat([t.flatten() for t in gp_[n]]))
               for n in gk_}
        print(f"pami train step {key[11:]} (b{IMG_B}, {IMG_S}², draws "
              f"{d.branch}, shift {d.shift}): kernels {json.dumps(lk)} "
              f"plain {json.dumps(lp)}; gradient cosines {cos}; launches "
              f"{json.dumps({k: v for k, v in launches[key].items() if v})}")
        check(launches[key] == IMG_TRAIN, f"{key} launches {launches[key]}")
        for k in ("loss", "lF", "lB", "l_mask"):
            check(math.isfinite(lk[k]) and abs(lk[k] - lp[k])
                  <= TRAIN_LOSS_RTOL * abs(lp[k]),
                  f"pami {key} {k}: kernels {lk[k]} plain {lp[k]}")
        check(all(c >= TRAIN_GRAD_COS for c in cos.values()),
              f"pami {key} gradient cosines {cos}")
        terms[key], cosines[key] = {"kernels": lk, "plain": lp}, cos
    launches["pami_train_step"] = launches["pami_train_splice"]

    # the eval step, KERNELS against PLAIN
    copy_image(ref, model)
    batch, prev = batches[4], batches[3].image
    d = sampler((IMG_B, IMG_S, IMG_S))
    torch.cuda.synchronize()
    reset_launch_counts()
    out = model.eval_step(batch, prev, d)
    torch.cuda.synchronize()
    launches["pami_eval_step"] = launch_counts()
    check(launches["pami_eval_step"] == IMG_EVAL,
          f"pami eval launches {launches['pami_eval_step']}")
    outp = ref.eval_step(batch, prev, d)
    ek = {k: float(v) for k, v in out.items() if v.dim() == 0}
    ep = {k: float(v) for k, v in outp.items() if v.dim() == 0}
    for k, atol in (("psnr_forward", EVAL_PSNR_ATOL),
                    ("psnr_backward", EVAL_PSNR_ATOL),
                    ("ssim_forward", EVAL_SSIM_ATOL)):
        check(abs(ek[k] - ep[k]) <= atol, f"pami eval {k}: {ek[k]} vs "
              f"{ep[k]}")
    _, flips = f1_bounds(out["predicted_mask"], outp["predicted_mask"],
                         batch.mask)
    k_sweep = [float(v) for v in out["f1_sweep"]]
    used = {k: v for k, v in launches["pami_eval_step"].items() if v}
    print(f"pami eval step: kernels {json.dumps(ek)} plain "
          f"{json.dumps(ep)}; branch 0 pixels across a level {flips}; "
          f"launches {json.dumps(used)}")
    check(all(math.isfinite(v) for v in k_sweep) and 0.0 <= ek["f1_best"]
          <= 1.0, f"pami eval f1 {k_sweep}")
    check(abs(ek["f1_best"] - ep["f1_best"]) <= IMG_F1_ATOL,
          f"pami eval f1_best {ek['f1_best']} vs {ep['f1_best']}")

    # ImugeV2: one step from the same nets
    imuge = image_model(cfg, 31, task="imuge")
    reset_launch_counts()
    li = {k: float(v) for k, v in imuge.train_step(
        batches[2], batches[1].image, sampler((IMG_B, IMG_S,
                                               IMG_S))).items()}
    torch.cuda.synchronize()
    launches["imuge_train_step"] = launch_counts()
    check(all(math.isfinite(v) for v in li.values())
          and launches["imuge_train_step"] == IMG_TRAIN,
          f"imuge step {li} {launches['imuge_train_step']}")
    print(f"imuge train step: {json.dumps(li)}")
    del imuge

    # the guard: an Inf pixel through the JPEG branches
    bad = batches[5].image.clone()
    bad[1, 7, 9, 2] = float("inf")
    before = [t.clone() for t in model._tensors()]
    logs = model.train_step(ImageBatch(bad, batches[5].canny,
                                       batches[5].mask), batches[4].image,
                            sampler((IMG_B, IMG_S, IMG_S)))
    check(not math.isfinite(float(logs["loss"])), "Inf batch: finite loss")
    check(all(torch.equal(a, b) for a, b in zip(before, model._tensors())),
          "Inf batch moved a parameter, moment, count or spectral vector")
    print("pami guard: an Inf pixel left every parameter, Adam moment, "
          "count and spectral vector as it was")
    del ref, before
    gc.collect()

    it_ = iter(range(10 ** 6))

    def train_one():
        i = next(it_) % 5 + 1
        return model.train_step(batches[i], batches[i - 1].image, sampler(
            (IMG_B, IMG_S, IMG_S)))["loss"].item()

    def eval_one():
        i = next(it_) % 5 + 1
        return model.eval_step(batches[i], batches[i - 1].image, sampler(
            (IMG_B, IMG_S, IMG_S)))["f1_best"].item()
    train_p50 = p50_of(train_one, 10, warmup=2)
    eval_p50 = p50_of(eval_one, 10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"pami p50 at b{IMG_B}, {IMG_S}², k {IMG_K}: train step "
          f"{train_p50:.3f} ms ({IMG_B / train_p50 * 1e3:.1f} images/s), "
          f"eval step {eval_p50:.3f} ms ({IMG_B / eval_p50 * 1e3:.1f} "
          f"images/s); peak memory {peak:.3f} GiB [{card}]")
    del model, batches
    gc.collect()

    # 512² b3 with reverse_k 3: the JAX record's configuration
    bs, bn, bk = IMG_BIG
    big = image_model(image_cfg(bs, bn), 32, reverse_k=bk)
    bb = image_batches(big, 2)
    sampler = big.sampler(6)
    torch.cuda.synchronize()
    reset_launch_counts()
    lb = {k: float(v) for k, v in big.train_step(
        bb[1], bb[0].image, sampler((bn, bs, bs))).items()}
    torch.cuda.synchronize()
    launches["pami_train_512"] = launch_counts()
    check(all(math.isfinite(v) for v in lb.values())
          and launches["pami_train_512"] == IMG_TRAIN,
          f"pami 512² step {lb} {launches['pami_train_512']}")
    p512 = p50_of(lambda: big.train_step(bb[1], bb[0].image, sampler(
        (bn, bs, bs)))["loss"].item(), 3, warmup=1)
    print(f"pami 512² b3 reverse_k 3 train step: {json.dumps(lb)}; p50 "
          f"{p512:.3f} ms [{card}]")
    del big, bb
    gc.collect()
    print(json.dumps({"pami": {
        "train_step_p50_ms": train_p50,
        "train_images_per_s": IMG_B / train_p50 * 1e3,
        "eval_step_p50_ms": eval_p50,
        "eval_images_per_s": IMG_B / eval_p50 * 1e3, "batch": IMG_B,
        "size": IMG_S, "attacks": IMG_K, "peak_memory_gib": peak,
        "terms": terms, "gradient_cosines": cosines,
        "eval": {"kernels": ek, "plain": ep},
        "train_step_512_b3_reverse_k3_p50_ms": p512, "card": card}}))
    return launches


# ------------------------------------------------------------ phase 17
# CLR at clr.yaml's width, then the image family's options

CLR_LOSS_RTOL = 1e-5     # loss terms, KERNELS vs PLAIN
CLR_GRAD_COS = 0.9999    # each net's gradient, KERNELS vs PLAIN
# a CLR train step: PAMI's INN, fan-out and canny launches, the crop
# forward and backward, the rectification of the reversed copies forward
# and backward, K8 and K22 for the SSIM term; the eval step: PAMI's, the
# crop, the rectification of every copy
CLR_TRAIN = {**IMG_TRAIN, "crop_cubic": 2, "rectify": 2, "ssim": 1,
             "ssim_grad": 1}
CLR_EVAL = {**IMG_EVAL, "crop_cubic": 1, "rectify": 1}


def clr_cfg(s, b):
    from vwfd_tpu_torch import CLR_CONFIG
    cfg = load_config(CLR_CONFIG)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, gt_size=s, batch_size=b))


def grad_cosines(gk, gp):
    return {n: cosine(torch.cat([t.flatten() for t in gk[n]]),
                      torch.cat([t.flatten() for t in gp[n]]))
            for n in gk}


def kernels_vs_plain_step(model, ref, batch, prev, d, key, keys, launches,
                          want=None):
    """One train step through ``model`` (KERNELS) with the launch counts at
    0 just before and read just after, and through ``ref`` (PLAIN) from the
    same state: loss terms within ``CLR_LOSS_RTOL``, gradient cosines ≥
    ``CLR_GRAD_COS``; returns (kernels' terms, plain's, cosines)."""
    copy_image(ref, model)
    gp_, gk_ = {}, {}
    lp = {k: float(v) for k, v in ref.train_step(batch, prev, d,
                                                 gp_).items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    logs = model.train_step(batch, prev, d, gk_)
    torch.cuda.synchronize()
    launches[key] = launch_counts()
    lk = {k: float(v) for k, v in logs.items()}
    cos = grad_cosines(gk_, gp_)
    used = {k: v for k, v in launches[key].items() if v}
    print(f"{key} train step: kernels {json.dumps(lk)} plain "
          f"{json.dumps(lp)}; gradient cosines {cos}; launches "
          f"{json.dumps(used)}")
    if want is not None:
        check(launches[key] == want, f"{key} launches {launches[key]}")
    for k in keys:
        check(math.isfinite(lk[k]) and abs(lk[k] - lp[k])
              <= CLR_LOSS_RTOL * abs(lp[k]),
              f"{key} {k}: kernels {lk[k]} plain {lp[k]}")
    check(all(c >= CLR_GRAD_COS for c in cos.values()),
          f"{key} gradient cosines {cos}")
    return lk, lp, cos


def run_clr(card):
    """Phase 17: CLR at clr.yaml's width (256², b8, k 6, the bf16 INN, the
    localizer, the apex regressor), random weights from a seed with the
    INN heads perturbed: a ``train_step`` through ``KERNELS`` and
    ``PLAIN`` from the same state, batch, previous batch and draws (loss
    terms within ``CLR_LOSS_RTOL``, each net's gradient cosine ≥
    ``CLR_GRAD_COS``: netG's carries K22's SSIM gradient), with the launch
    counts at 0 just before and read just after; an ``eval_step`` with its
    counts beside the plain one; an Inf pixel that moves nothing; p50s,
    images/s and the peak memory; one step at 512² b3 ``reverse_k`` 3;
    then one PAMI step each with ``with_gan`` and ``use_perceptual`` (256²
    b8) through ``KERNELS`` and ``PLAIN``."""
    from vwfd_tpu_torch.models.image_model import ImageBatch
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    cfg = clr_cfg(CLR_S, CLR_B)
    mc = cfg.model
    check((cfg.task, mc.inn_subnet, mc.inn_haar, mc.inn_down_num,
           mc.n_attacks, mc.localizer_dim, cfg.train.dtype)
          == ("clr", "res", "mixed", 3, CLR_K, 16, "bfloat16"), "clr config")
    model = image_model(cfg, 41, task="clr")
    ref = image_model(cfg, 41, kernels=PLAIN, task="clr")
    check(model.apex_net.out_size == CLR_S, "apex regressor's out_size")
    batches = image_batches(model, 6)
    sampler = model.sampler(7)
    launches, terms, cosines = {}, {}, {}
    keys = ("loss", "lF", "lB", "l_mask", "l_apex", "l_ce")
    for i in range(2):
        d = sampler((CLR_B, CLR_S, CLR_S))
        key = f"clr_train_{i}"
        lk, lp, cos = kernels_vs_plain_step(model, ref, batches[i + 1],
                                            batches[i].image, d, key, keys,
                                            launches, CLR_TRAIN)
        terms[key], cosines[key] = {"kernels": lk, "plain": lp,
                                    "apex_u": d.apex_u.tolist()}, cos
    launches["clr_train_step"] = launches["clr_train_0"]

    copy_image(ref, model)
    batch, prev = batches[4], batches[3].image
    d = sampler((CLR_B, CLR_S, CLR_S))
    torch.cuda.synchronize()
    reset_launch_counts()
    out = model.eval_step(batch, prev, d)
    torch.cuda.synchronize()
    launches["clr_eval_step"] = launch_counts()
    check(launches["clr_eval_step"] == CLR_EVAL,
          f"clr eval launches {launches['clr_eval_step']}")
    outp = ref.eval_step(batch, prev, d)
    ek = {k: float(v) for k, v in out.items() if v.dim() == 0}
    ep = {k: float(v) for k, v in outp.items() if v.dim() == 0}
    for k, atol in (("psnr_forward", EVAL_PSNR_ATOL),
                    ("psnr_backward", EVAL_PSNR_ATOL),
                    ("ssim_forward", EVAL_SSIM_ATOL),
                    ("f1_best", IMG_F1_ATOL)):
        check(abs(ek[k] - ep[k]) <= atol, f"clr eval {k}: {ek[k]} vs {ep[k]}")
    check(0.0 <= ek["f1_best"] <= 1.0 and all(
        math.isfinite(v) for v in ek.values()), f"clr eval {ek}")
    used = {k: v for k, v in launches["clr_eval_step"].items() if v}
    print(f"clr eval step: kernels {json.dumps(ek)} plain {json.dumps(ep)}; "
          f"launches {json.dumps(used)}")

    bad = batches[5].image.clone()
    bad[1, 120, 130, 2] = float("inf")
    before = [t.clone() for t in model._tensors()]
    logs = model.train_step(ImageBatch(bad, batches[5].canny,
                                       batches[5].mask), batches[4].image,
                            sampler((CLR_B, CLR_S, CLR_S)))
    check(not math.isfinite(float(logs["loss"])), "Inf batch: finite loss")
    check(all(torch.equal(a, b) for a, b in zip(before, model._tensors())),
          "clr Inf batch moved a parameter, moment, count or spectral "
          "vector")
    print("clr guard: an Inf pixel left every parameter, Adam moment, count "
          "and spectral vector of netG, the localizer and the apex "
          "regressor as it was")
    del ref, before
    gc.collect()

    it_ = iter(range(10 ** 6))

    def train_one():
        i = next(it_) % 5 + 1
        return model.train_step(batches[i], batches[i - 1].image, sampler(
            (CLR_B, CLR_S, CLR_S)))["loss"].item()

    def eval_one():
        i = next(it_) % 5 + 1
        return model.eval_step(batches[i], batches[i - 1].image, sampler(
            (CLR_B, CLR_S, CLR_S)))["f1_best"].item()
    train_p50 = p50_of(train_one, 10, warmup=2)
    eval_p50 = p50_of(eval_one, 10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"clr p50 at b{CLR_B}, {CLR_S}², k {CLR_K}: train step "
          f"{train_p50:.3f} ms ({CLR_B / train_p50 * 1e3:.1f} images/s), "
          f"eval step {eval_p50:.3f} ms ({CLR_B / eval_p50 * 1e3:.1f} "
          f"images/s); peak memory {peak:.3f} GiB [{card}]")
    del model, batches
    gc.collect()

    bs, bn, bk = CLR_BIG
    big = image_model(clr_cfg(bs, bn), 42, task="clr", reverse_k=bk)
    bb = image_batches(big, 2)
    sampler = big.sampler(8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lb = {k: float(v) for k, v in big.train_step(
        bb[1], bb[0].image, sampler((bn, bs, bs))).items()}
    torch.cuda.synchronize()
    launches["clr_train_512"] = launch_counts()
    check(all(math.isfinite(v) for v in lb.values())
          and launches["clr_train_512"] == CLR_TRAIN,
          f"clr 512² step {lb} {launches['clr_train_512']}")
    p512 = p50_of(lambda: big.train_step(bb[1], bb[0].image, sampler(
        (bn, bs, bs)))["loss"].item(), 3, warmup=1)
    peak512 = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"clr 512² b3 reverse_k 3 train step: {json.dumps(lb)}; p50 "
          f"{p512:.3f} ms; peak memory {peak512:.3f} GiB [{card}]")
    del big, bb
    gc.collect()

    # the options, on PAMI at pami.yaml's width
    opts = {}
    for name, kw, extra in (("gan", dict(with_gan=True), ("g_adv",
                                                         "d_loss")),
                            ("perceptual", dict(use_perceptual=True), ())):
        pcfg = image_cfg(IMG_S, IMG_B)
        m = image_model(pcfg, 43, **kw)
        r = image_model(pcfg, 43, kernels=PLAIN, **kw)
        if name == "perceptual":
            r.vgg.load_state_dict(m.vgg.state_dict())
        pb = image_batches(m, 2)
        d = m.sampler(9)((IMG_B, IMG_S, IMG_S))
        lk, lp, cos = kernels_vs_plain_step(
            m, r, pb[1], pb[0].image, d, f"pami_{name}",
            ("loss", "lF", "lB", "l_mask") + extra, launches, IMG_TRAIN)
        ms = p50_of(lambda: m.train_step(pb[1], pb[0].image, d)[
            "loss"].item(), 3, warmup=1)
        opts[name] = {"kernels": lk, "plain": lp, "gradient_cosines": cos,
                      "train_step_p50_ms": ms}
        print(f"pami {name} train step p50 {ms:.3f} ms [{card}]")
        del m, r, pb
        gc.collect()
    print(json.dumps({"clr": {
        "train_step_p50_ms": train_p50,
        "train_images_per_s": CLR_B / train_p50 * 1e3,
        "eval_step_p50_ms": eval_p50,
        "eval_images_per_s": CLR_B / eval_p50 * 1e3, "batch": CLR_B,
        "size": CLR_S, "attacks": CLR_K, "peak_memory_gib": peak,
        "terms": terms, "gradient_cosines": cosines,
        "eval": {"kernels": ek, "plain": ep},
        "train_step_512_b3_reverse_k3_p50_ms": p512,
        "peak_memory_512_gib": peak512, "options": opts, "card": card}}))
    return launches


# ------------------------------------------------------------ phase 3,
# KD-JPEG's FiLM epilogue

# K23 at KD-JPEG's three up levels (256² b6: four launches each way a level
# at nb 4) and at the image model's simulator at PAMI's 512² b3 (one each)
FILM_KD = [(6, 128, 64, 64), (6, 64, 128, 128), (6, 32, 256, 256)]
FILM_SIM = [(3, 32, 128, 128), (3, 24, 256, 256), (3, 16, 512, 512)]
FILM_NB = 4              # KD-JPEG's blocks a level: launches a level each way
FILM_SUM_RTOL = 1e-5     # gγ, gβ: of the plain Σ|g·h| and Σ|g| of the plane
# per value: forward γ·h, + β, + x; backward γ·g, g·h and its sum, Σ g
FILM_OPS = (3, 4)


def film_inputs(g, shape):
    x, h = (torch.randn(shape, device="cuda", generator=g) for _ in range(2))
    gamma = torch.rand(shape[:2], device="cuda", generator=g)
    beta = torch.rand(shape[:2], device="cuda", generator=g) * 2 - 1
    return x, h, gamma, beta


def alloc_bytes(*ts):
    """The caching allocator's bytes for ``ts``: each tensor's rounded up
    to its 512-byte blocks."""
    return sum(-(-nbytes(t) // 512) * 512 for t in ts)


def film_sums_err(gk, gp, cot, h):
    """gγ's and gβ's largest error, each of its plane's plain Σ|g·h| and
    Σ|g|."""
    s_gh = (cot * h).abs().sum((2, 3))
    s_g = cot.abs().sum((2, 3))
    return max(float(((gk[2] - gp[2]).abs() / s_gh).max()),
               float(((gk[3] - gp[3]).abs() / s_g).max()))


def check_film(rows, card):
    """K23 at KD-JPEG's three up levels and the simulator's three at PAMI's
    512² b3, and a ragged plane (the scalar path): the forward and gh
    EQUAL to the plain version, gx the cotangent itself, gγ and gβ within
    ``FILM_SUM_RTOL`` of the plain Σ|g·h| and Σ|g| of their plane, all
    bit-identical over calls; a NaN and an Inf in h, x and the cotangent
    give NaN where the plain version's are; a call with γ and β frozen
    (the simulator's branch: no sums) equal too; no bytes allocated beyond
    out, gh and the (B, C) sums. Each shape timed warm and with a cold L2,
    forward and backward, beside the plain version (autograd of the
    expression) and ``torch.addcmul(x + β, γ, h)`` (the forward's
    yardstick: no PyTorch call computes the function); the bound counts x
    and h read and out written, g and h read and gh written."""
    row = rows["film_residual"]
    g = torch.Generator("cuda").manual_seed(78)
    needs = [True] * 4
    worst = 0.0
    for shape in FILM_KD + FILM_SIM + [(2, 5, 7, 9)]:
        ins = film_inputs(g, shape)
        cot = torch.randn(shape, device="cuda", generator=g)
        (yk,), gk = grads_of(film.film_residual, list(ins), needs, cot)
        (yk2,), gk2 = grads_of(film.film_residual, list(ins), needs, cot)
        (yp,), gp = grads_of(film.film_residual_plain, list(ins), needs, cot)
        torch.cuda.synchronize()
        check(torch.equal(yk, yp), f"film {shape}: forward differs from "
              f"plain ({float((yk - yp).abs().max())})")
        check(torch.equal(gk[0], cot) and torch.equal(gk[1], gp[1]),
              f"film {shape}: gx or gh differs")
        err = film_sums_err(gk, gp, cot, ins[1])
        check(err <= FILM_SUM_RTOL, f"film {shape}: sums {err}")
        check(torch.equal(yk, yk2) and all(torch.equal(a, b)
                                           for a, b in zip(gk, gk2)),
              f"film {shape}: two calls differ")
        worst = max(worst, err)
        print(f"check film_residual {shape}: forward and gh equal to plain, "
              f"gx is g, sums within {err:.3g} of the plain Σ|·| (tol "
              f"{FILM_SUM_RTOL}), bit-identical over calls")
    x, h, gm, bt = film_inputs(g, (2, 4, 16, 16))
    cot = torch.randn(x.shape, device="cuda", generator=g)
    h[0, 1, 5, 7] = float("nan")
    x[1, 3, 0, 0] = float("inf")
    cot[1, 2, 3, 3] = float("nan")
    (yk,), gk = grads_of(film.film_residual, [x, h, gm, bt], needs, cot)
    (yp,), gp = grads_of(film.film_residual_plain, [x, h, gm, bt], needs,
                         cot)
    torch.cuda.synchronize()
    for what, k, p in (("out", yk, yp), ("gh", gk[1], gp[1]),
                       ("gγ", gk[2], gp[2]), ("gβ", gk[3], gp[3])):
        fin = p.isfinite()
        check(torch.equal(k.isnan(), p.isnan()) and torch.equal(
            k.isinf(), p.isinf()) and float((k[fin] - p[fin]).abs().max())
            <= 1e-5 * float(p[fin].abs().max()),
            f"film non-finite {what}: differs from plain")
    print(f"check film_residual non-finite: NaN {int(yp.isnan().sum())} "
          f"out, {int(gp[2].isnan().sum())} gγ, {int(gp[3].isnan().sum())} "
          f"gβ planes, at the plain version's places")
    x, h, gm, bt = film_inputs(g, FILM_SIM[2])
    cot = torch.randn(x.shape, device="cuda", generator=g)
    before = film.COUNT.n
    (yk,), gk = grads_of(lambda a, b: film.film_residual(a, b, gm, bt),
                         [x, h], [True, True], cot)
    (yp,), gp = grads_of(lambda a, b: film.film_residual_plain(a, b, gm, bt),
                         [x, h], [True, True], cot)
    torch.cuda.synchronize()
    check(film.COUNT.n - before == 2 and torch.equal(yk, yp)
          and torch.equal(gk[1], gp[1]), "film with frozen γ, β")
    print("check film_residual frozen γ, β: equal to plain, one forward "
          "and one backward launch (no sums)")
    row.err = worst

    out = {}
    for shape in FILM_KD + FILM_SIM:
        x, h, gm, bt = ins = film_inputs(g, shape)
        cot = torch.randn(shape, device="cuda", generator=g)
        xs = [t.clone().requires_grad_(True) for t in ins]
        y = film.film_residual(*xs)
        torch.autograd.grad(y, xs, cot)  # the stream scratch, once
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = film.film_residual(*xs)
        torch.cuda.synchronize()
        fwd_extra = (torch.cuda.max_memory_allocated() - base
                     - alloc_bytes(y))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gs = torch.autograd.grad(y, xs, cot)
        torch.cuda.synchronize()
        gx_is_g = gs[0].data_ptr() == cot.data_ptr()
        new = [t for t in gs if t.data_ptr() != cot.data_ptr()]
        bwd_extra = (torch.cuda.max_memory_allocated() - base
                     - alloc_bytes(*new))
        del xs, y, gs, new
        check(fwd_extra == 0 and bwd_extra == 0, f"film {shape}: "
              f"{fwd_extra} bytes beyond out, {bwd_extra} beyond gh and the "
              f"sums")
        fwd_bytes, bwd_bytes = nbytes(x, h, x), nbytes(cot, h, cot)
        n = x.numel()
        t = {"f": time_ms(lambda: film.film_residual(x, h, gm, bt)),
             "b": time_ms(lambda: film.film_backward(cot, h, gm)),
             "b_frozen": time_ms(lambda: film.film_backward(
                 cot, h, gm, want_sums=False))}
        t["cf"] = time_cold_ms(
            film.film_residual,
            cold_sets(lambda i: film_inputs(g, shape), fwd_bytes))
        t["cb"] = time_cold_ms(
            lambda c, hh, gg: film.film_backward(c, hh, gg),
            cold_sets(lambda i: (torch.randn(shape, device="cuda",
                                             generator=g),
                                 *film_inputs(g, shape)[1:3]), bwd_bytes))
        ps = [t_.clone().requires_grad_(True) for t_ in ins]
        t["pf"] = time_ms(lambda: film.film_residual_plain(*ps))
        yp = film.film_residual_plain(*ps)
        t["pb"] = time_ms(lambda: torch.autograd.grad(yp, ps, cot,
                                                      retain_graph=True))
        bb = bt[:, :, None, None]
        gg = gm[:, :, None, None]
        t["ys"] = time_ms(lambda: torch.addcmul(x + bb, gg, h))
        t["fwd"] = (fwd_bytes, n * FILM_OPS[0])
        t["bwd"] = (bwd_bytes, n * FILM_OPS[1])
        t["bf"], t["bb"] = bound(*t["fwd"])[0], bound(*t["bwd"])[0]
        t["gx_is_g"] = gx_is_g
        out[shape] = t
        print(f"check film_residual {shape}: forward ms={t['f']:.4f} "
              f"cold_ms={t['cf']:.4f} plain_ms={t['pf']:.4f} addcmul "
              f"yardstick ms={t['ys']:.4f} bound_ms={t['bf']:.4f} share="
              f"{t['bf'] / t['f']:.3f} (cold {t['bf'] / t['cf']:.3f}); "
              f"backward ms={t['b']:.4f} cold_ms={t['cb']:.4f} frozen γ, β "
              f"ms={t['b_frozen']:.4f} plain_ms={t['pb']:.4f} bound_ms="
              f"{t['bb']:.4f} share={t['bb'] / t['b']:.3f} (cold "
              f"{t['bb'] / t['cb']:.3f}); 0 bytes beyond the outputs, gx is "
              f"g: {gx_is_g} [{card}]")
    for shape in FILM_KD:  # a KD-JPEG train step: four launches a level
        t = out[shape]
        row.add(FILM_NB * t["f"], FILM_NB * t["pf"],
                *(FILM_NB * v for v in t["fwd"]),
                yardstick_ms=FILM_NB * t["ys"], cold_ms=FILM_NB * t["cf"])
        row.add(FILM_NB * t["b"], FILM_NB * t["pb"],
                *(FILM_NB * v for v in t["bwd"]), cold_ms=FILM_NB * t["cb"])

    def path(shapes, reps):
        return {k: reps * sum(out[s][k] for s in shapes)
                for k in ("f", "cf", "b", "cb", "pf", "pb", "ys", "bf",
                          "bb", "b_frozen")}
    kd, sim = path(FILM_KD, FILM_NB), path(FILM_SIM, 1)
    row.extra = {
        "forward_ms": kd["f"], "forward_cold_ms": kd["cf"],
        "forward_bound_ms": kd["bf"], "backward_ms": kd["b"],
        "backward_cold_ms": kd["cb"], "backward_bound_ms": kd["bb"],
        "plain_forward_ms": kd["pf"], "plain_backward_ms": kd["pb"],
        "bytes_beyond_outputs": 0,
        "gx_is_g": all(t["gx_is_g"] for t in out.values()),
        "shapes": {str(list(s)): {k: out[s][k] for k in (
            "f", "cf", "b", "cb", "b_frozen", "pf", "pb", "ys", "bf", "bb")}
            for s in out},
        "pami_sim_512": {"shapes": [list(s) for s in FILM_SIM],
                         "launches_each_way_per_call": 3,
                         "forward_ms": sim["f"],
                         "backward_frozen_ms": sim["b_frozen"],
                         "backward_ms": sim["b"], "bound_ms": sim["bf"]
                         + sim["bb"], "plain_ms": sim["pf"] + sim["pb"]}}


# ------------------------------------------------------------ phase 18
# KD-JPEG at its published widths, and the image family's simulator

KD_S, KD_B = 256, 6      # the JAX runner's geometry: one source × 6 classes
KD_LOG_RTOL = 1e-5       # the logs, KERNELS vs PLAIN
KD_PSNR_ATOL = 1e-3      # PSSIMU (dB)
KD_GRAD_COS = 0.9999     # each net's gradient, KERNELS vs PLAIN
KD_SIM_ATOL = 1e-5       # simulate, KERNELS vs PLAIN
KD_LOGS = ("lQF", "l_simul", "l_simul_bayar", "qfsimu", "FW_GAN",
           "dis_loss")
# a KD-JPEG train step: one generator forward (12 K23 launches at nb 4)
# and its backward (12)
KD_TRAIN = {**ZERO_LAUNCHES, "film_residual": 2 * 3 * FILM_NB}
# PAMI with the simulator: PAMI's, the jpeg_basic target's K5 draw, two
# simulator calls of three K23 launches each way
SIM_TRAIN = {**IMG_TRAIN, "jpeg_pair": IMG_TRAIN["jpeg_pair"] + 1,
             "film_residual": 12}


def kd_cfg(s, b):
    from vwfd_tpu_torch import KDJPEG_CONFIG
    cfg = load_config(KDJPEG_CONFIG)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, gt_size=s, batch_size=b))


def kd_model(cfg, seed, kernels=None):
    from vwfd_tpu_torch.models import KDJpegModel
    model = KDJpegModel(cfg, kernels=kernels or KERNELS)
    model.init_states(seed)
    return model


def kd_batches(model, n, seed=10):
    """``n`` class-major batches of the runner's LQ items (PIL's JPEG at 10,
    30, 50, 70, 90), on the device."""
    from vwfd_tpu_torch.data import LQJpegDataset
    items = max(1, model.cfg.data.batch_size // model.qf_classes)
    ds = LQJpegDataset(size=model.size, synthetic_length=n * items,
                       seed=seed)
    out = []
    for i in range(n):
        v, lab = (np.stack(x) for x in zip(*[ds[i * items + j]
                                             for j in range(items)]))
        out.append(model.to_device(*model.collate(v, lab)))
    return out


def run_kdjpeg(card):
    """Phase 18: KD-JPEG at its published widths (FBCNN nc (32, 64, 128,
    256) nb 4, the QF classifier nb 1, the discriminator dim 32; 256², one
    clean source × 6 classes, f32), random weights from a seed: a
    ``train_step`` at ``aux_ramp`` 0 and 1 through ``KERNELS`` and
    ``PLAIN`` from the same state and batch (logs within ``KD_LOG_RTOL``,
    PSSIMU within ``KD_PSNR_ATOL``, each net's gradient cosine ≥
    ``KD_GRAD_COS``), with the launch counts at 0 just before and read just
    after (K23 ×24); an Inf pixel that moves no state of the three nets;
    ``simulate`` against ``PLAIN``'s; the p50 of a train step, images/s and
    the peak memory. Then one PAMI step at 512² b3 ``reverse_k`` 3 with
    ``with_jpeg_simulator`` (the ``jpeg_basic`` target) through both sets:
    K5 ×1 more than PAMI's, K23 ×12."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    cfg = kd_cfg(KD_S, KD_B)
    model = kd_model(cfg, 51)
    ref = kd_model(cfg, 51, PLAIN)
    gen = model.generator
    check((gen.nb, gen.head.out_channels, gen.down3_down.out_channels,
           model.localizer.nb, model.discriminator.init_a.features)
          == (4, 32, 128, 1, 32), "kdjpeg widths")
    batches = kd_batches(model, 4)
    launches, terms, cosines = {}, {}, {}
    for i, ramp in enumerate((0.0, 1.0)):
        copy_image(ref, model)
        gp_, gk_ = {}, {}
        lp = {k: float(v) for k, v in ref.train_step(
            *batches[i], aux_ramp=ramp, grads_out=gp_).items()}
        torch.cuda.synchronize()
        reset_launch_counts()
        logs = model.train_step(*batches[i], aux_ramp=ramp, grads_out=gk_)
        torch.cuda.synchronize()
        key = f"kdjpeg_train_{i}"
        launches[key] = launch_counts()
        lk = {k: float(v) for k, v in logs.items()}
        cos = grad_cosines(gk_, gp_)
        print(f"{key} (aux_ramp {ramp}): kernels {json.dumps(lk)} plain "
              f"{json.dumps(lp)}; gradient cosines {cos}; launches "
              f"{json.dumps({k: v for k, v in launches[key].items() if v})}")
        check(launches[key] == KD_TRAIN, f"{key} launches {launches[key]}")
        for k in KD_LOGS:
            check(math.isfinite(lk[k]) and abs(lk[k] - lp[k])
                  <= KD_LOG_RTOL * abs(lp[k]),
                  f"{key} {k}: kernels {lk[k]} plain {lp[k]}")
        check(abs(lk["PSSIMU"] - lp["PSSIMU"]) <= KD_PSNR_ATOL,
              f"{key} PSSIMU {lk['PSSIMU']} vs {lp['PSSIMU']}")
        check(all(c >= KD_GRAD_COS for c in cos.values()),
              f"{key} gradient cosines {cos}")
        terms[key], cosines[key] = {"kernels": lk, "plain": lp}, cos
    launches["kdjpeg_train_step"] = launches["kdjpeg_train_0"]

    bad = batches[2][0].clone()
    bad[3, KD_S // 3, KD_S // 2, 1] = float("inf")
    before = [t.clone() for t in model._tensors()]
    logs = model.train_step(bad, batches[2][1])
    check(not math.isfinite(float(logs["lQF"])), "Inf batch: finite lQF")
    check(all(torch.equal(a, b) for a, b in zip(before, model._tensors())),
          "kdjpeg Inf batch moved a parameter, moment, count or spectral "
          "vector")
    print("kdjpeg guard: an Inf pixel left every parameter, Adam moment, "
          "count and spectral vector of the generator, the QF classifier "
          "and the discriminator as it was")
    del before

    copy_image(ref, model)
    src = batches[3][0][:KD_B]
    qf = torch.arange(KD_B, device=src.device,
                      dtype=torch.float32)[:, None] / 5
    reset_launch_counts()
    sim = model.simulate(src, qf)
    torch.cuda.synchronize()
    sim_launches = launch_counts()["film_residual"]
    simp = ref.simulate(src, qf)
    serr = float((sim - simp).abs().max())
    check(sim.shape == src.shape and bool(torch.isfinite(sim).all())
          and float(sim.min()) >= 0.0 and float(sim.max()) <= 1.0
          and serr <= KD_SIM_ATOL and sim_launches == 3 * FILM_NB,
          f"kdjpeg simulate: err {serr}, launches {sim_launches}")
    print(f"kdjpeg simulate: {tuple(sim.shape)} in [0, 1], max_abs_err vs "
          f"plain {serr:.3g}, K23 ×{sim_launches}")
    del ref
    gc.collect()

    it_ = iter(range(10 ** 6))

    def train_one():
        b = batches[next(it_) % 4]
        return model.train_step(*b)["lQF"].item()
    train_p50 = p50_of(train_one, 10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"kdjpeg p50 at {KD_S}², {KD_B} images: train step "
          f"{train_p50:.3f} ms ({KD_B / train_p50 * 1e3:.1f} images/s); "
          f"peak memory {peak:.3f} GiB [{card}]")
    del model, batches
    gc.collect()

    bs, bn, bk = IMG_BIG
    pcfg = image_cfg(bs, bn)
    m = image_model(pcfg, 44, with_jpeg_simulator=True, reverse_k=bk)
    r = image_model(pcfg, 44, kernels=PLAIN, with_jpeg_simulator=True,
                    reverse_k=bk)
    pb = image_batches(m, 2)
    d = m.sampler(9)((bn, bs, bs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lk, lp, cos = kernels_vs_plain_step(
        m, r, pb[1], pb[0].image, d, "pami_sim_512",
        ("loss", "lF", "lB", "l_mask", "l_sim"), launches, SIM_TRAIN)
    peak_sim = torch.cuda.max_memory_allocated() / 2 ** 30
    del r
    gc.collect()
    p_sim = p50_of(lambda: m.train_step(pb[1], pb[0].image, d)[
        "loss"].item(), 3, warmup=1)
    print(f"pami 512² b3 reverse_k 3 with the JPEG simulator: train step "
          f"p50 {p_sim:.3f} ms; peak memory {peak_sim:.3f} GiB (both "
          f"models) [{card}]")
    del m, pb
    gc.collect()
    print(json.dumps({"kdjpeg": {
        "train_step_p50_ms": train_p50,
        "train_images_per_s": KD_B / train_p50 * 1e3, "images": KD_B,
        "size": KD_S, "peak_memory_gib": peak, "terms": terms,
        "gradient_cosines": cosines, "simulate_max_abs_err": serr,
        "pami_sim_512": {"kernels": lk, "plain": lp,
                         "gradient_cosines": cos, "train_step_p50_ms": p_sim,
                         "peak_memory_gib": peak_sim},
        "card": card}}))
    return launches


# ------------------------------------------------------------ phase 19


DP_TIMEOUT_S = 120.0     # the group's collective timeout
DP_RANKS_TIMEOUT_S = 180.0  # the two ranks' wall time in all
DP_TIMED = 10            # timed steps of each kind (2 warm-up)
# bf16 replicas vs one device: cuDNN takes other convolution kernels for a
# replica's half batch, so the INN's bf16 output may move by an ulp or two,
# about a level each near 1 (2⁻⁸), before the 8-bit rounding
DP_EMBED_MAX_LEVELS = 2
# a replica's mask bit may differ from one device's only where one device's
# probability lies this close to the threshold: the half batch moves the
# detect head's bf16 logits by at most 0.0088 (port_tools/dp_diagnose.py),
# p by at most a quarter of that
DP_MASK_NEAR = 0.01


@contextlib.contextmanager
def world1_group(name):
    """One NCCL rank in this process (a ``FileStore`` under ``build/``):
    the ``"data"`` mesh of world size 1."""
    store_dir = Path(__file__).resolve().parent / "build" / name
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    store = dist.FileStore(str(store_dir / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


def dp_params(model):
    """Each net's parameters flattened, float32, on the host."""
    return {name: torch.cat([p.detach().flatten() for p in
                             net.parameters()]).float().cpu()
            for name, net in model.nets().items()}


def dp_child(out_dir):
    """Phase 19 (b), one rank (``chip_smoke.py --dp-child DIR``): gloo on
    ``cuda:0``, phase 4's weights replicated, this rank's 8 of the 16
    clips of each global batch; two train steps (the first's update and
    every step's logs kept), the replicas' equality, then a batch with an
    Inf pixel in rank 1's rows alone."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rank = parallel.maybe_init_distributed(dev, backend="gloo",
                                           timeout_s=DP_TIMEOUT_S)
    try:
        mesh = parallel.make_mesh()
        cfg = load_config(FLAGSHIP_CONFIG)
        model = VideoWatermarkModel(cfg, device=dev, mesh=mesh)
        model.load_states(perturbed_states(cfg, seed=7))
        parallel.replicate(model, mesh)
        rows = parallel.local_batch_slice(B, mesh)
        loader = Loader(SyntheticVideoDataset(size=S, frames=T, length=4 * B,
                                              seed=cfg.train.seed), B,
                        seed=cfg.train.seed, rows=rows)
        batches = [model.to_device(v, m) for v, m in loader]
        before = dp_params(model)
        grads = {}
        logs = [model.train_step(batches[1][0], batches[1][1],
                                 batches[0][0], grads_out=grads)]
        update = {k: v - before[k] for k, v in dp_params(model).items()}
        grads = {k: torch.cat([g.flatten() for g in v]).float().cpu()
                 for k, v in grads.items()}
        logs.append(model.train_step(batches[2][0], batches[2][1],
                                     batches[1][0]))
        equal = parallel.replicas_equal(model, mesh)
        kept = snapshot(model)
        bad = batches[3][0].clone()
        if rank == 1:
            bad[2, 1, 9, 11, 0] = float("inf")
        guard = model.train_step(bad, batches[3][1], batches[2][0])
        guard_kept = all(torch.equal(a, b)
                         for a, b in zip(snapshot(model), kept))
        torch.save({"rank": rank, "rows": rows, "update": update,
                    "grads": grads,
                    "logs": [{k: float(v) for k, v in lg.items()}
                             for lg in logs],
                    "replicas_equal": equal,
                    "guard_loss": float(guard["loss"]),
                    "guard_kept": guard_kept,
                    "guard_equal": parallel.replicas_equal(model, mesh)},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_world1(card):
    """Phase 19 (a): one NCCL rank in this process (a ``FileStore`` under
    ``build/``), phase 6's shape and weights."""
    cfg = load_config(FLAGSHIP_CONFIG)
    states = perturbed_states(cfg, seed=7)
    plain = VideoWatermarkModel(cfg)
    plain.load_states(states)
    with world1_group("chip_smoke_dp") as mesh:
        dp = VideoWatermarkModel(cfg, mesh=mesh)
        dp.load_states(states)
        parallel.replicate(dp, mesh)
        loader = Loader(SyntheticVideoDataset(size=S, frames=T, length=4 * B,
                                              seed=cfg.train.seed), B,
                        seed=cfg.train.seed)
        batches = [plain.to_device(v, m) for v, m in loader]
        prev, (video, mask_) = batches[0][0], batches[1]
        draws = plain.sample_draws(B, T)
        dp.eval_step(video, mask_, prev, draws)  # warm up cuDNN/cuBLAS
        torch.cuda.synchronize()
        want = plain.train_step(video, mask_, prev, draws)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = dp.train_step(video, mask_, prev, draws)
        torch.cuda.synchronize()
        train_launches = launch_counts()
        check(train_launches == TRAIN_LAUNCHES,
              f"dp train launch counts {train_launches}")
        check(all(torch.equal(got[k], want[k]) for k in want),
              f"dp step logs {got} vs plain {want}")
        equal = all(torch.equal(a, b) for a, b in zip(snapshot(dp),
                                                      snapshot(plain)))
        check(equal, "world size 1: a parameter, moment, count or running "
              "statistic differs from the step without a group")
        reset_launch_counts()
        ev_dp = dp.eval_step(video, mask_, prev, draws)
        torch.cuda.synchronize()
        eval_launches = launch_counts()
        ev = plain.eval_step(video, mask_, prev, draws)
        check(eval_launches == EVAL_LAUNCHES,
              f"dp eval launch counts {eval_launches}")
        check(all(torch.equal(ev[k], ev_dp[k]) for k in ev),
              f"dp eval {ev_dp} vs plain {ev}")
        print(f"parallel (a) world size 1, NCCL: train step and eval step "
              f"torch.equal to the steps without a group "
              f"({len(snapshot(dp))} state tensors); launches "
              f"{json.dumps({k: v for k, v in train_launches.items() if v})}")
        times = {"plain": [], "dp": []}
        for i in range(2 + DP_TIMED):
            p, (v, m) = batches[i % 3][0], batches[i % 3 + 1]
            for name, model in (("plain", plain), ("dp", dp)):
                t0 = time.perf_counter()
                model.train_step(v, m, p)
                torch.cuda.synchronize()
                if i >= 2:
                    times[name].append((time.perf_counter() - t0) * 1e3)
        p50 = {k: float(np.percentile(v, 50)) for k, v in times.items()}
        grad_bytes = sum(4 * q.numel() for net in dp.nets().values()
                         for q in net.parameters())
        print(f"parallel (a) train step p50: plain {p50['plain']:.3f} ms, "
              f"data-parallel at world size 1 {p50['dp']:.3f} ms "
              f"(+{p50['dp'] - p50['plain']:.3f}); {grad_bytes} bytes of "
              f"float32 gradients all-reduced a step [{card}]")
        return {"train_step_p50_ms": p50["plain"],
                "dp_train_step_p50_ms": p50["dp"],
                "allreduce_bytes_per_step": grad_bytes,
                "equal": equal}, train_launches, eval_launches


def dp_reference(cfg, states, batches):
    """The one-process step on the global batch (phase 6's model): its
    logs, each net's gradients and update, flattened."""
    ref = VideoWatermarkModel(cfg)
    ref.load_states(states)
    before = dp_params(ref)
    grads = {}
    logs = {k: float(v) for k, v in ref.train_step(
        batches[1][0], batches[1][1], batches[0][0],
        grads_out=grads).items()}
    upd = {k: v - before[k] for k, v in dp_params(ref).items()}
    return logs, {k: torch.cat([g.flatten() for g in v]).float().cpu()
                  for k, v in grads.items()}, upd


def dp_two_ranks(card):
    """Phase 19 (b): two gloo ranks on ``cuda:0`` (``dp_child``) against
    the one-process step on the global batch: loss terms within
    ``TRAIN_LOSS_RTOL`` and each net's all-reduced gradient within
    ``TRAIN_GRAD_COS`` (phase 6's tolerances). The updates' cosines are
    printed: the first AdamW update is about lr·sign(g), so the gradients
    that cancel, whose sign the half batch's other cuDNN algorithms and
    BatchNorm's variance formula flip, weigh as much as the rest."""
    cfg = load_config(FLAGSHIP_CONFIG)
    states = perturbed_states(cfg, seed=7)
    loader = Loader(SyntheticVideoDataset(size=S, frames=T, length=4 * B,
                                          seed=cfg.train.seed), B,
                    seed=cfg.train.seed)
    batches = [[t.cuda() for t in map(torch.as_tensor, b)] for b in loader]
    want, grads, upd = dp_reference(cfg, states, batches)
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        with LocalRanks([sys.executable, str(Path(__file__).resolve()),
                         "--dp-child", str(out_dir)], 2) as ranks:
            ranks.wait(DP_RANKS_TIMEOUT_S)
        got = [torch.load(out_dir / f"rank{r}.pt") for r in range(2)]
    except RankFailure as e:
        check(False, f"two gloo ranks on cuda:0 failed (if gloo refuses "
              f"CUDA tensors in this build, this phase cannot run): {e}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    check(got[0]["logs"] == got[1]["logs"],
          f"ranks' losses differ: {got[0]['logs']} vs {got[1]['logs']}")
    check(all(g["replicas_equal"] for g in got),
          "the two ranks' states differ after two steps")
    lk = got[0]["logs"][0]
    for k in ("loss", "lF", "lB"):
        check(abs(lk[k] - want[k]) <= TRAIN_LOSS_RTOL * abs(want[k]),
              f"two ranks {k} {lk[k]} vs one process {want[k]}")
    cos = {k: cosine(got[0]["grads"][k], grads[k]) for k in grads}
    check(all(c >= TRAIN_GRAD_COS for c in cos.values()),
          f"two ranks' gradient cosines {cos}")
    ucos = {k: cosine(got[0]["update"][k], upd[k]) for k in upd}
    check(all(not math.isfinite(g["guard_loss"]) and g["guard_kept"]
              and g["guard_equal"] for g in got),
          f"Inf pixel on rank 1: {[(g['guard_loss'], g['guard_kept']) for g in got]}")
    print(f"parallel (b) two gloo ranks on cuda:0 (8 + 8 clips): losses "
          f"bit-equal across ranks over 2 steps, replicas bit-equal; step 1 "
          f"{json.dumps(lk)} vs one process {json.dumps(want)}; gradient "
          f"cosines {cos}; update cosines {ucos}; an Inf pixel in rank 1's "
          f"rows kept every state on "
          f"both ranks; {wall:.1f} s for both ranks (not a scaling figure: "
          f"the two ranks share one card) [{card}]")
    return {"loss_terms": {"ranks": lk, "one_process": want},
            "gradient_cosines": cos, "update_cosines": ucos,
            "ranks_wall_s": wall}


def replica_diff(got, want, one, detected):
    """How far a replicated server's outputs lie from the one-device
    server's (``one``): the watermark's largest level difference and its
    exact share; the mask bits that disagree, and of them those where
    ``one``'s probability on ``detected`` (the uint8 frames its detector
    read) lies ``DP_MASK_NEAR`` or more from the threshold; the tamper
    fraction's largest error."""
    out = {}
    if "watermarked" in got.keys():
        d = np.abs(got.watermarked.astype(int) - want.watermarked.astype(int))
        out.update(embed_max_levels=int(d.max()),
                   embed_exact=float((d == 0).mean()))
    if "mask_bits" in got.keys():
        n = len(got.mask)
        pad = np.zeros((B,) + detected.shape[1:], np.uint8)
        pad[:n] = detected
        p = int8_probs(one, pad).reshape(B, T, S, S, 1)[:n]
        flips = got.mask != want.mask
        out.update(mask_disagree=float(flips.mean()),
                   mask_flips_off_threshold=int(
                       (flips & (np.abs(p - one.threshold)
                                 >= DP_MASK_NEAR)).sum()),
                   tamper_fraction_err=float(np.abs(
                       got.tamper_fraction - want.tamper_fraction).max()))
    return out


def dp_server(card, devices):
    """Phase 19 (c)/(d): ``WatermarkServer(devices=devices)`` against the
    one-device server on phase 4's weights, a request launching phase 4's
    counts once per replica: int8 (both int8 paths) EQUAL; bf16 within
    ``DP_EMBED_MAX_LEVELS`` on ≥ ``EMBED_FRAC_EXACT`` of the bytes, mask
    bits differing only within ``DP_MASK_NEAR`` of the threshold, the
    bytes and bits that differ counted: cuDNN takes other convolution
    kernels for a replica's half
    batch (other sums, from the UNet's third convolution and the INN's
    trunk on), whatever ``cudnn.deterministic`` or ``benchmark`` say. The
    roundtrip's p50 beside the one-device server's."""
    cfg = load_config(FLAGSHIP_CONFIG)
    states = perturbed_states(cfg, seed=7)
    modes = ("embed", "detect", "roundtrip")
    rng = np.random.default_rng(19)
    clip = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    out, launches, diff = {}, {}, {}
    for kind, kw in (("bf16", {}), ("int8", dict(
            int8_extract=True, int8_embed=True, int8_calib=clip))):
        one = WatermarkServer(cfg, weights=states, modes=modes, **kw)
        many = WatermarkServer(cfg, devices=devices, weights=states,
                               modes=modes, **kw)
        for mode in modes:
            for req in (clip, clip[: B - 3]):
                want = one.serve(req, mode)
                n1, _ = served_launches(one, req, mode)
                n2, got = served_launches(many, req, mode)
                check(n2 == {k: len(devices) * v for k, v in n1.items()},
                      f"{kind} {mode}: launches {n2} vs one device {n1}")
                same = {k: bool(np.array_equal(getattr(got, k),
                                               getattr(want, k)))
                        for k in want.keys()}
                if kind == "int8":
                    check(all(same.values()), f"int8 {mode} over {devices}: "
                          f"{same} (EQUAL expected)")
                else:
                    read = want.watermarked if mode == "roundtrip" else req
                    diff[f"{mode}_{len(req)}"] = {
                        "equal": same,
                        **replica_diff(got, want, one, read)}
            launches[f"dp_server_{kind}_{mode}"] = n2
        out[kind] = {"roundtrip_p50_ms": p50_ms(one, clip, "roundtrip"),
                     "replicas_roundtrip_p50_ms":
                     p50_ms(many, clip, "roundtrip")}
        del one, many
        gc.collect()
    out["bf16_against_one_device"] = diff
    for key, d in diff.items():
        check(d.get("embed_max_levels", 0) <= DP_EMBED_MAX_LEVELS
              and d.get("embed_exact", 1.0) >= EMBED_FRAC_EXACT
              and d.get("mask_flips_off_threshold", 0) == 0,
              f"bf16 replicas over {devices}, {key}: {d}")
    print(f"parallel server over {list(map(str, devices))}: int8 embed, "
          f"detect and roundtrip EQUAL to one device (full and short "
          f"requests); bf16 {json.dumps(diff)}; roundtrip p50 "
          f"{json.dumps({k: v for k, v in out.items() if k != 'bf16_against_one_device'})} [{card}]")
    return out, launches


def run_parallel(card):
    """Phase 19: data-parallel training and multi-card serving."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    world1, train_l, eval_l = dp_world1(card)
    gc.collect()
    torch.cuda.empty_cache()
    two = dp_two_ranks(card)
    server, launches = dp_server(card, ("cuda:0", "cuda:0"))
    launches.update(dp_train_step=train_l, dp_eval_step=eval_l)
    multi = None
    if torch.cuda.device_count() > 1:
        from vwfd_tpu_torch import dryrun_multiprocess
        multi = {"nccl_two_cards": dryrun_multiprocess.run(
            2, "cuda", batch=B, frames=T, size=S,
            timeout_s=DP_RANKS_TIMEOUT_S),
            "server_two_cards": dp_server(card, ("cuda:0", "cuda:1"))[0]}
    else:
        print("parallel (d): one card: two ranks over NCCL on two cards and "
              "the two-card server were not run")
    wall = time.perf_counter() - t0
    print(json.dumps({"parallel": {
        "world_size_1_nccl": world1, "two_gloo_ranks_one_card": two,
        "two_replica_server_one_card": server, "two_cards": multi,
        "phase_s": wall, "batch": B, "frames": T, "size": S,
        "card": card}}))
    return launches


# ------------------------------------------------------------ phase 20
# data parallelism of every other family: (a) one NCCL rank per task at its
# family phase's shape, EQUAL to the step without a group; (b) MBRS and CLR
# on two gloo ranks sharing cuda:0

DPF_TASKS = ("hidden", "mbrs", "tianchi", "pami", "imuge", "clr", "kdjpeg")
DPF_EVALS = ("tianchi", "pami", "clr")
DPF_TIMEOUT_S = 120.0        # the group's collective timeout
DPF_RANKS_TIMEOUT_S = 240.0  # the two ranks' wall time in all
DPF_TIMED = 4                # (a): timed steps of each kind (1 warm-up)
DPF_LOSS_RTOL = 1e-4         # (b): loss terms against the one process
DPF_GRAD_COS = 0.9999        # (b): each net's all-reduced gradient
DPF_B = {"hidden": HID_B, "mbrs": MBRS_B, "tianchi": TC_B, "pami": IMG_B,
         "imuge": IMG_B, "clr": CLR_B, "kdjpeg": KD_B}
DPF_S = {"hidden": HID_S, "mbrs": MBRS_S, "tianchi": TC_S, "pami": IMG_S,
         "imuge": IMG_S, "clr": CLR_S, "kdjpeg": KD_S}


def dpf_model(task, mesh=None):
    """``task``'s model at its family phase's width, from a fixed seed
    (two calls give bit-equal states), on ``cuda:0``; CLR with the GAN
    and the JPEG simulator (K23), ImugeV2 with the VGG loss."""
    from vwfd_tpu_torch.models import (HiddenModel, KDJpegModel, MBRSModel,
                                       TianchiModel)
    if task == "hidden":
        model = HiddenModel(image_size=HID_S, mesh=mesh)
    elif task == "mbrs":
        model = MBRSModel(mesh=mesh)
    elif task == "tianchi":
        model = TianchiModel(tianchi_cfg(TC_S, TC_B), mesh=mesh)
    elif task == "kdjpeg":
        model = KDJpegModel(kd_cfg(KD_S, KD_B), mesh=mesh)
    elif task == "clr":
        return image_model(clr_cfg(CLR_S, CLR_B), 41, task="clr",
                           with_gan=True, with_jpeg_simulator=True, mesh=mesh)
    else:
        return image_model(image_cfg(IMG_S, IMG_B), 31, task=task, mesh=mesh,
                           use_perceptual=task == "imuge")
    model.init_states(26)
    return model


def dpf_inputs(task, model):
    """Two global batches of ``task`` on the device (the second for the
    eval step and the two-rank phase's second step) and each one's draws,
    from fixed seeds."""
    from vwfd_tpu_torch.models.hidden_model import HiddenSampler
    from vwfd_tpu_torch.models.mbrs_model import MBRSDraws
    from vwfd_tpu_torch.models.tianchi_model import TianchiDraws
    b, s = DPF_B[task], DPF_S[task]
    if task in ("hidden", "mbrs"):
        from vwfd_tpu_torch.data import SyntheticImageDataset
        ds = SyntheticImageDataset(size=s, length=2 * b, seed=10)
        rng = np.random.default_rng(10)
        sampler = HiddenSampler(14, "cuda")
        return [dict(img=model.to_device(np.stack(
                    [ds[i * b + j] for j in range(b)]))[0],
                     msg=model.to_device((rng.random((b, 30)) > 0.5).astype(
                         np.float32))[0],
                     draws=(sampler((b, s, s, 3), ("crop", "gaussian")[i])
                            if task == "hidden" else MBRSDraws(2, 4)))
                for i in range(2)]
    if task == "tianchi":
        return [dict(zip(("img", "mask"), model.to_device(*x)),
                     draws=TianchiDraws(*TC_DRAWS[i]))
                for i, x in enumerate(tianchi_batches(model, 2))]
    if task == "kdjpeg":
        return [dict(zip(("flat", "lab"), x)) for x in kd_batches(model, 2)]
    batches = image_batches(model, 3)
    sampler = model.sampler(5)
    return [dict(batch=batches[i + 1], prev=batches[i].image,
                 draws=sampler((b, s, s))) for i in range(2)]


def dpf_step(task, model, d, mesh, grads=None):
    """One train step of ``task`` on this process's rows of ``d`` (all of
    them without a mesh or at world size 1)."""
    from vwfd_tpu_torch.models.image_model import ImageBatch
    rows = functools.partial(parallel.local_rows, mesh=mesh)
    if task in ("hidden", "mbrs"):
        draws = d["draws"].rows(mesh) if task == "hidden" else d["draws"]
        return model.train_step(rows(d["img"]), rows(d["msg"]), draws, grads)
    if task == "tianchi":
        out = [] if grads is not None else None
        logs = model.train_step(rows(d["img"]), rows(d["mask"]), d["draws"],
                                out)
        if grads is not None:
            grads.update(ce=out[0], ce1=out[1])
        return logs
    if task == "kdjpeg":
        flat, lab, src = model.local_batch(d["flat"], d["lab"])
        return model.train_step(flat, lab, grads_out=grads, sources=src)
    return model.train_step(ImageBatch(*map(rows, d["batch"])),
                            rows(d["prev"]), d["draws"].rows(mesh), grads)


def dpf_eval(task, model, d, mesh):
    from vwfd_tpu_torch.models.image_model import ImageBatch
    rows = functools.partial(parallel.local_rows, mesh=mesh)
    if task == "tianchi":
        return model.eval_step(rows(d["img"]), rows(d["mask"]))
    return model.eval_step(ImageBatch(*map(rows, d["batch"])),
                           rows(d["prev"]), d["draws"].rows(mesh))


def dpf_counted(fn):
    """``fn()`` with the launch counts at 0 just before and read just
    after, under cuDNN's deterministic algorithms."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
    return out, launch_counts()


def dpf_collectives(fn):
    """``fn()``'s ``all_reduce`` calls and their bytes."""
    sizes = []
    real = dist.all_reduce

    def counted(t, *a, **kw):
        sizes.append(t.numel() * t.element_size())
        return real(t, *a, **kw)
    dist.all_reduce = counted
    try:
        fn()
    finally:
        dist.all_reduce = real
    return len(sizes), sum(sizes)


def dpf_world1(card):
    """Phase 20 (a): per task, a train step (and for Tianchi, PAMI and CLR
    an eval step) through the model without a group and through the model
    over a world-1 NCCL group, from the same state, batch and draws: every
    log, state tensor and eval output ``torch.equal``, the launch counts
    equal; the group's launches are the main path's. Then the all-reduce
    calls and bytes of a step, and the p50 of ``DPF_TIMED`` steps of each
    model, interleaved after one warm-up (host wall ending in a
    synchronize)."""
    out, launches = {}, {}
    with world1_group("chip_smoke_dpf") as mesh:
        for task in DPF_TASKS:
            t0 = time.perf_counter()
            plain = dpf_model(task)
            dp = dpf_model(task, mesh)
            parallel.replicate(dp, mesh)
            inp = dpf_inputs(task, plain)
            check(all(torch.equal(a, b) for a, b in zip(
                parallel._state_tensors(dp),
                parallel._state_tensors(plain))), f"{task}: states differ")
            want, n_plain = dpf_counted(lambda: dpf_step(task, plain, inp[0],
                                                         None))
            got, n_dp = dpf_counted(lambda: dpf_step(task, dp, inp[0], mesh))
            launches[f"dp_{task}_train_step"] = n_dp
            check(n_dp == n_plain, f"{task} dp train launches {n_dp} vs "
                  f"{n_plain}")
            check(want.keys() == got.keys() and all(
                torch.equal(got[k], want[k]) for k in want),
                f"{task} dp step logs {got} vs {want}")
            ts = parallel._state_tensors(dp)
            equal = all(torch.equal(a, b) for a, b in zip(
                ts, parallel._state_tensors(plain)))
            check(equal, f"{task} world size 1: a state tensor differs from "
                  f"the step without a group")
            res = {"state_tensors": len(ts), "train_equal": equal,
                   "logs": {k: float(v) for k, v in got.items()}}
            if task in DPF_EVALS:
                ev, e_plain = dpf_counted(lambda: dpf_eval(task, plain,
                                                           inp[1], None))
                ev_dp, e_dp = dpf_counted(lambda: dpf_eval(task, dp, inp[1],
                                                           mesh))
                launches[f"dp_{task}_eval_step"] = e_dp
                check(e_dp == e_plain, f"{task} dp eval launches {e_dp} vs "
                      f"{e_plain}")
                check(ev.keys() == ev_dp.keys() and all(
                    torch.equal(ev_dp[k], ev[k]) for k in ev),
                    f"{task} dp eval differs from the eval without a group")
                res["eval_equal"] = True
            res["allreduce_calls"], res["allreduce_bytes"] = dpf_collectives(
                lambda: dpf_step(task, dp, inp[1], mesh))
            times = {"plain": [], "dp": []}
            for i in range(1 + DPF_TIMED):
                for name, m, me in (("plain", plain, None), ("dp", dp, mesh)):
                    t1 = time.perf_counter()
                    dpf_step(task, m, inp[i % 2], me)
                    torch.cuda.synchronize()
                    if i >= 1:
                        times[name].append((time.perf_counter() - t1) * 1e3)
            res["train_step_p50_ms"] = float(np.percentile(times["plain"], 50))
            res["dp_train_step_p50_ms"] = float(np.percentile(times["dp"],
                                                              50))
            res["s"] = time.perf_counter() - t0
            used = {k: v for k, v in n_dp.items() if v}
            print(f"parallel families (a) {task} b{DPF_B[task]} "
                  f"{DPF_S[task]}², world size 1 NCCL: train step"
                  f"{' and eval step' if task in DPF_EVALS else ''} "
                  f"torch.equal to the step without a group "
                  f"({len(ts)} state tensors); launches {json.dumps(used)}; "
                  f"{res['allreduce_calls']} all-reduces of "
                  f"{res['allreduce_bytes']} bytes a step; step p50 plain "
                  f"{res['train_step_p50_ms']:.3f} ms, data-parallel "
                  f"{res['dp_train_step_p50_ms']:.3f} ms [{card}]")
            out[task] = res
            del plain, dp, inp
            gc.collect()
            torch.cuda.empty_cache()
    return out, launches


DPF_CHILD_TASKS = ("mbrs", "clr")


def dpf_flat(grads):
    return {k: torch.cat([g.flatten() for g in v]).float().cpu()
            for k, v in grads.items()}


def dpf_jpeg(model, d, mesh):
    """MBRS: the JPEG of the first step's clipped encoding (this process's
    rows), as the step computes it."""
    from vwfd_tpu_torch.attacks import jpeg_basic
    from vwfd_tpu_torch.device import full_f32
    from vwfd_tpu_torch.kernels.zigzag import clip01
    rows = functools.partial(parallel.local_rows, mesh=mesh)
    with torch.no_grad(), full_f32():
        enc = clip01(model.encoder(rows(d["img"]), rows(d["msg"]),
                                   train=True, mesh=mesh)[0])
        return jpeg_basic(enc, d["draws"].q_idx, "ss").cpu()


def dpf_run(task, model, inp, mesh, bad_rank):
    """Two steps (the first's gradients and update kept, every step's
    logs; MBRS: the first step's JPEG too), the replicas' equality, then
    the first batch with an Inf pixel in ``bad_rank``'s rows alone (every
    rank's state kept)."""
    jpeg = dpf_jpeg(model, inp[0], mesh) if task == "mbrs" else None
    before = dp_params(model)
    grads = {}
    logs = [dpf_step(task, model, inp[0], mesh, grads)]
    update = {k: v - before[k] for k, v in dp_params(model).items()}
    logs.append(dpf_step(task, model, inp[1], mesh))
    equal = parallel.replicas_equal(model, mesh)
    kept = [t.clone() for t in parallel._state_tensors(model)]
    bad = dict(inp[0])
    b = DPF_B[task]
    if task == "mbrs":
        bad["img"] = inp[0]["img"].clone()
        bad["img"][b - 1, 9, 11, 0] = float("inf")
    else:
        from vwfd_tpu_torch.models.image_model import ImageBatch
        img = inp[0]["batch"].image.clone()
        img[b - 1, 120, 130, 2] = float("inf")
        bad["batch"] = ImageBatch(img, *inp[0]["batch"][1:])
    guard = dpf_step(task, model, bad, mesh)
    return {"logs": [{k: float(v) for k, v in lg.items()} for lg in logs],
            "grads": dpf_flat(grads), "update": update, "jpeg": jpeg,
            "replicas_equal": equal,
            "guard_loss": float(guard["loss"]),
            "guard_kept": all(torch.equal(a, b) for a, b in zip(
                parallel._state_tensors(model), kept)),
            "guard_equal": parallel.replicas_equal(model, mesh)}


def dpf_child(out_dir):
    """Phase 20 (b), one rank (``chip_smoke.py --dpf-child DIR``): gloo on
    ``cuda:0``, MBRS then CLR, each from a rank-seeded model made equal by
    ``replicate``, on this rank's half of every global batch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rank = parallel.maybe_init_distributed(dev, backend="gloo",
                                           timeout_s=DPF_TIMEOUT_S)
    try:
        mesh = parallel.make_mesh()
        out = {"rank": rank}
        for task in DPF_CHILD_TASKS:
            model = dpf_model(task, mesh)
            if rank == 1:  # a state of its own, for replicate to overwrite
                with torch.no_grad():
                    first = next(iter(model.nets().values()))
                    next(first.parameters()).add_(1.0)
            differed = not parallel.replicas_equal(model, mesh)
            parallel.replicate(model, mesh)
            inp = dpf_inputs(task, model)
            out[task] = {"differed": differed,
                         **dpf_run(task, model, inp, mesh, 1)}
            del model, inp
            gc.collect()
            torch.cuda.empty_cache()
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def dpf_flax_form():
    """Train-mode BatchNorm with flax's ``E[x²] − E[x]²`` variance on this
    process's rows (the global path's formula; ``F.batch_norm`` takes
    another, which parts a cancelled gradient by more than its rounding:
    ``tests/test_torch_parallel.py``)."""
    from unittest import mock

    from vwfd_tpu_torch.nets import mbrs as mbrs_nets
    from vwfd_tpu_torch.nets import unet
    plain = unet._bn

    def bn(x, layer, stats=None):
        return (plain(x, layer) if stats is None
                else unet._bn_global(x, layer, stats))
    with mock.patch.object(unet, "_bn", bn), \
            mock.patch.object(mbrs_nets, "_bn", bn):
        yield


def dpf_two_ranks(card):
    """Phase 20 (b): two gloo ranks on ``cuda:0`` (``dpf_child``), MBRS
    (BatchNorm over the global batch, K5) and CLR (K14, K15, K19-K22, K8,
    the gates), each against the one-process step on the global batch
    (MBRS's with flax's variance, ``dpf_flax_form``; the plain one's
    cosines printed): the ranks' states bit-equal after two steps, loss
    terms within ``DPF_LOSS_RTOL``, each net's all-reduced gradient cosine
    ≥ ``DPF_GRAD_COS``, an Inf pixel in rank 1's rows keeping every state on
    both ranks; the first updates' cosines printed, not gated (the first
    AdamW update is about lr·sign(g), and the gradients that cancel take
    either sign between two summation orders). MBRS's soft JPEG is counted
    for 8×8 blocks that flipped between the ranks' encoding and the one
    process's (cuDNN's other algorithms for the half batch move the
    encoding by ulps): with flips, phase 13's rule for each
    (``MBRS_FLIP_LOSS_RTOL``, ``MBRS_FLIP_GRAD_COS``)."""
    want, plain_bn = {}, {}
    for task in DPF_CHILD_TASKS:
        model = dpf_model(task)
        inp = dpf_inputs(task, model)
        if task == "mbrs":
            plain_bn[task] = dpf_run(task, model, inp, None, 1)
            model = dpf_model(task)
            with dpf_flax_form():
                want[task] = dpf_run(task, model, inp, None, 1)
        else:
            want[task] = dpf_run(task, model, inp, None, 1)
        del model, inp
        gc.collect()
        torch.cuda.empty_cache()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_dpf2"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        with LocalRanks([sys.executable, str(Path(__file__).resolve()),
                         "--dpf-child", str(out_dir)], 2) as ranks:
            ranks.wait(DPF_RANKS_TIMEOUT_S)
        got = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
               for r in range(2)]
    except RankFailure as e:
        check(False, f"phase 20 (b): two gloo ranks on cuda:0 failed: {e}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    out = {"ranks_wall_s": wall}
    for task in DPF_CHILD_TASKS:
        a, b = got[0][task], got[1][task]
        check(a["differed"] and b["differed"],
              f"{task}: the ranks' seeded states were equal before replicate")
        check(a["logs"] == b["logs"], f"{task}: ranks' logs differ: "
              f"{a['logs']} vs {b['logs']}")
        check(a["replicas_equal"] and b["replicas_equal"],
              f"{task}: the two ranks' states differ after two steps")
        ref = want[task]
        nflip = 0
        if task == "mbrs":
            nflip, nblocks = flipped_blocks(torch.cat([a["jpeg"], b["jpeg"]]),
                                            ref["jpeg"], JPEG_FLIP_ATOL)
            print(f"parallel families (b) mbrs: the step's soft JPEG, ranks "
                  f"against one process: {nflip} of {nblocks} 8×8 blocks "
                  f"flipped")
        rtol = MBRS_FLIP_LOSS_RTOL * nflip if nflip else DPF_LOSS_RTOL
        min_cos = 1 - (1 - MBRS_FLIP_GRAD_COS) * nflip if nflip \
            else DPF_GRAD_COS
        lk, lp = a["logs"][0], ref["logs"][0]
        check(lk.keys() == lp.keys(), f"{task} log keys {lk} vs {lp}")
        # the bit error counts bits: printed, not a loss term
        rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp
               if k != "bitwise_error"}
        check(all(r <= rtol for r in rel.values()),
              f"{task} two ranks' loss terms {lk} vs one process {lp}")
        cos = {k: cosine(a["grads"][k], ref["grads"][k]) for k in ref["grads"]}
        check(all(c >= min_cos for c in cos.values()),
              f"{task} two ranks' gradient cosines {cos} ({nflip} flipped "
              f"JPEG blocks)")
        ucos = {k: cosine(a["update"][k], ref["update"][k])
                for k in ref["update"]}
        if task in plain_bn:
            cos_bn = {k: cosine(a["grads"][k], plain_bn[task]["grads"][k])
                      for k in ref["grads"]}
            print(f"parallel families (b) {task}: gradient cosines against "
                  f"the one process with F.batch_norm's variance {cos_bn}")
        check(all(not math.isfinite(g["guard_loss"]) and g["guard_kept"]
                  and g["guard_equal"] for g in (a, b)),
              f"{task} Inf pixel on rank 1: "
              f"{[(g['guard_loss'], g['guard_kept']) for g in (a, b)]}")
        print(f"parallel families (b) {task} on two gloo ranks on cuda:0 "
              f"(b{DPF_B[task]} {DPF_S[task]}², half each): logs bit-equal "
              f"across ranks over 2 steps, replicas bit-equal; step 1 "
              f"{json.dumps(lk)} vs one process {json.dumps(lp)} (largest "
              f"relative difference {max(rel.values()):.3g}); gradient "
              f"cosines {cos}; first-update cosines {ucos}; an Inf pixel in "
              f"rank 1's rows kept every state on both ranks [{card}]")
        out[task] = {"loss_terms": {"ranks": lk, "one_process": lp},
                     "max_rel": max(rel.values()), "gradient_cosines": cos,
                     "update_cosines": ucos, "flipped_jpeg_blocks": nflip}
        if task in plain_bn:
            out[task]["gradient_cosines_f_batch_norm"] = cos_bn
    return out


def run_parallel_families(card):
    """Phase 20: data-parallel training of every other family."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    world1, launches = dpf_world1(card)
    t1 = time.perf_counter()
    two = dpf_two_ranks(card)
    wall = time.perf_counter() - t0
    print(json.dumps({"parallel_families": {
        "world_size_1_nccl": world1, "two_gloo_ranks_one_card": two,
        "world_size_1_s": t1 - t0, "two_ranks_s": time.perf_counter() - t1,
        "phase_s": wall, "card": card}}))
    return launches


# ------------------------------------------------------------ phase 21
# the JPEG-vs-adversarial study and the library around it: K24 diffjpeg,
# K5's 4:2:0 mode, K25 blockdct (the host), the study end to end, and the
# library's ops and losses on the card against their CPU results

STUDY_N, STUDY_SIZE, STUDY_STEPS = 16, 32, 10   # the study's defaults
STUDY_SHAPE = (1, STUDY_SIZE, STUDY_SIZE, 3)    # one image an attack step
STUDY_ATTACKS = (("fgsm", False), ("igsm", False), ("igsm", True),
                 ("jpeg_resistant", False))
# K24 vs plain: forward within DIFFJPEG_ATOL (outputs in [0, 1]) and the
# gradient within DIFFJPEG_ATOL of its max on every 16×16 macroblock, but
# for those where the plain version has a coefficient within rounding of
# the soft round's jump at |c/t| = ½ (forward and gradient) or a pre-clip
# value within rounding of 0 or 255 (gradient), where the sums' order may
# tip it (``diffjpeg.tie_macroblocks``); at the study's and the ragged
# shape those too
DIFFJPEG_ATOL = 1e-5
# per pixel, the least work: colour maps 2 × 15, the 2×2 means 1, four
# 8-term passes over Y (64 flops a value) and over the two quarter-size
# chroma planes (32), quantisation 6, the clip and /255 3: about 140
# forward; the backward recomputes it and carries g back: about 420
DIFFJPEG_OPS = (140, 420)
# the study, K24 against plain: a gradient sign that is rounding noise may
# flip between the two (tests/test_torch_adversarial.py), so at most one of
# the STUDY_N images may end on another label or move its PSNR by more
# than 0.05 dB
STUDY_ROWS_APART = 1
LIB_RTOL = 1e-4  # library ops on the card vs their CPU results, of scale


def flipped_mbs(got, want, atol):
    """16×16 macroblocks (all channels) of NHWC frames where |got − want| >
    atol, and their number."""
    n, h, w, c = got.shape
    d = (got - want).abs().reshape(n, h // 16, 16, w // 16, 16, c)
    d = d.amax(dim=(2, 4, 5))
    return int((d > atol).sum()), n * (h // 16) * (w // 16), d


def diffjpeg_against_plain(what, x, f, cot, strict):
    """K24 and its plain version forward and backward at x: NaN where the
    plain version's are, within ``DIFFJPEG_ATOL`` on every macroblock
    (``strict``) or on every one that is not a tie of the plain version;
    returns (parted fwd, parted grad, ties fwd, ties grad, macroblocks, max
    err outside the parted fwd, grad)."""
    (yk,), (gk,) = grads_of(lambda v: diffjpeg.diffjpeg(v, f), [x], [True],
                            cot)
    (yp,), (gp,) = grads_of(lambda v: diffjpeg.diffjpeg_plain(v, f), [x],
                            [True], cot)
    torch.cuda.synchronize()
    for name, k, p in (("forward", yk, yp), ("gradient", gk, gp)):
        check(torch.equal(k.isnan(), p.isnan()),
              f"{what} {name}: NaN at other places than the plain version's "
              f"({int(k.isnan().sum())} vs {int(p.isnan().sum())})")
    yk, yp, gk, gp = (torch.nan_to_num(t, nan=0.0) for t in (yk, yp, gk, gp))
    gscale = float(gp.abs().max()) or 1.0
    fb, mbs, dy = flipped_mbs(yk, yp, DIFFJPEG_ATOL)
    gfb, _, dg = flipped_mbs(gk, gp, DIFFJPEG_ATOL * gscale)
    jump, tie = diffjpeg.tie_macroblocks(x, f)
    if strict:
        jump, tie = torch.zeros_like(jump), torch.zeros_like(tie)
    loose_y = int(((dy > DIFFJPEG_ATOL) & ~jump).sum())
    loose_g = int(((dg > DIFFJPEG_ATOL * gscale) & ~tie).sum())
    check(loose_y == 0 and loose_g == 0,
          f"{what}: {loose_y} / {loose_g} of {mbs} macroblocks differ where "
          f"the plain version has no tie (forward / gradient; {fb} / {gfb} "
          f"in all, {int(jump.sum())} / {int(tie.sum())} ties)")
    calm_y = float(dy[dy <= DIFFJPEG_ATOL].max()) if fb < mbs else 0.0
    calm_g = (float(dg[dg <= DIFFJPEG_ATOL * gscale].max()) / gscale
              if gfb < mbs else 0.0)
    return fb, gfb, int(jump.sum()), int(tie.sum()), mbs, calm_y, calm_g


def check_diffjpeg(rows, card):
    """(a) K24 against its plain version, forward and backward, at the
    study's (1, 32, 32, 3), at K5's train shape (64 frames of 256²) and at
    a ragged (3, 48, 80, 3) (a last CTA with one macroblock of four), at
    the study's Q75 and at Q50, with a saturated macroblock (the clip); with
    NaN and Inf pixels; timed warm (and at the train shape with a cold L2)
    beside the plain version, with its bound. Then K5's 4:2:0 mode against
    its plain version at MBRS's shape, timed beside its 4:4:4 mode."""
    from vwfd_tpu_torch.attacks import jpeg_basic
    from vwfd_tpu_torch.ops.quantize import quality_to_factor
    row = rows["diffjpeg"]
    g = torch.Generator("cuda").manual_seed(210)
    train = (B * T, S, S, 3)
    flips, calm_y, calm_g = {}, 0.0, 0.0
    # (3, 48, 80): 45 macroblocks, the last CTA's one live macroblock of 4
    for shape in (STUDY_SHAPE, train, (3, 48, 80, 3)):
        for q in (75, 50):
            x = torch.rand(shape, device="cuda", generator=g)
            x[:, :16, :16] = 1.0
            f = torch.full((shape[0],), quality_to_factor(q), device="cuda")
            cot = torch.randn(shape, device="cuda", generator=g)
            fb, gfb, tj, tg, mbs, cy, cg = diffjpeg_against_plain(
                f"diffjpeg {shape} Q{q}", x, f, cot, shape != train)
            flips[f"{shape[0]}x{shape[1]}_Q{q}"] = [fb, gfb, tj, tg, mbs]
            calm_y, calm_g = max(calm_y, cy), max(calm_g, cg)
    bad = torch.rand((2, 48, 64, 3), device="cuda", generator=g)
    bad[0, 5, 9, 1] = float("nan")
    bad[1, 30, 40, 0] = float("inf")
    diffjpeg_against_plain("diffjpeg non-finite", bad,
                           torch.full((2,), 0.5, device="cuda"),
                           torch.randn(bad.shape, device="cuda",
                                       generator=g), False)
    print(f"check diffjpeg (K24) f32: parted macroblocks (forward, "
          f"gradient, the plain version's ties forward, gradient, of; none "
          f"parted but ties) {json.dumps(flips)}; max_abs_err outside them "
          f"{calm_y:.3g} (gradient {calm_g:.3g} of its max); with NaN and "
          f"Inf pixels NaN where the plain version's are")

    f75 = quality_to_factor(75)

    def times(shape, cold):
        n = shape[0]
        f = torch.full((n,), f75, device="cuda")
        fn = lambda v: diffjpeg.diffjpeg(v, f)  # noqa: E731
        pfn = lambda v: diffjpeg.diffjpeg_plain(v, f)  # noqa: E731
        make = lambda i: (torch.rand(shape, device="cuda", generator=g),  # noqa: E731,E501
                          torch.randn(shape, device="cuda", generator=g))
        sets = cold_sets(make, 5 * 4 * math.prod(shape)) if cold \
            else [make(0)]
        kf, kb, cf, cb = fused_times(fn, sets, [True])
        pf, pb, _, _ = fused_times(pfn, sets[:1], [True])
        px = n * shape[1] * shape[2]
        bf, _ = bound(24 * px, DIFFJPEG_OPS[0] * px)
        bb, _ = bound(36 * px, DIFFJPEG_OPS[1] * px)
        return {"shape": list(shape), "fwd_ms": kf, "bwd_ms": kb,
                "cold_ms": (cf + cb) if cold else None, "plain_fwd_ms": pf,
                "plain_bwd_ms": pb, "bound_fwd_ms": bf, "bound_bwd_ms": bb}

    step = times(STUDY_SHAPE, False)
    big = times(train, True)
    row.err = calm_y  # (ms and plain_ms: the study run's, run_study_phase)
    row.extra.update({"step": step, "train_shape": big,
                      "parted_macroblocks": flips,
                      "grad_err_of_max": calm_g})
    for name, t in (("study step", step), ("train shape", big)):
        k = t["fwd_ms"] + t["bwd_ms"]
        b = t["bound_fwd_ms"] + t["bound_bwd_ms"]
        print(f"check diffjpeg {name} {t['shape']} ms fwd={t['fwd_ms']:.5f} "
              f"bwd={t['bwd_ms']:.5f} cold={t['cold_ms']} plain "
              f"fwd={t['plain_fwd_ms']:.4f} bwd={t['plain_bwd_ms']:.4f} "
              f"bound_ms={b:.5f} (bytes) share_of_bound={b / k:.4f} "
              f"[{card}]")

    # K5's 4:2:0 mode (jpeg_basic(subsample=2)) at MBRS's shape
    x = torch.rand(MBRS_SHAPE, device="cuda", generator=g)
    cot = torch.randn(MBRS_SHAPE, device="cuda", generator=g)
    sub_flips, sub_calm = {}, 0.0
    for rounding in ("round", "ss"):
        for q in (0, 2, 4):
            fb, gfb, c = k5_against_plain(
                f"jpeg_basic 4:2:0 {rounding} q_idx {q}",
                lambda v: jpeg_basic(v, q, rounding, subsample=2),
                lambda v: jpeg_basic(v, q, rounding, subsample=2,
                                     kernels=PLAIN), x, cot)
            sub_flips[f"{rounding}_{q}"] = [fb, gfb]
            sub_calm = max(sub_calm, c)
    n = MBRS_B
    qt = quant_tables(torch.full((n, 2), 4, device="cuda")).contiguous()
    mode = torch.ones((n, 2), dtype=torch.int32, device="cuda")
    w = torch.tensor([[1.0, 0.0]], device="cuda").expand(n, 2).contiguous()
    sets = [(x, cot)]
    t = {}
    for sub in (0, 2):
        kf, kb, _, _ = fused_times(
            lambda v: jpeg.jpeg_pair(v, qt, mode, w, subsample=sub), sets,
            [True])
        pf, pb, _, _ = fused_times(
            lambda v: jpeg.jpeg_pool_pair_plain(v, qt, mode, w, sub), sets,
            [True])
        t[sub] = (kf, kb, pf, pb)
    nb = nbytes(x)
    bms, by = bound(5 * nb, x.numel() * (64 + 20 + 96 + 30))
    rows["jpeg_pair"].extra["sub420"] = {
        "shape": list(MBRS_SHAPE), "mode": "ss Q90 (fwd + bwd)",
        "fwd_ms": t[2][0], "bwd_ms": t[2][1], "plain_ms": t[2][2] + t[2][3],
        "mode0_fwd_ms_same_call": t[0][0], "mode0_bwd_ms_same_call": t[0][1],
        "bound_ms": bms, "bound_by": by, "flipped_blocks": sub_flips,
        "max_abs_err_outside_flips": sub_calm}
    print(f"check jpeg_basic 4:2:0 (K5) {MBRS_SHAPE}: flipped blocks "
          f"{json.dumps(sub_flips)}; max_abs_err outside them {sub_calm:.3g};"
          f" ms fwd={t[2][0]:.5f} bwd={t[2][1]:.5f} (4:4:4 fwd={t[0][0]:.5f}"
          f" bwd={t[0][1]:.5f}) plain={t[2][2] + t[2][3]:.4f} "
          f"bound_ms={bms:.5f} ({by}) [{card}]")


def device_ms(fn, names):
    """Device ms of one call of ``fn`` under ``torch.profiler``: of the
    kernels named ``names`` and of every device event."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    mine = total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            total += ms
            name = e.name.replace("(anonymous namespace)::", "")
            if name.split("(")[0].split("::")[-1] in names:
                mine += ms
    return mine, total


def run_study_phase(rows, card):
    """(b) The study through its entry point
    (``python -m vwfd_tpu_torch.jpegadv_experiment``'s ``main``) on the card
    at its defaults for every victim and attack, with the launch counts at
    0 just before and read just after each run (K24 ×2 a step of
    ``jpeg_resistant``, nothing else); each ``jpeg_resistant`` run again
    with ``PLAIN``'s K24 on the same weights and images. K24's row: its
    device time inside victim A's ``jpeg_resistant`` run (``run_study`` on
    the entry point's weights and images) under ``torch.profiler``, and
    the plain K24's as the same run's with ``PLAIN`` less the device time
    the two runs share (all but K24's)."""
    import contextlib
    import io
    from vwfd_tpu_torch import jpegadv_experiment as study
    zero = {k: 0 for k in ROUNDTRIP_LAUNCHES}
    out, by_path = {}, {}
    for victim in "ABC":
        for attack, targeted in STUDY_ATTACKS:
            args = ["--victim", victim, "--attack", attack, "--n",
                    str(STUDY_N)] + (["--targeted"] if targeted else [])
            buf = io.StringIO()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                summary = study.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            want = dict(zero)
            if attack == "jpeg_resistant":
                want["diffjpeg"] = 2 * STUDY_STEPS * STUDY_N
            check(launches == want, f"study {args}: launches {launches}")
            line = json.loads(buf.getvalue().splitlines()[-1])
            for k in ("adv_fooled_rate", "adv_target_rate"):
                check(0.0 <= line[k] <= 1.0 and line[k] == summary[k],
                      f"study {args}: {k} {line[k]}")
            check(all(math.isfinite(r["adv_psnr"]) and r["adv_psnr"] > 20
                      for r in summary["rows"]),
                  f"study {args}: an adversarial image's PSNR")
            name = f"{victim}_{attack}{'_targeted' if targeted else ''}"
            res = {"fooled": line["adv_fooled_rate"],
                   "target": line["adv_target_rate"], "wall_s": wall}
            if attack == "jpeg_resistant":
                if victim == "A":
                    by_path["study_jpeg_resistant"] = launches
                model = study.build_victim(victim, 10, STUDY_SIZE)
                images = np.random.default_rng(0).random(
                    (STUDY_N, STUDY_SIZE, STUDY_SIZE, 3)).astype(np.float32)
                reset_launch_counts()
                plain = study.run_study(model, images, attack, False, 0.03,
                                        [90, 70, 50, 30, 10], kernels=PLAIN,
                                        log=lambda s: None)
                check(launch_counts()["diffjpeg"] == 0, "plain study: K24")
                if victim == "A":
                    k24_run_ms(rows["diffjpeg"], study, model, images, card)
                apart = sum(a["adv_label"] != b["adv_label"]
                            or abs(a["adv_psnr"] - b["adv_psnr"]) > 0.05
                            for a, b in zip(summary["rows"], plain["rows"]))
                check(apart <= STUDY_ROWS_APART,
                      f"study {victim} jpeg_resistant: {apart} images apart "
                      f"from the plain K24's")
                res.update(plain_fooled=plain["adv_fooled_rate"],
                           plain_target=plain["adv_target_rate"],
                           rows_apart=apart)
            out[name] = res
            if victim == "A" and attack == "igsm" and not targeted:
                by_path["study_igsm"] = launches
    print(json.dumps({"study": out, "n": STUDY_N, "size": STUDY_SIZE,
                      "card": card}))
    return by_path


def k24_run_ms(row, study, model, images, card):
    """K24's device time in one ``jpeg_resistant`` study run (320 launches)
    and the plain K24's in the same run with ``PLAIN``, into its row with
    the run's bound."""
    def run(kernels):
        return lambda: study.run_study(
            model, images, "jpeg_resistant", False, 0.03,
            [90, 70, 50, 30, 10], kernels=kernels, log=lambda s: None)
    k_ms, k_total = device_ms(run(None), ("diffjpeg_fwd", "diffjpeg_bwd"))
    _, p_total = device_ms(run(PLAIN), ())
    plain_ms = p_total - (k_total - k_ms)
    steps = STUDY_N * STUDY_STEPS  # the run's attack steps
    px = math.prod(STUDY_SHAPE[:3])
    row.add(k_ms, plain_ms, steps * 60 * px, steps * sum(DIFFJPEG_OPS) * px)
    row.extra["in_run"] = {
        "run": "victim A jpeg_resistant, 16 images x 10 steps",
        "device_ms_run": k_total, "device_ms_run_plain": p_total,
        "plain_ms_by": "difference of the two runs' device time"}
    print(f"check diffjpeg in a jpeg_resistant run ({2 * steps} launches): "
          f"device ms {k_ms:.4f} (run {k_total:.3f}); plain K24 "
          f"{plain_ms:.3f} (run {p_total:.3f}) [{card}]")


def run_dct_data(rows, card):
    """(c) K25 against its plain version on the card machine's host at 256²
    (the coefficients within 1e-4 of their max), timed (the median of 7
    rounds) beside the plain version and ``scipy.fft.dctn`` of the blocks; ``DCTDomainDataset`` at
    256² with the count at 0 just before an item and read just after (K25
    ×2: Y, then Cb and Cr), and the cvtransforms train and val pipelines
    on it."""
    import random
    from vwfd_tpu_torch import native
    from vwfd_tpu_torch.data import cvtransforms as cvt
    from vwfd_tpu_torch.data.jpeg_data import DCTDomainDataset
    row = rows["blockdct"]
    rng = np.random.default_rng(25)
    y = (rng.random((256, 256)) * 255 - 128).astype(np.float32)
    c = (rng.random((2, 128, 128)) * 255 - 128).astype(np.float32)
    err = 0.0
    for p in (y, c):
        got, want = native.blockwise_dct(p), native.blockwise_dct_plain(p)
        e = float(np.abs(got - want).max())
        check(e <= 1e-4 * float(np.abs(want).max()), f"blockdct err {e}")
        err = max(err, e)

    def host_ms(fn, reps=20, rounds=7):
        """The median over ``rounds`` of the mean of ``reps`` calls (the
        host's clock: a shared host's cores make single rounds spread)."""
        fn()
        means = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            means.append((time.perf_counter() - t0) / reps * 1e3)
        return float(np.median(means))

    ms = host_ms(lambda: native.blockwise_dct(y)) + \
        host_ms(lambda: native.blockwise_dct(c))
    plain_ms = host_ms(lambda: native.blockwise_dct_plain(y)) + \
        host_ms(lambda: native.blockwise_dct_plain(c))
    library_ms = None
    try:
        import scipy.fft

        def lib(p):
            b = p.reshape(*p.shape[:-2], p.shape[-2] // 8, 8,
                          p.shape[-1] // 8, 8).swapaxes(-3, -2)
            return scipy.fft.dctn(b, norm="ortho", axes=(-2, -1))
        ref = lib(y).reshape(32, 32, 64)
        check(float(np.abs(ref - native.blockwise_dct(y)).max())
              <= 1e-4 * float(np.abs(ref).max()), "blockdct vs scipy")
        library_ms = host_ms(lambda: lib(y)) + host_ms(lambda: lib(c))
    except ImportError:
        pass
    values = y.size + c.size  # read each once, write each once
    row.err = err
    row.add(ms, plain_ms, 8 * values, 2 * 1024 * (values // 64),
            library_ms=library_ms)
    row.extra["host"] = ("the card machine's host CPU: host ms by "
                         "time.perf_counter; bound_ms from the card's table "
                         "as for every row")
    ds = DCTDomainDataset(size=256, synthetic_length=4)
    native.COUNT.n = 0
    item = ds[0]
    launches = {"blockdct": native.COUNT.n}
    check(launches["blockdct"] == 2, f"DCT item: K25 launches {launches}")
    check(item["dct_y"].shape == (32, 32, 64)
          and item["dct_cb"].shape == (16, 16, 64)
          and all(np.isfinite(v).all() for v in item.values()),
          "DCT item shapes or values")
    trip = (item["dct_y"], item["dct_cb"], item["dct_cr"])
    r = random.Random(0)
    train = cvt.Compose([
        cvt.UpsampleCbCr(), cvt.SubsetDCT2(channels=24),
        cvt.RandomResizedCropDCT(size=224, rng=r), cvt.Aggregate2(),
        cvt.RandomHorizontalFlip(rng=r), cvt.ToTensorDCT2(),
        cvt.NormalizeDCT(np.zeros(192), np.ones(192), channels=24)])
    val = cvt.Compose([
        cvt.UpsampleCbCr(), cvt.SubsetDCT2(channels=24),
        cvt.Resize(28), cvt.CenterCropDCT(size=224), cvt.Aggregate2(),
        cvt.ToTensorDCT2(),
        cvt.NormalizeDCT(np.zeros(192), np.ones(192), channels=24)])
    for name, tf in (("train", train), ("val", val)):
        t = tf(trip)
        check(t.shape == (24, 28, 28) and np.isfinite(t).all(),
              f"cvtransforms {name}: {t.shape}")
    print(f"check blockdct (K25, host) 256² item: max_abs_err {err:.3g}; "
          f"ms {ms:.4f} plain {plain_ms:.4f} scipy {library_ms}; "
          f"DCTDomainDataset item K25 x2, train and val pipelines "
          f"(24, 28, 28) [{card}]")
    return {"dct_dataset_item": launches}


def lib_cases(g):
    """The library's ops and losses: (name, function, inputs, whether the
    inputs take a gradient)."""
    from vwfd_tpu_torch.attacks import gf_attack
    from vwfd_tpu_torch.attacks import stegastamp as steg
    from vwfd_tpu_torch.metrics import losses as L
    from vwfd_tpu_torch.ops import color, dwt, filters, morphology, resize
    from vwfd_tpu_torch.ops import warp

    def r(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    img, img2 = r(2, 32, 48, 3), r(2, 32, 48, 3)
    mask = (r(2, 32, 48, 1) > 0.5).float()
    u5, u42 = r(5), r(4, 2)
    uh, ub = r(2, 1, 1, 3), r(2, 1, 1, 1)
    logits, target = r(4, 10, lo=-3, hi=3), torch.tensor([1, 0, 9, 3])
    cases = [
        ("rgb_to_ycbcr_diffjpeg", color.rgb_to_ycbcr_diffjpeg,
         [img * 255], True),
        ("ycbcr_to_rgb_diffjpeg", color.ycbcr_to_rgb_diffjpeg,
         [img * 255], True),
        ("rgb_to_y_bt601", color.rgb_to_y_bt601, [img], True),
        ("avg_pool_2x2", filters.avg_pool_2x2, [img], True),
        ("median_5", lambda v: filters.median_blur(v, 5), [img], True),
        ("resize_lanczos_aa", lambda v: resize.resize(v, (13, 20),
                                                      "lanczos", True),
         [img], True),
        ("resize_bicubic_aa", lambda v: resize.resize_bicubic(
            v, (13, 20), antialias=True), [img], True),
        ("dwt", dwt.dwt, [img], True),
        ("iwt", dwt.iwt, [r(2, 16, 24, 12)], True),
        ("dilate", lambda m: morphology.dilate(m, 2), [mask], False),
        ("erode", lambda m: morphology.erode(m, 2), [mask], False),
        ("closing", morphology.closing, [mask], False),
        ("opening", morphology.opening, [mask], False),
        ("blur_kernel", steg.random_blur_kernel, [u5], False),
        ("apply_blur_kernel", lambda v, u: steg.apply_blur_kernel(
            v, steg.random_blur_kernel(u)), [img, u5], True),
        ("perspective", steg.random_perspective, [img, u42], True),
        ("brightness_hue", steg.random_brightness_hue, [img, uh, ub],
         True),
        ("gf_attack", gf_attack, [img], True),
        ("smooth_l1", L.smooth_l1, [img, img2], True),
        ("reconstruction_loss", L.reconstruction_loss, [img, img2], True),
        ("ssim_loss_map", L.ssim_loss_map, [img, img2], True),
        ("exclusion_loss", L.exclusion_loss, [img, img2], True),
        ("gradient_loss", L.gradient_loss, [img], True),
        ("grayscale_loss", L.grayscale_loss, [img, img2], True),
        ("extended_l1_loss", L.extended_l1_loss, [img, img2, mask], True),
        ("non_blurry_loss", L.non_blurry_loss, [img], True),
        ("std_loss", L.std_loss, [img], True),
        ("dice_loss", L.dice_loss, [img, (img2 > 0.5).float()], True),
        ("cw_loss", lambda v, t: L.cw_loss(v, t, False, 10, 0.5),
         [logits, target], False),
    ]
    for interp in ("bilinear", "nearest"):
        for pad in ("zeros", "border"):
            cases.append((f"flow_warp_{interp}_{pad}",
                          lambda v, f, i=interp, p=pad: warp.flow_warp(
                              v, f, i, p), [img, r(2, 32, 48, 2, lo=-3,
                                                   hi=3)], True))
    return cases


def run_library_ops(card):
    """(d) Each library op and loss on the card against the same function
    on the CPU (TF32 off), forward and input gradients within ``LIB_RTOL``
    of their scale; ``gradient_penalty`` on a discriminator (dim 8) with
    the same weights on both."""
    from vwfd_tpu_torch.metrics import losses as L
    from vwfd_tpu_torch.nets.discriminator import Discriminator
    g = torch.Generator().manual_seed(211)
    worst = {}
    for name, fn, ins, diff in lib_cases(g):
        outs = []
        for dev in ("cpu", "cuda"):
            xs = [t.to(dev).clone() for t in ins]
            needs = [diff and t.is_floating_point() for t in xs]
            if any(needs):
                xs = [t.requires_grad_(True) if n else t
                      for t, n in zip(xs, needs)]
            y = fn(*xs)
            # (a nearest warp's flow reaches the output through indices
            # alone: no gradient, compared as zeros)
            grads = (torch.autograd.grad(
                y, [t for t in xs if t.requires_grad],
                torch.ones_like(y) if y.dim() else None, allow_unused=True)
                if any(needs) else [])
            outs.append([y.detach().cpu()] + [
                torch.zeros(()) if t is None else t.cpu() for t in grads])
        err = 0.0
        for a, b in zip(*outs):
            scale = float(a.abs().max()) or 1.0
            e = float((a.float() - b.float()).abs().max()) / scale
            check(e <= LIB_RTOL, f"library op {name} on the card: {e:.3g}")
            err = max(err, e)
        worst[name] = err
    net = Discriminator(dim=8, use_sigmoid=False, use_spectral_norm=False)
    net.init_params(torch.Generator().manual_seed(212))
    real, fake = torch.rand(2, 32, 32, 3, generator=g), \
        torch.rand(2, 32, 32, 3, generator=g)
    eps = torch.rand(2, 1, 1, 1, generator=g)
    pens = []
    for dev in ("cpu", "cuda"):
        d = net.to(dev)
        pens.append(float(L.gradient_penalty(d, eps.to(dev), real.to(dev),
                                             fake.to(dev)).detach()))
    net.cpu()
    e = abs(pens[0] - pens[1]) / max(abs(pens[0]), 1e-12)
    check(e <= LIB_RTOL, f"gradient_penalty on the card: {e:.3g}")
    worst["gradient_penalty"] = e
    print(f"check library ops on the card vs the CPU (of scale): "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})} "
          f"[{card}]")


def run_library(rows, card):
    """Phase 21: (a) K24 and K5's 4:2:0 mode, (b) the study, (c) K25 and
    the DCT-domain data, (d) the library on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_diffjpeg(rows, card)
    t1 = time.perf_counter()
    launches = run_study_phase(rows, card)
    t2 = time.perf_counter()
    launches.update(run_dct_data(rows, card))
    run_library_ops(card)
    print(f"phase 21: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c)+(d) "
          f"{time.perf_counter() - t2:.1f} s")
    return launches


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-child":
        return dp_child(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--dpf-child":
        return dpf_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        sys.exit(2)
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    _lib.load()
    built = ("already built" if _lib.build_seconds is None
             else f"nvcc {_lib.build_seconds:.1f} s")
    print(f"build: {_lib.library_path().name} loaded in "
          f"{time.perf_counter() - t0:.1f} s ({built})")

    rows = {n: Row(n) for n in KERNEL_SOURCES}
    t_phase = time.perf_counter()
    check_transition(rows, card)
    check_coupling(rows, card)
    check_wire(rows, card)
    check_mask(rows, card)
    check_jpeg(rows, card)
    check_median(rows, card)
    check_f1(rows, card)
    check_ssim(rows, card)
    check_mix(rows, card)
    check_splice(rows, card)
    check_qconv(rows, card)
    check_qconv_t(rows, card)
    check_qcoupling(rows, card)
    check_int8_build(card)
    check_stem(rows, card)
    check_haar(rows, card)
    check_affine(rows, card)
    check_down_num_4(rows, card)
    check_zigzag(rows, card)
    check_crop_resize(rows, card)
    check_hidden_build(card)
    check_jpeg_basic(rows, card)
    check_window_attention(rows, card)
    check_canny(rows, card)
    check_image_inn_shapes(card)
    check_crop_cubic(rows, card)
    check_rectify(rows, card)
    check_ssim_grad(rows, card)
    t_film = time.perf_counter()
    check_film(rows, card)
    print(f"phase 3: {time.perf_counter() - t_phase:.1f} s, of it K23's "
          f"checks {time.perf_counter() - t_film:.1f} s")
    errs = {n: r.err for n, r in rows.items()}
    print(f"kernels max_abs_err (bf16 vs plain): {json.dumps(errs)}")

    server, plain, clips, launches = run_slice(card)
    run_timing(server, plain, clips, card)
    del server, plain
    train_launches = run_train(card)
    eval_launches = run_eval(card)
    run_trainer(card)
    int8_launches = run_int8(card)
    conv_launches = run_convergence_phase(card)
    ref_launches = run_refshape(card)
    hid_launches = run_hidden(card)
    mbrs_launches = run_mbrs(card)
    serve_launches = run_serving_remainder(card)
    tc_launches = run_tianchi(card)
    img_launches = run_image(card)
    clr_launches = run_clr(card)
    t_phase = time.perf_counter()
    kd_launches = run_kdjpeg(card)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s; script so far "
          f"{time.perf_counter() - t0:.1f} s")
    t_phase = time.perf_counter()
    dp_launches = run_parallel(card)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s; script so far "
          f"{time.perf_counter() - t0:.1f} s")
    t_phase = time.perf_counter()
    dpf_launches = run_parallel_families(card)
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s; script so far "
          f"{time.perf_counter() - t0:.1f} s")
    t_phase = time.perf_counter()
    lib_launches = run_library(rows, card)
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s; script so far "
          f"{time.perf_counter() - t0:.1f} s")

    by_path = {"roundtrip": launches, "train_step": train_launches,
               "eval_step": eval_launches, **int8_launches,
               **conv_launches, **ref_launches, **hid_launches,
               **mbrs_launches, **serve_launches, **tc_launches,
               **img_launches, **clr_launches, **kd_launches,
               **dp_launches, **dpf_launches, **lib_launches}
    print(json.dumps({"kernels": [rows[n].json(by_path)
                                  for n in KERNEL_SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
