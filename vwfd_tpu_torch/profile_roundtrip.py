"""Where the serving roundtrip's or detect's, the train step's or the eval
step's time goes on the card.

    FLAG="--subnet res_tpu2 --extractor unet_tpu --haar conv --packed \
          --econvs 2,2,1,1,1"
    python -m vwfd_tpu_torch.profile_roundtrip $FLAG [--requests 10] \
        [--trace PATH]
    python -m vwfd_tpu_torch.profile_roundtrip $FLAG --mode detect [--int8]
    python -m vwfd_tpu_torch.profile_roundtrip $FLAG --mode train \
        [--requests 5]
    python -m vwfd_tpu_torch.profile_roundtrip $FLAG --mode eval
    python -m vwfd_tpu_torch.profile_roundtrip $FLAG --int8 [--int8-embed]
    # the reference shapes (the runner's defaults), training at batch 8
    python -m vwfd_tpu_torch.profile_roundtrip [--mode train --batch 8]
    # HiDDeN's train step (message 30, 64 channels, 128², f32)
    python -m vwfd_tpu_torch.profile_roundtrip --mode hidden --batch 8
    # MBRS's train step (message 30, 64 channels, 4 SE blocks, 128², f32)
    python -m vwfd_tpu_torch.profile_roundtrip --mode mbrs
    # Tianchi's train step, then its eval step (SUNet, 256², b8, f32)
    python -m vwfd_tpu_torch.profile_roundtrip --mode tianchi
    python -m vwfd_tpu_torch.profile_roundtrip --mode pami
    python -m vwfd_tpu_torch.profile_roundtrip --mode clr
    # KD-JPEG's train step (FBCNN, the QF classifier, the discriminator)
    python -m vwfd_tpu_torch.profile_roundtrip --mode kdjpeg

The model options are the convergence runner's
(``run_convergence.model_options``, the JAX runner's names and defaults:
without them the reference shapes), at batch 16 unless ``--batch`` says
otherwise (T=4, 256², bf16; random weights from a seed). ``--mode
roundtrip`` (the default) serves the roundtrip; ``--mode detect`` serves
the detect alone; ``--mode train`` runs ``train_step`` and ``--mode eval``
``eval_step`` on synthetic batches; ``--mode hidden`` runs the HiDDeN
family's ``train_step`` (``models/hidden_model.py``, the published widths,
128², float32, continue_hidden's weighted pool; the video model options
do not apply) on synthetic images, ``--mode mbrs`` the MBRS family's
(``models/mbrs_model.py``, the published widths, 128², float32, the
noise draws of ``MBRSSampler``) on the runner's synthetic images, and
``--mode tianchi`` the Tianchi family's ``train_step`` and then its
``eval_step`` (``models/tianchi_model.py``, SUNet at the published widths,
the port's ``configs/tianchi.yaml``, 256², batch 8 unless ``--batch``,
float32, the JPEG draws of ``TianchiSampler``) on the runner's splice
forgeries, one JSON line each; ``--mode pami`` the image family's PAMI
``train_step`` and then its ``eval_step`` (``models/image_model.py``, the
port's ``configs/pami.yaml``: the 4-channel INN in bf16, k = 6, 256²,
batch 8 unless ``--batch``, ``--size``; random weights from a seed, the
draws of ``ImageSampler``) on the runner's synthetic images with their
host canny maps and stroke masks, one JSON line each; ``--mode clr`` the
same for CLR (the port's ``configs/clr.yaml``: the crop tamper, the apex
regressor, the rectified reverse, the SSIM term); ``--mode kdjpeg`` the
KD-JPEG family's ``train_step`` (``models/kdjpeg_model.py`` at the
published widths, the port's ``configs/kdjpeg.yaml``: 256², six images a
clean source, batch 6 unless ``--batch``, float32, ``aux_ramp`` 1) on
``LQJpegDataset``'s synthetic items, one JSON line; ``--reverse-k`` bounds
their reversed copies (``--size 512 --batch 3 --reverse-k 3``: the JAX
records' geometry). ``--int8`` serves the roundtrip or the
detect through the int8 extractor and ``--int8-embed`` the roundtrip
through the int8 embed (calibrated on one seeded random clip, off the
clock). Each runs under
``torch.profiler`` after a warm-up, then prints one JSON line: the host
wall time per request (or step), the device time per request by kernel
class (the port's kernels, convolutions, GEMMs, BatchNorm, concatenations,
other elementwise work, copies (memcpy, memset), copy kernels (PyTorch's
permuted copies, casts and rolls)), the kernels of the GEMM class and the
twelve longest kernels by name, and the device's idle share over the
window (1 − device busy time / host wall time), and the device
operations per request counted from the profiler's events: kernels, and
memcpy / memset operations apart.
Needs the CUDA card; ``--trace`` also writes a Chrome trace.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data import Loader, SyntheticVideoDataset
from .models import VideoWatermarkModel
from .run_convergence import build_config, model_options
from .serving import WatermarkServer

# substrings of the port's kernel names (csrc/*.cu), by kernel
PORT_KERNELS = {"transition": ("transition_entry", "transition_p2p",
                               "transition_p2u"),
                "coupling_head": ("coupling_head",),
                "wire": ("wire_decode_rows", "wire_encode_rows",
                         "u8_to_channels", "channels_to_u8", "u8_to_s2d"),
                "mask_pack": ("mask_pack",),
                "jpeg_pair": ("jpeg_pair",), "median3": ("median3",),
                "f1_sweep": ("f1_sweep_counts",), "ssim": ("ssim_strips",),
                "attack_mix": ("attack_mix_fwd", "attack_mix_bwd"),
                "splice": ("splice_fwd", "splice_bwd"),
                "qconv": ("qconv_wgmma",), "qconv_t": ("qconv_t_wgmma",),
                "qcoupling_head": ("qcoupling_wgmma",),
                "haar": ("haar_kernel",),
                "coupling_affine": ("affine_fwd", "affine_bwd"),
                "zigzag_jpeg": ("zigzag_kernel",),
                "crop_resize": ("crop_resize_fwd", "crop_resize_bwd",
                                "crop_resize_taps"),
                "window_attention": ("window_attention_fwd",
                                     "window_attention_bwd"),
                "canny_soft": ("canny_max_kernel", "canny_map_kernel",
                               "canny_local_kernel", "canny_input_kernel"),
                "crop_cubic": ("crop_cubic_fwd_kernel",
                               "crop_cubic_bwd_kernel"),
                "rectify": ("rectify_kernel", "rectify_bwd_kernel"),
                "ssim_grad": ("ssim_grad_kernel",),
                "film_residual": ("film_fwd", "film_bwd"),
                "diffjpeg": ("diffjpeg_fwd", "diffjpeg_bwd")}


def classify(name: str) -> str:
    low = name.lower()
    for kernel, keys in PORT_KERNELS.items():
        if any(k in name for k in keys):
            return f"port:{kernel}"
    if "memcpy" in low or "memset" in low:
        return "copies"
    # PyTorch's copy kernels: permuted or strided copies to contiguous,
    # casts, torch.roll
    if "direct_copy_kernel" in low or "roll_cuda_kernel" in low:
        return "copy_kernels"
    if "catarray" in low:  # torch.cat
        return "concat"
    if "batch_norm" in low or "batchnorm" in low or "bn_" in low:
        return "batchnorm"
    # cuDNN's implicit-GEMM convolutions carry "gemm" in their names too
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                              "cudnn")):
        return "convolutions"
    if any(k in low for k in ("gemm", "cutlass", "cublas", "xmma")):
        return "gemm"
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 parents=[model_options()])
    ap.add_argument("--mode", default="roundtrip",
                    choices=["roundtrip", "detect", "train", "eval",
                             "hidden", "mbrs", "tianchi", "pami", "clr",
                             "kdjpeg"])
    ap.add_argument("--requests", type=int, default=10,
                    help="requests (or train or eval steps) in the window")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--int8", action="store_true",
                    help="roundtrip or detect through the int8 extractor")
    ap.add_argument("--int8-embed", action="store_true",
                    help="roundtrip through the int8 embed")
    ap.add_argument("--reverse-k", type=int, default=0,
                    help="pami, clr: attacked copies reversed (0: all)")
    ap.set_defaults(batch=None)
    args = ap.parse_args(argv)
    if args.batch is None:  # the families' batches; the video model's
        args.batch = {"tianchi": 8, "pami": 8, "clr": 8, "kdjpeg": 6}.get(
            args.mode, 16)

    cfg = build_config(args)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    if args.mode == "hidden":
        from .data import SyntheticImageDataset
        from .models import HiddenModel
        from .models.hidden_model import HiddenSampler
        t, s = 1, 128
        model = HiddenModel(image_size=s, encoder_loss_weight=1.0,
                            device=args.device)
        model.init_states(cfg.train.seed)
        ds = SyntheticImageDataset(size=s, length=4 * b, seed=10)
        rng = np.random.default_rng(10)
        batches = [model.to_device(
            np.stack([ds[i * b + j] for j in range(b)]),
            (rng.random((b, model.message_length)) > 0.5).astype(np.float32))
            for i in range(4)]
        sampler = HiddenSampler(cfg.train.seed, model.device,
                                [0.5, 2, 3, 1, 0.5, 1])
        step = [0]

        def one():
            step[0] += 1
            imgs, msgs = batches[step[0] % len(batches)]
            return model.train_step(imgs, msgs, sampler(imgs.shape))
    elif args.mode == "mbrs":
        from .data import SyntheticImageDataset
        from .models import MBRSModel
        from .models.mbrs_model import MBRSSampler
        t, s = 1, 128
        model = MBRSModel(image_size=s, device=args.device)
        model.init_states(0)
        ds = SyntheticImageDataset(size=s, length=4 * b, seed=10)
        rng = np.random.default_rng(10)
        batches = [model.to_device(
            np.stack([ds[i * b + j] for j in range(b)]),
            (rng.random((b, model.message_length)) > 0.5).astype(np.float32))
            for i in range(4)]
        sampler = MBRSSampler(0)
        step = [0]

        def one():
            step[0] += 1
            imgs, msgs = batches[step[0] % len(batches)]
            return model.train_step(imgs, msgs, sampler())
    elif args.mode == "tianchi":
        import dataclasses
        from . import TIANCHI_CONFIG, load_config
        from .data import SpliceForgeryDataset
        from .models import TianchiModel
        t = 1
        tcfg = load_config(TIANCHI_CONFIG)
        tcfg = dataclasses.replace(tcfg, data=dataclasses.replace(
            tcfg.data, gt_size=s, batch_size=b))
        model = TianchiModel(tcfg, device=args.device)
        model.init_states(0)
        ds = SpliceForgeryDataset(size=s, length=4 * b, seed=10)
        batches = [model.to_device(*(np.stack(x) for x in zip(
            *[ds[i * b + j] for j in range(b)]))) for i in range(4)]
        sampler = model.sampler(0)
        step = [0]

        def train_one():
            step[0] += 1
            imgs, masks = batches[step[0] % len(batches)]
            return model.train_step(imgs, masks, sampler())

        def eval_one():
            step[0] += 1
            return model.eval_step(*batches[step[0] % len(batches)])
    elif args.mode in ("pami", "clr"):
        import dataclasses
        from . import CLR_CONFIG, PAMI_CONFIG, load_config
        from .data import CannyImages, SyntheticImageDataset, stroke_masks
        from .models import ImageImmunizationModel
        from .models.image_model import ImageBatch
        t = 1
        pcfg = load_config(CLR_CONFIG if args.mode == "clr" else PAMI_CONFIG)
        pcfg = dataclasses.replace(pcfg, data=dataclasses.replace(
            pcfg.data, gt_size=s, batch_size=b))
        model = ImageImmunizationModel(pcfg, task=args.mode,
                                       reverse_k=args.reverse_k,
                                       device=args.device)
        model.init_states(0)
        ds = CannyImages(SyntheticImageDataset(size=s, length=5 * b,
                                               seed=10))
        batches = []
        for i in range(5):
            imgs, canny = (np.stack(x) for x in zip(
                *[ds[i * b + j] for j in range(b)]))
            batches.append(ImageBatch(*model.to_device(
                imgs, canny, stroke_masks((10, i), b, (s, s)))))
        sampler = model.sampler(0)
        step = [0]

        def train_one():
            step[0] += 1
            i = step[0] % len(batches)
            return model.train_step(batches[i], batches[i - 1].image,
                                    sampler((b, s, s)))

        def eval_one():
            step[0] += 1
            i = step[0] % len(batches)
            return model.eval_step(batches[i], batches[i - 1].image,
                                   sampler((b, s, s)))
    elif args.mode == "kdjpeg":
        import dataclasses
        from . import KDJPEG_CONFIG, load_config
        from .data import LQJpegDataset
        from .models import KDJpegModel
        t = 1
        kcfg = load_config(KDJPEG_CONFIG)
        kcfg = dataclasses.replace(kcfg, data=dataclasses.replace(
            kcfg.data, gt_size=s, batch_size=b))
        model = KDJpegModel(kcfg, size=s, device=args.device)
        model.init_states(0)
        items = max(1, b // model.qf_classes)
        ds = LQJpegDataset(size=s, synthetic_length=4 * items, seed=10)
        batches = [model.to_device(*KDJpegModel.collate(*(
            np.stack(x) for x in zip(*[ds[i * items + j]
                                       for j in range(items)]))))
            for i in range(4)]
        step = [0]

        def one():
            step[0] += 1
            return model.train_step(*batches[step[0] % len(batches)])
    elif args.mode in ("train", "eval"):
        model = VideoWatermarkModel(cfg, device=args.device)
        model.init_states(cfg.train.seed)
        loader = Loader(SyntheticVideoDataset(size=s, frames=t, length=4 * b),
                        b)
        batches = [model.to_device(v, m) for v, m in loader]
        step_fn = model.train_step if args.mode == "train" else \
            model.eval_step
        step = [0]

        def one():
            i = step[0] = step[0] + 1
            video, mask = batches[i % len(batches)]
            prev = batches[(i - 1) % len(batches)][0]
            return step_fn(video, mask, prev)
    else:
        clip = np.random.default_rng(0).integers(0, 256, (b, t, s, s, 3),
                                                 dtype=np.uint8)
        server = WatermarkServer(cfg, device=args.device, modes=(args.mode,),
                                 int8_extract=args.int8,
                                 int8_embed=args.int8_embed,
                                 int8_calib=clip)

        def one():  # every output, on the host
            r = server.serve(clip, args.mode)
            return [getattr(r, k) for k in r.keys()]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    head = {"card": card, "mode": args.mode, "subnet": args.subnet,
            "extractor": args.extractor, "haar": args.haar,
            "packed": args.packed, "int8": args.int8,
            "int8_embed": args.int8_embed, "requests": args.requests,
            "batch": b, "frames": t, "size": s,
            **({"reverse_k": args.reverse_k}
               if args.mode in ("pami", "clr") else {})}
    if args.mode in ("tianchi", "pami", "clr"):
        for what, fn in (("train_step", train_one), ("eval_step", eval_one)):
            print(json.dumps({**head, "step": what,
                              **profile_window(fn, args.requests,
                                               args.trace and
                                               f"{args.trace}.{what}")}))
        return
    print(json.dumps({**head, **profile_window(one, args.requests,
                                               args.trace)}))


def profile_window(one, n: int, trace=None) -> dict:
    """``one()`` 3 times to warm up, then ``n`` times under
    ``torch.profiler``: host wall time, device busy time and idle share,
    device time by kernel class and the longest kernels, per call."""
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace:
        prof.export_chrome_trace(trace)

    spans, by_name, memops = [], {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        memops += classify(e.name) == "copies"
    busy, end = 0.0, float("-inf")
    for a, z in sorted(spans):  # union of device intervals
        if z > end:
            busy += z - max(a, end)
            end = z
    by_class = {}
    for name, us in by_name.items():
        c = classify(name)
        by_class[c] = by_class.get(c, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms_per_request": wall_us / n / 1e3,
        "device_busy_ms_per_request": busy / n / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_kernels_per_request": (len(spans) - memops) / n,
        "device_memcpy_memset_per_request": memops / n,
        "device_ms_per_request_by_class": {
            k: v / n / 1e3 for k, v in sorted(by_class.items(),
                                               key=lambda kv: -kv[1])},
        "gemm_kernels_ms_per_request": {
            k[:90]: v / n / 1e3 for k, v in by_name.items()
            if classify(k) == "gemm"},
        "top_kernels_ms_per_request": {k[:90]: v / n / 1e3 for k, v in top},
    }


if __name__ == "__main__":
    main()
