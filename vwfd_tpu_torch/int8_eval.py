"""Quality gate of the int8 post-training-quantized extractor, and with
``--int8-embed`` of the int8 embed, on a trained flagship checkpoint (port
of tools/exp_int8_eval.py:24-209).

    python -m vwfd_tpu_torch.run_convergence --steps 10000 ... \\
        --ckpt-dir build/conv_ckpt
    python -m vwfd_tpu_torch.int8_eval --subnet res_tpu2 --extractor \\
        unet_tpu --haar conv --packed --econvs 2,2,1,1,1 \\
        --ckpt-dir build/conv_ckpt [--int8-embed]

Restores the nets of the latest checkpoint in ``--ckpt-dir``
(``models.state.load_nets``: a full checkpoint or ``save_nets``'s), then,
as the JAX script:

1. calibrates the int8 UNet (``nets/unet_int8.py``) on ``--calib-batches``
   batches of ATTACKED traffic, what the extractor sees: embed, splice with
   the previous batch, the attack pool, clip to [0, 1];
2. with ``--int8-embed``, calibrates the int8 INN (``nets/inn_int8.py``)
   on ``--calib-batches`` clean clips;
3. on ``--eval-batches`` fresh batches, runs the same attacked clip
   through the bf16 extractor and the int8 one: best F1 of each (sweep
   0.1–0.9), the forward PSNR and the mean |Δprob|; with ``--int8-embed``
   also the int8 embed: its PSNR beside the bf16 embed's, the PSNR between
   the two, and the F1 of the int8-embedded clip, attacked with the same
   draws, through each extractor.

It prints the JAX script's lines: one per batch, then the means. Clips and
attack draws are the runner's ``Streams`` on the gate's own streams, each
batch a function of its index alone. The model options are the runner's
(``run_convergence.model_options``), with the JAX runner's defaults, the
reference shapes, where the int8 paths raise as the JAX package's do (the
int8 extractor needs ``UNetTPU``, the int8 embed the packed INN): pass the
flagship's options, as above. On the card everything runs through the
port's kernels: K1 and K2 (embed), K10 (splice), K5, K6 and K9 (attack
pool), K7 (F1 sweep), K11 and K12 (int8 UNet), and with ``--int8-embed``
K11 and K13 (int8 INN). Runs on the CUDA card unless ``--device cpu``; without a card
it raises.
"""

import argparse
from typing import Dict, Iterable

import numpy as np
import torch

from .attacks import AttackDraws, attack_pool_video
from .device import resolve_device
from .metrics import f1_sweep, psnr255_int
from .models import VideoWatermarkModel
from .models.state import latest_step, load_nets
from .models.video_model import _to_channels
from .nets import inn_int8, unet_int8
from .run_convergence import SEED, Streams, build_config, model_options
from .serving import check_int8

__all__ = ["attacked", "quantize_extract", "quantize_embed", "eval_both",
           "eval_embed", "parse_args", "main"]

# the gate's streams of clips (the JAX script's keys) and of their attack
# draws (the ids that drew the committed gate records)
CALIB, EMBED_CALIB, EVAL = 123, 321, 999
CALIB_DRAWS, EVAL_DRAWS = CALIB + (1 << 20), EVAL + (1 << 20)


def attacked(model: VideoWatermarkModel, video, mask, prev,
             draws: AttackDraws):
    """``(clip(attack_pool(embed(video)·(1 − mask) + prev·mask), 0, 1),
    embed(video))``: the extractor's traffic and the watermarked clip."""
    fwd, spliced = model._embed_splice(video, mask, prev)
    att = attack_pool_video(spliced, draws.to(model.device),
                            model.attack_ratios, model.kernels,
                            epilogue="clamp")
    return att, fwd


def quantize_extract(model: VideoWatermarkModel, batches: Iterable,
                     margin: float = 1.0) -> Dict:
    """The int8 UNet tree calibrated on ``batches`` ((N, H, W, 3) frames)."""
    scales = unet_int8.calibrate(model.unet, batches, margin)
    return unet_int8.quantize(model.unet, scales, model.device)


def quantize_embed(model: VideoWatermarkModel, clips: Iterable,
                   margin: float = 1.0) -> Dict:
    """The int8 INN tree calibrated on clean ``clips`` (B, T, H, W, 3)."""
    batches = [_to_channels(torch.as_tensor(v).float()) for v in clips]
    scales = inn_int8.calibrate(model.inn, batches, margin, model.kernels)
    return inn_int8.quantize(model.inn, scales, model.device)


def _predict_int8(model, qp, att):
    b, t, h, w, c = att.shape
    p = unet_int8.apply_int8(qp, att.reshape(b * t, h, w, c),
                             model.unet.s2d, kernels=model.kernels)
    return p.reshape(b, t, h, w, -1)


def _best_f1(model, pred, mask):
    return torch.max(f1_sweep(pred, mask, kernels=model.kernels)[1])


@torch.no_grad()
def eval_both(model: VideoWatermarkModel, qp: Dict, video, mask, prev,
              draws: AttackDraws):
    """``(F1 bf16, F1 int8, PF, mean |Δprob|)``, 0-dim tensors: the same
    attacked clip through the model's extractor and the int8 tree ``qp``."""
    video, mask, prev = model.to_device(video, mask, prev)
    att, fwd = attacked(model, video, mask, prev, draws)
    p_bf = model.predict_mask(att)
    p_i8 = _predict_int8(model, qp, att)
    return (_best_f1(model, p_bf, mask), _best_f1(model, p_i8, mask),
            psnr255_int(video, fwd), torch.mean(torch.abs(p_i8 - p_bf)))


@torch.no_grad()
def eval_embed(model: VideoWatermarkModel, qp: Dict, qemb: Dict, video,
               mask, prev, draws: AttackDraws):
    """``(PF bf16 embed, PF int8 embed, PSNR(int8 vs bf16 embed), F1 of the
    int8-embedded clip through the bf16 extractor, through the int8
    one)``, 0-dim tensors; the attack takes ``draws``."""
    video, mask, prev = model.to_device(video, mask, prev)
    t = video.shape[1]
    fwd_bf = model.embed(video)
    dt = model.compute_dtype
    y = inn_int8.forward_int8(
        qemb, _to_channels(video.to(dt)), channels=3 * t,
        down_num=model.inn.down_num,
        dtype=None if dt == torch.float32 else dt, out_f32=False,
        kernels=model.kernels)
    fwd_i8, spliced = model.kernels.splice(y, t, mask, prev)
    att = attack_pool_video(spliced, draws.to(model.device),
                            model.attack_ratios, model.kernels,
                            epilogue="clamp")
    return (psnr255_int(video, fwd_bf), psnr255_int(video, fwd_i8),
            psnr255_int(fwd_bf, fwd_i8),
            _best_f1(model, model.predict_mask(att), mask),
            _best_f1(model, _predict_int8(model, qp, att), mask))


def _batches(streams: Streams, clips: int, draws: int, n: int):
    """``(i, video, mask, prev, draws)`` of ``n`` batches of the ``clips``
    stream with attack draws from ``draws``, batch ``i`` spliced with batch
    ``i − 1`` (batch 0 only seeds it)."""
    prev = streams.clips(0, clips)[0]
    for i in range(1, n + 1):
        video, mask = streams.clips(i, clips)
        yield i, video, mask, prev, streams.draws(i, draws)
        prev = video


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 parents=[model_options()])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--eval-batches", type=int, default=16)
    ap.add_argument("--margin", type=float, default=1.0,
                    help="calibration amax head-room multiplier")
    ap.add_argument("--int8-embed", action="store_true",
                    help="also gate the int8 PTQ embed (nets/inn_int8.py)")
    args = ap.parse_args(argv)
    if min(args.calib_batches, args.eval_batches) < 1:
        ap.error("--calib-batches and --eval-batches take at least 1")
    return args


def main(argv=None) -> Dict[str, float]:
    """Runs the gate; returns the means printed last."""
    args = parse_args(argv)
    cfg = build_config(args)
    check_int8(cfg.model, True, args.int8_embed)
    model = VideoWatermarkModel(cfg, device=resolve_device(args.device))
    at = latest_step(args.ckpt_dir)
    if at is None:
        raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
    model.load_states(load_nets(args.ckpt_dir, at))
    streams = Streams(model, SEED)
    name = (torch.cuda.get_device_name(model.device)
            if model.device.type == "cuda" else "cpu")
    print(f"restored step {at} from {args.ckpt_dir} [{name}]")

    # calibrate on attacked traffic (what the extractor actually sees)
    with torch.no_grad():
        calib = [attacked(model, v, m, p, d)[0].reshape(
            -1, *v.shape[2:]) for _, v, m, p, d in
            _batches(streams, CALIB, CALIB_DRAWS, args.calib_batches)]
    qp = quantize_extract(model, calib, args.margin)
    del calib
    qemb = None
    if args.int8_embed:
        clips = [streams.clips(i, EMBED_CALIB)[0]
                 for i in range(args.calib_batches)]
        qemb = quantize_embed(model, clips, args.margin)

    rows, rows_e = [], []
    for i, video, mask, prev, draws in _batches(streams, EVAL, EVAL_DRAWS,
                                                args.eval_batches):
        f_bf, f_i8, pf, dm = (float(x) for x in
                              eval_both(model, qp, video, mask, prev, draws))
        rows.append((f_bf, f_i8, pf, dm))
        print(f"batch {i}: F1 bf16 {f_bf:.4f}  int8 {f_i8:.4f}  "
              f"Δprob {dm:.4f}  PF {pf:.2f}")
        if qemb is not None:
            pf_bf, pf_i8, pfx, fe_bf, fe_i8 = (float(x) for x in eval_embed(
                model, qp, qemb, video, mask, prev, draws))
            rows_e.append((pf_bf, pf_i8, pfx, fe_bf, fe_i8))
            print(f"  embed-int8: PF bf16 {pf_bf:.2f}  int8 {pf_i8:.2f}  "
                  f"PSNR(i8,bf16) {pfx:.2f}  "
                  f"F1 e8→x-bf16 {fe_bf:.4f}  e8→x-int8 {fe_i8:.4f}")
    a = np.array(rows).mean(0)
    out = {"f1_bf16": a[0], "f1_int8": a[1], "delta_f1": a[1] - a[0],
           "pf": a[2], "mean_abs_dprob": a[3]}
    print(f"\nmean over {len(rows)} batches: "
          f"F1 bf16 {a[0]:.4f}  int8 {a[1]:.4f}  "
          f"ΔF1 {a[1] - a[0]:+.4f}  mean|Δprob| {a[3]:.4f}")
    if rows_e:
        e = np.array(rows_e).mean(0)
        out.update(pf_bf16_embed=e[0], pf_int8_embed=e[1],
                   delta_pf=e[1] - e[0], psnr_int8_vs_bf16_embed=e[2],
                   f1_int8_embed_bf16_extract=e[3],
                   f1_int8_embed_int8_extract=e[4])
        print(f"embed-int8 mean: PF bf16 {e[0]:.2f} dB  "
              f"int8 {e[1]:.2f} dB  "
              f"ΔPF {e[1] - e[0]:+.2f} dB  "
              f"PSNR(i8 vs bf16 embed) {e[2]:.2f} dB  "
              f"F1 (int8 embed → bf16 extract) {e[3]:.4f}  "
              f"(→ int8 extract) {e[4]:.4f}  "
              f"[bf16-embed F1 baseline {a[0]:.4f}]")
    return {k: float(v) for k, v in out.items()}


if __name__ == "__main__":
    main()
