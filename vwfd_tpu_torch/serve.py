"""Serving CLI of the port (counterpart of scripts/serve_video.py).

    python -m vwfd_tpu_torch.serve --mode roundtrip --synthetic 32
    python -m vwfd_tpu_torch.serve --mode roundtrip --latency 50
    python -m vwfd_tpu_torch.serve --mode roundtrip --stream 32
    python -m vwfd_tpu_torch.serve --mode embed --root data/clips \\
        --ckpt-dir checkpoints/video --out served/
    python -m vwfd_tpu_torch.serve --mode detect --root served/ --out masks/
    python -m vwfd_tpu_torch.serve --mode detect --synthetic 8 --device cpu \\
        --batch 2 --size 64
    python -m vwfd_tpu_torch.serve --mode roundtrip --synthetic 32 --int8 \\
        --int8-embed
    python -m vwfd_tpu_torch.serve --mode roundtrip --synthetic 8 --s2d 4

Serves uint8 clips through ``WatermarkServer`` with the weights of a
checkpoint directory (``--ckpt-dir``, its latest step or ``--step``), of a
``--weights`` file, or random ones:

* ``--root DIR`` serves a media folder (the DAVIS directory protocol:
  ``<root>/<clip>/<frame>.png``; ``iter_disk_clips``, the script's
  ``_iter_disk_clips``, :35-57): each run of T consecutive frames of a clip
  directory (sorted paths; files that are not images or do not decode
  skipped) is one request, the frames BGR→RGB and resized bilinearly to
  the serving size; requests are grouped into server batches (``batched``,
  ``:68-79``; the last stays short: the server pads it and trims the
  outputs). With ``--out DIR`` it writes ``{name}_f{t}.png`` (embed, and
  roundtrip's watermarked frames) and ``{name}_f{t}_mask.png`` (detect,
  roundtrip), the request's name with ``/`` as ``_``, and for detect and
  roundtrip ``verdicts.json``, each request row's tamper fraction under
  ``"{name}#{row in its batch}"``. It prints the script's summary line.
  Images are read and written through OpenCV unless the caller of
  ``main`` passes ``read_image(path, size)`` (uint8 RGB (size, size, 3) or
  None) and ``write_image(path, array)`` (uint8 RGB (H, W, 3) or gray
  (H, W, 1));
* ``--synthetic N`` serves N synthetic request batches and prints clips and
  frames per second over the stream, ``--latency N`` N synchronous
  requests and their latency percentiles;
* ``--stream N`` (``:172-207``): ``min(N, 8)`` distinct clips from
  ``default_rng(0)``, one warm-up pass at window 2, then N request batches
  at windows 1, 2 and 4, every output read back to the host before the
  clock stops, one JSON line a window with the script's keys.

``--s2d`` overrides ``model.extractor_s2d`` (4: the coarse-mask serving
point). ``--int8`` serves detect / roundtrip through the int8 PTQ
extractor and ``--int8-embed`` embed / roundtrip through the int8 PTQ
INN, both self-calibrated at start-up. Runs on the CUDA card unless
``--device cpu``. Not ported: ``--export-dir`` (AOT export, ROADMAP.md §1).
"""

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import FLAGSHIP_CONFIG, load_config
from .serving import WatermarkServer

__all__ = ["iter_disk_clips", "batched", "serve_folder", "cv2_io", "main"]

IMAGE_EXT = (".png", ".jpg", ".jpeg", ".bmp")
Reader = Callable[[str, int], Optional[np.ndarray]]
Writer = Callable[[str, np.ndarray], None]


def cv2_io() -> Tuple[Reader, Writer]:
    """``(read_image, write_image)`` through OpenCV, as the script reads and
    writes: ``cv2.imread`` (None where it does not decode), BGR→RGB,
    ``cv2.resize`` (bilinear) to size²; ``cv2.imwrite`` of RGB as BGR, of a
    one-channel mask as it is. OpenCV is imported here: without it this
    raises an ``ImportError`` that names it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("serving a media folder reads and writes images "
                          "through OpenCV (cv2), and it does not import "
                          "here; pass read_image and write_image") from e

    def read_image(path, size):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            return None
        return cv2.resize(img[:, :, ::-1], (size, size))

    def write_image(path, arr):
        cv2.imwrite(path, arr[:, :, ::-1] if arr.shape[-1] == 3 else arr)

    return read_image, write_image


def iter_disk_clips(root: str, frames: int, size: int, read_image: Reader
                    ) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ``(name, uint8 (1, T, size, size, 3))`` per T consecutive
    frames of each clip directory of ``root``, one request a window."""
    for clip in sorted(os.listdir(root)):
        cdir = os.path.join(root, clip)
        if not os.path.isdir(cdir):
            continue
        paths = sorted(p for p in os.listdir(cdir)
                       if p.lower().endswith(IMAGE_EXT))
        window = []
        for p in paths:
            img = read_image(os.path.join(cdir, p), size)
            if img is None:
                continue
            window.append((os.path.splitext(p)[0], img))
            if len(window) == frames:
                names = [n for n, _ in window]
                arr = np.stack([im for _, im in window])[None]
                yield f"{clip}/{names[0]}..{names[-1]}", arr.astype(np.uint8)
                window = []


def batched(reqs: Iterable[Tuple[str, np.ndarray]], batch: int
            ) -> Iterator[Tuple[List[str], np.ndarray]]:
    """Group per-clip requests into server batches (the tail stays short)."""
    names, rows = [], []
    for name, arr in reqs:
        for row in arr:
            names.append(name)
            rows.append(row)
        while len(rows) >= batch:
            yield names[:batch], np.stack(rows[:batch])
            names, rows = names[batch:], rows[batch:]
    if rows:
        yield names, np.stack(rows)


def serve_folder(server: WatermarkServer, root: str, mode: str,
                 out: Optional[str], window: int, read_image: Reader,
                 write_image: Optional[Writer]) -> dict:
    """Serve every request of ``root`` (``iter_disk_clips`` → ``batched``)
    through ``server.serve_stream``; with ``out``, write the script's
    frames, masks and ``verdicts.json`` there. Returns the clip and frame
    counts and the wall time."""
    frames, size = server.frames, server.size
    if out:
        os.makedirs(out, exist_ok=True)
    n_frames = n_clips = 0
    verdicts = {}
    t1 = time.time()
    batches = list(batched(iter_disk_clips(root, frames, size, read_image),
                           server.batch))
    results = server.serve_stream((arr for _, arr in batches), mode,
                                  window=window)
    for (names, _), res in zip(batches, results):
        n_clips += res.n
        n_frames += res.n * frames
        wm = res.watermarked if mode == "embed" or (
            out and mode == "roundtrip") else None
        mask = None
        if mode in ("detect", "roundtrip"):
            mask = res.mask  # unpacked from the 1-bit wire format
            frac = res.tamper_fraction
            for i, name in enumerate(names[: res.n]):
                verdicts[f"{name}#{i}"] = float(frac[i])
        if out:
            for i, name in enumerate(names[: res.n]):
                safe = name.replace("/", "_")
                for t in range(frames):
                    if wm is not None:
                        write_image(os.path.join(out, f"{safe}_f{t}.png"),
                                    wm[i, t])
                    if mask is not None:
                        write_image(os.path.join(
                            out, f"{safe}_f{t}_mask.png"), mask[i, t])
    wall = time.time() - t1
    if out and verdicts:
        with open(os.path.join(out, "verdicts.json"), "w") as f:
            json.dump(verdicts, f, indent=1, sort_keys=True)
    return {"clips": n_clips, "frames": n_frames, "wall_s": wall}


def _materialize(res):
    for k in res.keys():
        getattr(res, "mask" if k == "mask_bits" else k)


def _stream(server, mode, n, int8, info):
    """The script's ``--stream``: one JSON line per window 1, 2, 4."""
    rng = np.random.default_rng(0)
    b, t, s = server.batch, server.frames, server.size
    clips = [(rng.random((b, t, s, s, 3)) * 255).astype(np.uint8)
             for _ in range(min(n, 8))]

    def reqs():
        for i in range(n):
            yield clips[i % len(clips)]
    for res in server.serve_stream(iter(clips), mode, window=2):
        _materialize(res)  # warm-up
    for window in (1, 2, 4):
        t0 = time.perf_counter()
        done = 0
        for res in server.serve_stream(reqs(), mode, window=window):
            _materialize(res)
            done += res.n
        wall = time.perf_counter() - t0
        print(json.dumps({
            "mode": mode, "window": window, "requests": n, "clips": done,
            "batch": b, "frames": t, "size": s, "int8": bool(int8),
            "wall_s": wall, "clips_per_s": done / wall,
            "frames_per_s": done * t / wall, **info}))


def main(argv=None, read_image: Optional[Reader] = None,
         write_image: Optional[Writer] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="roundtrip",
                    choices=["embed", "detect", "roundtrip"])
    ap.add_argument("--root", default=None,
                    help="clip root (<root>/<clip>/<frame>.png)")
    ap.add_argument("--out", default=None,
                    help="with --root: output dir (embed: frames; detect: "
                         "masks + verdicts.json)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="serve N synthetic request batches")
    ap.add_argument("--latency", type=int, default=0,
                    help="serve N synchronous requests; report p50/p95/p99")
    ap.add_argument("--stream", type=int, default=0,
                    help="push N request batches at in-flight windows 1, 2 "
                         "and 4; report clips/s and frames/s per window")
    ap.add_argument("--config", default=None,
                    help="YAML config (defaults to the packaged video.yaml)")
    ap.add_argument("--weights", default=None,
                    help="weights file written by serving.save_weights")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (models/state.py layout)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: the latest)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--window", type=int, default=2,
                    help="in-flight request window (double-buffer = 2)")
    ap.add_argument("--s2d", type=int, default=None,
                    help="model.extractor_s2d override (4: the coarse-mask "
                         "serving point)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--int8", action="store_true",
                    help="detect/roundtrip through the int8 PTQ extractor "
                         "(nets/unet_int8.py)")
    ap.add_argument("--int8-embed", action="store_true",
                    help="embed/roundtrip through the int8 PTQ INN "
                         "(nets/inn_int8.py)")
    ap.add_argument("--int8-margin", type=float, default=1.0,
                    help="calibration amax head-room multiplier")
    args = ap.parse_args(argv)
    if not (args.synthetic or args.latency or args.stream or args.root):
        ap.error("need --root, --synthetic N, --latency N or --stream N")
    if args.root and (read_image is None or (args.out and write_image is None)):
        try:
            r, w = cv2_io()
        except ImportError as e:
            ap.error(str(e))
        read_image, write_image = read_image or r, write_image or w

    cfg = load_config(args.config or FLAGSHIP_CONFIG)
    data = dict(batch_size=args.batch or cfg.data.batch_size,
                frames=args.frames or cfg.data.frames,
                gt_size=args.size or cfg.data.gt_size)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))
    if args.s2d:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, extractor_s2d=args.s2d))
    t0 = time.perf_counter()
    server = WatermarkServer(cfg, device=args.device, weights=args.weights,
                             modes=(args.mode,), threshold=args.threshold,
                             ckpt_dir=args.ckpt_dir, step=args.step,
                             int8_extract=args.int8,
                             int8_embed=args.int8_embed,
                             int8_margin=args.int8_margin)
    setup_s = time.perf_counter() - t0
    b, t, s = cfg.data.batch_size, cfg.data.frames, cfg.data.gt_size
    dev = {"device": str(server.device),
           "device_name": (torch.cuda.get_device_name(server.device)
                           if server.device.type == "cuda" else "cpu")}

    if args.stream:
        return _stream(server, args.mode, args.stream, args.int8, dev)
    if args.root and not (args.synthetic or args.latency):
        stats = serve_folder(server, args.root, args.mode, args.out,
                             args.window, read_image, write_image)
        print(json.dumps({
            "mode": args.mode, "clips": stats["clips"],
            "frames": stats["frames"], "wall_s": stats["wall_s"],
            "compile_s": setup_s,
            "frames_per_s": stats["frames"] / max(stats["wall_s"], 1e-9),
            "window": args.window, "batch": b, "size": s, **dev}))
        return
    clip = np.random.default_rng(0).integers(0, 256, (b, t, s, s, 3),
                                             dtype=np.uint8)
    info = {"mode": args.mode, "batch": b, "frames": t, "size": s, **dev,
            "setup_s": setup_s, "int8": args.int8,
            "int8_embed": args.int8_embed}
    for _ in range(3):  # warm-up: cuDNN/cuBLAS plans, kernel build
        _materialize(server.serve(clip, args.mode))

    if args.latency:
        times = []
        for _ in range(args.latency):
            t1 = time.perf_counter()
            _materialize(server.serve(clip, args.mode))
            times.append((time.perf_counter() - t1) * 1e3)
        times = np.asarray(times)
        info.update(requests=args.latency,
                    p50_ms=float(np.percentile(times, 50)),
                    p95_ms=float(np.percentile(times, 95)),
                    p99_ms=float(np.percentile(times, 99)),
                    mean_ms=float(times.mean()))
    else:
        n = 0
        t1 = time.perf_counter()
        for res in server.serve_stream((clip for _ in range(args.synthetic)),
                                       args.mode, window=args.window):
            _materialize(res)
            n += res.n
        wall = time.perf_counter() - t1
        info.update(requests=args.synthetic, window=args.window, clips=n,
                    wall_s=wall, clips_per_s=n / wall,
                    frames_per_s=n * t / wall)
    print(json.dumps(info))


if __name__ == "__main__":
    main()
