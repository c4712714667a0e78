"""Serving runtime for the video watermarking pipeline (port of
vwfd_tpu/serving.py).

Two deployable operations and their fusion:

* ``embed``  — watermark a uint8 clip (INN forward, clamp, 8-bit round);
* ``detect`` — per-frame tamper mask, bit-packed, and a per-clip tamper
  fraction;
* ``roundtrip`` — embed then detect on the device, the detector reading
  exactly the uint8 the embed wire would carry.

The wire format is the JAX package's: uint8 frames in, uint8 frames out,
masks one bit per pixel (MSB first along W) when the frame width divides by
8, else uint8 {0,255}. A final partial batch is padded to the server's batch
and the outputs trimmed (eval-mode nets are per-sample, so this is exact).

On the card the uint8 decode/encode and relayouts run in K3
(``kernels/wire.py``; the roundtrip's encode and the detect stem's decode
in one pass), the INN in K1/K2 (the packed executor) or K14/K15 (the
module path) plus cuDNN/cuBLAS, and the detect epilogue in K4
(``kernels/mask.py``). Every configuration of ``VideoWatermarkModel`` is
served: with the reference ``UNet`` (or ``UNetTPU``'s ``convt`` head) the
stem is the frames themselves (K3 at s = 1) and K4 reads full-resolution
logits (s = 1).

Int8 serving (``int8_extract``, ``int8_embed``; vwfd_tpu/serving.py:212-338):
at construction, off the serving clock, the extractor and/or the embed INN
are calibrated on representative clips and quantized
(``nets/unet_int8.py``, ``nets/inn_int8.py``); the embed first, so that the
detect's self-calibration watermarks its clips through the int8 embed
when both are on. The int8 detect reads K3's int8 stem, runs the UNet in
K11 ``qconv`` and K12 ``qconv_t`` and hands the head's float32 logits to K4;
the int8 embed runs K1, K11 and K13 ``qcoupling_head``, and its output
goes through K3 as the bf16 INN's does. Uploads go through pinned host
buffers with ``non_blocking`` copies; results come back the same way,
behind a CUDA event, so ``serve`` returns without waiting for the cards and
``serve_stream`` keeps a window of requests in flight.

Weights come from a checkpoint directory (``ckpt_dir``: the port's own
layout, ``models/state.py``, which ``tools/jax_checkpoint_to_torch.py``
writes from a JAX package's orbax checkpoint), a weights file or mapping,
or a seed. Media folders, ``--stream`` and ``--s2d`` are the CLI's
(``serve.py``).

Several devices (``devices=``; the JAX package's data-mesh server,
vwfd_tpu/serving.py:178-181,208-232): one process holds a replica of the
states on each device, the int8 trees too (copied from the first, which
calibrates). A request's rows are split in order into equal parts, every
part is launched on its device before any is read back, so the cards work
at once, and the outputs are concatenated on the host. The batch must
divide by the number of devices. Not ported yet: AOT compile (CUDA
graphs), ``export_program`` and ``cost_analysis`` (ROADMAP.md §1).
"""

import copy
from typing import (Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .kernels import KERNELS, KernelSet
from .models.state import latest_step, load_nets
from .models.video_model import VideoWatermarkModel, _to_channels
from .nets import inn_int8, unet_int8
from .ops.resize import resize_bilinear

__all__ = ["WatermarkServer", "ServeResult", "unpack_mask_bits", "check_int8",
           "save_weights"]

MODES = ("embed", "detect", "roundtrip")
_DEVICE_FNS = {"embed": "_embed_u8", "detect": "_detect_u8",
               "roundtrip": "_roundtrip_u8"}
Weights = Union[str, Mapping[str, Mapping[str, torch.Tensor]]]


def check_int8(mc, int8_extract: bool, int8_embed: bool) -> None:
    """The JAX server's int8 rules (vwfd_tpu/serving.py:263-267, 298-306):
    the int8 embed needs the packed INN, the int8 extractor ``UNetTPU``
    with the ``d2s`` head and ``convt`` upsample."""
    if int8_embed and not mc.inn_packed:
        raise ValueError(
            "int8_embed requires the packed flagship embed "
            "(ModelConfig.inn_packed=True — nets/inn_int8.py quantizes "
            "the packed executor's learned convs)")
    if int8_extract and (mc.extractor not in ("unet_tpu", "unet_tpu2")
                         or mc.extractor_head != "d2s"
                         or mc.extractor_up != "convt"):
        raise ValueError(
            "int8_extract supports the UNetTPU extractor with the "
            "default head ('d2s') and upsample ('convt') lowerings "
            f"(got extractor={mc.extractor!r}, "
            f"head={mc.extractor_head!r}, up={mc.extractor_up!r})")


def unpack_mask_bits(packed) -> np.ndarray:
    """Host-side inverse of the packed mask wire: uint8 (...,S,S//8) →
    uint8 {0,255} (...,S,S,1)."""
    bits = np.unpackbits(np.asarray(packed), axis=-1)
    return (bits[..., None] * np.uint8(255)).astype(np.uint8)


def _smooth_synthetic_clips(rng: np.random.Generator, shape) -> np.ndarray:
    """Bilinear-upsampled coarse noise plus a per-frame drift, in [0, 1]:
    the "natural video"-like family the int8 self-calibration uses (smooth
    content matches natural activation statistics far better than uniform
    pixel noise). Drawn from ``rng`` (the JAX package draws from
    ``jax.random``; the two cannot give the same clips, F15)."""
    b, t, s, _, c = shape
    coarse = rng.uniform(size=(b, 1, 16, 16, c)).astype(np.float32)
    drift = (0.05 * rng.standard_normal((b, t, 1, 1, c))).astype(np.float32)
    up = resize_bilinear(torch.from_numpy(coarse), (s, s)).numpy()
    return np.broadcast_to(np.clip(up + drift, 0.0, 1.0), shape)


def _materialize(calib):
    """A one-shot iterable of calibration clips, listed once, so that both
    int8 paths can read it."""
    if calib is None or isinstance(calib, np.ndarray):
        return calib
    return list(calib)


def _clips(calib):
    return [calib] if isinstance(calib, np.ndarray) else list(calib)


def save_weights(states: Mapping[str, Mapping[str, torch.Tensor]],
                 path: str) -> None:
    """Write ``{"netG": ..., "generator": ...}`` state dicts for
    ``WatermarkServer(weights=path)``."""
    torch.save({k: {n: t.detach().cpu() for n, t in sd.items()}
                for k, sd in states.items()}, path)


class ServeResult:
    """One served clip batch. Holds device tensors, one dict of them per
    replica, in row order; the device→host copies start at ``prefetch``
    (into pinned buffers, behind a CUDA event on each device) and the
    consumer waits only when it reads an output, the replicas' rows
    concatenated."""

    __slots__ = ("_parts", "n", "_host", "_done")

    def __init__(self, arrays: Union[Dict[str, torch.Tensor],
                                     List[Dict[str, torch.Tensor]]], n: int):
        self._parts = arrays if isinstance(arrays, list) else [arrays]
        self.n = n  # valid rows (≤ server batch; the rest is tail padding)
        self._host = None
        self._done = []

    def prefetch(self) -> "ServeResult":
        """Start the device→host copies of every output now."""
        if self._host is None:
            self._host = []
            for part in self._parts:
                host = {}
                for name, arr in part.items():
                    if arr.is_cuda:
                        buf = torch.empty(arr.shape, dtype=arr.dtype,
                                          pin_memory=True)
                        host[name] = buf.copy_(arr, non_blocking=True)
                    else:
                        host[name] = arr
                self._host.append(host)
                for dev in {a.device for a in part.values() if a.is_cuda}:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
                    self._done.append(done)
        return self

    def _fetch(self, name: str) -> np.ndarray:
        self.prefetch()
        for done in self._done:
            done.synchronize()
        parts = [h[name].numpy() for h in self._host]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def __getattr__(self, name):
        if name == "mask" and "mask" not in self._parts[0]:
            # bit-packed wire format — unpack on the host, same interface
            return unpack_mask_bits(self._fetch("mask_bits"))[: self.n]
        if name not in self._parts[0]:
            raise AttributeError(name)
        return self._fetch(name)[: self.n]

    def keys(self):
        return self._parts[0].keys()


class WatermarkServer:
    """Embed / detect / roundtrip server for one clip shape.

    Parameters
    ----------
    cfg : Config
        ``cfg.data`` fixes the clip shape (batch_size, frames, gt_size);
        ``cfg.model`` picks the nets; ``cfg.train.dtype`` the compute dtype.
    device : str or torch.device, optional
        ``None`` → the current CUDA card (raises without one); ``"cpu"``
        runs the plain PyTorch path.
    devices : sequence of str or torch.device, optional
        Serve over several devices instead (``device`` then stays None):
        a replica of the states on each, each request's rows split in
        order over them (``cfg.data.batch_size`` must divide by their
        number). ``("cpu", "cpu")`` runs the split on the CPU.
    weights : str or mapping, optional
        A file written by ``save_weights`` or ``{"netG": state_dict,
        "generator": state_dict}`` (e.g. from ``convert.params_from_jax``).
    ckpt_dir : str, optional
        A checkpoint directory (``models/state.py``); the nets of its step
        ``step`` (default: the latest) are served, and ``FileNotFoundError``
        is raised when it holds none. Without ``weights`` or ``ckpt_dir``
        the server serves random-init params (seed 0).
    step : int, optional
        The checkpoint step to serve from ``ckpt_dir``.
    modes : tuple of {"embed", "detect", "roundtrip"}
        The operations this server accepts.
    threshold : float
        Mask binarisation threshold on the sigmoid probabilities.
    kernels : KernelSet
        ``kernels.KERNELS`` (default) or ``kernels.PLAIN`` (the plain
        versions on any device, for comparisons).
    int8_extract : bool
        Run detect / roundtrip's extractor through the int8 PTQ path
        (``nets/unet_int8.py``). Requires ``extractor='unet_tpu'`` (or
        ``unet_tpu2``) with the default head (``d2s``) and upsample
        (``convt``) lowerings.
    int8_embed : bool
        Run embed / roundtrip's INN through the int8 PTQ path
        (``nets/inn_int8.py``). Requires the packed flagship embed
        (``inn_packed=True``).
    int8_calib : np.ndarray or iterable of np.ndarray, optional
        Calibration traffic, uint8 clips ``(n, T, S, S, 3)``, shared by both
        int8 paths (clean clips for the embed; watermarked and/or attacked
        frames for the detect). Default: self-generated smooth clips
        (numpy generators seeded 0 for the embed, 1 for the detect, whose
        clips are watermarked by this server's embed first).
    int8_calib_embed, int8_calib_detect : optional
        Path-specific calibration clips; each falls back to ``int8_calib``.
    int8_margin : float
        Calibration amax head-room multiplier.
    """

    def __init__(self, cfg: Config, device=None,
                 devices: Optional[Sequence] = None,
                 weights: Optional[Weights] = None,
                 modes: Tuple[str, ...] = ("embed", "detect"),
                 threshold: float = 0.5, kernels: KernelSet = KERNELS,
                 ckpt_dir: Optional[str] = None, step: Optional[int] = None,
                 int8_extract: bool = False, int8_embed: bool = False,
                 int8_calib=None, int8_calib_embed=None,
                 int8_calib_detect=None, int8_margin: float = 1.0):
        unknown = set(modes) - set(MODES)
        if unknown:
            raise ValueError(f"unknown modes {sorted(unknown)}")
        if devices is not None:
            if device is not None:
                raise ValueError("pass device or devices, not both")
            devices = [resolve_device(d) for d in devices]
            if not devices or cfg.data.batch_size % len(devices):
                raise ValueError(
                    f"the server batch {cfg.data.batch_size} must divide "
                    f"by the number of devices {len(devices)}")
            device = devices[0]
        check_int8(cfg.model, int8_extract, int8_embed)
        if weights is not None and ckpt_dir is not None:
            raise ValueError("pass weights or ckpt_dir, not both")
        if ckpt_dir is not None:
            at = step if step is not None else latest_step(ckpt_dir)
            if at is None:
                raise FileNotFoundError(
                    f"no checkpoint steps under {ckpt_dir!r}")
            weights = load_nets(ckpt_dir, at)
        self.cfg = cfg
        self.batch = cfg.data.batch_size
        self.frames = cfg.data.frames
        self.size = cfg.data.gt_size
        self.threshold = float(threshold)
        self.modes = tuple(modes)
        self.kernels = kernels
        self.model = VideoWatermarkModel(cfg, device=device, kernels=kernels)
        self.device = self.model.device
        if weights is None:
            self.model.init_states(0)
        else:
            if isinstance(weights, str):
                weights = torch.load(weights, map_location="cpu",
                                     weights_only=True)
            self.model.load_states(weights)
        self._qemb = self._qext = None
        int8_calib = _materialize(int8_calib)
        if int8_embed:  # first: the detect's self-calibration embeds with it
            self._qemb = self._quantize_embed(
                _materialize(int8_calib_embed)
                if int8_calib_embed is not None else int8_calib, int8_margin)
        if int8_extract:
            self._qext = self._quantize_extract(
                _materialize(int8_calib_detect)
                if int8_calib_detect is not None else int8_calib, int8_margin)
        self._replicas = [self] + [self._replica(d)
                                   for d in (devices or [])[1:]]

    def _replica(self, device: torch.device) -> "WatermarkServer":
        """This server's states and int8 trees on ``device``: a server of
        its own, which serves its rows of each request."""
        r = copy.copy(self)
        r.model = VideoWatermarkModel(self.cfg, device=device,
                                      kernels=self.kernels)
        r.model.load_states(self.model.states())
        r.device = r.model.device
        for key in ("_qemb", "_qext"):
            tree = getattr(self, key)
            setattr(r, key, None if tree is None else unet_int8.tree_map(
                lambda t: t.to(r.device), tree))
        r._replicas = [r]
        return r

    # ------------------------------------------------------ int8 conversion

    def _smooth_u8(self, seed: int) -> np.ndarray:
        shape = (self.batch, self.frames, self.size, self.size, 3)
        clip = _smooth_synthetic_clips(np.random.default_rng(seed), shape)
        return np.ascontiguousarray((clip * 255).astype(np.uint8))

    def _quantize_embed(self, calib, margin: float) -> Dict:
        """Calibrate the INN on clean clips (default: smooth synthetic ones)
        and quantize it (``nets/inn_int8.py``)."""
        clips = [self._smooth_u8(0)] if calib is None else _clips(calib)
        batches = [_to_channels(torch.from_numpy(
            np.asarray(c).astype(np.float32) / 255.0)) for c in clips]
        inn = self.model.inn
        scales = inn_int8.calibrate(inn, batches, margin, self.kernels)
        return inn_int8.quantize(inn, scales, self.device)

    def _quantize_extract(self, calib, margin: float) -> Dict:
        """Calibrate the UNet on detect traffic (default: smooth synthetic
        clips watermarked by this server's embed, the roundtrip's own
        traffic) and quantize it (``nets/unet_int8.py``)."""
        if calib is None:
            with torch.no_grad():
                wm = self._embed_u8(torch.from_numpy(self._smooth_u8(1)).to(
                    self.device))["watermarked"]
            clips = [wm.cpu().numpy()]
        else:
            clips = _clips(calib)
        batches = [np.asarray(c).astype(np.float32).reshape(
            -1, self.size, self.size, 3) / 255.0 for c in clips]
        unet = self.model.unet
        scales = unet_int8.calibrate(unet, batches, margin)
        return unet_int8.quantize(unet, scales, self.device)

    # ---------------------------------------------------------- device fns

    def _inn_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """u8 clip → INN output (B,H,W,3T) in the compute dtype."""
        m, k = self.model, self.kernels
        x = k.wire_to_channels(x_u8, m.compute_dtype)
        if self._qemb is None:
            return m.inn(x, out_f32=False)
        dt = None if m.compute_dtype == torch.float32 else m.compute_dtype
        return inn_int8.forward_int8(
            self._qemb, x, channels=3 * self.frames, down_num=m.inn.down_num,
            dtype=dt, out_f32=False, kernels=k)

    def _detect_s2d(self, xs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Detect stem (B·T,H/s,W/s,3s²), the compute dtype or, for the int8
        extractor, int8 → mask and tamper fraction."""
        m = self.model
        logits = (m.unet.body(xs) if self._qext is None
                  else unet_int8.body_int8(self._qext, xs, self.kernels))
        # K4's grid planned for the whole request: a replica sums each
        # clip's fraction in the order one device does
        mask, frac = self.kernels.mask_pack(logits, self.frames,
                                            m.unet.head_s2d, self.threshold,
                                            plan_clips=self.batch)
        key = "mask_bits" if self.size % 8 == 0 else "mask"
        return {key: mask, "tamper_fraction": frac}

    def _embed_u8(self, x_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"watermarked": self.kernels.wire_to_u8(self._inn_u8(x_u8),
                                                       self.frames)}

    def _detect_u8(self, x_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        m, k = self.model, self.kernels
        b, t, h, w, c = x_u8.shape
        frames = x_u8.reshape(b * t, h, w, c)
        xs = (k.wire_to_s2d(frames, m.unet.s2d, m.compute_dtype)
              if self._qext is None else k.wire_to_s2d_i8(frames, m.unet.s2d))
        return self._detect_s2d(xs)

    def _roundtrip_u8(self, x_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Embed then detect; the detector reads the stem input decoded
        from the watermarked bytes in the same pass that writes them."""
        m, k = self.model, self.kernels
        to = k.wire_to_u8_s2d if self._qext is None else k.wire_to_u8_s2d_i8
        wm, xs = to(self._inn_u8(x_u8), self.frames, m.unet.s2d)
        return {"watermarked": wm, **self._detect_s2d(xs)}

    # ------------------------------------------------------------- serving

    def _put(self, clip_u8: np.ndarray) -> Tuple[List[torch.Tensor], int]:
        """Host→device uploads with tail padding to the server batch: each
        replica's rows, in order, on its device."""
        n = clip_u8.shape[0]
        want = (self.batch, self.frames, self.size, self.size, 3)
        if clip_u8.dtype != np.uint8:
            raise TypeError(f"serving wire format is uint8, got "
                            f"{clip_u8.dtype} (scale to 0..255 on the host)")
        if clip_u8.shape[1:] != want[1:] or n > self.batch:
            raise ValueError(f"server clip shape is {want}, got "
                             f"{clip_u8.shape} — start one server per shape")
        host = torch.empty(want, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        host[:n] = torch.from_numpy(np.ascontiguousarray(clip_u8))
        host[n:] = 0
        per = self.batch // len(self._replicas)
        return [host[i * per:(i + 1) * per].to(r.device, non_blocking=True)
                for i, r in enumerate(self._replicas)], n

    def serve(self, clip_u8: np.ndarray, mode: str) -> ServeResult:
        """One request; returns before the cards finish (the result waits
        only when its outputs are read). Over several devices, every
        replica's rows are launched before any is read back."""
        if mode not in self.modes:
            raise KeyError(f"mode {mode!r} not served (modes={self.modes})")
        parts, n = self._put(clip_u8)
        fn = _DEVICE_FNS[mode]
        with torch.no_grad():
            return ServeResult([getattr(r, fn)(x) for r, x
                                in zip(self._replicas, parts)], n)

    def serve_stream(self, clips: Iterable[np.ndarray], mode: str,
                     window: int = 2) -> Iterator[ServeResult]:
        """Pipelined serving: keeps ≤ ``window`` request batches in flight.
        The oldest result is yielded (and may then block its reader) only
        when the window is full or the input is exhausted."""
        if mode not in self.modes:
            raise KeyError(f"mode {mode!r} not served (modes={self.modes})")
        inflight = []
        for clip in clips:
            inflight.append(self.serve(clip, mode).prefetch())
            if len(inflight) >= max(1, window):
                yield inflight.pop(0)
        while inflight:
            yield inflight.pop(0)
