"""Typed configuration of the PyTorch port: a copy of `vwfd_tpu/config.py`
(same dataclasses, defaults and `load_config`), kept here so that the port
imports nothing of the JAX package. Unknown keys raise; every field has a
typed default drawn from the reference's train YAMLs
(options/train/train_IRNcrop_x4.yml:88-118).
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import yaml


@dataclass(frozen=True)
class DataConfig:
    """Reference: options/train/*.yml `datasets:` block + data/Dataloader.py."""
    root: Optional[str] = None          # DAVIS root (JPEGImages/480p etc.)
    mask_root: Optional[str] = None     # forgery-mask dir (tianchi_dataset.py:16-77)
    gt_size: int = 256                  # train_IRNcrop_x4.yml:37
    batch_size: int = 16                # train_IRNcrop_x4.yml:36 (global)
    frames: int = 4                     # video clip length T (netG 12 = 3·4 ch)
    mask_rate_max: float = 0.2          # DVDataset rejection bound (Dataloader.py:77-95)
    use_flip: bool = True
    use_rot: bool = True
    synthetic: bool = False             # use the synthetic generator (tests/bench)
    ratio: int = 1                      # epoch enlargement (DistIterSampler ratio;
                                        # the reference passes 200, train.py:57)


@dataclass(frozen=True)
class ModelConfig:
    """Reference: models/IRNcrop_model.py:121-143 net construction."""
    inn_down_num: int = 3
    inn_block_num: Tuple[int, ...] = (1, 1, 1)
    # Coupling subnet: "res" = reference-exact ResBlock trunk; "dense" =
    # reference DenseBlock; "res_tpu" = MXU-shaped 128-wide trunk; "res_tpu2"
    # = res_tpu computed at half spatial resolution for <256-ch couplings
    # (bandwidth cut — see nets/inn.py::ResSubnetTPUS2). A fused Pallas
    # coupling kernel was built, measured and retired — RETIRED.md.
    inn_subnet: str = "res"
    inn_width: int = 0            # coupling trunk width (0 = reference's 64)
    # Haar squeeze implementation inside the INN: "lift" = reshape+add
    # lifting (minimal FLOPs — reference-equivalent); "conv" = the same
    # linear map as a fixed-weight stride-2 (transposed) conv, which keeps
    # tensors in conv-native layouts and avoids XLA:TPU data-formatting
    # copies around every squeeze (ops/haar.py; BASELINE.md r3 layout study).
    inn_haar: str = "lift"
    # Packed-space INN executor (nets/inn_packed.py): run every <256-channel
    # level space-to-depth-packed at its coupling-trunk resolution, fusing
    # the per-subnet s2d/d2s pairs and the Haar squeezes into fixed
    # orthogonal transition convs. Value-identical math, identical param
    # tree (checkpoints interchange); valid only for inn_subnet="res_tpu2"
    # with fused_st=True (asserted at model build).
    inn_packed: bool = False
    # fused_st=True: each coupling (s,t) pair from ONE trunk with a
    # double-width head (TPU default). False = the reference's four separate
    # subnets (invertible_net.py:122-175) — REQUIRED to load converted
    # reference .pth checkpoints (tools/convert_reference_checkpoint.py).
    fused_st: bool = True
    # Directory of converted reference weights (netG.npz / generator.npz from
    # tools/convert_reference_checkpoint.py) — the analog of the reference's
    # pretrain load at startup (models/IRNcrop_model.py:152-178).
    pretrain_path: Optional[str] = None
    unet_features: int = 32
    # Tamper-mask extractor: "unet" = reference-exact network/UNet.py (loads
    # converted reference checkpoints); "unet_tpu" = the MXU-shaped redesign
    # (nets/unet.py::UNetTPU) — the flagship/bench choice (BASELINE.md r3);
    # "unet_tpu_slim" = unet_tpu with half-width 1×1 skip projections
    # (−25% decoder FLOPs — a perf experiment, see BASELINE.md);
    # "unet_tpu2" = unet_tpu with single-conv encoder levels (halves extract
    # FLOPs/intermediate bytes — convergence-validated, BASELINE.md r3).
    extractor: str = "unet"
    extractor_features: int = 64        # UNetTPU channel base
    extractor_s2d: int = 2              # UNetTPU space-to-depth stem factor
    # UNetTPU head lowering: "d2s" = 1×1 conv to s²·out packed logits +
    # depth-to-space; "convt" = the same affine map composed into one s×s
    # stride-s transposed conv (identical params/output — see nets/unet.py).
    extractor_head: str = "d2s"
    # UNetTPU decoder lowerings (value-identical A/B knobs — nets/unet.py):
    # upsample "convt" | "gemm"; decoder conv "concat" | "split".
    extractor_up: str = "convt"
    extractor_dec: str = "concat"
    # Per-level encoder-conv plan (enc1..enc4, bottleneck) for finer
    # speed/quality frontier points, e.g. (2, 1, 1, 1, 1). None = the
    # extractor's default (2, or 1 for "unet_tpu2").
    extractor_enc_convs: Optional[Tuple[int, ...]] = None
    localizer_dim: int = 16
    localizer_residual_blocks: int = 2
    discriminator_dim: int = 32
    # Attack-pool shape knobs (reference: the pools are hard-coded per model,
    # models/IRNcrop_model.py:84-104 / IRNclr_model.py:504-546; configurable
    # here). n_attacks = image-family fan-out width k; attack_ratios bounds
    # the resize round-trip ratio pool (None = full reference pool — tiny
    # configs use a short tuple to cut compile time).
    n_attacks: int = 6
    attack_ratios: Optional[Tuple[float, ...]] = None


@dataclass(frozen=True)
class TrainConfig:
    """Reference: options/train/train_IRNcrop_x4.yml:88-118."""
    lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 1e-5
    gradient_clipping: float = 1.0
    niter: int = 500_000
    seed: int = 10                      # manual_seed (train.py:317-331)
    psnr_gate: float = 33.0             # IRNcrop_model.py:384-388
    # forward-fidelity criterion: "l1" (default — trains from scratch without
    # the PSNR collapse documented in BASELINE.md); "bce" = reference parity
    # (BCEWithLogits on images, IRNcrop_model.py:378-388 — its minimum is the
    # LOGIT of the target, which saturates pixels; the reference masks this by
    # fine-tuning from a pretrained netG, :152-178). "l2" also available.
    forward_criterion: str = "l1"
    loss_weight_low: float = 1.0
    loss_weight_high: float = 0.8
    save_interval: int = 5000           # IRNcrop_model.py:334
    montage_interval: int = 500         # IRNcrop_model.py:421
    print_freq: int = 100
    dtype: str = "bfloat16"             # compute dtype (ref: fp16 AMP)
    # LR schedule (models/lr_scheduler.py + base_model.py:51-75 warmup):
    # "constant" | "multistep" | "cosine" — built in models/state.py.
    lr_scheme: str = "constant"
    warmup_steps: int = 0               # linear warmup (base_model.py:61-75)
    lr_milestones: Tuple[int, ...] = () # multistep decay points
    lr_gamma: float = 0.5               # multistep decay factor
    lr_restarts: Tuple[int, ...] = ()   # multistep restart steps
    lr_restart_weights: Tuple[float, ...] = ()
    lr_periods: Tuple[int, ...] = ()    # cosine period lengths
    eta_min: float = 0.0                # cosine floor
    # Pretrained VGG19 weights for the perceptual/style losses (.npz from
    # tools/convert_vgg19.py — the reference loads torchvision's pretrained
    # VGG19, loss.py:155-178). None = the documented seeded-random fallback
    # (this environment ships no pretrained weights).
    vgg_weights: Optional[str] = None


@dataclass(frozen=True)
class Config:
    name: str = "vwfd"
    task: str = "video"                 # video | hidden | mbrs | kdjpeg | tianchi | image
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    ckpt_dir: str = "checkpoints"
    out_dir: str = "test_results"


def _build(cls, d: dict):
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(names)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for k, v in d.items():
        ftype = names[k].type
        if isinstance(v, dict):
            sub = {"data": DataConfig, "model": ModelConfig,
                   "train": TrainConfig}[k]
            kwargs[k] = _build(sub, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    d = {}
    if path is not None:
        with open(path) as f:
            d = yaml.safe_load(f) or {}
    if overrides:
        d = _merge(d, overrides)
    return _build(Config, d)


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out
