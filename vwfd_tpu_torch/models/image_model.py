"""The image family's immunization model: PAMI, ImugeV2 and CLR (port of
vwfd_tpu/models/image_model.py:44-570; the reference's IRN-PAMI, IRN and
CLRNet orchestrators, models/IRNp_model.py:449+, IRN_model.py:603+,
IRNclr_model.py:428+).

One ``train_step`` (``_loss``, ``:205-468``, and ``train_step``,
``:476-511``):

1. the 4-channel INN (``nets/inn.py``, the module path: K14 Haar, K15
   couplings; bf16 compute with float32 parameters and losses) embeds
   ``[image, watermark]``, where the watermark is the host canny map
   (``pami``, ``clr``) or the previous batch in gray (``imuge``,
   ``:209-213``); ``clamp_with_grad`` and the straight-through 8-bit
   quantizer give the immunized RGB, the 4th channel the null channel;
2. the tamper: the previous batch spliced in through the stroke mask, or
   (``copymove``, or ``mixed`` on the steps its draw says) a shifted
   detached copy of the image pasted through the shifted mask, which
   becomes the ground truth (``attacks.copy_move_tamper``); for ``clr``
   (``:225-233``) the crop: the window ``sample_crop_apex`` draws (rates
   0.6–1.0) resampled bicubically back to full size (K20
   ``crop_cubic``), the ground truth 1 outside the window; clipped;
3. the k-way attack fan-out, B → k·B (``:184-201``): branch i is member
   ``i mod 7`` of (8-bit quantizer, JPEG pool draw (K5), bicubic resize
   round trip, 3×3 median (K6), 3×3 σ 2 gaussian blur, JPEG pool draw,
   gaussian noise), each clipped to [0, 1];
4. the localizer (``nets/localizer.py``, float32) on all k·B copies, its
   input ``flat·share + flat.detach()·(1 − share)``: netG takes a 0.01
   share of the BCE (``pami``, ``imuge``) or none (``clr``), the localizer
   all of it (``:306-308``); the new spectral-norm vectors collected;
5. ``clr`` only (``:334-356``): the apex regressor (``nets/fbcnn.py``,
   ``QFPredictor(crop_pred=True)``) trains on the detached copies against
   the window's fractions ``(h0/h, h1/h, w0/w, w1/w)`` and the ground
   truth (``l_apex``); a second forward with its parameters frozen gives
   netG ``l_ce`` through the live copies; the copies are rectified (K21
   ``rectify``: the attacked values pasted back at the window's place,
   the gradient through the clean embed, ``fwd_rgb`` tiled);
6. the reverse pass on the first ``n_rev·B`` copies (``reverse_k``, 0 for
   all): ``[copy, canny_soft(copy)]`` (K19, with its gradient) through the
   INN's inverse, the recovered RGB and watermark clipped;
7. the losses. PAMI's recipe (``:401-432``): ``alpha_f·(L1 forward + 8·L2
   null [+ 0.01·perceptual]) + 0.75·(L1 backward + L1 watermark +
   local_w·l_local) + BCE``, ``alpha_f`` 3 below 35 dB forward PSNR,
   ``local_w`` 3 above 20 % tamper, ``l_local`` divided by ``1e-3 +
   mean(mask)``. CLR's (``:384-399``): ``alpha_f·(L1 forward + L1(null,
   canny)) + alpha_b·(L1 backward + L1 watermark + l_local) + 0.1·l_ce +
   l_apex + 0.1·(1 − SSIM(fwd, img)) + BCE``, ``alpha_f`` 5 below 35 dB
   else 1.5, ``alpha_b`` 1.5 where PF − PB > 1 dB, ``l_local`` divided by
   ``mean(mask) + 1e-6``; the SSIM is K8 forward and K22 backward
   (``kernels/ssim.py``). ``with_gan`` (``:437-462``) adds
   0.01 times the nsgan generator term (the discriminator,
   ``nets/discriminator.py``, frozen on ``fwd_rgb``) and the
   discriminator's ``½(BCE real + BCE fake)`` on ``img`` and the detached
   ``fwd_rgb``, its spectral vectors threaded through the three calls in
   that order; ``use_perceptual`` (``:418-425``, PAMI and ImugeV2 only)
   adds the VGG19 feature loss (``metrics/perceptual.py``: the
   ``TrainConfig.vgg_weights`` npz, else the port's seeded trunk);
8. one AdamW per net (netG, localizer, the apex regressor, the
   discriminator; ``models/state.py``, each clipped on its own); where the
   loss is not finite every parameter, moment, count and spectral vector
   keeps its value (``torch.where`` on the device, F6).

Every clip that can sit exactly on 0 or 1 (the tamper's, each branch's,
the reverse's) is ``jnp.clip``'s, gradient ½ there
(``torch.minimum(torch.maximum(·))``).

``eval_step`` (``:515-570``): embed, the splice tamper (``clr``: the crop),
the fan-out on the eval draws, the localizer, the reverse of all k·B copies
(``clr``: rectified first); forward PSNR, SSIM (K8), the recovered PSNR per
branch and its mean, the F1 sweep per branch and pooled (K7, k + 1 sweeps).

The draws (F4): JAX draws the copy-move shift, the mixed mode's choice,
each branch's member draw and (``clr``) the window's four uniforms from
its key on the device; the port's ``ImageSampler`` draws them on the host
from a numpy generator (``ImageDraws``; the window's only for ``clr``, so
the other tasks' streams are unchanged) and the step runs only the drawn
tamper (JAX's ``where`` gives the other none of the gradient).
``with_jpeg_simulator`` (KD-JPEG's FBCNN) is not ported: it raises,
naming its ROADMAP.md item. The apex regressor is built for ``clr``
alone: JAX's rectification and target read a window only the crop draws.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..attacks import (copy_move_shift, copy_move_tamper,
                       gaussian_blur_attack, gaussian_noise, jpeg_pool_draw,
                       median_blur_attack, resize_roundtrip)
from ..attacks.jpeg import QUALITIES
from ..attacks.spatial import DEFAULT_RATIOS, rect_mask, sample_crop_apex
from ..config import Config
from ..device import compute_dtype, full_f32, resolve_device
from ..kernels import KERNELS, KernelSet
from ..kernels.canny import gray as gray_of
from ..kernels.zigzag import clip01
from ..metrics import (adversarial_loss, bce_loss, f1_sweep, l1_loss,
                       l2_loss, psnr255_int, ssim)
from ..metrics.perceptual import (default_features, load_vgg_npz,
                                  perceptual_loss)
from ..nets.discriminator import Discriminator
from ..nets.fbcnn import QFPredictor
from ..nets.inn import InvertibleNet
from ..nets.localizer import UNetDiscriminator
from ..ops.quantize import clamp_with_grad, ste_quantize_255
from .state import AdamW, make_optimizer

__all__ = ["TASKS", "TAMPER_MODES", "POOL", "ImageBatch", "ImageDraws",
           "ImageSampler", "ImageImmunizationModel", "attack_fanout"]

TASKS = ("pami", "imuge", "clr")
TAMPER_MODES = ("splice", "copymove", "mixed")
# the fan-out's members, branch i taking POOL[i % 7] (image_model.py:189-198)
POOL = ("quantize", "jpeg", "resize", "median", "blur", "jpeg", "noise")
_LATER = "ROADMAP.md §1, KD-JPEG's item"
CROP_RATES = (0.6, 1.0)  # CLR's window: each side 60-100 % (:229)
ADVERSARIAL_WEIGHT = 0.01  # the GAN's generator term (JAX's default, :63)


class ImageBatch(NamedTuple):
    image: object  # (B, H, W, 3) in [0, 1]
    canny: object  # (B, H, W, 1) host canny map (pami)
    mask: object   # (B, H, W, 1) stroke tamper mask


class ImageDraws(NamedTuple):
    """One step's draws: the copy-move shift (dx, dy) and whether the mixed
    mode takes copy-move, then per fan-out branch its member's draw: None
    (quantizer, median, blur), (quality index into ``QUALITIES``, mode)
    (JPEG), the ratio index (resize) or a (B, H, W, 3) N(0, 1) array
    (noise); for ``clr`` the crop window's four U[0, 1) draws (height
    ratio, width ratio, row, column: ``attacks.sample_crop_apex``)."""
    shift: Tuple[int, int]
    use_cm: bool
    branch: Tuple
    apex_u: Optional[np.ndarray] = None


class ImageSampler:
    """Seeded draws on the host (numpy ``default_rng``), per step in this
    order: the shift's two uniforms, the mixed mode's uniform (copy-move
    below ``copy_move_prob``), each branch's draw, then (``apex``, CLR's
    crop) the window's four uniforms."""

    def __init__(self, seed: int, n_attacks: int, n_ratios: int,
                 copy_move_prob: float = 1.0 / 3.0, apex: bool = False):
        self.rng = np.random.default_rng(seed)
        self.n_attacks, self.n_ratios = n_attacks, n_ratios
        self.copy_move_prob = copy_move_prob
        self.apex = apex

    def __call__(self, shape) -> ImageDraws:
        b, h, w = shape[0], shape[1], shape[2]
        r = self.rng
        shift = copy_move_shift(r.random(), r.random(), (h, w))
        use_cm = bool(r.random() < self.copy_move_prob)
        branch = []
        for i in range(self.n_attacks):
            kind = POOL[i % len(POOL)]
            if kind == "jpeg":
                branch.append((int(r.integers(len(QUALITIES))),
                               int(r.integers(3))))
            elif kind == "resize":
                branch.append(int(r.integers(self.n_ratios)))
            elif kind == "noise":
                branch.append(r.standard_normal((b, h, w, 3)).astype(
                    np.float32))
            else:
                branch.append(None)
        apex_u = r.random(4).astype(np.float32) if self.apex else None
        return ImageDraws(shift, use_cm, tuple(branch), apex_u)


def attack_fanout(img: torch.Tensor, branch, ratios=DEFAULT_RATIOS,
                  kernels: KernelSet = KERNELS) -> torch.Tensor:
    """(B, H, W, 3) → (k, B, H, W, 3): branch i is ``POOL[i % 7]`` on its
    draw ``branch[i]``, clipped to [0, 1] (``image_model.py:184-201``)."""
    b = img.shape[0]
    outs = []
    for i, d in enumerate(branch):
        kind = POOL[i % len(POOL)]
        if kind == "quantize":
            a = ste_quantize_255(img)
        elif kind == "jpeg":
            a = jpeg_pool_draw(img, QUALITIES[d[0]], d[1], kernels)
        elif kind == "resize":
            idx = torch.full((b,), int(d), dtype=torch.long,
                             device=img.device)
            a = resize_roundtrip(img, idx, ratios)
        elif kind == "median":
            a = median_blur_attack(img, kernels=kernels)
        elif kind == "blur":
            a = gaussian_blur_attack(img)
        else:
            a = gaussian_noise(img, torch.as_tensor(d).to(img.device,
                                                          img.dtype))
        outs.append(clip01(a))
    return torch.stack(outs)


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the cotangent by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class ImageImmunizationModel:
    """``task`` ``pami`` (the canny watermark, ``tamper_mode`` mixed unless
    given), ``imuge`` (the previous batch in gray, splice) or ``clr`` (the
    canny watermark, the crop tamper, the apex regressor); the nets on
    ``device`` (``None`` → the CUDA card; raises without one unless
    ``device="cpu"``) through ``kernels`` (``kernels.KERNELS`` or
    ``kernels.PLAIN``)."""

    def __init__(self, cfg: Config, task: str = "pami",
                 n_attacks: Optional[int] = None, attack_ratios=None,
                 with_gan: bool = False, with_jpeg_simulator: bool = False,
                 tamper_mode: Optional[str] = None,
                 copy_move_prob: float = 1.0 / 3.0,
                 reverse_k: Optional[int] = None,
                 use_perceptual: bool = False, device=None,
                 kernels: KernelSet = KERNELS):
        if with_jpeg_simulator:
            raise NotImplementedError(f"with_jpeg_simulator (KD-JPEG's "
                                      f"FBCNN) is not ported yet: {_LATER}")
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        if tamper_mode is None:
            tamper_mode = "mixed" if task == "pami" else "splice"
        if tamper_mode not in TAMPER_MODES:
            raise ValueError(f"tamper_mode must be one of {TAMPER_MODES}")
        mc, tc = cfg.model, cfg.train
        self.cfg, self.task, self.tamper_mode = cfg, task, tamper_mode
        self.with_gan = with_gan
        self.use_perceptual = use_perceptual
        self.n_attacks = n_attacks if n_attacks is not None else mc.n_attacks
        ratios = attack_ratios if attack_ratios is not None \
            else mc.attack_ratios
        self.attack_ratios = tuple(ratios) if ratios else DEFAULT_RATIOS
        self.copy_move_prob = copy_move_prob
        self.reverse_k = reverse_k or 0
        self.device = resolve_device(device)
        self.kernels = kernels
        dt = compute_dtype(tc.dtype)
        self.netG = InvertibleNet(
            channels=4, down_num=mc.inn_down_num, block_num=mc.inn_block_num,
            subnet=mc.inn_subnet, fused_st=mc.fused_st, haar=mc.inn_haar,
            dtype=None if dt == torch.float32 else dt, kernels=kernels,
            packed=False).to(self.device)
        self.localizer = UNetDiscriminator(
            dim=mc.localizer_dim, residual_blocks=mc.localizer_residual_blocks,
            out_channels=1, use_sigmoid=True).to(self.device)
        # the crop-apex regressor (QF_predictor, IRNclr_model.py:148)
        self.apex_net = QFPredictor(
            nc=(16, 24, 32, 48), nb=1, classes=4, crop_pred=True,
            out_size=cfg.data.gt_size).to(self.device) if task == "clr" \
            else None
        self.discriminator = Discriminator(
            dim=mc.discriminator_dim, use_sigmoid=True).to(self.device) \
            if with_gan else None
        self.vgg = None
        if use_perceptual:
            self.vgg = (load_vgg_npz(tc.vgg_weights, self.device)
                        if tc.vgg_weights else default_features(self.device))
        self.optimizers = self._adamw()

    def _adamw(self) -> Dict[str, AdamW]:
        return {name: make_optimizer(list(net.parameters()), self.cfg.train)
                for name, net in self.nets().items()}

    def nets(self) -> Dict[str, torch.nn.Module]:
        out = {"netG": self.netG, "localizer": self.localizer}
        if self.apex_net is not None:
            out["apex"] = self.apex_net
        if self.discriminator is not None:
            out["discriminator"] = self.discriminator
        return out

    def init_states(self, seed: int = 0) -> None:
        """Fresh parameters with flax's initialisers' distributions from a
        seeded ``torch.Generator`` (zero-init coupling heads: the INN starts
        at the identity), ``u`` at ``ones/√n``, fresh AdamW."""
        gen = torch.Generator().manual_seed(seed)
        for net in self.nets().values():
            net.to("cpu")
            net.init_params(gen)
            net.to(self.device)
        self.optimizers = self._adamw()

    def load_states(self, states: Dict[str, Dict[str, torch.Tensor]]
                    ) -> None:
        for name, net in self.nets().items():
            net.load_state_dict(states[name])

    def sampler(self, seed: int) -> ImageSampler:
        return ImageSampler(seed, self.n_attacks, len(self.attack_ratios),
                            self.copy_move_prob, apex=self.task == "clr")

    def to_device(self, *arrays) -> List[torch.Tensor]:
        """Images, maps or masks (numpy or tensors) → float32 on the
        model's device (None stays None)."""
        return [None if a is None else torch.as_tensor(a).to(
            self.device, torch.float32, non_blocking=True) for a in arrays]

    def _sn_nets(self):
        return [n for n in (self.localizer, self.discriminator)
                if n is not None]

    def _tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state: spectral vectors, parameters, Adam
        moments and counts."""
        out = [c.u for n in self._sn_nets() for c in n.sn_convs()]
        for name, net in self.nets().items():
            opt = self.optimizers[name]
            out += [*net.parameters(), *opt.mu, *opt.nu, opt.count]
        return out

    # ------------------------------------------------------------- pieces

    def watermark(self, canny: torch.Tensor, prev: torch.Tensor
                  ) -> torch.Tensor:
        """The 4th INN channel: the canny map (pami, clr) or the previous
        batch in gray (imuge, XLA's ``prev @ (0.299, 0.587, 0.114)``)."""
        if self.task == "imuge":
            return gray_of(prev)[..., None]
        return canny

    def _embed(self, img: torch.Tensor, wm: torch.Tensor):
        fwd = self.netG(torch.cat([img, wm], -1))
        return ste_quantize_255(clamp_with_grad(fwd[..., :3])), fwd[..., 3:]

    @torch.no_grad()
    def embed(self, images, canny=None, prev=None):
        """Immunize a batch: ``(rgb, null)``."""
        img, canny, prev = self.to_device(images, canny, prev)
        with full_f32():
            return self._embed(img, self.watermark(canny, prev))

    def _reverse(self, copies: torch.Tensor) -> torch.Tensor:
        """``[copies, canny_soft(copies)]`` through the INN's inverse: the
        recovered (RGB ‖ watermark), unclipped."""
        rev_in = torch.cat([copies, self.kernels.canny_soft(copies)], -1)
        return self.netG.inverse(rev_in, return_middle=False)

    def _crop(self, fwd_rgb: torch.Tensor, apex_u):
        """CLR's tamper (``:225-233``): the window from the draws, the
        clipped bicubic crop (K20) and the mask, 1 outside the window."""
        b, h, w, _ = fwd_rgb.shape
        apex = sample_crop_apex(torch.as_tensor(apex_u).to(self.device),
                                (h, w), *CROP_RATES)
        tampered = clip01(self.kernels.crop_cubic(fwd_rgb.contiguous(),
                                                  apex))
        mask = (1.0 - rect_mask((h, w), apex.unbind()))[None, ..., None]
        return apex, tampered, mask * torch.ones((b, 1, 1, 1),
                                                 device=self.device)

    def _apex_loss(self, flat, apex, gt):
        """The regressor's loss ``l`` on the k·B copies (``:336-350``).
        JAX runs it twice, as ``l_apex`` on the detached copies and as
        ``l_ce`` with its parameters frozen on the live ones, and adds
        ``0.1·l_ce + l_apex``. One forward through an identity whose
        backward scales by 0.1 gives both gradients: the parameters get
        ``∂l/∂θ`` and the copies ``0.1·∂l/∂x``. The caller adds
        ``0.1·l.detach() + l`` for the value."""
        h, w = flat.shape[1:3]
        div = torch.tensor([h, h, w, w], dtype=torch.float32,
                           device=self.device)
        target = (apex / div)[None].expand(flat.shape[0], 4)
        apex_mask, apex_pred = self.apex_net(_ScaleGrad.apply(flat, 0.1))
        return l1_loss(apex_pred, target) + l1_loss(apex_mask, gt)

    def _gan(self, fwd_rgb, img, sn_d: dict):
        """``(g_adv, d_loss)`` (``:437-460``): D frozen on ``fwd_rgb``, D on
        ``img``, D on the detached ``fwd_rgb``, each call's spectral
        vectors starting from the last's; ``sn_d`` gets the last's."""
        d = self.discriminator
        frozen = {k: v.detach() for k, v in d.named_parameters()}
        sn: dict = {}
        g_adv = adversarial_loss(functional_call(d, frozen, (fwd_rgb,),
                                                 {"sn": sn}),
                                 True, False, loss_type="nsgan")
        d.load_u(sn)
        sn = {}
        d_real = d(img, sn=sn)
        d.load_u(sn)
        d_fake = d(fwd_rgb.detach(), sn=sn_d)
        d_loss = 0.5 * (adversarial_loss(d_real, True, True, "nsgan")
                        + adversarial_loss(d_fake, False, True, "nsgan"))
        return g_adv, d_loss

    # --------------------------------------------------------------- train

    def _loss(self, img, wm, mask, prev, draws: ImageDraws, sn: dict,
              sn_d: dict):
        b, h, w, _ = img.shape
        clr = self.task == "clr"
        fwd_rgb, fwd_null = self._embed(img, wm)
        if clr:
            apex, tampered, mask = self._crop(fwd_rgb, draws.apex_u)
        elif self.tamper_mode == "splice" or (self.tamper_mode == "mixed"
                                              and not draws.use_cm):
            tampered = fwd_rgb * (1.0 - mask) + prev * mask
        else:
            tampered, mask = copy_move_tamper(fwd_rgb, mask, draws.shift)
        attacked = attack_fanout(clip01(tampered), draws.branch,
                                 self.attack_ratios, self.kernels)
        k = attacked.shape[0]
        flat = attacked.reshape(k * b, h, w, 3)
        share = 0.0 if clr else 0.01
        flat_ce = flat * share + flat.detach() * (1.0 - share)
        pred = self.localizer(flat_ce, sn=sn)
        gt = mask.repeat(k, 1, 1, 1)
        l_mask = bce_loss(pred, gt)
        n_rev = k if self.reverse_k == 0 else min(self.reverse_k, k)
        aux = {}
        rect = flat[:n_rev * b]
        if clr:
            l_apex = self._apex_loss(flat, apex, gt)
            aux = {"l_apex": l_apex, "l_ce": l_apex}
            # only the reversed copies are rectified: the rest feed nothing
            rect = self.kernels.rectify(rect, fwd_rgb.contiguous(), apex)
        rev = self._reverse(rect)
        rev_rgb, rev_wm = clip01(rev[..., :3]), clip01(rev[..., 3:])
        img_exp = img.repeat(n_rev, 1, 1, 1)
        wm_exp = wm.repeat(n_rev, 1, 1, 1)
        with torch.no_grad():
            psnr_f = psnr255_int(img, fwd_rgb)
            psnr_b = psnr255_int(img_exp, rev_rgb)
        l_backward = l1_loss(rev_rgb, img_exp) + l1_loss(rev_wm, wm_exp)
        mask_r = gt[:n_rev * b]
        if clr:
            l_null = l1_loss(fwd_null, wm)
            l_forward = l1_loss(fwd_rgb, img) + l_null
            l_local = l1_loss(rev_rgb * mask_r, img_exp * mask_r) / (
                torch.mean(mask_r) + 1e-6)
            alpha_f = torch.where(psnr_f < 35.0, 5.0, 1.5)
            alpha_b = torch.where(psnr_f - psnr_b > 1.0, 1.5, 1.0)
            loss = alpha_f * l_forward + alpha_b * (l_backward + l_local)
            loss = loss + 0.1 * l_apex.detach() + l_apex
            loss = loss + 0.1 * (1.0 - ssim(fwd_rgb, img,
                                            kernels=self.kernels))
        else:
            l_null = l2_loss(fwd_null, torch.zeros_like(fwd_null))
            l_forward = l1_loss(fwd_rgb, img) + 8.0 * l_null
            if self.use_perceptual:
                l_forward = l_forward + 0.01 * perceptual_loss(
                    fwd_rgb, img, self.vgg)
            mean_mask = torch.mean(mask)
            l_local = l1_loss(rev_rgb * mask_r, img_exp * mask_r) / (
                1e-3 + mean_mask)
            alpha_f = torch.where(psnr_f < 35.0, 3.0, 1.0)
            local_w = torch.where(mean_mask > 0.2, 3.0, 1.0)
            loss = alpha_f * l_forward + 0.75 * (l_backward
                                                 + local_w * l_local)
        loss = loss + l_mask
        if self.with_gan:
            g_adv, d_loss = self._gan(fwd_rgb, img, sn_d)
            loss = loss + ADVERSARIAL_WEIGHT * g_adv + d_loss
            aux.update(g_adv=g_adv, d_loss=d_loss)
        return loss, {"lF": l_forward, "lB": l_backward, "l_mask": l_mask,
                      "PF": psnr_f, "PB": psnr_b, "NULL": l_null, **aux}

    def train_step(self, batch: ImageBatch, prev, draws: ImageDraws,
                   grads_out: Optional[dict] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` with the previous batch's images ``prev``
        spliced in and the step's ``draws``; returns the logs (``loss``,
        ``lF``, ``lB``, ``l_mask``, ``PF``, ``PB``, ``NULL``; ``l_apex``,
        ``l_ce`` for CLR; ``g_adv``, ``d_loss`` with the GAN) as 0-dim
        tensors (no host sync). ``grads_out``, a dict, receives each net's
        gradients (lists in parameter order)."""
        img, canny, mask, prev = self.to_device(*batch, prev)
        nets = self.nets()
        params = {k: list(net.parameters()) for k, net in nets.items()}
        flat = [p for ps in params.values() for p in ps]
        sn: dict = {}
        sn_d: dict = {}
        u_d = ({c: c.u.clone() for c in self.discriminator.sn_convs()}
               if self.with_gan else None)
        with torch.enable_grad(), full_f32():
            loss, aux = self._loss(img, self.watermark(canny, prev), mask,
                                   prev, draws, sn, sn_d)
            g = torch.autograd.grad(loss, flat, allow_unused=True)
        g = [torch.zeros_like(p) if d is None else d for p, d in zip(flat, g)]
        grads, i = {}, 0
        for name, ps in params.items():
            grads[name] = g[i:i + len(ps)]
            i += len(ps)
        with torch.no_grad():
            good = torch.isfinite(loss)
            for name, opt in self.optimizers.items():
                opt.step(grads[name], good)
            self.localizer.load_u(sn, good)
            if self.with_gan:
                self.discriminator.load_u(sn_d, good, u_d)
        if grads_out is not None:
            grads_out.update(grads)
        return {"loss": loss.detach(), **{k: v.detach()
                                          for k, v in aux.items()}}

    # ---------------------------------------------------------------- eval

    @torch.no_grad()
    def eval_step(self, batch: ImageBatch, prev, draws: ImageDraws
                  ) -> Dict[str, torch.Tensor]:
        """Embed → splice (``clr``: the crop) → the full k-way fan-out →
        localize → (``clr``: rectify) → reverse all k·B copies
        (``image_model.py:515-570``); device tensors: ``psnr_forward``,
        ``psnr_backward`` (the mean over branches),
        ``psnr_backward_per_attack`` (k,), ``ssim_forward``, ``f1_best``,
        ``f1_sweep`` (pooled), ``f1_per_attack`` (k,), ``recovered`` and
        ``predicted_mask`` (branch 0's)."""
        img, canny, mask, prev = self.to_device(*batch, prev)
        b, h, w, _ = img.shape
        with full_f32():
            fwd_rgb, _ = self._embed(img, self.watermark(canny, prev))
            if self.task == "clr":
                apex, tampered, mask = self._crop(fwd_rgb, draws.apex_u)
            else:
                tampered = fwd_rgb * (1.0 - mask) + prev * mask
            attacked = attack_fanout(clip01(tampered), draws.branch,
                                     self.attack_ratios, self.kernels)
            k = attacked.shape[0]
            flat = attacked.reshape(k * b, h, w, 3)
            pred = self.localizer(flat)
            if self.task == "clr":
                flat = self.kernels.rectify(flat, fwd_rgb.contiguous(), apex)
            rev_rgb = clip01(self._reverse(flat)[..., :3])
            pred_k = pred.reshape(k, b, h, w, 1)
            rev_k = rev_rgb.reshape(k, b, h, w, 3)
            kw = {"kernels": self.kernels}
            f1_k = torch.stack([f1_sweep(pred_k[i], mask, **kw)[1]
                                for i in range(k)])
            psnr_b_k = torch.stack([psnr255_int(img, rev_k[i])
                                    for i in range(k)])
            _, f1s = f1_sweep(pred, mask.repeat(k, 1, 1, 1), **kw)
            return {"psnr_forward": psnr255_int(img, fwd_rgb),
                    "psnr_backward": torch.mean(psnr_b_k),
                    "psnr_backward_per_attack": psnr_b_k,
                    "ssim_forward": ssim(fwd_rgb, img, **kw),
                    "f1_best": torch.max(f1s), "f1_sweep": f1s,
                    "f1_per_attack": torch.max(f1_k, -1).values,
                    "recovered": rev_k[0], "predicted_mask": pred_k[0]}
