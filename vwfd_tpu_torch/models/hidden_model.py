"""The HiDDeN trainer (port of vwfd_tpu/models/hidden_model.py:33-197; the
reference's hidden_models/hidden.py:12-184).

One ``train_step`` runs both updates of the reference's two optimizer steps
per batch, as the JAX step does:

* D step: ``BCE(D(cover), 1) + BCE(D(encoded.detach()), 0)``, the
  discriminator in train mode twice in sequence, its BatchNorm updated by
  the cover batch and then, from those statistics, by the encoded batch
  (``:136-140``; not one update on the concatenated batch); Adam.
* G step: ``w_adv·BCE(D(encoded), 1) + w_enc·MSE(encoded, cover) +
  w_dec·MSE(decoded, message)`` with the UPDATED discriminator in eval mode
  (running statistics, ``:155-157``); Adam on the encoder and decoder.
* The guard (``:176-180``): where either loss is not finite, every
  parameter, BatchNorm statistic, Adam moment and count of the three nets
  keeps its value (``torch.where`` on the device, no host sync, F6).

The JAX D step reruns encode → noise → decode and keeps only the encoded
images; the encoder's output and BatchNorm statistics in train mode do not
depend on the discriminator, so the port encodes once: the detached output
feeds the D step, its graph the G step after D's update. Both steps share
one noise draw (the JAX step's ``k_noise``).

The noise pool (``NOISE_POOL``, ``:33-43``) is identity, crop (0.55-1.0,
resampled back through K17), cropout, dropout, gaussian and the zig-zag
JPEG mask with its clip (K16). JAX picks the member with ``lax.switch`` on
a device draw; the port's ``HiddenSampler`` picks it on the host from its
own numpy generator and draws that member's noise on the device from a
``torch.Generator`` (F4: ``jax.random`` cannot be replayed), so no device
value is read back to pick a branch and the crop window reaches K17 on the
device. The members are ``jax.random``-free functions of explicit draws
(``HiddenDraws``); tests derive the draws from a JAX key with the JAX
code's split sequence.

Data parallelism (``mesh=``, JAX's ``_message_loop`` over its ``"data"``
mesh): each rank passes its rows of the global batch and its rows of the
global draws (``HiddenDraws.rows``: gaussian's (B, H, W, 3) field is
sliced, dropout's (H, W) field and every ``u`` stay whole). The BatchNorm
moments of the three nets are the global batch's (F27; the discriminator's
two train-mode forwards each), every loss term and the bit error global
means, D's gradients all-reduced before its update and the encoder's and
decoder's before theirs, the G step against the updated D, and the guard
reads the global totals (F29).

Adam is ``optax.adam(1e-3)``: the port's ``AdamW`` without clip or decay.
The model runs in float32 throughout, as the JAX package's, and on the card
with TF32 off for its convolutions and products (``device.full_f32``).
"""

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..attacks import (crop_attack, cropout, dropout_mix, gaussian_noise,
                       hidden_jpeg_mask_compression, sample_crop_apex)
from ..device import full_f32, resolve_device
from ..kernels import KERNELS, KernelSet
from ..metrics import bce_with_logits, bitwise_message_error, l2_loss
from ..nets import HiddenDecoder, HiddenDiscriminator, HiddenEncoder
from ..parallel import Mesh, all_reduce_grads, global_means, local_rows
from .state import AdamW

__all__ = ["NOISE_POOL", "EVAL_MEMBERS", "PAPER_RATIO", "HiddenDraws",
           "HiddenSampler", "member_draws", "apply_noise", "HiddenModel"]

# the training pool, in the JAX package's order (its lax.switch index)
NOISE_POOL = ("identity", "crop", "cropout", "dropout", "gaussian",
              "jpeg_mask")
# the paper-geometry cropout (arXiv 1807.09937 §5): 30 % of the area kept,
# √0.30 ≈ 0.5477 a side (tools/eval_hidden.py)
PAPER_RATIO = 0.5477
# the per-member evaluation's members, in tools/eval_hidden.py's order
EVAL_MEMBERS = ("identity", "crop", "cropout", "cropout_paper_p30",
                "dropout", "gaussian", "jpeg_mask")
CROP_RATES = (0.55, 1.0)  # the pool's crop: min and max side ratio


class HiddenDraws(NamedTuple):
    """One step's noise: the member and its draws."""
    member: str
    u: Optional[torch.Tensor] = None      # U[0, 1): crop (4,), cropout (2,),
                                          # dropout's keep ratio ()
    field: Optional[torch.Tensor] = None  # dropout's (H, W) U[0, 1),
                                          # gaussian's (B, H, W, 3) N(0, 1)

    def to(self, device) -> "HiddenDraws":
        return HiddenDraws(self.member, *(None if t is None else t.to(device)
                                          for t in (self.u, self.field)))

    def rows(self, mesh: Optional[Mesh]) -> "HiddenDraws":
        """This rank's draws of the global batch's: gaussian's per-image
        field sliced to the rank's rows, every other draw whole (dropout's
        (H, W) field and each ``u`` serve every image); itself without a
        mesh. ``parallel.local_rows`` would slice dropout's field too."""
        if mesh is None or self.member != "gaussian":
            return self
        return self._replace(field=local_rows(self.field, mesh))


def member_draws(member: str, shape: Sequence[int],
                 gen: torch.Generator) -> HiddenDraws:
    """The draws ``member`` takes for images of ``shape`` (B, H, W, 3), from
    ``gen`` on its device."""
    b, h, w, c = shape
    kw = {"generator": gen, "device": gen.device}
    if member == "crop":
        return HiddenDraws(member, torch.rand(4, **kw))
    if member in ("cropout", "cropout_paper_p30"):
        return HiddenDraws(member, torch.rand(2, **kw))
    if member == "dropout":
        return HiddenDraws(member, torch.rand((), **kw),
                           torch.rand(h, w, **kw))
    if member == "gaussian":
        return HiddenDraws(member, None, torch.randn(b, h, w, c, **kw))
    if member in ("identity", "jpeg_mask"):
        return HiddenDraws(member)
    raise ValueError(f"unknown HiDDeN noise member {member!r}")


class HiddenSampler:
    """Seeded noise draws: the member on the host (numpy ``default_rng``,
    uniform or with ``weights`` over ``members``), its draws on ``device``
    from a ``torch.Generator``."""

    def __init__(self, seed: int, device, weights: Optional[Sequence] = None,
                 members: Sequence[str] = NOISE_POOL):
        self.members = tuple(members)
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(torch.device(device)).manual_seed(seed)
        self.p = None
        if weights is not None:
            w = np.asarray(weights, np.float64)
            if w.shape != (len(self.members),) or (w < 0).any() or not w.sum():
                raise ValueError(f"weights {weights} do not fit "
                                 f"{len(self.members)} members")
            self.p = w / w.sum()

    def member(self) -> str:
        i = (self.rng.choice(len(self.members), p=self.p) if self.p is not None
             else self.rng.integers(len(self.members)))
        return self.members[int(i)]

    def __call__(self, shape: Sequence[int], member: Optional[str] = None
                 ) -> HiddenDraws:
        return member_draws(member or self.member(), shape, self.gen)


def apply_noise(encoded: torch.Tensor, cover: torch.Tensor, d: HiddenDraws,
                kernels: KernelSet = KERNELS) -> torch.Tensor:
    """The member ``d.member`` on the encoded images with its draws."""
    m = d.member
    if m == "identity":
        return encoded
    if m == "crop":
        return crop_attack(encoded, sample_crop_apex(
            d.u, encoded.shape[1:3], *CROP_RATES), kernels)
    if m == "cropout":
        return cropout(encoded, cover, d.u)
    if m == "cropout_paper_p30":
        return cropout(encoded, cover, d.u, PAPER_RATIO, PAPER_RATIO)
    if m == "dropout":
        return dropout_mix(encoded, cover, d.u, d.field)
    if m == "gaussian":
        return gaussian_noise(encoded, d.field)
    if m == "jpeg_mask":
        return hidden_jpeg_mask_compression(encoded, clip=True,
                                            kernels=kernels)
    raise ValueError(f"unknown HiDDeN noise member {m!r}")


class HiddenModel:
    def __init__(self, message_length: int = 30, image_size: int = 128,
                 encoder_channels: int = 64, encoder_blocks: int = 4,
                 decoder_channels: int = 64, decoder_blocks: int = 7,
                 discriminator_channels: int = 64,
                 discriminator_blocks: int = 3,
                 adversarial_loss_weight: float = 1e-3,
                 encoder_loss_weight: float = 0.7,
                 decoder_loss_weight: float = 1.0, lr: float = 1e-3,
                 device=None, kernels: KernelSet = KERNELS,
                 mesh: Optional[Mesh] = None):
        self.message_length = message_length
        self.mesh = mesh
        self.image_size = image_size
        self.w_adv = adversarial_loss_weight
        self.w_enc = encoder_loss_weight
        self.w_dec = decoder_loss_weight
        self.lr = lr
        self.device = resolve_device(device)
        self.kernels = kernels
        self.encoder = HiddenEncoder(message_length, encoder_channels,
                                     encoder_blocks).to(self.device)
        self.decoder = HiddenDecoder(message_length, decoder_channels,
                                     decoder_blocks).to(self.device)
        self.discriminator = HiddenDiscriminator(
            discriminator_channels, discriminator_blocks).to(self.device)
        self.optimizers = self._adam()

    def _adam(self) -> Dict[str, AdamW]:
        return {name: AdamW(list(net.parameters()), self.lr,
                            weight_decay=0.0, clip=None)
                for name, net in self.nets().items()}

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {"encoder": self.encoder, "decoder": self.decoder,
                "discriminator": self.discriminator}

    def init_states(self, seed: int = 0) -> None:
        """Fresh parameters with flax's initialisers' distributions from a
        seeded ``torch.Generator``, identity BatchNorm, fresh Adam."""
        gen = torch.Generator().manual_seed(seed)
        for net in self.nets().values():
            net.to("cpu")
            net.init_params(gen)
            net.to(self.device)
        self.optimizers = self._adam()

    def load_states(self, states: Dict[str, Dict[str, torch.Tensor]]
                    ) -> None:
        for name, net in self.nets().items():
            net.load_state_dict(states[name])

    def to_device(self, *tensors):
        """Images or messages (numpy or tensors) → the nets' dtype (float32)
        on the model's device."""
        dt = self.encoder.final.weight.dtype
        return [torch.as_tensor(t).to(self.device, dt, non_blocking=True)
                for t in tensors]

    def _tensors(self, name: str) -> List[torch.Tensor]:
        """Every tensor of one net's state: parameters, BatchNorm running
        statistics, Adam moments and count."""
        net, opt = self.nets()[name], self.optimizers[name]
        bufs = [b for k, b in net.named_buffers()
                if not k.endswith("num_batches_tracked")]
        return [*net.parameters(), *bufs, *opt.mu, *opt.nu, opt.count]

    def train_step(self, images, messages, draws: HiddenDraws,
                   grads_out: Optional[dict] = None
                   ) -> Dict[str, torch.Tensor]:
        """One D step and one G step on a batch (B, H, W, 3) in [0, 1] and
        its messages (B, L) in {0, 1}, with the noise ``draws``; returns the
        logs as 0-dim tensors (no host sync). ``grads_out``, a dict, receives
        each net's gradients (lists in parameter order; under a mesh
        all-reduced). Under a mesh the batch and ``draws`` are this rank's
        rows (``HiddenDraws.rows``)."""
        images, messages = self.to_device(images, messages)
        draws = draws.to(self.device)
        mesh = self.mesh
        enc_p = list(self.encoder.parameters())
        dec_p = list(self.decoder.parameters())
        disc_p = list(self.discriminator.parameters())
        disc = self.discriminator
        old_disc = [t.clone() for t in self._tensors("discriminator")]
        with torch.enable_grad(), full_f32():
            enc, enc_stats = self.encoder(images, messages, train=True,
                                          mesh=mesh)

            # ---- D step, on the detached encoded images
            d_cover, s1 = disc(images, train=True, mesh=mesh)
            disc.load_stats(s1)
            d_enc, s2 = disc(enc.detach(), train=True, mesh=mesh)
            disc.load_stats(s2)
            d_on_cover, d_on_encoded = global_means(
                (bce_with_logits(d_cover, torch.ones_like(d_cover)),
                 bce_with_logits(d_enc, torch.zeros_like(d_enc))), mesh)
            d_total = d_on_cover + d_on_encoded
            d_grads = all_reduce_grads(torch.autograd.grad(d_total, disc_p),
                                       mesh)
            self.optimizers["discriminator"].step(d_grads)

            # ---- G step, against the updated discriminator in eval mode
            noised = apply_noise(enc, images, draws, self.kernels)
            dec, dec_stats = self.decoder(noised, train=True, mesh=mesh)
            d_on_enc = disc(enc)
            g_adv, g_enc, g_dec, bit_err = global_means(
                (bce_with_logits(d_on_enc, torch.ones_like(d_on_enc)),
                 l2_loss(enc, images), l2_loss(dec, messages),
                 bitwise_message_error(dec.detach(), messages)), mesh)
            g_total = (self.w_adv * g_adv + self.w_enc * g_enc
                       + self.w_dec * g_dec)
            g_grads = torch.autograd.grad(g_total, enc_p + dec_p)
            good = torch.isfinite(g_total) & torch.isfinite(d_total)
        g_grads = (all_reduce_grads(g_grads[:len(enc_p)], mesh),
                   all_reduce_grads(g_grads[len(enc_p):], mesh))

        with torch.no_grad():
            self.optimizers["encoder"].step(g_grads[0], good)
            self.optimizers["decoder"].step(g_grads[1], good)
            self.encoder.load_stats(enc_stats, good)
            self.decoder.load_stats(dec_stats, good)
            for t, old in zip(self._tensors("discriminator"), old_disc):
                t.copy_(torch.where(good, t, old))
        if grads_out is not None:
            grads_out.update(encoder=list(g_grads[0]),
                             decoder=list(g_grads[1]),
                             discriminator=list(d_grads))
        return {"loss": g_total.detach(), "encoder_mse": g_enc.detach(),
                "dec_mse": g_dec.detach(), "bitwise_error": bit_err.detach(),
                "adversarial_bce": g_adv.detach(),
                "discr_cover_bce": d_on_cover.detach(),
                "discr_encod_bce": d_on_encoded.detach()}

    @torch.no_grad()
    def encode(self, images, messages) -> torch.Tensor:
        """The encoder in eval mode."""
        images, messages = self.to_device(images, messages)
        with full_f32():
            return self.encoder(images, messages)

    @torch.no_grad()
    def decode(self, noised) -> torch.Tensor:
        """The decoder in eval mode: message logits."""
        with full_f32():
            return self.decoder(self.to_device(noised)[0])

    @torch.no_grad()
    def infer(self, images, messages, draws: HiddenDraws):
        """encode → noise → decode, eval mode: ``(encoded, noised,
        decoded)``."""
        enc = self.encode(images, messages)
        noised = apply_noise(enc, self.to_device(images)[0],
                             draws.to(self.device), self.kernels)
        return enc, noised, self.decode(noised)
