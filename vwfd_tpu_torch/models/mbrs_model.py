"""The MBRS trainer (port of vwfd_tpu/models/mbrs_model.py): JPEG-robust
watermarking of a message into a still image, the reference's
mbrs_models/ Encoder_MP_Diffusion and Decoder_Diffusion.

One ``train_step`` encodes the batch, clips it to [0, 1], passes it
through one noise draw (``mbrs_noise``) and decodes it; the loss is
``w_enc·MSE(encoded, images) + w_msg·MSE(decoded, messages)`` on the
unclipped encoding; Adam (``optax.adam(lr)``: the port's ``AdamW`` without
clip or decay) updates each net. Where the loss is not finite, every
parameter, BatchNorm statistic, Adam moment and count of both nets keeps
its value (``torch.where`` on the device, F6).

The noise (``_mbrs_noise``, ``:26-36``): one draw a batch of a quality in
{50, 70, 90} and a mode, identity, hard JPEG with a straight-through
gradient, or soft JPEG, both ``attacks.jpeg_basic`` (K5). JAX draws them
from its key on the device and computes all three branches under
``jnp.where``; the port's ``MBRSSampler`` draws them on the host from a
numpy generator (F4: ``jax.random`` cannot be replayed) and runs only the
drawn branch, so no device value is read back: identity launches no K5,
hard one (its forward under ``no_grad``), soft two (forward and backward).

The model runs in float32, on the card with TF32 off
(``device.full_f32``).

Data parallelism (``mesh=``, JAX's ``_message_loop`` over its ``"data"``
mesh): each rank passes its rows of the global batch and the whole
``MBRSDraws`` (one draw a batch, every rank's sampler seeded alike); the
BatchNorm moments are the global batch's (F27), the two loss terms and
the bit error global means (one all-reduce), each net's gradients
all-reduced before its update, and the guard reads the global loss (F29).
"""

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..attacks import jpeg_basic
from ..device import full_f32, resolve_device
from ..kernels import KERNELS, KernelSet
from ..kernels.zigzag import clip01
from ..metrics import bitwise_message_error, l2_loss
from ..nets import MBRSDecoder, MBRSEncoder
from ..parallel import Mesh, all_reduce_grads, global_means
from .state import AdamW

__all__ = ["MODES", "QUALITY_INDICES", "MBRSDraws", "MBRSSampler",
           "mbrs_noise", "MBRSModel"]

MODES = ("identity", "hard", "soft")
# the qualities 50, 70 and 90 as indices into attacks.jpeg.QUALITIES
QUALITY_INDICES = (0, 2, 4)


class MBRSDraws(NamedTuple):
    """One batch's noise: ``mode`` indexes ``MODES``, ``q_idx`` is the
    quality's index into ``attacks.jpeg.QUALITIES``."""
    mode: int
    q_idx: int


class MBRSSampler:
    """Seeded noise draws on the host (numpy ``default_rng``): the quality,
    uniform over ``QUALITY_INDICES``, then the mode, uniform over
    ``MODES``, one pair a batch, as the JAX step draws them from its key's
    two halves."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape: Optional[Sequence[int]] = None) -> MBRSDraws:
        """One batch's draws (``shape``, the batch's, is not needed: one
        draw serves the whole batch)."""
        q = QUALITY_INDICES[int(self.rng.integers(len(QUALITY_INDICES)))]
        return MBRSDraws(int(self.rng.integers(len(MODES))), q)


def mbrs_noise(enc: torch.Tensor, draws: MBRSDraws,
               kernels: KernelSet = KERNELS) -> torch.Tensor:
    """``jnp.clip(enc, 0, 1)`` (gradient ½ at the ends), then the drawn
    mode: identity; ``x + (jpeg_basic(x, round) − x)`` with the difference
    detached (the JAX formula: its value is not bit-equal to the JPEG's);
    or ``jpeg_basic(x, ss)``."""
    x = clip01(enc)
    if MODES[draws.mode] == "identity":
        return x
    if MODES[draws.mode] == "hard":
        with torch.no_grad():
            hard = jpeg_basic(x, draws.q_idx, "round", kernels=kernels)
        return x + (hard - x.detach())
    return jpeg_basic(x, draws.q_idx, "ss", kernels=kernels)


class MBRSModel:
    def __init__(self, image_size: int = 128, message_length: int = 30,
                 channels: int = 64, blocks: int = 4,
                 diffusion_length: int = 256, lr: float = 1e-3,
                 w_enc: float = 0.7, w_msg: float = 10.0, device=None,
                 kernels: KernelSet = KERNELS, mesh: Optional[Mesh] = None):
        self.image_size = image_size
        self.mesh = mesh
        self.message_length = message_length
        self.w_enc, self.w_msg = w_enc, w_msg
        self.lr = lr
        self.device = resolve_device(device)
        self.kernels = kernels
        self.encoder = MBRSEncoder(image_size, message_length, channels,
                                   blocks, diffusion_length).to(self.device)
        self.decoder = MBRSDecoder(image_size, message_length, channels,
                                   diffusion_length).to(self.device)
        self.optimizers = self._adam()

    def _adam(self) -> Dict[str, AdamW]:
        return {name: AdamW(list(net.parameters()), self.lr,
                            weight_decay=0.0, clip=None)
                for name, net in self.nets().items()}

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {"encoder": self.encoder, "decoder": self.decoder}

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

    def train_step(self, images, messages, draws: MBRSDraws,
                   grads_out: Optional[dict] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on a batch (B, H, W, 3) in [0, 1] and its messages (B,
        L) in {0, 1} with the noise ``draws``; returns the logs as 0-dim
        tensors (no host sync). ``grads_out``, a dict, receives each net's
        gradients (lists in parameter order; under a mesh all-reduced).
        Under a mesh the batch is this rank's rows."""
        images, messages = self.to_device(images, messages)
        enc_p = list(self.encoder.parameters())
        dec_p = list(self.decoder.parameters())
        mesh = self.mesh
        with torch.enable_grad(), full_f32():
            enc, enc_stats = self.encoder(images, messages, train=True,
                                          mesh=mesh)
            noised = mbrs_noise(enc, draws, self.kernels)
            dec, dec_stats = self.decoder(noised, train=True, mesh=mesh)
            l_enc = l2_loss(enc, images)
            l_msg = l2_loss(dec, messages)
            bit_err = bitwise_message_error(dec.detach(), messages)
            l_enc, l_msg, bit_err = global_means((l_enc, l_msg, bit_err),
                                                 mesh)
            loss = self.w_enc * l_enc + self.w_msg * l_msg
            grads = torch.autograd.grad(loss, enc_p + dec_p)
            good = torch.isfinite(loss)
        grads = {"encoder": all_reduce_grads(grads[:len(enc_p)], mesh),
                 "decoder": all_reduce_grads(grads[len(enc_p):], mesh)}
        with torch.no_grad():
            self.optimizers["encoder"].step(grads["encoder"], good)
            self.optimizers["decoder"].step(grads["decoder"], good)
            self.encoder.load_stats(enc_stats, good)
            self.decoder.load_stats(dec_stats, good)
        if grads_out is not None:
            grads_out.update({k: list(v) for k, v in grads.items()})
        return {"loss": loss.detach(), "encoder_mse": l_enc.detach(),
                "message_mse": l_msg.detach(),
                "bitwise_error": bit_err.detach()}

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
    def infer(self, images, messages, draws: MBRSDraws):
        """encode → noise → decode, eval mode: ``(encoded, noised,
        decoded)``."""
        enc = self.encode(images, messages)
        noised = mbrs_noise(enc, draws, self.kernels)
        return enc, noised, self.decode(noised)
