"""The KD-JPEG trainer: a JPEG simulator learnt against a QF classifier and a
discriminator (port of vwfd_tpu/models/kdjpeg_model.py:34-208; the
reference's models/IRNrhi_model.py:425-527).

Three nets, each with its own AdamW (``make_optimizer``): the ``generator``
(``nets/fbcnn.py::FBCNN`` at ``nc`` (32, 64, 128, 256), ``nb`` 4: the
simulator, its FiLM epilogues K23), the ``localizer``
(``QFPredictor(nc, nb=1, classes=6)``: the Bayar-front QF classifier) and
the ``discriminator`` (``nets/discriminator.py``, ``dim`` 32, sigmoid,
spectral norm). A batch is ``LQJpegDataset``'s items flattened
class-major by ``collate``: entry c·B + i is class c of item i, so the
first B are the clean sources and the labels read [0]·B, [1]·B, …

``train_step(real_jpeg, labels, aux_ramp)`` runs JAX's three updates in
its order:

1. the QF classifier: CE(localizer(real_jpeg), labels), its AdamW step;
   its Bayar features of the batch, from the parameters before the step,
   are the target below (detached);
2. the discriminator: ½(BCE(D(real_jpeg), 1) + BCE(D(sim), 0)) on the
   detached simulation, its spectral vectors threaded through the two
   calls (the second starts from the first's), its AdamW step;
3. the generator: ``sim = clamp_with_grad(FBCNN(tile(real[:B], 6),
   label/5))``; L1(sim, real) + ``aux_ramp``·(5·L1(bayar(sim),
   bayar_real)/(1e-3 + mean|bayar_real|) + 0.01·CE(QF(sim), labels) +
   0.01·BCE(D(sim), 1)), with the classifier and the discriminator at
   their UPDATED parameters, frozen (they take no gradient), D's vectors
   read and not written.

JAX runs the generator forward twice with the same parameters (the
detached simulation of step 2 and step 3's); the port runs it once before
step 2 and detaches that output for the discriminator: the same values
and the same gradients, one forward (12 K23 launches at ``nb`` 4) and one
backward (12 more).

Where any of the three losses is not finite, every parameter, Adam moment,
count and spectral vector of the three nets keeps its value (JAX's guard
spans all three, F6): the step snapshots them, updates, and
``torch.where``s them back on the device. The logs: ``lQF``, ``l_simul``,
``l_simul_bayar``, ``qfsimu``, ``FW_GAN``, ``dis_loss``, ``PSSIMU``
(``psnr255_int(sim, real_jpeg)``), 0-dim tensors. ``simulate(images,
qf01)`` is ``clip(FBCNN(images, qf01), 0, 1)``.

Data parallelism (``mesh=``, JAX's ``_kdjpeg_loop``, ``train.py:301-303``):
the loader is not row-sharded; every rank collates the whole class-major
batch and takes its contiguous block of the flat rows (``local_batch``:
JAX's ``device_put(flat, batch_sharding(mesh))``; at 6 images on two
ranks rank 0 holds classes 0-2, rank 1 classes 3-5) with each row's clean
source (row j's is row j mod B, which another rank may hold). The
classifier's CE, the discriminator's loss, the generator's L1, CE and GAN
terms and the PSNR are global means (one all-reduce a net's step), the
Bayar ratio is the global L1 over the global ``1e-3 + mean|bayar_real|``,
each net's gradients (K23's γ and β sums among them) are all-reduced
before its update, and the guard reads the three global losses (F29).
"""

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..config import Config
from ..device import full_f32, resolve_device
from ..kernels import KERNELS, KernelSet
from ..metrics import bce_loss, l1_loss, mse255_int, psnr_from_mse
from ..nets.discriminator import Discriminator
from ..nets.fbcnn import FBCNN, QFPredictor
from ..ops.quantize import clamp_with_grad
from ..parallel import (Mesh, all_reduce_grads, global_means,
                        local_batch_slice)
from .state import AdamW, make_optimizer

__all__ = ["KDJpegModel", "QF_CLASSES"]

QF_CLASSES = 6  # the clean image and LQJpegDataset's five qualities


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels``, meaned."""
    return F.cross_entropy(logits, labels.long())


def _frozen(net: torch.nn.Module, *args):
    """``net(*args)`` with its parameters detached: gradients reach only
    the inputs."""
    params = {k: v.detach() for k, v in net.named_parameters()}
    return functional_call(net, params, args)


class KDJpegModel:
    def __init__(self, cfg: Config, qf_classes: int = QF_CLASSES,
                 size: Optional[int] = None, nc=(32, 64, 128, 256),
                 nb: int = 4, disc_dim: int = 32, device=None,
                 kernels: KernelSet = KERNELS, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.size = size or cfg.data.gt_size
        self.qf_classes = qf_classes
        self.device = resolve_device(device)
        self.kernels = kernels
        self.generator = FBCNN(nc=nc, nb=nb, kernels=kernels).to(self.device)
        self.localizer = QFPredictor(nc=nc, nb=1, classes=qf_classes).to(
            self.device)
        self.discriminator = Discriminator(dim=disc_dim,
                                           use_sigmoid=True).to(self.device)
        self.optimizers = self._adamw()

    def _adamw(self) -> Dict[str, AdamW]:
        return {name: make_optimizer(list(net.parameters()), self.cfg.train)
                for name, net in self.nets().items()}

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {"generator": self.generator, "localizer": self.localizer,
                "discriminator": self.discriminator}

    def init_states(self, seed: int = 0) -> None:
        """Fresh parameters with flax's initialisers' distributions from a
        seeded ``torch.Generator``, ``u`` at ``ones/√n``, fresh AdamW."""
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

    def _tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state: the discriminator's spectral
        vectors, and each net's parameters, Adam moments and count."""
        out = [c.u for c in self.discriminator.sn_convs()]
        for name, net in self.nets().items():
            opt = self.optimizers[name]
            out += [*net.parameters(), *opt.mu, *opt.nu, opt.count]
        return out

    @staticmethod
    def collate(versions, labels, qf_classes: int = QF_CLASSES):
        """An ``LQJpegDataset`` batch ((B, Q+1, H, W, C), (B, Q+1)) →
        the class-major ``(flat (Q+1)·B images, labels)`` ``train_step``
        takes; raises where the batch is not that layout."""
        versions, labels = np.asarray(versions), np.asarray(labels)
        b, q1 = labels.shape
        if q1 != qf_classes:
            raise ValueError(
                f"batch carries {q1} quality classes, model expects "
                f"{qf_classes} (LQJpegDataset qualities + clean)")
        flat = versions.transpose(1, 0, 2, 3, 4).reshape(
            (q1 * b,) + versions.shape[2:])
        lab = labels.T.reshape(-1)
        if not np.array_equal(lab, np.repeat(np.arange(q1), b)):
            raise ValueError(
                "LQ batch labels are not class-major [0]*B,[1]*B,…: "
                f"got {lab[:3 * b]}…")
        return flat, lab

    def local_batch(self, flat, labels):
        """This rank's block of a class-major batch (``collate``'s ``(flat,
        labels)``, numpy): its contiguous rows of the flat images and
        labels (JAX's ``batch_sharding`` blocks) and each row's clean source
        (row j's is row j mod B, B the items); ``(flat, labels, None)``
        without a mesh. A flat batch that does not divide by the world size
        raises."""
        if self.mesh is None:
            return flat, labels, None
        lo, hi = local_batch_slice(len(flat), self.mesh)
        b = len(flat) // self.qf_classes
        return flat[lo:hi], labels[lo:hi], flat[np.arange(lo, hi) % b]

    def to_device(self, *arrays) -> List[torch.Tensor]:
        """Images or labels (numpy or tensors) on the model's device,
        floating ones in the nets' dtype (float32)."""
        dt = self.generator.head.weight.dtype
        out = []
        for a in arrays:
            t = torch.as_tensor(a)
            out.append(t.to(self.device, dt if t.is_floating_point()
                            else t.dtype, non_blocking=True))
        return out

    def train_step(self, real_jpeg, labels, aux_ramp: float = 1.0,
                   grads_out: Optional[dict] = None, sources=None
                   ) -> Dict[str, torch.Tensor]:
        """One step on a class-major batch (``collate``): ``real_jpeg``
        (6B, H, W, 3) in [0, 1], ``labels`` (6B,); returns the logs as 0-dim
        tensors (no host sync). ``grads_out``, a dict, receives each net's
        gradients (lists in parameter order; under a mesh all-reduced).
        Under a mesh the three arrays are this rank's (``local_batch``):
        its rows, their labels and their clean ``sources``."""
        real, labels = self.to_device(real_jpeg, labels)
        mesh = self.mesh
        if sources is None:
            if mesh is not None:
                raise ValueError("under a mesh pass this rank's rows with "
                                 "their sources (local_batch())")
            b6 = real.shape[0]
            if b6 % self.qf_classes:
                raise ValueError(
                    f"batch of {b6} is not divisible by qf_classes="
                    f"{self.qf_classes}; pass a class-major LQ batch "
                    f"(collate())")
            b = b6 // self.qf_classes
            src = real[:b].repeat(self.qf_classes, 1, 1, 1)
        else:
            (src,) = self.to_device(sources)
        gen, loc, disc = self.generator, self.localizer, self.discriminator
        opts = self.optimizers
        with torch.no_grad():
            before = [t.clone() for t in self._tensors()]
        grads = {}
        with torch.enable_grad(), full_f32():
            # 1. the QF classifier
            bayar_real, logits = loc(real)
            (l_qf,) = global_means((_ce(logits, labels),), mesh)
            grads["localizer"] = all_reduce_grads(torch.autograd.grad(
                l_qf, list(loc.parameters())), mesh)
            bayar_real = bayar_real.detach()
            opts["localizer"].step(grads["localizer"])
            # the simulation, once: detached for D, live for the generator
            qf_in = (labels.to(real.dtype)
                     / float(self.qf_classes - 1))[:, None]
            sim = clamp_with_grad(gen(src, qf_in)[0])
            # 2. the discriminator
            sn: dict = {}
            d_real = disc(real, sn=sn)
            disc.load_u(sn)
            d_fake = disc(sim.detach(), sn=sn)
            d_on_real, d_on_fake = global_means(
                (bce_loss(d_real, torch.ones_like(d_real)),
                 bce_loss(d_fake, torch.zeros_like(d_fake))), mesh)
            dis_loss = 0.5 * (d_on_real + d_on_fake)
            grads["discriminator"] = all_reduce_grads(torch.autograd.grad(
                dis_loss, list(disc.parameters())), mesh)
            opts["discriminator"].step(grads["discriminator"])
            disc.load_u(sn)
            # 3. the generator, on the updated classifier and discriminator
            l_simul = l1_loss(sim, real)
            bayar_sim, qf_sim = _frozen(loc, sim)
            bayar_l1 = l1_loss(bayar_sim, bayar_real)
            bayar_mean = torch.mean(torch.abs(bayar_real))
            l_qf_sim = _ce(qf_sim, labels)
            g_fake = _frozen(disc, sim)
            fw_gan = bce_loss(g_fake, torch.ones_like(g_fake))
            with torch.no_grad():
                mse = mse255_int(sim, real)
            l_simul, bayar_l1, bayar_mean, l_qf_sim, fw_gan, mse = \
                global_means((l_simul, bayar_l1, bayar_mean, l_qf_sim,
                              fw_gan, mse), mesh)
            l_bayar = bayar_l1 / (1e-3 + bayar_mean)
            g_total = l_simul + aux_ramp * (5.0 * l_bayar + 0.01 * l_qf_sim
                                            + 0.01 * fw_gan)
            grads["generator"] = all_reduce_grads(torch.autograd.grad(
                g_total, list(gen.parameters())), mesh)
        opts["generator"].step(grads["generator"])
        with torch.no_grad():
            good = (torch.isfinite(l_qf) & torch.isfinite(dis_loss)
                    & torch.isfinite(g_total))
            for t, old in zip(self._tensors(), before):
                t.copy_(torch.where(good, t, old))
            pssimu = psnr_from_mse(mse)
        if grads_out is not None:
            grads_out.update({k: list(v) for k, v in grads.items()})
        logs = {"lQF": l_qf, "l_simul": l_simul, "l_simul_bayar": l_bayar,
                "qfsimu": l_qf_sim, "FW_GAN": fw_gan, "dis_loss": dis_loss}
        return {**{k: v.detach() for k, v in logs.items()},
                "PSSIMU": pssimu}

    @torch.no_grad()
    def simulate(self, images, qf01) -> torch.Tensor:
        """JPEG simulated at normalised quality ``qf01`` ((B, 1) in [0, 1])
        of (B, H, W, 3) images: ``clip(FBCNN(images, qf01), 0, 1)``."""
        images, qf01 = self.to_device(images, qf01)
        with full_f32():
            out, _ = self.generator(images, qf01)
        return torch.clamp(out, 0.0, 1.0)

    @torch.no_grad()
    def classify(self, images) -> torch.Tensor:
        """The QF classifier's class of each image (argmax of its
        logits)."""
        (images,) = self.to_device(images)
        with full_f32():
            _, logits = self.localizer(images)
        return torch.argmax(logits, -1)
