"""Data parallelism of every family but the flagship (HiDDeN, MBRS,
Tianchi, PAMI, ImugeV2, CLR, KD-JPEG) against the one-process port and, for
PAMI and MBRS, JAX's step over conftest's 8-device mesh, on the CPU.

One pair of gloo ranks runs in child processes of this file (``python
tests/test_torch_parallel_families.py ranks DIR``); the children take every
family in turn, each on its rows of the global batch (``parallel.
local_batch_slice``; KD-JPEG's rows of the collated class-major batch,
``KDJpegModel.local_batch``). The parent runs the one-process step of each
family on the whole batch, and the JAX references, from the same weights,
batches and draws while the ranks run. Each family at the tiny widths of its
own step test (``test_torch_mbrs.py``, ``test_torch_hidden.py``,
``test_torch_tianchi.py``, ``test_torch_image_model.py``,
``test_torch_clr.py``, ``test_torch_kdjpeg_step.py``) and with its options:
PAMI's mixed tamper, ImugeV2 with ``use_perceptual`` and the noise branch
(k = 7), CLR with ``with_gan`` and ``with_jpeg_simulator`` on a real-JPEG
pair.

Every family in float32 but HiDDeN and MBRS, which run in float64 as their
step tests do. MBRS: in float32 a hard JPEG step's gradients part by up to
4 % with the rounding of its input (``test_torch_mbrs_step.py``), and in
float64 it is held to JAX's x64 mesh step with that test's tolerances.
HiDDeN: its G step reads the discriminator after D's first Adam update, in
eval mode; a conv bias before a BatchNorm has gradient 0 in exact
arithmetic, so in float32 its rounding noise (1e-9 to 1e-7, its sign set
by the summation order) is near Adam's ε and moves the bias by up to ±lr,
which shifts D's eval-mode logits: the G terms then part by 4e-5 relative
between any two summation orders. In float64 the noise is far below ε and
the update of such a bias vanishes.

Tolerances and why:

* against the one-process port: loss terms within 1e-6 relative (PSNRs
  too: an ulp of float32 at 50 dB is 3.8e-6 dB); every gradient tensor
  within 1e-4 of its max-abs (the same sums in another order; a tensor
  whose exact gradient is 0, a bias before a BatchNorm, within 1e-4 of 1 %
  of its net's max-abs: its own max is rounding noise); BatchNorm
  statistics within 1e-6; eval counts EQUAL; PSNR and SSIM within 1e-6
  relative. For HiDDeN and MBRS the one process runs with flax's
  ``E[x²] − E[x]²`` variance in its train-mode BatchNorm (the global
  path's formula on one process's rows), as ``tests/test_torch_parallel.py``
  explains: ``F.batch_norm``'s variance is another formula, and a
  gradient that cancels parts with it by more than its rounding;
* the ranks against each other: EQUAL after two steps (the same update from
  the same all-reduced gradients), checked by ``parallel.replicas_equal``
  on every state tensor, the frozen VGG trunk's included;
* against JAX's mesh step: ``test_torch_image_model.py``'s tolerances for
  PAMI and ``test_torch_mbrs_step.py``'s for MBRS, for the same reasons.

No test can hang: the group's collectives time out after
``GROUP_TIMEOUT_S``, the children are killed after ``RANKS_TIMEOUT_S``
(``parallel.spawn.LocalRanks``), and the ``with`` block reaps them.
"""

import contextlib
import copy
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from vwfd_tpu_torch import (Config, DataConfig, ModelConfig, TrainConfig,
                            parallel)
from vwfd_tpu_torch import train as train_cli
from vwfd_tpu_torch.attacks import jpeg_real
from vwfd_tpu_torch.convert import states_to_jax
from vwfd_tpu_torch.kernels import PLAIN
from vwfd_tpu_torch.models import (HiddenModel, ImageImmunizationModel,
                                   KDJpegModel, MBRSModel, TianchiModel)
from vwfd_tpu_torch.metrics import psnr255_int
from vwfd_tpu_torch.models.hidden_model import HiddenSampler
from vwfd_tpu_torch.models.image_model import ImageBatch, ImageSampler
from vwfd_tpu_torch.models.tianchi_model import TianchiDraws
from vwfd_tpu_torch.nets import mbrs as mbrs_nets
from vwfd_tpu_torch.nets import unet as unet_mod
from vwfd_tpu_torch.parallel import Mesh
from vwfd_tpu_torch.parallel.spawn import LocalRanks

WORLD = 2
GROUP_TIMEOUT_S = 30.0
RANKS_TIMEOUT_S = 240.0
S = 32
FAMILIES = ("mbrs", "hidden", "tianchi", "pami", "imuge", "clr", "kdjpeg")
EVALS = ("tianchi", "pami", "imuge", "clr")
BN_FAMILIES = ("hidden", "mbrs")
F64 = ("hidden", "mbrs")  # float64, as their step tests
# the global batch of each family (PAMI and MBRS: 8, for JAX's 8 devices)
B = {"mbrs": 8, "hidden": 4, "tianchi": 4, "pami": 8, "imuge": 4, "clr": 4,
     "kdjpeg": 6}
MBRS_KW = dict(image_size=S, channels=8, blocks=2, diffusion_length=16)
SUNET = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=4)
KD_NETS = dict(nc=(8, 8, 16, 16), nb=2, disc_dim=8)
IMAGE_MODEL = dict(inn_down_num=2, inn_block_num=(1, 1), inn_haar="mixed",
                   localizer_residual_blocks=1, attack_ratios=(0.5, 1.0, 1.5))
IMAGE_LR = 1e-4
IMAGE_OPTIONS = {"pami": dict(task="pami", tamper_mode="mixed"),
                 "imuge": dict(task="imuge", use_perceptual=True),
                 "clr": dict(task="clr", with_gan=True,
                             with_jpeg_simulator=True)}
IMAGE_K = {"pami": 6, "imuge": 7, "clr": 6}  # imuge: the noise branch
HEAD_PERTURB = 2e-4
_PLAIN_BN = unet_mod._bn


# ------------------------------------------------------------- the families


def _image_cfg(fam):
    return Config(data=DataConfig(gt_size=S, batch_size=B[fam]),
                  model=ModelConfig(n_attacks=IMAGE_K[fam], **IMAGE_MODEL),
                  train=TrainConfig(lr=IMAGE_LR, dtype="float32"))


def _model(fam, seed, mesh=None):
    """The family's model at its step test's widths, weights from
    ``seed`` (the image family's INN heads perturbed, so that the reverse
    pass and every coupling take gradients; HiDDeN and MBRS in float64)."""
    if fam in F64:
        model = (MBRSModel(device="cpu", mesh=mesh, **MBRS_KW)
                 if fam == "mbrs" else
                 HiddenModel(image_size=S, device="cpu", mesh=mesh))
        model.init_states(seed)
        for net in model.nets().values():
            net.double()
        model.optimizers = model._adam()
    elif fam == "tianchi":
        cfg = Config(data=DataConfig(gt_size=S, batch_size=B[fam]),
                     train=TrainConfig(lr=2.0 ** -13))
        model = TianchiModel(cfg, device="cpu", mesh=mesh, **SUNET)
        model.init_states(seed)
    elif fam == "kdjpeg":
        cfg = Config(data=DataConfig(gt_size=S, batch_size=B[fam]))
        model = KDJpegModel(cfg, device="cpu", mesh=mesh, **KD_NETS)
        model.init_states(seed)
    else:
        model = ImageImmunizationModel(_image_cfg(fam), device="cpu",
                                       kernels=PLAIN, mesh=mesh,
                                       **IMAGE_OPTIONS[fam])
        model.init_states(seed)
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name, p in model.netG.named_parameters():
                if name.endswith(("Conv_4.weight", "Conv_4.bias")):
                    p.add_(HEAD_PERTURB * torch.randn(p.shape, generator=gen))
    return model


def _state(model):
    """Every state tensor by name: parameters, buffers (BatchNorm
    statistics, spectral vectors), the frozen nets', AdamW moments and
    counts."""
    out = {}
    nets = {**model.nets(), **getattr(model, "frozen_nets", dict)()}
    for net_name, net in nets.items():
        for k, v in list(net.named_parameters()) + list(net.named_buffers()):
            out[f"{net_name}.{k}"] = v.detach().clone()
    for net_name, opt in model.optimizers.items():
        names = [k for k, _ in model.nets()[net_name].named_parameters()]
        for key in ("mu", "nu"):
            for k, v in zip(names, getattr(opt, key)):
                out[f"{net_name}.{key}.{k}"] = v.clone()
        out[f"{net_name}.count"] = opt.count.clone()
    return out


def _grid_images(rng, n, top=255):
    """Images a quarter level above the 8-bit grid (below ``top``)."""
    return ((rng.integers(0, top, (n, S, S, 3)) + 0.25) / 255.0
            ).astype(np.float32)


def _image_inputs(fam, rng, draws_of):
    """Three steps' batches (the third with an Inf pixel in the last
    image: rank 1's), an eval batch and each one's draws."""
    b = B[fam]
    out = {}
    for i in (1, 2, 3, 4):
        mask = np.zeros((b, S, S, 1), np.float32)
        for j in range(b):
            y, x = rng.integers(0, S // 2, 2)
            mask[j, y:y + S // 2, x:x + S // 3] = 1.0
        img = _grid_images(rng, b)
        out[i] = dict(img=img, canny=(rng.random((b, S, S, 1)) > 0.85
                                      ).astype(np.float32),
                      mask=mask, prev=_grid_images(rng, b),
                      draws=draws_of(i))
        if fam == "clr":
            q = (50, 70, 90, 60)[i - 1]
            out[i]["pair"] = (jpeg_real(img, q),
                              np.full((b,), q / 100.0, np.float32))
    out[3]["img"][b - 1, 3, 5, 1] = np.inf
    return out


def _inputs(jax_draws):
    """Every family's batches and draws, from fixed seeds; ``jax_draws``
    (made by the parent from JAX keys) gives PAMI's and MBRS's."""
    rng = np.random.default_rng(26)
    inp = {}
    b = B["mbrs"]
    inp["mbrs"] = {i: dict(img=rng.random((b, S, S, 3)),
                           msg=(rng.random((b, 30)) > 0.5).astype(np.float64),
                           draws=jax_draws["mbrs"][i]) for i in (1, 2, 3)}
    inp["mbrs"][3]["img"][b - 1, 4, 4, 0] = np.inf
    b = B["hidden"]
    members = {1: "gaussian", 2: "dropout", 3: "crop"}
    inp["hidden"] = {i: dict(img=_grid_images(rng, b),
                             msg=(rng.random((b, 30)) > 0.5).astype(
                                 np.float32),
                             draws=HiddenSampler(26 + i, "cpu")(
                                 (b, S, S, 3), members[i]))
                     for i in (1, 2, 3)}
    inp["hidden"][3]["img"][b - 1, 6, 2, 2] = np.inf
    b = B["tianchi"]
    inp["tianchi"] = {i: dict(img=rng.random((b, S, S, 3), dtype=np.float32),
                              mask=(rng.random((b, S, S, 1)) > 0.6).astype(
                                  np.float32),
                              draws=TianchiDraws(i % 4, i % 3))
                      for i in (1, 2, 3, 4)}
    inp["tianchi"][3]["img"][b - 1, 1, 1, 0] = np.inf
    inp["pami"] = _image_inputs("pami", rng, lambda i: jax_draws["pami"][i])
    for fam in ("imuge", "clr"):
        sampler = ImageSampler(26, IMAGE_K[fam], 3, apex=fam == "clr",
                               sim=fam == "clr")
        inp[fam] = _image_inputs(fam, rng,
                                 lambda i: sampler((B[fam], S, S)))
    versions = rng.random((3, 1, 6, S, S, 3), dtype=np.float32)
    inp["kdjpeg"] = {i + 1: dict(zip(("flat", "lab"), KDJpegModel.collate(
        versions[i], np.tile(np.arange(6), (1, 1))))) for i in range(3)}
    inp["kdjpeg"][3]["flat"][5, 2, 2, 0] = np.inf
    inp["gate"] = _gate_inputs(rng)
    return inp


def _gate_inputs(rng):
    """The gates' batches: PAMI's (8 images) and CLR's (4), images below
    level 200 (no shift reaches 1), and the shifts of the forward and the
    reverse: rank 0's rows by one level at a few pixels (PSNR far above 35
    dB), rank 1's by 20 levels everywhere (far below); CLR's reverse 10
    levels off on rank 0, 20 on rank 1, so that the global PF − PB is
    0.97 dB while rank 0's alone is far above 1 dB. PAMI's masks cover 10
    % of rank 0's images and 40 % of rank 1's (25 % in all, above the
    0.2 gate)."""
    out = {}
    for fam in ("pami", "clr"):
        b, h = B[fam], B[fam] // 2
        se = np.zeros((b, S, S, 3), np.float32)
        se[:h, ::7, ::5] = 1.0 / 255
        se[h:] = 20.0 / 255
        sb = np.full((b, S, S, 3), 10.0 / 255, np.float32)
        sb[h:] = 20.0 / 255
        mask = np.zeros((b, S, S, 1), np.float32)
        mask[:h, :S // 4, :int(S * 0.4)] = 1.0   # 10 %
        mask[h:, :int(S * 0.4), :] = 1.0         # 40 % (12.8 rows → 12)
        mask[h:, 12, :S // 2] = 1.0
        out[fam] = dict(img=_grid_images(rng, b, top=200), se=se, sb=sb,
                        canny=(rng.random((b, S, S, 1)) > 0.85).astype(
                            np.float32),
                        mask=mask, prev=_grid_images(rng, b, top=200))
    return out


@contextlib.contextmanager
def _default_dtype(dt):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dt)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _rows(mesh):
    def take(x):
        if x is None or mesh is None:
            return x
        lo, hi = parallel.local_batch_slice(len(x), mesh)
        return x[lo:hi]
    return take


def _step(fam, model, d, mesh, grads=None):
    """One train step of ``fam`` on this process's rows of batch ``d``."""
    r = _rows(mesh)
    if fam == "mbrs":
        return model.train_step(r(d["img"]), r(d["msg"]), d["draws"], grads)
    if fam == "hidden":
        return model.train_step(r(d["img"]), r(d["msg"]),
                                d["draws"].rows(mesh), grads)
    if fam == "tianchi":
        out = [] if grads is not None else None
        logs = model.train_step(r(d["img"]), r(d["mask"]), d["draws"], out)
        if grads is not None:
            grads.update(ce=out[0], ce1=out[1])
        return logs
    if fam == "kdjpeg":
        flat, lab, src = model.local_batch(d["flat"], d["lab"])
        return model.train_step(flat, lab, grads_out=grads, sources=src)
    pair = d.get("pair")
    if pair is not None:
        pair = tuple(r(x) for x in pair)
    return model.train_step(ImageBatch(r(d["img"]), r(d["canny"]),
                                       r(d["mask"])), r(d["prev"]),
                            d["draws"].rows(mesh), grads, jpeg_pair=pair)


def _eval(fam, model, d, mesh):
    r = _rows(mesh)
    if fam == "tianchi":
        out = model.eval_step(r(d["img"]), r(d["mask"]))
    else:
        out = model.eval_step(ImageBatch(r(d["img"]), r(d["canny"]),
                                         r(d["mask"])), r(d["prev"]),
                              d["draws"].rows(mesh))
    return {k: v.clone() for k, v in out.items()
            if k not in ("predicted", "recovered", "predicted_mask")}


def _floats(logs):
    return {k: float(v) for k, v in logs.items()}


def _scenario(fam, model, inp, mesh=None):
    """What the ranks and the one process both run from ``model``
    (replicated): a step (its gradients kept), an eval step, a second
    step, a step on a batch with an Inf pixel in its last image."""
    out = {"state0": _state(model)}
    grads = {}
    out["logs1"] = _floats(_step(fam, model, inp[1], mesh, grads))
    out["grads1"] = {k: [g.clone() for g in v] for k, v in grads.items()}
    out["state1"] = _state(model)
    if fam in ("pami", "mbrs"):  # numpy views of the tensors: copied
        out["trees1"] = copy.deepcopy(states_to_jax(model))
    if fam in EVALS:
        out["eval"] = _eval(fam, model, inp[4], mesh)
    out["logs2"] = _floats(_step(fam, model, inp[2], mesh))
    out["state2"] = _state(model)
    out["equal2"] = parallel.replicas_equal(model, mesh)
    out["guard_logs"] = _floats(_step(fam, model, inp[3], mesh))
    after = _state(model)
    out["guard_kept"] = all(torch.equal(after[k], v)
                            for k, v in out["state2"].items())
    return out


def _gate(fam, model, g, mesh=None):
    """The loss of a PAMI or CLR model whose embed is ``image + se`` (a
    zero null channel) and, for CLR, whose reverse is ``image + sb``: the
    terms that read the gates, this process's PSNRs of its rows alone and
    its rows' tamper share."""
    r = _rows(mesh)
    img, canny, mask, prev = (torch.from_numpy(r(g[k])) for k in
                              ("img", "canny", "mask", "prev"))
    se, sb = torch.from_numpy(r(g["se"])), torch.from_numpy(r(g["sb"]))
    k = model.n_attacks + (model.jpeg_sim is not None)
    model._embed = lambda x, wm: (x + se, torch.zeros_like(wm))
    if fam == "clr":
        model._reverse = lambda rect: torch.cat(
            [(img + sb).repeat(k, 1, 1, 1), canny.repeat(k, 1, 1, 1)], -1)
    draws = ImageSampler(5, model.n_attacks, 3, apex=fam == "clr",
                         sim=model.jpeg_sim is not None)((B[fam], S, S))
    draws = draws._replace(use_cm=False).rows(mesh)
    with torch.no_grad():
        loss, aux = model._loss(img, model.watermark(canny, prev), mask,
                                prev, draws, {}, {})
        local = {"PF": float(psnr255_int(img, img + se)),
                 "PB": float(psnr255_int(img, torch.clamp(img + sb, 0, 1))),
                 "mean_mask": float(mask.mean())}
    return {"loss": float(loss), **_floats(aux), "local": local}


def _run_all(inp, seed, mesh=None):
    out = {}
    for fam in FAMILIES:
        dt = torch.float64 if fam in F64 else torch.float32
        with _default_dtype(dt):
            model = _model(fam, seed, mesh)
            if mesh is not None:
                if fam == "imuge" and mesh.rank == 1:
                    with torch.no_grad():  # the frozen trunk too
                        next(model.vgg.parameters()).add_(1.0)
                out[fam + "_equal_before"] = parallel.replicas_equal(
                    model, mesh)
                parallel.replicate(model, mesh)
            out[fam] = _scenario(fam, model, inp[fam], mesh)
    for fam in ("pami", "clr"):
        model = _model(fam, seed, mesh)
        parallel.replicate(model, mesh)
        out["gate_" + fam] = _gate(fam, model, inp["gate"][fam], mesh)
    return out


def _ranks_child(out_dir):
    """One rank (run by ``LocalRanks``): each family from a rank-seeded
    model, replicated, on its rows; everything to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    rank = parallel.maybe_init_distributed("cpu", timeout_s=GROUP_TIMEOUT_S)
    mesh = parallel.make_mesh()
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    out = _run_all(inp, 100 * rank, mesh)
    out["rank"] = rank
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _ranks_env():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _flax_form_bn(x, bn, stats=None):
    """``_bn`` with flax's batch variance in train mode (the global path's
    formula on this process's rows)."""
    if stats is None:
        return _PLAIN_BN(x, bn)
    return unet_mod._bn_global(x, bn, stats)


# ------------------------------------------------------------- the JAX side


def _jax_draws():
    """PAMI's train draws from JAX keys (``test_torch_image_model.py``'s
    split sequence) and MBRS's (under x64, where its step runs), with the
    keys."""
    import jax
    from test_torch_image_model import train_draws
    from test_torch_mbrs_step import jax_mbrs_draws

    keys = {i: jax.random.PRNGKey(60 + i) for i in (1, 2, 3, 4)}
    pami = {i: train_draws(keys[i]) for i in keys}
    with jax.enable_x64(True):
        mbrs = {i: jax_mbrs_draws(keys[i]) for i in (1, 2, 3)}
    return {"pami": pami, "mbrs": mbrs}, keys


def _jax_pami_mesh_step(inp, key):
    """JAX's PAMI ``train_step`` from the parent's weights, the states
    replicated and the batch sharded over conftest's 8-device mesh (XLA's
    all-reduces), compiled as ``test_torch_image_model.py`` compiles it."""
    import jax.numpy as jnp
    from test_torch_image_model import _jax, _jstates

    from vwfd_tpu.config import Config as JConfig
    from vwfd_tpu.config import DataConfig as JDataConfig
    from vwfd_tpu.config import ModelConfig as JModelConfig
    from vwfd_tpu.config import TrainConfig as JTrainConfig
    from vwfd_tpu.models.image_model import ImageBatch as JBatch
    from vwfd_tpu.models.image_model import ImageImmunizationModel as JImage
    from vwfd_tpu.parallel import make_mesh, replicate, shard_batch

    mesh = make_mesh(8)
    jcfg = JConfig(data=JDataConfig(gt_size=S, batch_size=B["pami"]),
                   model=JModelConfig(n_attacks=IMAGE_K["pami"],
                                      **IMAGE_MODEL),
                   train=JTrainConfig(lr=IMAGE_LR, dtype="float32"))
    jmodel = JImage(jcfg, task="pami", tamper_mode="mixed")
    trees = states_to_jax(_model("pami", 0))
    d = inp["pami"][1]
    img, canny, mask, prev = shard_batch(
        tuple(d[k] for k in ("img", "canny", "mask", "prev")), mesh)
    new, logs = _jax("train_step", jmodel,
                     replicate(_jstates(jmodel, trees), mesh),
                     JBatch(img, canny, mask), prev, key)
    return new, {k: float(v) for k, v in logs.items()
                 if jnp.ndim(v) == 0}


def _jax_mbrs_mesh_step(inp, key):
    """JAX's MBRS ``train_step`` in float64 (x64, its DCT unpinned, as
    ``test_torch_mbrs_step.py``) from the parent's weights over
    conftest's 8-device mesh."""
    import functools

    import jax
    import jax.numpy as jnp
    from test_torch_mbrs import TOOL
    from test_torch_mbrs_step import _f64_tree, _UnpinnedJnp

    from vwfd_tpu.models.mbrs_model import MBRSModel as JMBRS
    from vwfd_tpu.models.state import NetState
    from vwfd_tpu.ops import dct as jdct
    from vwfd_tpu.parallel import make_mesh, replicate, shard_batch

    with _default_dtype(torch.float64):
        trees = states_to_jax(_model("mbrs", 0))
    jmodel = JMBRS(**MBRS_KW)
    d = inp["mbrs"][1]
    with mock.patch.object(jdct, "jnp", _UnpinnedJnp()), \
            jax.enable_x64(True):
        mesh = make_mesh(8)
        states = {name: NetState.create(
            getattr(jmodel, name).apply, trees[name]["params"],
            {"batch_stats": trees[name]["batch_stats"]}, jmodel.tx)
            for name in ("encoder", "decoder")}
        states = replicate(_f64_tree(states), mesh)
        images, msgs = shard_batch((d["img"], d["msg"]), mesh)
        args = (states, images, msgs, key)
        fn = functools.partial(JMBRS.train_step.__wrapped__, jmodel)
        new, logs = jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_disable_hlo_passes": "algsimp"})(*args)
        return TOOL.trees_of(new), {k: float(v) for k, v in logs.items()}


# ------------------------------------------------------------------ fixture


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results, the one-process port's and the JAX mesh
    steps', from the same weights, batches and draws."""
    torch.set_num_threads(1)
    out_dir = str(tmp_path_factory.mktemp("family_ranks"))
    draws, keys = _jax_draws()
    inp = _inputs(draws)
    torch.save(inp, os.path.join(out_dir, "inputs.pt"))
    cmd = [sys.executable, os.path.abspath(__file__), "ranks", out_dir]
    with LocalRanks(cmd, WORLD, env=_ranks_env()) as ranks:
        # the references run while the ranks do
        one = _run_all(inp, 0)
        with mock.patch.object(unet_mod, "_bn", _flax_form_bn), \
                mock.patch.object(mbrs_nets, "_bn", _flax_form_bn):
            flax_form = {}
            for fam in BN_FAMILIES:
                dt = torch.float64 if fam in F64 else torch.float32
                with _default_dtype(dt):
                    flax_form[fam] = _scenario(fam, _model(fam, 0),
                                               inp[fam])
                    # the first rank's rows alone (no mesh, no all-reduce)
                    half = {i: {k: (v[:B[fam] // 2]
                                    if k in ("img", "msg") else v)
                                for k, v in d.items()} for i, d in
                            inp[fam].items()}
                    half[1]["draws"] = half[1]["draws"].rows(
                        Mesh(None, 0, WORLD)) if fam == "hidden" \
                        else half[1]["draws"]
                    m = _model(fam, 0)
                    _step(fam, m, half[1], None)
                    flax_form[fam + "_half"] = _state(m)
        jax_ref = {"pami": _jax_pami_mesh_step(inp, keys[1]),
                   "mbrs": _jax_mbrs_mesh_step(inp, keys[1])}
        ranks.wait(RANKS_TIMEOUT_S)
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                      weights_only=False) for r in range(WORLD)]
    return got, one, flax_form, jax_ref


def _ref(fam, one, flax_form):
    return flax_form[fam] if fam in BN_FAMILIES else one[fam]


def _close(a, b, rel, what, floor=0.0):
    """``a`` within ``rel`` of ``b``'s max-abs (at least ``floor``)."""
    scale = max(float(b.abs().max()), floor) or 1.0
    err = float((a.double() - b.double()).abs().max())
    assert err <= rel * scale, (what, err, scale)


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("fam", FAMILIES)
def test_replicate_and_two_steps_leave_the_ranks_bit_equal(world, fam):
    """Differently seeded ranks (ImugeV2's frozen VGG trunk moved on rank
    1) are made equal by ``replicate``; after two steps every state tensor
    is bit-equal across the ranks and their logs are too."""
    got, one, _, _ = world
    assert not any(g[fam + "_equal_before"] for g in got)
    for g in got:
        assert g[fam]["equal2"]
        for k, v in one[fam]["state0"].items():  # rank 0's seed 0
            assert torch.equal(g[fam]["state0"][k], v), k
    a, b = got[0][fam], got[1][fam]
    assert a["logs1"] == b["logs1"] and a["logs2"] == b["logs2"]
    for k, v in a["state2"].items():
        assert torch.equal(b["state2"][k], v), k


@pytest.mark.parametrize("fam", FAMILIES)
def test_step_matches_the_one_process_step(world, fam):
    """Loss terms within 1e-6 relative, every gradient tensor within 1e-4
    of its max-abs, every net's count 1, BatchNorm statistics within
    1e-6."""
    got, one, flax_form, _ = world
    ref = _ref(fam, one, flax_form)
    assert ref["logs1"].keys() == got[0][fam]["logs1"].keys()
    for g in got:
        for k, v in ref["logs1"].items():
            assert abs(g[fam]["logs1"][k] - v) <= 1e-6 * abs(v), \
                (k, g[fam]["logs1"][k], v)
        assert g[fam]["grads1"].keys() == ref["grads1"].keys()
        for name, want in ref["grads1"].items():
            assert len(g[fam]["grads1"][name]) == len(want)
            # a bias before a BatchNorm has gradient 0: its max-abs is
            # rounding noise, so no tensor's scale is under 1 % of its net's
            floor = 1e-2 * max(float(w.abs().max()) for w in want)
            for i, (a, w) in enumerate(zip(g[fam]["grads1"][name], want)):
                _close(a, w, 1e-4, f"{fam} {name} gradient {i}", floor)
        for k, v in ref["state1"].items():
            w = g[fam]["state1"][k]
            if k.endswith(".count"):
                assert torch.equal(w, v) and int(v) >= 1, k
            elif "running_" in k:
                assert float((w - v).abs().max()) <= 1e-6, k


@pytest.mark.parametrize("fam", BN_FAMILIES)
def test_batchnorm_moments_are_global(world, fam):
    """F27: every BatchNorm's running statistics after a step (HiDDeN's
    encoder, decoder and its discriminator's two train-mode forwards;
    MBRS's SE blocks) are the global batch's, not a rank's own rows'."""
    got, _, flax_form, _ = world
    ref, half = flax_form[fam]["state1"], flax_form[fam + "_half"]
    stats = [k for k in ref if "running_" in k]
    assert len(stats) > 10
    apart = 0.0
    for k in stats:
        for g in got:
            assert float((g[fam]["state1"][k] - ref[k]).abs().max()) \
                <= 1e-6, k
        apart = max(apart, float((half[k] - ref[k]).abs().max()))
    assert apart > 1e-3  # one rank's rows alone give other moments


@pytest.mark.parametrize("fam", EVALS)
def test_eval_counts_and_metrics_are_global(world, fam):
    """F30: the F1 sweeps EQUAL to the one process's (int64 counts summed
    over the ranks), the PSNRs and SSIM within 1e-6 relative."""
    got, one, _, _ = world
    want = one[fam]["eval"]
    for g in got:
        ev = g[fam]["eval"]
        assert ev.keys() == want.keys()
        for k, w in want.items():
            if k.startswith("f1"):
                assert torch.equal(ev[k], w), k
            else:
                _close(ev[k], w, 1e-6, k)


@pytest.mark.parametrize("fam", FAMILIES)
def test_inf_pixel_on_one_rank_keeps_every_state_on_both(world, fam):
    """F29: an Inf pixel in rank 1's rows alone makes the global loss
    non-finite on both ranks, and both keep every state tensor."""
    got, one, _, _ = world
    for res in [g[fam] for g in got] + [one[fam]]:
        assert not all(np.isfinite(v) for v in res["guard_logs"].values())
        assert res["guard_kept"]


@pytest.mark.parametrize("fam", ("pami", "clr"))
def test_gates_read_global_values(world, fam):
    """F28: rank 0's rows lie far above the 35 dB gate and rank 1's far
    below; PAMI's tamper share is 10 % on rank 0 and 40 % on rank 1 (25 %
    in all, above the 0.2 gate); CLR's PF − PB is far above 1 dB on rank 0
    and 0.97 dB over the global batch. Both ranks take the global values'
    weights: their loss is the one process's, which rank 0's own values
    would change (its alpha_f, local_w or alpha_b)."""
    got, one, _, _ = world
    want = one["gate_" + fam]
    a, b = (g["gate_" + fam] for g in got)
    assert a["local"]["PF"] > 35 > b["local"]["PF"] > 0
    assert a["PF"] == b["PF"] < 35
    if fam == "pami":
        assert a["local"]["mean_mask"] < 0.2 < b["local"]["mean_mask"]
        assert abs(want["l_mask"] - a["l_mask"]) <= 1e-6 * want["l_mask"]
    else:
        assert a["local"]["PF"] - a["local"]["PB"] > 1.0
        assert 0 < a["PF"] - a["PB"] < 1.0
    for g in (a, b):
        for k in ("loss", "lF", "lB", "PF", "PB"):
            assert abs(g[k] - want[k]) <= 1e-6 * abs(want[k]), (k, g, want)


def _leaves(tree):
    import jax
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_pami_matches_jax_mesh_step(world):
    """The ranks' PAMI step against JAX's over 8 devices, at
    ``test_torch_image_model.py``'s tolerances: loss terms 1e-5 relative,
    PF and PB 1e-3 dB, parameters 2.1·lr, mu 1e-3 and nu 2e-3 of each
    tensor's max-abs, the count EQUAL, the spectral vectors 1e-5."""
    from test_torch_image_model import _adam_of
    got, _, _, jax_ref = world
    new, jlogs = jax_ref["pami"]
    for g in got:
        logs, trees = g["pami"]["logs1"], g["pami"]["trees1"]
        for k in ("loss", "lF", "lB", "l_mask", "NULL"):
            np.testing.assert_allclose(logs[k], jlogs[k], rtol=1e-5,
                                       err_msg=k)
        for k in ("PF", "PB"):
            assert abs(logs[k] - jlogs[k]) <= 1e-3, k
        for net in ("netG", "localizer"):
            adam = _adam_of(new[net])
            assert int(trees[net]["count"]) == int(adam.count) == 1
            for what, want_tree, tol in (("params", new[net].params, None),
                                         ("mu", adam.mu, 1e-3),
                                         ("nu", adam.nu, 2e-3)):
                want, have = _leaves(want_tree), _leaves(trees[net][what])
                assert set(want) == set(have)
                for path, w in want.items():
                    atol = 2.1 * IMAGE_LR if tol is None else tol * float(
                        np.abs(w).max())
                    np.testing.assert_allclose(
                        have[path], w, rtol=0, atol=atol,
                        err_msg=f"{net} {what} {path}")
        want = _leaves(new["localizer"].variables["spectral"])
        have = _leaves(trees["localizer"]["spectral"])
        assert set(want) == set(have) and want
        for path, w in want.items():
            np.testing.assert_allclose(have[path], w, rtol=0, atol=1e-5,
                                       err_msg=f"u {path}")


def test_mbrs_matches_jax_mesh_step(world):
    """The ranks' MBRS step (float64) against JAX's x64 step over 8
    devices, at ``test_torch_mbrs_step.py``'s tolerances: loss terms 1e-9
    relative, the bit errors' counts EQUAL, each gradient (as the first
    moment, 0.1·g) within 1e-7 of its net's max, parameters within
    1e-3·lr, BatchNorm statistics within 1e-10 (JAX's are the global
    batch's: F27), the count EQUAL."""
    from test_torch_mbrs_step import (GRAD_REL, LOSS_RTOL, PARAM_ATOL,
                                      STATS_ATOL)
    got, _, _, jax_ref = world
    want, jlogs = jax_ref["mbrs"]
    n_bits = B["mbrs"] * 30
    for g in got:
        logs, trees = g["mbrs"]["logs1"], g["mbrs"]["trees1"]
        for k in ("loss", "encoder_mse", "message_mse"):
            np.testing.assert_allclose(logs[k], jlogs[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        assert round(logs["bitwise_error"] * n_bits) == round(
            jlogs["bitwise_error"] * n_bits)
        for name in ("encoder", "decoder"):
            mus = _leaves(want[name]["mu"])
            net_max = max(float(np.abs(w).max()) for w in mus.values())
            have = _leaves(trees[name]["mu"])
            for path, w in mus.items():
                np.testing.assert_allclose(have[path], w, rtol=0,
                                           atol=GRAD_REL * net_max,
                                           err_msg=f"mu {name}{path}")
            for what, atol in (("params", PARAM_ATOL),
                               ("batch_stats", STATS_ATOL)):
                w_t, h_t = _leaves(want[name][what]), _leaves(
                    trees[name][what])
                assert set(w_t) == set(h_t)
                for path, w in w_t.items():
                    np.testing.assert_allclose(h_t[path], w, rtol=0,
                                               atol=atol,
                                               err_msg=f"{what} {path}")
            assert int(trees[name]["count"]) == int(want[name]["count"]) == 1


# ----------------------------------------------------- row-takers (no ranks)


def _mesh(rank, size=WORLD):
    return Mesh(None, rank, size)


@pytest.mark.parametrize("member", ["gaussian", "dropout", "crop", "cropout",
                                    "identity"])
def test_hidden_draws_rows(member):
    """``HiddenDraws.rows``: gaussian's (B, H, W, 3) field is the rank's
    block of the global draw; dropout's (H, W) field, even where H divides
    by the world size, and every ``u`` stay whole."""
    glob = HiddenSampler(3, "cpu")((8, S, S, 3), member)
    for r in range(WORLD):
        mine = glob.rows(_mesh(r))
        assert mine.member == member
        for name in ("u", "field"):
            g, m = getattr(glob, name), getattr(mine, name)
            if g is None:
                assert m is None
            elif member == "gaussian" and name == "field":
                assert torch.equal(m, g[4 * r:4 * r + 4])
            else:
                assert torch.equal(m, g)
    assert glob.rows(None) is glob


def test_image_draws_rows():
    """``ImageDraws.rows``: only the noise branches are sliced; the shift,
    the mixed mode's choice, the JPEG and resize draws, CLR's window and
    the simulator's quality are one draw a batch."""
    glob = ImageSampler(4, 14, 3, apex=True, sim=True)((8, S, S))
    noise = [i for i in range(14) if i % 7 == 6]
    assert len(noise) == 2
    for r in range(WORLD):
        mine = glob.rows(_mesh(r))
        assert (mine.shift, mine.use_cm, mine.sim_q) == \
            (glob.shift, glob.use_cm, glob.sim_q)
        assert np.array_equal(mine.apex_u, glob.apex_u)
        for i, (m, g) in enumerate(zip(mine.branch, glob.branch)):
            if i in noise:
                assert np.array_equal(m, g[4 * r:4 * r + 4])
            else:
                assert m == g
    assert glob.rows(None) is glob


def test_loop_messages_and_stroke_masks_are_rows_of_the_global_draw():
    """The message loop's messages and the image loop's stroke masks on a
    rank are its rows of what the one process draws for the global batch,
    the generators left where the one process leaves them."""
    one = np.random.default_rng(7)
    want = [train_cli._messages(one, 8, 30, (0, 8)) for _ in range(2)]
    for r in range(WORLD):
        rows = parallel.local_batch_slice(8, _mesh(r))
        rng = np.random.default_rng(7)
        for w in want:
            assert np.array_equal(train_cli._messages(rng, 8, 30, rows),
                                  w[rows[0]:rows[1]])
        masks = train_cli._strokes((7, 3), 8, S, rows)
        assert np.array_equal(masks, train_cli._strokes((7, 3), 8, S,
                                                         (0, 8))[rows[0]:
                                                                 rows[1]])


@pytest.mark.parametrize("items,world_size", [(1, 2), (8, 2), (8, 8)])
def test_kdjpeg_rows_are_jax_blocks_of_the_collated_batch(items, world_size):
    """``KDJpegModel.local_batch``: each rank's rows are the block JAX's
    ``jax.device_put(flat, batch_sharding(mesh))`` gives its device, with
    their labels; each row's source is the clean image of its item. At
    one item on two ranks rank 0 holds classes 0-2 and rank 1 classes
    3-5."""
    import jax

    from vwfd_tpu.parallel import batch_sharding, make_mesh

    rng = np.random.default_rng(items)
    versions = rng.random((items, 6, 8, 8, 3), dtype=np.float32)
    flat, lab = KDJpegModel.collate(versions, np.tile(np.arange(6),
                                                      (items, 1)))
    sharding = batch_sharding(make_mesh(world_size))
    blocks = [np.asarray(s.data) for s in sorted(
        jax.device_put(flat, sharding).addressable_shards,
        key=lambda s: s.index[0].start or 0)]
    lab_blocks = [np.asarray(s.data) for s in sorted(
        jax.device_put(lab, sharding).addressable_shards,
        key=lambda s: s.index[0].start or 0)]
    cfg = Config(data=DataConfig(gt_size=8, batch_size=6 * items))
    for r in range(world_size):
        model = KDJpegModel(cfg, device="cpu", mesh=_mesh(r, world_size),
                            **KD_NETS)
        rows, labels, src = model.local_batch(flat, lab)
        assert np.array_equal(rows, blocks[r])
        assert np.array_equal(labels, lab_blocks[r])
        n = len(rows)
        item = (np.arange(r * n, (r + 1) * n)) % items
        assert np.array_equal(src, versions[item, 0])
    if items == 1:
        assert list(lab_blocks[0]) == [0, 1, 2]
        assert list(lab_blocks[1]) == [3, 4, 5]


def test_a_batch_that_does_not_divide_by_the_world_size_raises():
    """KD-JPEG's flat batch of 6 on 4 ranks, and an image batch of 6 on 4
    ranks; without a mesh ``local_batch`` passes the batch through, and
    under one ``train_step`` wants the rows' sources."""
    cfg = Config(data=DataConfig(gt_size=8, batch_size=6))
    flat = np.zeros((6, 8, 8, 3), np.float32)
    lab = np.repeat(np.arange(6), 1)
    model = KDJpegModel(cfg, device="cpu", mesh=_mesh(1, 4), **KD_NETS)
    with pytest.raises(ValueError, match="divide"):
        model.local_batch(flat, lab)
    with pytest.raises(ValueError, match="sources"):
        model.train_step(flat[:3], lab[:3])
    plain = KDJpegModel(cfg, device="cpu", **KD_NETS)
    f, la, src = plain.local_batch(flat, lab)
    assert f is flat and la is lab and src is None
    with pytest.raises(ValueError, match="divide"):
        parallel.local_batch_slice(6, _mesh(0, 4))


@contextlib.contextmanager
def _world1(tmp_path):
    """A world-1 gloo group in this process, and its mesh."""
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, rank=0,
                                         world_size=1)
    try:
        yield parallel.make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_global_means_is_one_collective_and_the_identity_without_a_mesh(
        tmp_path, monkeypatch):
    """``global_means`` returns its tensors as they are without a mesh;
    over a group it all-reduces the stacked terms once, returns their
    global values and hands each term's cotangent through unchanged, with
    no backward collective."""
    xs = (torch.tensor(1.5), torch.tensor(2.5, requires_grad=True))
    out = parallel.global_means(xs, None)
    assert out[0] is xs[0] and out[1] is xs[1]
    calls = []
    real = torch.distributed.all_reduce

    def counted(t, *a, **kw):
        calls.append(t.shape)
        return real(t, *a, **kw)
    monkeypatch.setattr(torch.distributed, "all_reduce", counted)
    with _world1(tmp_path) as mesh:
        x = torch.tensor([0.25, 3.0, -1.0], requires_grad=True)
        a, b, c = parallel.global_means(x.unbind(), mesh)
        assert [float(v.detach()) for v in (a, b, c)] == [0.25, 3.0, -1.0]
        (g,) = torch.autograd.grad(2 * a + 5 * b - c, x)
    assert calls == [torch.Size([3])]
    assert g.tolist() == [2.0, 5.0, -1.0]


def test_all_reduce_grads_keeps_each_gradients_strides(tmp_path):
    """Over a world-1 group ``all_reduce_grads`` returns every gradient
    EQUAL with its own strides (a channels-last convolution gradient, a
    transposed one, a scalar), each in a slot aligned as a fresh tensor,
    so that a reduction over it (AdamW's clip norm) sums in the order it
    does without a mesh."""
    g = torch.Generator().manual_seed(1)
    grads = [torch.randn(4, 3, 3, 5, generator=g).to(
                 memory_format=torch.channels_last),
             torch.randn(7, generator=g), torch.randn(3, 2, generator=g).t(),
             torch.randn((), generator=g), torch.randn(5, 3, 2, generator=g
                                                       ).permute(2, 0, 1)]
    with _world1(tmp_path) as mesh:
        out = parallel.all_reduce_grads(grads, mesh)
    for a, b in zip(grads, out):
        assert torch.equal(a, b) and a.stride() == b.stride()
        assert b.data_ptr() % (4 * parallel._ALIGN) == \
            out[0].data_ptr() % (4 * parallel._ALIGN)
        assert torch.equal(torch.sum(a ** 2), torch.sum(b ** 2))


def test_image_model_state_covers_the_frozen_trunk():
    """``parallel.replicate`` reaches the VGG trunk of ``use_perceptual``
    (a rank would otherwise seed its own), and the spectral vectors."""
    model = ImageImmunizationModel(
        _image_cfg("imuge"), device="cpu", kernels=PLAIN,
        **IMAGE_OPTIONS["imuge"])
    ids = {id(t) for t in parallel._state_tensors(model)}
    assert all(id(p) in ids for p in model.vgg.parameters())
    assert all(id(c.u) in ids for c in model.localizer.sn_convs())
    for opt in model.optimizers.values():
        assert id(opt.count) in ids and all(id(m) in ids for m in opt.mu)


def test_unet_global_batchnorm_keeps_float64():
    """The global BatchNorm of a float64 input takes its moments in
    float64 (flax promotes to at least float32), so MBRS's float64 ranks
    hold JAX's x64 step; float32 and bf16 inputs stay float32 inside."""
    bn = torch.nn.BatchNorm2d(3).double()
    x = torch.randn(4, 5, 5, 3, dtype=torch.float64) + 1e8
    stats = unet_mod.BatchStats(None)
    y = unet_mod._bn_global(x, bn, stats)
    assert y.dtype == torch.float64 and stats[bn][0].dtype == torch.float64
    assert float(y.detach().std()) > 0.5  # float32 moments of 1e8 + N(0,1) lose it


if __name__ == "__main__":
    if sys.argv[1] == "ranks":
        _ranks_child(sys.argv[2])
