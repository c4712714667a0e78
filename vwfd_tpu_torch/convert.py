"""Weight bridge between the JAX package's flax trees and the port's state
dicts. Imports no JAX: the trees come in as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``).

Rules:

* ``Conv`` kernel HWIO → ``weight`` OIHW (``k.transpose(3, 2, 0, 1)``);
* flax ``ConvTranspose`` kernel (2,2,Cin,Cout) → ``ConvTranspose2d``
  ``weight`` (Cin,Cout,2,2) as ``K[::-1, ::-1].transpose(2, 3, 0, 1)``: flax
  applies the kernel spatially flipped relative to PyTorch;
* ``BatchNorm`` ``scale``/``bias`` + batch stats ``mean``/``var`` →
  ``weight``/``bias``/``running_mean``/``running_var`` (+
  ``num_batches_tracked``); flax's default epsilon 1e-5 is the port's;
* ``Dense`` kernel (in, out) → ``Linear`` ``weight`` (out, in);
* ``LayerNorm`` ``scale``/``bias`` → ``weight``/``bias``, as BatchNorm's
  without statistics (flax's epsilon 1e-6 is the port's ``nn.LayerNorm``'s
  there: ``nets/sunet.py``);
* arrays of a module that has no ``kernel`` keep their names and layout:
  SUNet's ``PReLU_i.negative_slope`` (a scalar) and its attention's
  ``rel_pos_bias`` ((2·ws − 1)², heads), which sits beside the ``qkv`` and
  ``proj`` submodules.

The int8 serving trees (``nets/unet_int8.py``, ``nets/inn_int8.py``) keep the
JAX package's keys; their int8 conv kernels HWIO become the port's
``(Cout, k, k, Cin)`` (``k.transpose(3, 0, 1, 2)``), and the UNet's int8
transposed-conv kernels (2, 2, Cin, Cout) become ``(2, 2, Cout, Cin)`` with
the same spatial flip as the float32 ones (``K[::-1, ::-1].transpose(0, 1,
3, 2)``); ``unet_int8_from_jax`` / ``inn_int8_from_jax`` map them.

The optimizer state follows the parameters: optax's ``ScaleByAdamState``
(``count``, ``mu``, ``nu``; ``vwfd_tpu/models/state.py:37-45``) holds two
trees shaped like the params, which map to the port's ``AdamW.mu`` and
``.nu`` (lists in the net's parameter order) by the same rules, and the
count to ``AdamW.count``.

``states_from_jax`` / ``states_to_jax`` carry a whole model's nets (the
HiDDeN family's encoder, decoder and discriminator, MBRS's encoder and
decoder, Tianchi's SUNet ``netG``, the image family's ``netG`` and
``localizer``, CLR's ``apex`` regressor and the ``with_gan``
``discriminator``: params, batch stats, spectral vectors and Adam ``mu`` /
``nu`` / ``count`` of each) both ways. MBRS's ExpandNet transposed convs
are ``message_expand.up{i}``, which the ConvTranspose rule's name pattern
matches.

The localizer (``nets/localizer.py``, flax's ``UNetDiscriminator``): its
``bayar_kernel`` is an array of the root module with no ``kernel`` beside
it, so it keeps its name and flax's (5, 5, Cin, 3) layout; its decoder's
transposed ``SNConv`` (``dec{i}_up``) take the ConvTranspose rule (flax's
``conv_transpose`` without ``transpose_kernel`` is PyTorch's transposed
convolution of the flipped kernel, F3); the ``spectral`` collection's
``u`` vectors (flax's row order (kh, kw, cin), which the port keeps)
become each ``SNConv``'s ``u`` buffer (``spectral_from_jax`` /
``spectral_to_jax``). The apex regressor (``nets/fbcnn.py``, flax's
``QFPredictor``) keeps its ``bayar_kernel`` the same way (HWIO (5, 5, Cin,
3)); its residual blocks' ``c1`` / ``c2``, the stride-2 ``*_down`` convs,
``to_img`` and the Dense ``qf0``–``qf2`` take the Conv and Dense rules; the
discriminator's ``SNConv`` pairs carry no bias. ``FBCNN`` (KD-JPEG's
generator, the image model's ``jpeg_sim``) keeps flax's names: the Dense
``qf_embed{i}``, ``to_gamma_{lvl}``, ``to_beta_{lvl}``, the convs
``head``, ``*_down``, ``tail`` and the blocks' ``c1`` / ``c2``, and its
``up{3,2,1}_up`` take the ConvTranspose rule. KD-JPEG's three nets
(``generator``, ``localizer``: a ``QFPredictor``, ``discriminator`` with
its spectral vectors) carry both ways as any model's. The VGG19 trunk of
``use_perceptual`` (``metrics/perceptual.py``) is frozen and not a state:
``state_dict_from_jax`` maps a flax tree of it.
"""

import re
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "state_dict_from_jax",
           "state_dict_to_jax", "opt_state_from_jax", "opt_state_to_jax",
           "states_from_jax", "states_to_jax", "spectral_from_jax",
           "spectral_to_jax", "unet_int8_from_jax", "inn_int8_from_jax"]

# the ConvTransposes: UNetTPU's decoder's, MBRS's message_expand's, the
# localizer's transposed SNConv, FBCNN's up stages
_CONVT = re.compile(r"(^|\.)up\d+$|(^|\.)dec\d+_up$|(^|\.)up\d+_up$")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Mapping]:
    """Each module's own arrays by dotted path: a dict's arrays belong to
    it (SUNet's ``attn`` holds its ``rel_pos_bias`` beside its ``qkv`` and
    ``proj`` submodules), its dicts are submodules."""
    out = {}
    own = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if own:
        out[prefix] = own  # "" : the root module's own arrays
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _module_to_torch(path: str, p: Mapping, stats: Mapping
                     ) -> Dict[str, torch.Tensor]:
    if "scale" in p:  # BatchNorm or LayerNorm (running statistics if given)
        out = {"weight": _tensor(p["scale"]), "bias": _tensor(p["bias"])}
        if path in stats:
            s = stats[path]
            out.update(running_mean=_tensor(s["mean"]),
                       running_var=_tensor(s["var"]),
                       num_batches_tracked=torch.tensor(0, dtype=torch.long))
        return out
    if "kernel" not in p:  # a PReLU's slope, a relative-position table
        return {name: _tensor(a) for name, a in p.items()}
    k = np.asarray(p["kernel"])
    w = (k.T if k.ndim == 2
         else k[::-1, ::-1].transpose(2, 3, 0, 1) if _CONVT.search(path)
         else k.transpose(3, 2, 0, 1))
    out = {"weight": _tensor(w)}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"])
    return out


def state_dict_from_jax(tree: Mapping, stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """One net's flax params (+ its ``batch_stats``) → its state dict."""
    flat_stats = _flatten(stats) if stats else {}
    sd = {}
    for path, p in _flatten(tree).items():
        for name, t in _module_to_torch(path, p, flat_stats).items():
            sd[f"{path}.{name}" if path else name] = t
    return sd


def params_from_jax(netG_tree: Mapping, generator_tree: Mapping,
                    batch_stats: Mapping) -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, torch.Tensor]]:
    """flax params of the INN and the extractor (+ the extractor's
    ``batch_stats``) → ``(netG_state_dict, generator_state_dict)``."""
    return (state_dict_from_jax(netG_tree),
            state_dict_from_jax(generator_tree, batch_stats))


def _set(tree: Dict, path: str, leaf: str, value: np.ndarray) -> None:
    node = tree
    for k in path.split(".") if path else ():
        node = node.setdefault(k, {})
    node[leaf] = value


def _state_dict_to_tree(sd: Mapping[str, torch.Tensor],
                        bn: Optional[Set[str]] = None) -> Tuple[Dict, Dict]:
    """``bn``: the BatchNorm modules' paths (default: those with a
    ``running_mean`` in ``sd``)."""
    params, stats = {}, {}
    for key, t in sd.items():
        path, name = key.rsplit(".", 1) if "." in key else ("", key)
        a = t.detach().cpu().numpy()
        is_bn = (f"{path}.running_mean" in sd) if bn is None else path in bn
        if name == "num_batches_tracked":
            continue
        if is_bn:
            leaf, dst = {"weight": ("scale", params), "bias": ("bias", params),
                         "running_mean": ("mean", stats),
                         "running_var": ("var", stats)}[name]
            _set(dst, path, leaf, a)
        elif name == "weight" and a.ndim == 1:  # LayerNorm
            _set(params, path, "scale", a)
        elif name == "weight":
            k = (a.T if a.ndim == 2
                 else a.transpose(2, 3, 0, 1)[::-1, ::-1]
                 if _CONVT.search(path) else a.transpose(2, 3, 1, 0))
            _set(params, path, "kernel", np.ascontiguousarray(k))
        else:
            _set(params, path, name, a)
    return params, stats


def state_dict_to_jax(sd: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """Inverse of ``state_dict_from_jax``: ``(params, batch_stats)``."""
    return _state_dict_to_tree(sd)


def params_to_jax(netG_sd: Mapping[str, torch.Tensor],
                  generator_sd: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict, Dict, Dict]:
    """Inverse of ``params_from_jax``: ``(netG_tree, generator_tree,
    batch_stats)`` as nested dicts of numpy arrays."""
    netG, _ = _state_dict_to_tree(netG_sd)
    gen, stats = _state_dict_to_tree(generator_sd)
    return netG, gen, stats


def _param_names(net: torch.nn.Module) -> List[str]:
    return [n for n, _ in net.named_parameters()]


def opt_state_from_jax(net: torch.nn.Module, mu: Mapping, nu: Mapping,
                       count) -> Tuple[List[torch.Tensor],
                                       List[torch.Tensor], torch.Tensor]:
    """optax ``ScaleByAdamState`` of ``net``'s params (``mu``, ``nu`` trees
    of numpy arrays, ``count``) → ``(mu, nu, count)`` for the port's
    ``AdamW``: lists in ``net``'s parameter order and an int32 count."""
    names = _param_names(net)
    out = []
    for what, tree in (("mu", mu), ("nu", nu)):
        sd = state_dict_from_jax(tree)
        if set(sd) != set(names):
            raise ValueError(f"{what} does not fit the net: missing "
                             f"{sorted(set(names) - set(sd))[:3]}, extra "
                             f"{sorted(set(sd) - set(names))[:3]}")
        out.append([sd[n] for n in names])
    return out[0], out[1], torch.tensor(int(np.asarray(count)),
                                        dtype=torch.int32)


def opt_state_to_jax(net: torch.nn.Module, mu, nu, count
                     ) -> Tuple[Dict, Dict, np.ndarray]:
    """Inverse of ``opt_state_from_jax``: ``(mu_tree, nu_tree, count)``."""
    names = _param_names(net)
    bn = {k.rsplit(".", 1)[0] for k in net.state_dict()
          if k.endswith(".running_mean")}
    trees = [_state_dict_to_tree(dict(zip(names, ts)), bn)[0]
             for ts in (mu, nu)]
    return trees[0], trees[1], np.asarray(int(count), np.int32)


def spectral_from_jax(spectral: Mapping) -> Dict[str, torch.Tensor]:
    """flax's ``spectral`` collection → the ``<module>.u`` buffers."""
    return {f"{path}.u": _tensor(p["u"])
            for path, p in _flatten(spectral).items()}


def spectral_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The ``<module>.u`` buffers of a state dict → flax's ``spectral``
    collection."""
    tree: Dict = {}
    for key, t in sd.items():
        if key.endswith(".u"):
            _set(tree, key[:-2], "u", t.detach().cpu().numpy())
    return tree


def states_from_jax(model, trees: Mapping[str, Mapping]) -> None:
    """Load each net of ``model`` (``model.nets()``, ``model.optimizers``)
    from ``trees[name]``: ``params``, ``batch_stats`` (where the net has
    BatchNorms), ``spectral`` (where it has spectral-norm convs) and, where
    given, the Adam state ``mu``, ``nu``, ``count``; shapes are checked by
    ``load_state_dict`` and ``opt_state_from_jax``."""
    with torch.no_grad():
        for name, net in model.nets().items():
            t = trees[name]
            sd = state_dict_from_jax(t["params"], t.get("batch_stats"))
            sd.update(spectral_from_jax(t.get("spectral", {})))
            own = net.state_dict()
            sd.update({k: v for k, v in own.items()
                       if k.endswith("num_batches_tracked")})
            net.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()})
            if "mu" in t:
                opt = model.optimizers[name]
                mu, nu, count = opt_state_from_jax(net, t["mu"], t["nu"],
                                                   t["count"])
                for dst, src in zip(opt.mu + opt.nu, mu + nu):
                    dst.copy_(src)
                opt.count.copy_(count)


def states_to_jax(model, optimizer: bool = True) -> Dict[str, Dict]:
    """Inverse of ``states_from_jax``: per net ``params``, ``batch_stats``,
    ``spectral`` (where it has spectral-norm convs) and (with
    ``optimizer``) ``mu``, ``nu``, ``count``, numpy trees."""
    out = {}
    for name, net in model.nets().items():
        sd = net.state_dict()
        params, stats = _state_dict_to_tree(
            {k: v for k, v in sd.items() if not k.endswith(".u")})
        out[name] = {"params": params, "batch_stats": stats}
        spectral = spectral_to_jax(sd)
        if spectral:
            out[name]["spectral"] = spectral
        if optimizer:
            opt = model.optimizers[name]
            mu, nu, count = opt_state_to_jax(net, opt.mu, opt.nu, opt.count)
            out[name].update(mu=mu, nu=nu, count=count)
    return out


def _leaf(a, conv: bool = False, flip: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    if flip:   # flax ConvTranspose HWIO (2,2,Cin,Cout) → (2,2,Cout,Cin)
        a = a[::-1, ::-1].transpose(0, 1, 3, 2)
    elif conv:  # HWIO → (Cout, kh, kw, Cin)
        a = a.transpose(3, 0, 1, 2)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def unet_int8_from_jax(qp: Mapping) -> Dict:
    """The JAX package's int8 UNet tree (``unet_int8.quantize``; numpy or
    jax leaves) → the port's (``nets/unet_int8.py``)."""
    def conv(c):
        return {"w": _leaf(c["w"], conv=True), "m": _leaf(c["m"]),
                "b": _leaf(c["b"])}

    return {
        "enc": [[conv(c) for c in lv] for lv in qp["enc"]],
        "dec": [{"up_w": _leaf(d["up_w"], flip=True),
                 "up_m": _leaf(d["up_m"]), "up_b": _leaf(d["up_b"]),
                 "w_up": _leaf(d["w_up"], conv=True),
                 "w_skip": _leaf(d["w_skip"], conv=True),
                 "m_up": _leaf(d["m_up"]), "m_skip": _leaf(d["m_skip"]),
                 "b": _leaf(d["b"])} for d in qp["dec"]],
        "head": conv(qp["head"]),
    }


def inn_int8_from_jax(q: Mapping) -> Dict:
    """The JAX package's int8 INN tree (``inn_int8.quantize``) → the
    port's (``nets/inn_int8.py``)."""
    convs = ("w0", "w1", "w2x", "w2h")
    return {blk: {st: {k: _leaf(v, conv=k in convs) for k, v in p.items()}
                  for st, p in sub.items()}
            for blk, sub in q.items()}
