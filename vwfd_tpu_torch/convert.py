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
  ``num_batches_tracked``); flax's default epsilon 1e-5 is the port's.
"""

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax"]

_CONVT = re.compile(r"(^|\.)up\d+$")  # UNetTPU's decoder ConvTransposes


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Mapping]:
    """Leaf modules (dicts whose values are arrays) by dotted path."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping) and any(isinstance(x, Mapping)
                                          for x in v.values()):
            out.update(_flatten(v, path))
        elif isinstance(v, Mapping):
            out[path] = v
        else:
            raise ValueError(f"{path}: expected a module dict, got an array")
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _module_to_torch(path: str, p: Mapping, stats: Mapping
                     ) -> Dict[str, torch.Tensor]:
    if "scale" in p:  # BatchNorm
        s = stats[path]
        return {"weight": _tensor(p["scale"]), "bias": _tensor(p["bias"]),
                "running_mean": _tensor(s["mean"]),
                "running_var": _tensor(s["var"]),
                "num_batches_tracked": torch.tensor(0, dtype=torch.long)}
    k = np.asarray(p["kernel"])
    w = (k[::-1, ::-1].transpose(2, 3, 0, 1) if _CONVT.search(path)
         else k.transpose(3, 2, 0, 1))
    out = {"weight": _tensor(w)}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"])
    return out


def _tree_to_state_dict(tree: Mapping, stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    flat_stats = _flatten(stats) if stats else {}
    sd = {}
    for path, p in _flatten(tree).items():
        for name, t in _module_to_torch(path, p, flat_stats).items():
            sd[f"{path}.{name}"] = t
    return sd


def params_from_jax(netG_tree: Mapping, generator_tree: Mapping,
                    batch_stats: Mapping) -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, torch.Tensor]]:
    """flax params of the INN and the extractor (+ the extractor's
    ``batch_stats``) → ``(netG_state_dict, generator_state_dict)``."""
    return (_tree_to_state_dict(netG_tree, {}),
            _tree_to_state_dict(generator_tree, batch_stats))


def _set(tree: Dict, path: str, leaf: str, value: np.ndarray) -> None:
    node = tree
    for k in path.split("."):
        node = node.setdefault(k, {})
    node[leaf] = value


def _state_dict_to_tree(sd: Mapping[str, torch.Tensor]
                        ) -> Tuple[Dict, Dict]:
    params, stats = {}, {}
    for key, t in sd.items():
        path, name = key.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        is_bn = f"{path}.running_mean" in sd
        if name == "num_batches_tracked":
            continue
        if is_bn:
            leaf, dst = {"weight": ("scale", params), "bias": ("bias", params),
                         "running_mean": ("mean", stats),
                         "running_var": ("var", stats)}[name]
            _set(dst, path, leaf, a)
        elif name == "weight":
            k = (a.transpose(2, 3, 0, 1)[::-1, ::-1] if _CONVT.search(path)
                 else a.transpose(2, 3, 1, 0))
            _set(params, path, "kernel", np.ascontiguousarray(k))
        else:
            _set(params, path, name, a)
    return params, stats


def params_to_jax(netG_sd: Mapping[str, torch.Tensor],
                  generator_sd: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict, Dict, Dict]:
    """Inverse of ``params_from_jax``: ``(netG_tree, generator_tree,
    batch_stats)`` as nested dicts of numpy arrays."""
    netG, _ = _state_dict_to_tree(netG_sd)
    gen, stats = _state_dict_to_tree(generator_sd)
    return netG, gen, stats
