"""Weight bridge: JAX/NNX parameters -> the port's modules.

`load_jax_state(module, tree)` takes the JAX module's parameters as a
nested dict of numpy arrays (what `nnx.state(m, nnx.Param).to_pure_dict()`
gives after `np.asarray` on each leaf) and copies them into the port's
module of the same structure: the port names its submodules after the JAX
attributes, so a parameter's path is the same on both sides and only the
leaf name and layout change:

  Linear         kernel (in, out)           -> weight (out, in)
  Conv2d         kernel HWIO, bias          -> weight OIHW, bias
  ConvTranspose  kernel (kh, kw, in, out)   -> weight (in, out, kh, kw),
                                               flipped in space
  GroupNorm      scale, bias                -> weight, bias
  Embedding      embedding                  -> weight
  LayerNorm      gamma; Attention null_kv (2, h, 1, d), q_scale, k_scale
                                            -> same names, as they are

Reading JAX msgpack checkpoints directly is not ported (no flax or msgpack
on the GPU machine); convert on a machine with JAX, then load the dict.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'a.b': x}; integer keys (nnx.List) become strings."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "."))
        else:
            flat[path] = np.asarray(value)
    return flat


def _rules(module: nn.Module):
    """(torch parameter name, jax leaf name, layout conversion) per module type."""
    if isinstance(module, nn.ConvTranspose2d):
        return [
            ("weight", "kernel", lambda a: np.flip(a.transpose(2, 3, 0, 1), axis=(2, 3))),
            ("bias", "bias", None),
        ]
    if isinstance(module, nn.Conv2d):
        return [("weight", "kernel", lambda a: a.transpose(3, 2, 0, 1)), ("bias", "bias", None)]
    if isinstance(module, nn.Linear):
        return [("weight", "kernel", lambda a: a.T), ("bias", "bias", None)]
    if isinstance(module, nn.GroupNorm):
        return [("weight", "scale", None), ("bias", "bias", None)]
    if isinstance(module, nn.Embedding):
        return [("weight", "embedding", None)]
    return None  # parameters keep their JAX names


def load_jax_state(module: nn.Module, tree: Mapping) -> List[str]:
    """Copy every parameter of `module` from `tree`. Raises if one is
    missing or has another shape; returns the JAX leaves that no parameter
    of the port consumed (e.g. the not-yet-ported VAE encoder)."""
    flat = flatten_tree(tree)
    used = set()
    with torch.no_grad():
        for mod_name, mod in module.named_modules():
            prefix = f"{mod_name}." if mod_name else ""
            rules = _rules(mod)
            if rules is None:
                rules = [(n, n, None) for n, _ in mod.named_parameters(recurse=False)]
            for pname, jname, convert in rules:
                param = getattr(mod, pname, None)
                if param is None:
                    continue
                key = prefix + jname
                if key not in flat:
                    raise KeyError(f"JAX state has no {key!r} for {prefix}{pname}")
                arr = flat[key]
                if convert is not None:
                    arr = convert(arr)
                if tuple(arr.shape) != tuple(param.shape):
                    raise ValueError(
                        f"{key}: JAX shape {arr.shape} (converted) != port shape "
                        f"{tuple(param.shape)}"
                    )
                param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
                used.add(key)
    return sorted(set(flat) - used)
