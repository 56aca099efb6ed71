"""Weight bridge: JAX/NNX parameters and batch statistics -> the port's modules.

`load_jax_state(module, tree)` takes the JAX module's state as a nested
dict of numpy arrays (what
`nnx.state(m, (nnx.Param, nnx.BatchStat)).to_pure_dict()` gives after
`np.asarray` on each leaf) and copies it into the port's module of the same
structure: the port names its submodules after the JAX attributes, so a
leaf's path is the same on both sides and only the leaf name and layout
change:

  Linear         kernel (in, out)           -> weight (out, in)
  Conv2d         kernel HWIO, bias          -> weight OIHW, bias
  ConvTranspose  kernel (kh, kw, in, out)   -> weight (in, out, kh, kw),
                                               flipped in space
  GroupNorm      scale, bias                -> weight, bias
  Embedding      embedding                  -> weight
  LayerNorm      gamma; Attention null_kv (2, h, 1, d), q_scale, k_scale;
                 T5 RMSNorm weight          -> same names, as they are
  nnx.List       blocks.0, blocks.1, ...    -> nn.ModuleList of the same name
  nnx.BatchStat  (EMA-VQ codebook, cluster_size, embed_avg, initted)
                                            -> registered buffers of the
                                               same names and dtypes

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
    """Copy every parameter and buffer of `module` from `tree`, in place, so
    each stays on its module's device. Raises if one is missing or has
    another shape; returns the JAX leaves that the port consumed none of
    (e.g. a not-yet-ported discriminator).

    One port module may stand under several paths where the JAX tree holds a
    subtree for each: a `MaskGit` built with `vae=v, cond_vae=v` keeps one
    object, while the JAX `MaskGit` stores an eval clone under `vae` and
    another under `cond_vae`. Every such subtree is consumed, and they must
    agree: two different subtrees for one shared module raise. A path that
    the JAX tree leaves out (it stores an aliased module once) is fine as
    long as another path of the same module is there."""
    flat = flatten_tree(tree)
    used = set()
    loaded = {}  # id(tensor) -> the key it was loaded from
    missing = {}  # id(tensor) -> the first key that was looked for
    with torch.no_grad():
        for mod_name, mod in module.named_modules(remove_duplicate=False):
            prefix = f"{mod_name}." if mod_name else ""
            rules = _rules(mod)
            if rules is None:
                rules = [(n, n, None) for n, _ in mod.named_parameters(recurse=False)]
            rules += [(n, n, None) for n, _ in mod.named_buffers(recurse=False)]
            for pname, jname, convert in rules:
                param = getattr(mod, pname, None)
                if param is None:
                    continue
                key = prefix + jname
                if key not in flat:
                    missing.setdefault(id(param), (key, prefix + pname))
                    continue
                arr = flat[key]
                if convert is not None:
                    arr = convert(arr)
                if tuple(arr.shape) != tuple(param.shape):
                    raise ValueError(
                        f"{key}: JAX shape {arr.shape} (converted) != port shape "
                        f"{tuple(param.shape)}"
                    )
                dtype = np.float32 if param.is_floating_point() else None  # e.g. bool `initted`
                arr = np.array(arr, dtype=dtype)
                used.add(key)
                if id(param) in loaded:
                    if not np.array_equal(param.cpu().numpy(), arr):
                        raise ValueError(
                            f"{loaded[id(param)]} and {key} differ in the JAX state but are one shared "
                            "tensor in the port: build the port with separate modules"
                        )
                    continue
                param.copy_(torch.from_numpy(arr))
                loaded[id(param)] = key
    for pid, (key, pname) in missing.items():
        if pid not in loaded:
            raise KeyError(f"JAX state has no {key!r} for {pname}")
    return sorted(set(flat) - used)
