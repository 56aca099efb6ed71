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

`to_jax_state(module)` is the inverse: the port's module as the JAX module's
state dict, in the JAX layout, with a module that the JAX state holds once
(a shared submodule) written once, under the path JAX keeps.

A file that the JAX package's `save_module` wrote is read without JAX by
`utils.checkpoint.load_module` (through `utils.msgpack_codec`, which needs
neither flax nor msgpack), which hands the decoded tree to `load_jax_state`.
The `Discriminator`, `VGG16` and `InceptionV3` are built of these layers
under the JAX names, so they bridge by the same rules: an `InceptionV3`
`BasicConv2d` is a bias-free `conv` (kernel HWIO -> weight OIHW) and its
BatchNorm statistics `bn_scale`, `bn_bias`, `bn_mean`, `bn_var`, which keep
their names. The leaves that no port module takes (a discriminator's, when
a GAN VAE's file is loaded into a VAE built with `use_vgg_and_gan=False`)
are skipped and returned by name.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _as_numpy(value) -> np.ndarray:
    """A leaf as a numpy array; a bf16 tensor (how `utils.msgpack_codec`
    hands over a bf16 leaf) widens to f32, which is exact."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'a.b': x}; integer keys (nnx.List) become strings."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "."))
        else:
            flat[path] = _as_numpy(value)
    return flat


def _rules(module: nn.Module):
    """(torch parameter name, jax leaf name, layout conversion to the port,
    the inverse conversion) per module type."""
    if isinstance(module, nn.ConvTranspose2d):
        return [
            (
                "weight", "kernel",
                lambda a: np.flip(a.transpose(2, 3, 0, 1), axis=(2, 3)),
                lambda w: np.flip(w, axis=(2, 3)).transpose(2, 3, 0, 1),
            ),
            ("bias", "bias", None, None),
        ]
    if isinstance(module, nn.Conv2d):
        return [
            ("weight", "kernel", lambda a: a.transpose(3, 2, 0, 1), lambda w: w.transpose(2, 3, 1, 0)),
            ("bias", "bias", None, None),
        ]
    if isinstance(module, nn.Linear):
        return [("weight", "kernel", lambda a: a.T, lambda w: w.T), ("bias", "bias", None, None)]
    if isinstance(module, nn.GroupNorm):
        return [("weight", "scale", None, None), ("bias", "bias", None, None)]
    if isinstance(module, nn.Embedding):
        return [("weight", "embedding", None, None)]
    return None  # parameters keep their JAX names


def _module_rules(mod: nn.Module):
    rules = _rules(mod)
    if rules is None:
        rules = [(n, n, None, None) for n, _ in mod.named_parameters(recurse=False)]
    return rules + [(n, n, None, None) for n, _ in mod.named_buffers(recurse=False)]


def load_jax_state(module: nn.Module, tree: Mapping) -> List[str]:
    """Copy every parameter and buffer of `module` from `tree`, in place, so
    each stays on its module's device. Raises if one is missing or has
    another shape; returns the JAX leaves that the port consumed none of
    (e.g. a discriminator's, where `module` has none).

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
            for pname, jname, convert, _ in _module_rules(mod):
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


def _jax_order(name) -> tuple:
    """nnx visits a node's attributes sorted by name (list entries by index)."""
    name = str(name)
    return (0, int(name), "") if name.isdigit() else (1, 0, name)


def to_jax_state(module: nn.Module) -> Dict:
    """The inverse of `load_jax_state`: `module`'s parameters and buffers as
    the JAX module's pure state dict (what `nnx.state(m).to_pure_dict()`
    gives, numpy leaves, integer keys for list entries), in the JAX layout.

    A submodule that the port reaches under several paths is written once,
    under the first path in nnx's order (attributes sorted by name), as
    `nnx.state` writes a shared module; except where a module names, in
    `jax_unshared_children`, the children that the JAX model holds as
    objects of their own (a `MaskGit` built with `vae=v, cond_vae=v`)."""
    tree: Dict = {}

    def visit(mod: nn.Module, path: Tuple, seen: set) -> None:
        if id(mod) in seen:
            return
        seen.add(id(mod))
        for pname, jname, _, back in _module_rules(mod):
            t = getattr(mod, pname, None)
            if t is None:
                continue
            arr = _as_numpy(t)
            if back is not None:
                arr = back(arr)
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            # C order (a transposed view is copied); np.ascontiguousarray
            # would turn a 0-d leaf into 1-d
            node[jname] = arr if arr.flags.c_contiguous else arr.copy(order="C")
        unshared = getattr(mod, "jax_unshared_children", ())
        children = [(n, c) for n, c in mod._modules.items() if c is not None]
        for name, child in sorted(children, key=lambda kv: _jax_order(kv[0])):
            key = int(name) if name.isdigit() else name
            visit(child, path + (key,), set() if name in unshared else seen)

    def ordered(node):
        # leaves and subtrees in nnx's order too, so the file's bytes are
        # the ones the JAX package writes for the same state
        if not isinstance(node, dict):
            return node
        return {k: ordered(node[k]) for k in sorted(node, key=_jax_order)}

    visit(module, (), set())
    return ordered(tree)
