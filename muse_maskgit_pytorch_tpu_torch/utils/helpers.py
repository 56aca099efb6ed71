"""Small generic helpers (counterpart of `muse_maskgit_pytorch_tpu/utils/helpers.py`)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


def exists(val: Any) -> bool:
    return val is not None


def default(val: Any, d: Any) -> Any:
    if val is not None:
        return val
    return d() if callable(d) else d


def pair(val):
    return val if isinstance(val, tuple) else (val, val)


def cast_tuple(t):
    return t if isinstance(t, (tuple, list)) else (t,)


def group_dict_by_key(cond: Callable[[str], bool], d: Dict) -> Tuple[Dict, Dict]:
    """(the items whose key `cond` accepts, the others), in `d`'s order."""
    matched, unmatched = {}, {}
    for key, value in d.items():
        (matched if cond(key) else unmatched)[key] = value
    return matched, unmatched


def group_by_key_prefix(prefix: str, d: Dict) -> Tuple[Dict, Dict]:
    return group_dict_by_key(lambda key: key.startswith(prefix), d)


def groupby_prefix_and_trim(prefix: str, d: Dict) -> Tuple[Dict, Dict]:
    """(the items whose key starts with `prefix`, the prefix cut off; the
    others): how keyword arguments are routed by prefix (`vq_*`, ...)."""
    with_prefix, rest = group_by_key_prefix(prefix, d)
    return {key[len(prefix):]: value for key, value in with_prefix.items()}, rest


def accum_log(log: Dict, new_logs: Dict) -> Dict:
    """Add each of `new_logs`' values to `log`'s under the same key (0 where
    absent), in place; returns `log`."""
    for key, value in new_logs.items():
        log[key] = log.get(key, 0.0) + value
    return log


def not_ported(what: str, roadmap_item: str):
    """The error every entry point raises for a feature the port has not
    reached yet; `roadmap_item` names the ROADMAP.md queue entry."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {roadmap_item})"
    )


def resolve_device(device) -> torch.device:
    """The device a public module is built on. The port's modules default to
    "cuda" and run there; a CPU build must be asked for (device="cpu"), so
    a machine without CUDA raises here rather than falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's modules are built on the GPU by default; "
            "pass device='cpu' to build on the CPU"
        )
    return device
