"""Small generic helpers (counterpart of `muse_maskgit_pytorch_tpu/utils/helpers.py`)."""

from __future__ import annotations

from typing import Any


def exists(val: Any) -> bool:
    return val is not None


def default(val: Any, d: Any) -> Any:
    if val is not None:
        return val
    return d() if callable(d) else d


def not_ported(what: str, roadmap_item: str):
    """The error every entry point raises for a feature the port has not
    reached yet; `roadmap_item` names the ROADMAP.md queue entry."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {roadmap_item})"
    )
