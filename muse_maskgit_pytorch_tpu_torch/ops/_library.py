"""The `muse_torch` operator namespace: K1, K2's forward, K3, the exact
sampler's noise (`philox_gumbel`) and the trunk's norms (`layer_norm`,
`geglu_layer_norm`) as PyTorch operators.

Each operator has three implementations: a fake one (output shapes and
dtypes only, for `torch.export` and other tracing), a "CPU" one that is the
kernel's plain version, and a "CUDA" one that launches the hand-written
kernel. Any other device has none, so a call there raises. Because the
route is chosen by the dispatcher at each call and not in Python at trace
time, a program traced on the CPU (`serving.export_pipeline`) and moved to
the card launches the kernels there. Defining the operators builds nothing:
the kernels are built at their first CUDA call (`ops/_build.py`).
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "muse_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define `muse_torch::<schema>` with its CPU, CUDA and fake
    implementations; returns the operator's overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
