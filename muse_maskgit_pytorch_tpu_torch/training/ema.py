"""Exponential moving average of the trainable parameters (counterpart of
`muse_maskgit_pytorch_tpu/training/ema.py`), updated in place with
`torch._foreach_*` after each optimizer step."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from muse_maskgit_pytorch_tpu_torch.training.optim import local_tensors


def ema_init(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Copies of `params` that do not alias them (a sharded `DTensor`
    stays a `DTensor` of the same placements)."""
    return [p.detach().clone() for p in params]


@torch.no_grad()
def ema_update(
    ema: List[torch.Tensor],
    params: Sequence[torch.Tensor],
    step: int,
    beta: float = 0.995,
    update_after_step: int = 0,
    update_every: int = 1,
) -> List[torch.Tensor]:
    """Update `ema` in place and return it, with the JAX package's
    semantics: only when `step % update_every == 0`; a copy of `params`
    while `step <= update_after_step`, else `ema * beta + params * (1 -
    beta)` with `1 - beta` taken in f32, as JAX takes it from the f32 decay.
    `step` is the optimizer step's count before its increment and `params`
    are the updated ones."""
    if step % update_every != 0:
        return ema
    params = local_tensors([p.detach() for p in params])
    local = local_tensors(ema)
    if step <= update_after_step:
        torch._foreach_copy_(local, params)
        return ema
    decay = np.float32(beta)
    torch._foreach_mul_(local, float(decay))
    torch._foreach_add_(local, torch._foreach_mul(params, float(np.float32(1.0) - decay)))
    return ema
