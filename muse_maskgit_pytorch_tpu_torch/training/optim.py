"""The trainers' optimizer: optax's `clip_by_global_norm` -> `adam` (or
`adamw`) with the `lr_schedule` of `muse_maskgit_pytorch_tpu/training/
trainers.py`, written out with `torch._foreach_*` in optax's order of
operations, so that a step on the CPU agrees with the JAX package's to f32
rounding.

The schedule is evaluated on the host at the optimizer's own count (the
first step's rate is `schedule(0)`, 0 under a warmup), in float32 as optax
evaluates it under `jit`; so a step reads nothing from the device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]

# optax.adam's defaults, which the JAX trainers use
B1, B2, EPS = 0.9, 0.999, 1e-8


def _linear(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule(init, end, steps)."""

    def schedule(count: int) -> np.float32:
        frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], np.float32]:
    """optax.cosine_decay_schedule(init, decay_steps, alpha)."""

    def schedule(count: int) -> np.float32:
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * c / np.float32(decay_steps)))
        return np.float32(init) * (np.float32(1.0 - alpha) * cosine + np.float32(alpha))

    return schedule


def lr_schedule(lr: float, warmup_steps: int = 0, decay_steps: Optional[int] = None, end_lr_ratio: float = 0.1) -> Schedule:
    """Linear warmup from 0 and / or cosine decay to `end_lr_ratio * lr`,
    joined as `optax.join_schedules` joins them; the constant `lr` (a float)
    when both are off. A schedule maps the optimizer's count to a float."""
    if not warmup_steps and decay_steps is None:
        return lr
    if decay_steps is not None and decay_steps <= 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")
    after = _cosine(lr, decay_steps, end_lr_ratio) if decay_steps is not None else (lambda count: np.float32(lr))
    if not warmup_steps:
        return lambda count: float(after(count))
    warm = _linear(0.0, lr, warmup_steps)
    return lambda count: float(warm(count) if count < warmup_steps else after(count - warmup_steps))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (0-d f32, on the device)."""
    return torch.stack(torch._foreach_norm(list(tensors))).square().sum().sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax's form: the gradients as they are where their global norm is
    below `max_norm`, else `(g / norm) * max_norm` (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). Decided on the device."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class Adam:
    """optax `adam` with its defaults (B1, B2, EPS), `adamw` when
    `weight_decay` > 0 (the decay `lr * wd * p` on every parameter), after
    an optional `clip_by_global_norm(max_grad_norm)`, over a fixed list of
    parameters updated in place."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: Schedule,
        weight_decay: float = 0.0,
        max_grad_norm: Optional[float] = None,
    ):
        self.params = list(params)
        self.lr = lr
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(np.float32(self.lr))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """One update from `grads` (one per parameter; `norm` their global
        norm, if the caller has it)."""
        grads = list(grads)
        if self.max_grad_norm is not None:
            grads = clip_by_global_norm(grads, self.max_grad_norm, norm)
        # mu = (1 - B1) g + B1 mu; nu = (1 - B2) g^2 + B2 nu
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2))
        lr = self.lr_at(self.count)
        self.count += 1
        # bias corrections in f32, as optax divides by (1 - b ** count).astype(f32)
        bc1 = float(np.float32(1.0 - B1**self.count))
        bc2 = float(np.float32(1.0 - B2**self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(updates, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)

    def state_dict(self, names: Sequence[str]) -> Dict:
        return dict(count=self.count, mu=dict(zip(names, self.mu)), nu=dict(zip(names, self.nu)))

    @torch.no_grad()
    def load_state_dict(self, state: Dict, names: Sequence[str]) -> None:
        self.count = int(state["count"])
        torch._foreach_copy_(self.mu, [state["mu"][n].to(m.device) for n, m in zip(names, self.mu)])
        torch._foreach_copy_(self.nu, [state["nu"][n].to(m.device) for n, m in zip(names, self.nu)])
