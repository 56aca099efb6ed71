"""Sampling and masking helpers (counterpart of
`muse_maskgit_pytorch_tpu/utils/sampling.py`).

The decode loop needs the schedule on the host: the per-step mask counts,
temperatures and compact-segment plan are computed once per `generate` so
the loop never reads a device value. `step_times` and `mask_counts`
reproduce, bit for bit, the float32 values the JAX decode computes inside
its jitted scan. Two details matter there:

  * `jnp.linspace(0, 1, T)` under jit evaluates `i * (1 / (T - 1))` in f32
    (XLA rewrites the division by a constant into a multiply by its
    reciprocal), and that differs from `i / (T - 1)` and from
    `torch.linspace` in the last bit for many T;
  * `floor(cos(t * pi / 2) * seq)` flips to the next integer where the f32
    product lands next to one, so the schedule must see those same bits.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

# ---------------------------------------------------------------------------
# noise schedules; each takes a tensor or a float32 numpy array
# ---------------------------------------------------------------------------


def cosine_schedule(t):
    """Mask-fraction schedule p(t) = cos(t * pi / 2), t in [0, 1]."""
    if isinstance(t, np.ndarray):
        a = t.astype(np.float32) * np.float32(math.pi) * np.float32(0.5)
        # cos of the f32 argument, evaluated in f64 and rounded once
        return np.cos(a.astype(np.float64)).astype(np.float32)
    return torch.cos(t * math.pi * 0.5)


def linear_schedule(t):
    if isinstance(t, np.ndarray):
        return np.float32(1.0) - t.astype(np.float32)
    return 1.0 - t


def step_times(timesteps: int, jitted: bool = True) -> np.ndarray:
    """float32 step times t_i of `jnp.linspace(0.0, 1.0, timesteps)`:
    as the jitted decode scan computes them (`i * (1 / (T - 1))`), or as an
    eager call does (`i / (T - 1)`, what the JAX compact plan uses)."""
    if timesteps == 1:
        return np.zeros(1, np.float32)
    i = np.arange(timesteps - 1, dtype=np.float32)
    div = np.float32(timesteps - 1)
    t = i * (np.float32(1.0) / div) if jitted else i / div
    return np.concatenate([t, np.ones(1, np.float32)])


def mask_counts(noise_schedule, seq_len: int, timesteps: int, jitted: bool = True) -> np.ndarray:
    """Per-step number of masked positions, max(floor(p(t_i) * seq), 1)."""
    p = noise_schedule(step_times(timesteps, jitted)).astype(np.float32)
    return np.maximum(np.floor(p * np.float32(seq_len)), 1).astype(np.int64)


def step_temperatures(temperature: float, timesteps: int) -> np.ndarray:
    """Annealed per-step temperature `temperature * (steps_left / T)` in
    f32, as the jitted JAX scan evaluates it: XLA folds the two constants,
    `steps_left * (temperature * (1 / T))`."""
    steps_left = np.arange(timesteps - 1, -1, -1).astype(np.float32)
    return steps_left * (np.float32(temperature) * (np.float32(1.0) / np.float32(timesteps)))


# ---------------------------------------------------------------------------
# top-k filtering
# ---------------------------------------------------------------------------


def top_k(logits: torch.Tensor, thres: float = 0.9) -> torch.Tensor:
    """Keep the top ceil((1 - thres) * vocab) logits, set the rest to -inf
    (ties at the k-th value are kept, as in the JAX package)."""
    vocab = logits.shape[-1]
    k = max(math.ceil((1 - thres) * vocab), 1)
    kth_val = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth_val, float("-inf"))


# ---------------------------------------------------------------------------
# confidence-based remasking
# ---------------------------------------------------------------------------


def mask_by_topk_scores(
    scores: torch.Tensor, num_masked: Union[int, torch.Tensor]
) -> torch.Tensor:
    """Boolean mask of the `num_masked` HIGHEST-score positions per row.

    Ties break at the lowest index, as the JAX version's stable argsort of
    `-scores` does: `torch.sort(stable=True)` keeps equal scores in index
    order, where `torch.topk` promises no order. `num_masked` is a host int
    or a per-row (b,) tensor."""
    b, seq = scores.shape
    order = torch.sort(-scores, dim=-1, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(
        1, order, torch.arange(seq, device=scores.device).expand(b, seq)
    )
    if isinstance(num_masked, torch.Tensor):
        num_masked = num_masked.reshape(b, 1)
    return ranks < num_masked
