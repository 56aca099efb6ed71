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
from typing import Optional, Union

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


def schedule_values(noise_schedule, timesteps: int, jitted: bool = True) -> np.ndarray:
    """float32 mask fraction p(t_i) of each step, the value the jitted JAX
    scan computes (`mask_counts` and the edit budgets are derived from it)."""
    return noise_schedule(step_times(timesteps, jitted)).astype(np.float32)


def mask_counts(noise_schedule, seq_len: int, timesteps: int, jitted: bool = True) -> np.ndarray:
    """Per-step number of masked positions, max(floor(p(t_i) * seq), 1)."""
    p = schedule_values(noise_schedule, timesteps, jitted)
    return np.maximum(np.floor(p * np.float32(seq_len)), 1).astype(np.int64)


def guidance_ramp(start: float, end: float, timesteps: int) -> np.ndarray:
    """float32 per-step guidance scales of a `(start, end)` schedule, as the
    jitted JAX decode builds them with `jnp.linspace(start, end, T)`: XLA
    rewrites the division by T - 1 into a multiply by r = 1 / (T - 1) and
    folds the constant `end * r`, so step i is `start * (1 - i * r) +
    i * (end * r)` and the last step is `end`. `torch.linspace` and numpy's
    differ from it in the last bit."""
    if timesteps == 1:
        return np.array([start], np.float32)
    i = np.arange(timesteps - 1, dtype=np.float32)
    r = np.float32(1.0) / np.float32(timesteps - 1)
    ramp = np.float32(start) * (np.float32(1.0) - i * r) + i * (np.float32(end) * r)
    return np.concatenate([ramp, np.array([end], np.float32)])


def step_temperatures(temperature: float, timesteps: int) -> np.ndarray:
    """Annealed per-step temperature `temperature * (steps_left / T)` in
    f32, as the jitted JAX scan evaluates it: XLA folds the two constants,
    `steps_left * (temperature * (1 / T))`."""
    steps_left = np.arange(timesteps - 1, -1, -1).astype(np.float32)
    return steps_left * (np.float32(temperature) * (np.float32(1.0) / np.float32(timesteps)))


# ---------------------------------------------------------------------------
# gumbel sampling
# ---------------------------------------------------------------------------


def log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(t.clamp(min=eps))


def gumbel_noise(
    shape, generator: Optional[torch.Generator] = None, device=None, dtype=torch.float32
) -> torch.Tensor:
    """-log(-log(u)), u ~ U[0, 1) drawn from `generator` on `device`."""
    u = torch.rand(tuple(shape), generator=generator, device=device, dtype=dtype)
    return -log(-log(u))


def first_argmax(t: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximal value along the last axis (int64), as
    `jnp.argmax` returns it, in a form that does not depend on how a device
    reduces ties: the lowest index among the positions equal to the maximum."""
    n = t.shape[-1]
    idx = torch.arange(n, device=t.device, dtype=torch.int32)
    at_max = t == t.amax(dim=-1, keepdim=True)
    first = torch.where(at_max, idx, n).amin(dim=-1)
    return first.clamp_(max=n - 1).long()  # a row with a NaN has no position equal to its maximum


def gumbel_sample(
    logits: torch.Tensor,
    temperature=1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """First-index argmax of `logits / max(temperature, 1e-10) + gumbel`
    over the last axis (int64 ids). The noise is drawn in f32 from
    `generator` on the logits' device and the sum is taken in f32, whatever
    the logits' dtype (the JAX package draws its noise in the logits' dtype;
    the two random streams cannot agree anyway)."""
    temperature = max(float(temperature), 1e-10)
    g = gumbel_noise(logits.shape, generator, logits.device)
    return first_argmax(logits.float() / temperature + g)


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
