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

The training masks (`batch_random_mask`, `get_mask_subset_prob`) take the
uniform scores the JAX package draws from a key, so that both packages can
be given the same draws.
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


NOISE_SCHEDULES = {"cosine": cosine_schedule, "linear": linear_schedule}


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
    """-log(-log(u)), u ~ U[0, 1) drawn in `dtype` from `generator` on
    `device` (as the JAX package draws u in the dtype it is given)."""
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
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """First-index argmax of `logits / max(temperature, 1e-10) + gumbel`
    over the last axis (int64 ids), in the logits' dtype as the JAX package
    takes it (bf16 logits: the noise, the division and the sum are bf16).
    The noise is drawn from `generator` on the logits' device, or given as
    `noise` (the logits' shape). The temperature (a number or a 0-d tensor)
    divides as a tensor: CUDA would turn a division by a python scalar into
    a multiply by its reciprocal."""
    dt = logits.dtype
    if isinstance(temperature, torch.Tensor) and temperature.device == logits.device:
        temp = temperature.to(dt)
    else:  # a number, or a host tensor: filled on the device, no copy
        temp = torch.full((), float(temperature), dtype=dt, device=logits.device)
    temp = temp.clamp(min=1e-10)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device, dt)
    return first_argmax(logits / temp + noise.to(dt))


# ---------------------------------------------------------------------------
# training masks (the JAX package draws from keys; here the uniform scores
# are given, so a test can hand both sides the same draws)
# ---------------------------------------------------------------------------


def uniform(shape, generator: Optional[torch.Generator] = None, device=None, dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) of `shape` from `generator`."""
    return torch.rand(tuple(shape), generator=generator, device=device, dtype=dtype)


def prob_mask_like(shape, prob: float, u: Optional[torch.Tensor] = None, generator=None, device=None) -> torch.Tensor:
    """Bernoulli(prob) bool mask, `u < prob` for the uniforms `u` (drawn
    from `generator` when not given); prob 0 and 1 need no draw."""
    if prob == 1:
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)
    if prob == 0:
        return torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    u = uniform(shape, generator, device) if u is None else u
    return u < prob


def _ranks(scores: torch.Tensor) -> torch.Tensor:
    """Ascending rank of each score in its row (a double stable argsort, as
    `jnp.argsort` is stable)."""
    return torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1, stable=True)


def get_mask_subset_prob(mask: torch.Tensor, prob: float, scores: torch.Tensor, min_mask: int = 0) -> torch.Tensor:
    """Random subset of the bool `mask` (b, n) with per-row expected fraction
    `prob`: rank the uniform `scores` (b, n) with the non-mask positions
    forced to the bottom and keep the ranks below `mask.sum(-1) * prob`
    (f32, as JAX's traced product is), after discounting the padding."""
    num_to_mask = (mask.sum(dim=-1, keepdim=True) * prob).float().clamp(min=min_mask)
    logits = torch.where(mask, scores, torch.full_like(scores, -1.0))
    randperm = _ranks(logits).float() - (~mask).sum(dim=-1, keepdim=True)
    return (randperm < num_to_mask) & mask


def batch_random_mask(scores: torch.Tensor, num_masked: torch.Tensor) -> torch.Tensor:
    """Bool (b, n) mask with exactly `num_masked[b]` True entries per row,
    at the positions of the lowest uniform `scores` (b, n)."""
    return _ranks(scores) < num_masked.reshape(-1, 1)


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
