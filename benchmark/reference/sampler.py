"""Plain reference of the decode loop's sampler, from its published contract
(the port's K1 and exact sampler both draw this noise):

- the guided logits of a row are filtered to those at or above the top-k
  threshold that 10 rounds of value bisection between the row's minimum
  and maximum find (the largest mid that keeps at least k logits);
- each kept logit gets Gumbel noise from Philox4x32-10 (Salmon et al.,
  SC'11): key (seed, row), counter (column // 4, 0, 0, 0), output word
  column % 4, its top 23 bits turned into u = bits 2^-23 + 2^-24 and
  g = -log(-log(u));
- the token is the first argmax of l / T + g, T the step's temperature
  `temperature (steps left) / steps`;
- the token's confidence is its softmax probability under the unfiltered
  guided logits, and the next step remasks the least confident of the
  positions this step filled.

A frozen copy: it imports nothing of the program.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
U32 = 0xFFFFFFFF
BISECT_ITERS = 10
# rows a block: the noise of (rows, candidates) is worked out in int64
CHUNK = 2048


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a u32 constant and an int64
    tensor of u32 values, without overflowing int64."""
    t = a * (b & 0xFFFF)
    u = a * (b >> 16)
    low = ((u & 0xFFFF) << 16) + t
    return ((u >> 16) + (low >> 32)) & U32, low & U32


def philox4x32_10(x0, x1, x2, x3, k0, k1):
    for _ in range(10):
        hi0, lo0 = _mulhilo32(M0, x0)
        hi1, lo1 = _mulhilo32(M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + W0) & U32
        k1 = (k1 + W1) & U32
    return x0, x1, x2, x3


def gumbel_at(seed: int, keys: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """f32 Gumbel noise at `cols` (R, C) int64 of the rows keyed `keys` (R,)."""
    x0 = cols >> 2
    zero = torch.zeros_like(x0)
    k1 = (keys[:, None] & U32).expand_as(x0)
    words = torch.stack(philox4x32_10(x0, zero, zero, zero, int(seed) & U32, k1), dim=-1)
    bits = words.gather(-1, (cols & 3)[..., None])[..., 0]
    u = (bits >> 9).to(torch.float32) * (1.0 / (1 << 23)) + (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def topk_threshold(l: torch.Tensor, k: int) -> torch.Tensor:
    """(R, 1) threshold of f32 rows: bisection keeping count(l >= lo) >= k."""
    lo = l.amin(dim=-1, keepdim=True)
    hi = l.amax(dim=-1, keepdim=True)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = (l >= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return lo


def step_temperature(temperature: float, step: int, steps: int) -> float:
    return float(temperature) * (steps - 1 - step) / steps


def _candidates(l: torch.Tensor, k: int, temp: float, seed: int, keys: torch.Tensor):
    """Per row: the threshold (R,), and the kept logits, their columns and
    their l + T g in logit units (R, C; -inf past a row's kept ones)."""
    th = topk_threshold(l, k)
    count = int((l >= th).sum(dim=-1).max())
    vals, cols = l.topk(count, dim=-1)
    z = torch.where(vals >= th, vals + temp * gumbel_at(seed, keys, cols), float("-inf"))
    return th[:, 0], vals, cols, z


def margins(l: torch.Tensor, tok: torch.Tensor, k: int, temp: float, seed: int, keys: torch.Tensor) -> torch.Tensor:
    """(R,) by how much, in logits, the reference's f32 guided logits `l`
    (R, V) would have to move for each token `tok` to be the choice: the
    token has to be kept (its distance below the threshold), and each other
    kept logit has to fall behind it (its lead in l + T g) or out of the
    filter (its height above the threshold), whichever is nearer. 0 where
    the token is the reference's choice."""
    out = []
    for s in range(0, l.shape[0], CHUNK):
        lc, t, ky = l[s : s + CHUNK], tok[s : s + CHUNK, None], keys[s : s + CHUNK]
        th, vals, cols, z = _candidates(lc, k, temp, seed, ky)
        lt = lc.gather(1, t)[:, 0]
        own = lt + temp * gumbel_at(seed, ky, t)[:, 0]
        beat = torch.minimum(z - own[:, None], vals - th[:, None])
        beat = torch.where((cols != t) & torch.isfinite(z), beat, float("-inf")).amax(dim=-1)
        out.append(torch.maximum(beat, th - lt).clamp(min=0.0))
    return torch.cat(out)


def choose(l: torch.Tensor, k: int, temp: float, seed: int, keys: torch.Tensor) -> torch.Tensor:
    """(R,) the tokens a sampler on logits `l` picks (the control's)."""
    out = []
    for s in range(0, l.shape[0], CHUNK):
        _, _, cols, z = _candidates(l[s : s + CHUNK], k, temp, seed, keys[s : s + CHUNK])
        out.append(cols.gather(1, z.argmax(dim=-1, keepdim=True))[:, 0])
    return torch.cat(out)


def log_confidence(l: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """(R,) log softmax probability of `tok` under the unfiltered `l`."""
    return torch.cat([
        l[s : s + CHUNK].gather(1, tok[s : s + CHUNK, None])[:, 0] - torch.logsumexp(l[s : s + CHUNK], dim=-1)
        for s in range(0, l.shape[0], CHUNK)
    ])


def remask_gap(lp: torch.Tensor, filled: torch.Tensor, remasked: torch.Tensor) -> float:
    """The widest breach of the confidence order, in log probability: over
    the rows, how far the most confident remasked position (of those
    `filled` the step before) lies above the least confident kept one.
    `lp` (b, n) holds the reference's log confidences at `filled`; ties
    read 0."""
    hi = torch.where(remasked & filled, lp, float("-inf")).amax(dim=1)
    lo = torch.where(filled & ~remasked, lp, float("inf")).amin(dim=1)
    gap = hi - lo
    gap = torch.where(torch.isfinite(gap), gap, torch.zeros_like(gap)).clamp(min=0.0)
    return float(gap.max()) if gap.numel() else 0.0


def least_confident(lp: torch.Tensor, filled: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(b, n) bool: per row, the `count` positions of `filled` with the
    lowest `lp` (the control's remask)."""
    key = torch.where(filled, lp, float("inf"))
    ranks = torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1, stable=True)
    return ranks < count[:, None]
