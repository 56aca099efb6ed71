"""The benchmark's yardstick of work: operations and bytes reckoned from a
configuration and a traffic mix, never read from the program.

Frozen here so that a change to the program cannot move its own yardstick:

- `transformer_forward_flops`, `maskgit_generate_flops`,
  `maskgit_train_flops`: copies of the port's `utils/metrics.py`
  arithmetic (model FLOPs, 2 a multiply-add; softmax, norms and
  elementwise work not counted);
- the cosine schedule's mask counts and the compact decode's head rows a
  step (`compact_rows`), as the decode loop plans them;
- the VAE decode's and the T5 encoder's FLOPs;
- the least time of one K1, K2 or K2-backward launch (`Launch`), the larger
  of its operations at the peak rate and its bytes at the memory rate,
  counting each input byte once and each output byte once;
- the published dense peaks of one NVIDIA H100 SXM.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16 = 989e12  # FLOP/s on the tensor cores
PEAK_F32 = 67e12  # FLOP/s on the CUDA cores, no tensor cores
HBM_BYTES_S = 3.35e12  # device memory bytes/s


# -- the decode's schedule ------------------------------------------------------


def cosine_mask_counts(seq_len: int, timesteps: int, jitted: bool = True) -> np.ndarray:
    """Masked positions a step, max(floor(cos(t_i pi / 2) seq), 1), with t_i
    in f32 as `i * (1 / (T - 1))` (jitted) or `i / (T - 1)` (eager)."""
    if timesteps == 1:
        t = np.zeros(1, np.float32)
    else:
        i = np.arange(timesteps - 1, dtype=np.float32)
        div = np.float32(timesteps - 1)
        t = np.concatenate([i * (np.float32(1.0) / div) if jitted else i / div, np.ones(1, np.float32)])
    a = t * np.float32(math.pi) * np.float32(0.5)
    p = np.cos(a.astype(np.float64)).astype(np.float32)
    return np.maximum(np.floor(p * np.float32(seq_len)), 1).astype(np.int64)


def compact_rows(seq_len: int, timesteps: int) -> List[int]:
    """Head (and sampler) positions a row at each step of the compact
    decode: the step's count + 1 rounded up to seq / 8, the whole sequence
    at step 0 (base seq 256, T 18: 256 x6, 224 x2, 192 x2, 160 x2, 128,
    96 x2, 64, 32 x2)."""
    ks = cosine_mask_counts(seq_len, timesteps, jitted=False)
    gran = max(1, seq_len // 8)
    rows = [min(seq_len, -(-(int(k) + 1) // gran) * gran) for k in ks]
    if timesteps > 1 and int(ks[0]) < seq_len:
        rows[0] = seq_len
    return rows if timesteps > 1 else [seq_len]


# -- copies of utils/metrics.py -------------------------------------------------


def transformer_forward_flops(
    rows: int, n: int, m_cross: int, *, dim: int, depth: int, ff_mult: float = 4.0, self_cond: bool = False
) -> float:
    """Matmul FLOPs of one trunk forward over `rows` rows of `n` tokens with
    `m_cross` cross-attention keys; no vocab head, no context K/V."""
    D = dim
    inner = int(D * ff_mult * 2 / 3)
    per_layer = (
        3 * n * 2 * D * D
        + n * 2 * D * D
        + 2 * (2 * n * n * D)
        + n * 2 * D * D
        + n * 2 * D * D
        + 2 * (2 * n * m_cross * D)
        + 6 * n * D * inner
    )
    total = depth * per_layer
    if self_cond:
        total += 6 * n * D * int(D * 4 * 2 / 3)
    return float(rows * total)


def maskgit_generate_flops(
    *, batch: int, timesteps: int, seq_len: int, text_len: int, dim: int, depth: int, vocab: int,
    ff_mult: float = 4.0, cond_scale: float = 3.0, self_cond: bool = True, cond_seq_len: int = 0,
    head_positions_per_step: Sequence[int] = None, vae_decode_flops: float = 0.0,
) -> float:
    """Model FLOPs of one `generate` call: CFG-doubled trunk forwards, the
    compact vocab head, the context K/V once, and the VAE decode."""
    rows = batch * (2 if cond_scale != 1 else 1)
    m_cross = text_len + cond_seq_len + 1
    if head_positions_per_step is None:
        head_positions_per_step = [seq_len] * timesteps
    if len(head_positions_per_step) != timesteps:
        raise ValueError("one head position count per step")
    step_fwd = transformer_forward_flops(rows, seq_len, m_cross, dim=dim, depth=depth, ff_mult=ff_mult, self_cond=self_cond)
    head = sum(rows * p * 2 * dim * vocab for p in head_positions_per_step)
    ctx_kv = batch * depth * (text_len + cond_seq_len) * 2 * dim * (2 * dim)
    return float(timesteps * step_fwd + head + ctx_kv + vae_decode_flops)


def maskgit_train_flops(
    *, batch: int, seq_len: int, text_len: int, dim: int, depth: int, vocab: int, ff_mult: float = 4.0,
    self_cond: bool = True, self_cond_prob: float = 0.9, cond_seq_len: int = 0,
) -> float:
    """Model FLOPs of one train micro-batch: forward and backward (3x) of
    the trunk, context K/V and full head, and the expected self-conditioning
    forward."""
    m_cross = text_len + cond_seq_len + 1
    fwd = transformer_forward_flops(batch, seq_len, m_cross, dim=dim, depth=depth, ff_mult=ff_mult, self_cond=self_cond)
    ctx_kv = batch * depth * (text_len + cond_seq_len) * 2 * dim * (2 * dim)
    head = batch * seq_len * 2 * dim * vocab
    total = 3.0 * (fwd + ctx_kv + head)
    if self_cond:
        total += self_cond_prob * (fwd + ctx_kv)
    return float(total)


# -- the VAE decode and T5 -------------------------------------------------------


def vae_decode_flops(image_size: int, *, dim: int, layers: int, codebook_size: int, channels: int = 3) -> float:
    """FLOPs of one image's `decode_from_ids`: LFQ's projection of the
    bits, the GLU res block at the bottom, the transposed 4x4 stride-2
    convolutions up, the 1x1 convolution to pixels."""
    dims = [dim] + [dim * 2**t for t in range(layers)]
    f = image_size // 2**layers
    top = dims[-1]
    bits = int(math.log2(codebook_size))
    total = 2 * f * f * bits * top  # project_out
    # GLUResBlock(top): two 3x3 convolutions to 2 * top, a 1x1 top -> top
    total += 2 * (2 * f * f * 9 * top * 2 * top) + 2 * f * f * top * top
    side = f
    for d_in, d_out in zip(reversed(dims[1:]), reversed(dims[:-1])):
        total += 2 * side * side * d_in * d_out * 16  # each input pixel meets a 4x4 kernel
        side *= 2
    total += 2 * side * side * dim * channels
    return float(total)


def t5_encoder_flops(tokens: int, *, d_model: int, d_ff: int, num_heads: int, d_kv: int, num_layers: int) -> float:
    """FLOPs of a gated T5 encoder over one text of `tokens` tokens: q, k, v,
    o, the scores and value sum, wi_0, wi_1 and wo."""
    inner = num_heads * d_kv
    per_token = 4 * 2 * d_model * inner + 2 * 2 * tokens * inner + 3 * 2 * d_model * d_ff
    return float(num_layers * tokens * per_token)


# -- the kernels' least time a launch ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Launch:
    flops: float
    bytes: float
    peak: float = PEAK_BF16

    @property
    def bound_s(self) -> float:
        return max(self.flops / self.peak, self.bytes / HBM_BYTES_S)


def k2_forward(rows: int, n: int, keys_on: Sequence[int], *, heads: int, dim_head: int, keys: int,
               itemsize: int = 2) -> Launch:
    """One K2 forward launch: `rows` rows of `n` queries over `keys` keys of
    which row r has `keys_on[r]` left on (the null key besides). Operations
    4 n (on + 1) d a head; bytes: q and the output, k and v of the keys left
    on, the f32 key bias (when any key is off)."""
    h, d = heads, dim_head
    on = np.asarray(keys_on, np.float64)
    flops = float(4 * n * d * h * (on + 1).sum())
    moved = 2 * rows * n * h * d * itemsize + 2 * on.sum() * h * d * itemsize
    if (on < keys).any():
        moved += rows * keys * 4
    return Launch(flops, float(moved), PEAK_BF16 if itemsize == 2 else PEAK_F32)


def k2_backward(rows: int, n: int, keys_on: Sequence[int], *, heads: int, dim_head: int, keys: int,
                itemsize: int = 2) -> Launch:
    """One K2 backward call: 10 n (on + 1) d a head (the scores again, dP,
    dV, dQ, dK); bytes read q, k, v, the output, its gradient and the row
    logsumexp, written dq, dk, dv."""
    h, d = heads, dim_head
    on = np.asarray(keys_on, np.float64)
    flops = float(10 * n * d * h * (on + 1).sum())
    q_side = 3 * rows * n * h * d * itemsize + rows * n * h * d * itemsize  # q, out, g in; dq out
    k_side = 4 * on.sum() * h * d * itemsize  # k, v in; dk, dv out
    moved = q_side + k_side + rows * n * h * 4
    if (on < keys).any():
        moved += rows * keys * 4
    return Launch(flops, float(moved), PEAK_BF16 if itemsize == 2 else PEAK_F32)


def k1_launch(rows: int, vocab: int, itemsize: int = 2) -> Launch:
    """One K1 launch: reads `rows` rows of `vocab` logits, writes an int32
    token and an f32 probability a row (bytes bound)."""
    return Launch(0.0, float(rows * vocab * itemsize + rows * 8))
