"""Training observability (counterpart of
`muse_maskgit_pytorch_tpu/utils/metrics.py`): an append-only JSONL of
per-step scalars, a rolling step timer, and the analytic model FLOPs of a
MaskGit forward, `generate` call and train step, for MFU against the H100's
dense bf16 peak; `profile_trace`, a TensorBoard trace of a block of work;
and `span`, the named ranges (`muse.*`) that the generate and train paths
mark inside a trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from pathlib import Path
from typing import Optional

import torch

# NVIDIA H100 SXM: 989 TFLOP/s dense bf16 tensor-core peak (data sheet, 700 W)
H100_BF16_PEAK_FLOPS = 989e12


class MetricsLogger:
    """One JSON object a line: {"step", "time", **scalars}."""

    def __init__(self, path, enabled: bool = True, flush_every: int = 1):
        self.path = Path(path)
        self.enabled = enabled
        self.flush_every = flush_every
        self._fh = None
        self._since_flush = 0
        if enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)

    def log(self, step: int, **scalars):
        if not self.enabled or self._fh is None:
            return
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        self._fh.write(json.dumps(record) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self._fh.flush()
            self._since_flush = 0

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class StepTimer:
    """Rolling steps per second over the last `window` ticks."""

    def __init__(self, window: int = 50):
        self._times = deque(maxlen=window)

    def tick(self) -> None:
        self._times.append(time.perf_counter())

    @property
    def steps_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else None


def transformer_forward_flops(
    rows: int,
    n: int,
    m_cross: int,
    *,
    dim: int,
    depth: int,
    ff_mult: float = 4.0,
    self_cond: bool = False,
) -> float:
    """Matmul FLOPs (2 per multiply-add) of one Transformer forward over
    `rows` batch rows of `n` tokens with `m_cross` cross-attention keys:
    the q/k/v and output projections, both attentions' products, the GEGLU
    feed-forward (inner = dim * mult * 2 / 3) and the self-conditioning
    feed-forward. Softmax, norms and elementwise work are not counted (the
    model-FLOPs convention); nor are the vocab head and the context K/V
    projections (see the callers)."""
    D = dim
    inner = int(D * ff_mult * 2 / 3)
    per_layer = (
        3 * n * 2 * D * D  # self-attention q, k, v projections
        + n * 2 * D * D  # self-attention output projection
        + 2 * (2 * n * n * D)  # self-attention scores and value sum
        + n * 2 * D * D  # cross-attention q projection
        + n * 2 * D * D  # cross-attention output projection
        + 2 * (2 * n * m_cross * D)  # cross-attention scores and value sum
        + 6 * n * D * inner  # GEGLU feed-forward
    )
    total = depth * per_layer
    if self_cond:
        total += 6 * n * D * int(D * 4 * 2 / 3)  # self_cond_to_init_embed
    return float(rows * total)


def maskgit_generate_flops(
    *,
    batch: int,
    timesteps: int,
    seq_len: int,
    text_len: int,
    dim: int,
    depth: int,
    vocab: int,
    ff_mult: float = 4.0,
    cond_scale: float = 3.0,
    self_cond: bool = True,
    cond_seq_len: int = 0,
    head_positions_per_step=None,
    vae_decode_flops: float = 0.0,
) -> float:
    """Model FLOPs of one `MaskGit.generate` call: `timesteps` CFG-doubled
    trunk forwards, the (compact) vocab head (`head_positions_per_step`,
    default the full sequence every step), the context K/V projected once,
    and the VAE decode."""
    rows = batch * (2 if cond_scale != 1 else 1)
    m_cross = text_len + cond_seq_len + 1  # + the null key
    if head_positions_per_step is None:
        head_positions_per_step = [seq_len] * timesteps
    if len(head_positions_per_step) != timesteps:
        raise ValueError("one head position count per step")
    step_fwd = transformer_forward_flops(
        rows, seq_len, m_cross, dim=dim, depth=depth, ff_mult=ff_mult, self_cond=self_cond
    )
    head = sum(rows * p * 2 * dim * vocab for p in head_positions_per_step)
    ctx_kv = batch * depth * (text_len + cond_seq_len) * 2 * dim * (2 * dim)
    return float(timesteps * step_fwd + head + ctx_kv + vae_decode_flops)


def maskgit_train_flops(
    *,
    batch: int,
    seq_len: int,
    text_len: int,
    dim: int,
    depth: int,
    vocab: int,
    ff_mult: float = 4.0,
    self_cond: bool = True,
    self_cond_prob: float = 0.9,
    cond_seq_len: int = 0,
    critic: bool = False,
    vae_encode_flops: float = 0.0,
) -> float:
    """Model FLOPs of one MaskGit train micro-batch (`MaskGit.forward` and
    its backward): the main forward (trunk, context K/V projections, the
    full vocab head) at 3x (forward + backward), the expected no-grad
    self-conditioning forward (probability `self_cond_prob`, no head),
    optionally a TokenCritic's forward and backward, and the frozen VAE
    encode of the images path. Divide by seconds x `H100_BF16_PEAK_FLOPS`
    for MFU."""
    m_cross = text_len + cond_seq_len + 1  # + the null key
    fwd = transformer_forward_flops(
        batch, seq_len, m_cross, dim=dim, depth=depth, ff_mult=ff_mult, self_cond=self_cond
    )
    ctx_kv = batch * depth * (text_len + cond_seq_len) * 2 * dim * (2 * dim)
    head = batch * seq_len * 2 * dim * vocab
    total = 3.0 * (fwd + ctx_kv + head)
    if self_cond:
        total += self_cond_prob * (fwd + ctx_kv)
    if critic:
        critic_fwd = transformer_forward_flops(batch, seq_len, m_cross, dim=dim, depth=depth, ff_mult=ff_mult)
        total += 3.0 * (critic_fwd + ctx_kv + batch * seq_len * 2 * dim)
    return float(total + vae_encode_flops)


_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
# a function-scope record: the host event alone. A `record_function` is a
# user-scope record, which on a GPU also writes a device-side interval
# ("gpu_user_annotation") over the span's kernels, and a reader of the
# trace's device activity would count that as device work
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """`with span("muse.step"):` marks the block as a named range in the
    running `torch.profiler` trace (a `profile_trace`, a benchmark's
    traced run), on the profiler's clock: the kernels launched inside hold
    it in their chain of host events, and an idle gap of the device inside
    it is labelled with it. With no profiler running it is one shared
    no-op context, about a microsecond a use. `name` is a fixed string;
    the spans of the generate and train paths are listed in `PERF.md`,
    section 3. There is no store of its own: the profiler keeps them."""
    return _record(name) if _profiling() else _NO_SPAN


@contextlib.contextmanager
def profile_trace(log_dir, enabled: bool = True):
    """`with profile_trace("traces/step"): trainer.train_step()` writes a
    TensorBoard-viewable trace (`torch.profiler`, the card's kernels too
    when a card is present) of everything run inside, into `log_dir`.
    With `enabled=False` it runs the block and writes nothing. The trace
    carries the `muse.*` spans of the generate and train paths (`span`;
    their list is in `PERF.md`, section 3)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
