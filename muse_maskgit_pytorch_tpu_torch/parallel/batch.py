"""The statistics a model takes over its whole batch, when the batch is
split over ranks.

A data-parallel step gives each rank some rows of the global batch. A mean
over rows is then each rank's own mean averaged over the ranks, which the
gradient all-reduce does already; but a few quantities are not means of
per-row terms, and JAX computes them over the global batch: LFQ's codebook
entropy (the entropy of the batch-mean code distribution), EMA-VQ's
k-means, codebook sums and revival draws, and the adaptive generator weight
(the ratio of two gradient norms). Under `split_over(group, size)` the
models reduce those across the ranks of `group`; outside it (one process,
or a batch each rank holds whole) they do as before.

Sampling's draws are per row: under `rows_from(start)` the models' batches
are rows `start ...` of a global batch, and `MaskGit.generate` keys K1's
noise on the global row (`row_offset()`), so a rank samples its rows as one
process samples them in the whole batch.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from muse_maskgit_pytorch_tpu_torch.parallel.tensor import all_gather

_SPLIT: ContextVar[Optional[Tuple[object, int]]] = ContextVar("batch_split", default=None)
_ROW0: ContextVar[int] = ContextVar("batch_row_offset", default=0)


@contextlib.contextmanager
def split_over(group, size: int):
    """The models' batches in this block are one of `size` equal parts of
    the global batch, one a rank of `group` (None: the default group)."""
    token = _SPLIT.set((group, size) if size > 1 else None)
    try:
        yield
    finally:
        _SPLIT.reset(token)


@contextlib.contextmanager
def rows_from(start: int):
    """The models' batches in this block start at row `start` of a global
    batch that other ranks decode the rest of."""
    token = _ROW0.set(int(start))
    try:
        yield
    finally:
        _ROW0.reset(token)


def row_offset() -> int:
    """The global index of this block's first row (0 outside `rows_from`)."""
    return _ROW0.get()


def mean_over_ranks(t: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
    """The mean of `t` over the ranks (`t` itself when the batch is not
    split). `differentiable`: the gradient flows back to every rank's `t`
    (its backward all-reduces the gradient)."""
    split = _SPLIT.get()
    if split is None:
        return t
    group, size = split
    if differentiable:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t, group=group) / size
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out / size


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0 in rank order: the global
    batch's rows (no gradient). `t` itself when the batch is not split."""
    split = _SPLIT.get()
    if split is None:
        return t
    return torch.cat(all_gather(t, split[0]), dim=0)
