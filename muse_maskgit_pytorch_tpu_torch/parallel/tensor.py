"""Tensor parallelism over a mesh's `tensor` axis: the collectives around a
layer whose weights are split over the axis, written out.

The JAX package has no counterpart of this module. There a leaf that
`shard_tree` or `shard_state_rules=` placed on the `tensor` axis is a
layout, and XLA's SPMD partitioner inserts the collectives that compute a
column-sharded projection on each device's columns. Here each rank runs the
trunk on its share and these functions are the collectives:

  * `copy_in`: identity forward, all-reduce backward -- the input of a
    column-parallel projection (`to_q`, `to_kv`, `proj_in`, `to_logits`),
    whose ranks each send back a part of its gradient; also a replicated
    leaf of which each rank uses a slice (`null_kv`, `q_scale`), so that
    its gradient is whole on every rank;
  * `reduce_out`: all-reduce forward, identity backward -- the output of a
    row-parallel projection (`to_out`, `proj_out`) and any sum of per-rank
    parts that every rank then uses whole;
  * `gather_last`: the ranks' slices of the last dim concatenated (the
    vocab-sharded logits that a sampler reads whole), this rank's slice of
    the gradient back.

A sum of which each rank uses only its own part (a LayerNorm's statistics
over a split dim) is `copy_in(reduce_out(x))`. All three run under
`torch.autograd.grad`, and with remat (a recomputed forward repeats its
collectives, in the same order on every rank).

Gloo on CUDA tensors: two ranks on one card cannot form an NCCL group, so
they use gloo, whose CUDA path PyTorch documents for `all_reduce` and
`broadcast`. `all_gather` is then an all-reduce of a zero-filled buffer in
which each rank fills its own part, summed as integers so that every bit
arrives (a -0.0 too). bf16 and f16 tensors are reduced in f32.

`plan` sets which modules compute on their rank's share, from where their
leaves are stored; `shard_module` is the counterpart of putting
`shard_tree`'s leaves into a model (`nnx.update`) for `generate`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from muse_maskgit_pytorch_tpu_torch.parallel.mesh import (
    DEFAULT_TP_RULES,
    TENSOR_AXIS,
    TrivialMesh,
    axis_coordinate,
    mesh_axes,
    shard_tree,
)

_LOW = (torch.bfloat16, torch.float16)


@dataclass(frozen=True, eq=False)
class TensorSplit:
    """A module's place on the tensor axis: the axis' process group, this
    rank's index along it and its size, and the module's leaves (names
    relative to it) that it holds as this rank's slice."""

    group: object
    rank: int
    size: int
    local: frozenset = frozenset()

    def __deepcopy__(self, memo):
        return self  # the process group is one object per process

    def splits(self, leaf: str) -> bool:
        return leaf in self.local

    def part(self, n: int) -> slice:
        """This rank's share of n things split evenly."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def tensor_split(mesh) -> Optional[TensorSplit]:
    """The mesh's tensor axis as seen from this rank, or None where it has
    none of size > 1."""
    index, size = axis_coordinate(mesh, TENSOR_AXIS)
    if size == 1:
        return None
    return TensorSplit(mesh.get_group(TENSOR_AXIS), index, size)


# -- collectives ----------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: `t` reduced over `group` (bf16 / f16 in f32)."""
    out = t.detach().float() if t.dtype in _LOW else t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.dtype)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's `t` (equal shapes) over `group` (None: the default
    group), in its rank order; on CUDA under gloo, `gather_by_all_reduce`."""
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return gather_by_all_reduce(t, group)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def gather_by_all_reduce(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """`all_gather` as an integer all-reduce of a zero-filled buffer in
    which each rank fills its row: exact to the bit."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    n = raw.numel()
    words = (n + 7) // 8 * 2  # rows of whole 8-byte words, so that any dtype views back
    buf = torch.zeros(size, words, dtype=torch.int32, device=t.device)
    buf.view(torch.uint8)[rank, :n] = raw
    dist.all_reduce(buf, group=group)
    rows = buf.view(torch.uint8)
    return [rows[i, :n].view(t.dtype).view(t.shape) for i in range(size)]


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.split.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        return all_reduce(x, split.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return torch.cat(all_gather(x, split.group), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        split = ctx.split
        return grad.chunk(split.size, dim=-1)[split.rank].contiguous(), None


def copy_in(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """`x`, whose gradient is summed over the tensor group."""
    return _CopyIn.apply(x, split)


def reduce_out(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """The sum of every tensor rank's `x`; its gradient passes unchanged."""
    return _ReduceOut.apply(x, split)


def gather_last(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """Every tensor rank's `x` concatenated along the last dim."""
    return _GatherLast.apply(x, split)


def max_over(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """The elementwise max over the tensor group (no gradient)."""
    return all_reduce(x, split.group, dist.ReduceOp.MAX)


# -- which modules split --------------------------------------------------------------


def plan(module: nn.Module, placements: Mapping[str, Sequence], mesh) -> Dict[str, int]:
    """Set each submodule that can compute on a tensor rank's share (it has
    `tensor_local_leaves`) to do so where every leaf of one of its groups
    is stored split on the tensor axis along the group's dim (`placements`:
    leaf name -> placements, one a mesh dim); the others run whole. Returns
    leaf name -> dim of the leaves computed as this rank's slice."""
    split = tensor_split(mesh)
    names = list(mesh_axes(mesh))
    local: Dict[str, int] = {}
    for prefix, mod in module.named_modules():
        groups = getattr(mod, "tensor_local_leaves", None)
        if groups is None:
            continue
        mine: Dict[str, int] = {}
        for group in groups(split.size) if split is not None else ():
            full = {f"{prefix}.{n}" if prefix else n: d for n, d in group.items()}
            if all(placements.get(n) is not None and placements[n][names.index(TENSOR_AXIS)] == Shard(d) for n, d in full.items()):
                mine.update(group)
                local.update(full)
        mod.tensor_split = dataclasses.replace(split, local=frozenset(mine)) if mine else None
    return local


def unsplit(module: nn.Module) -> nn.Module:
    """Every submodule back to whole compute (its leaves must be whole)."""
    for mod in module.modules():
        if hasattr(mod, "tensor_local_leaves"):
            mod.tensor_split = None
    return module


def shard_module(module: nn.Module, mesh, rules=DEFAULT_TP_RULES) -> Dict[str, torch.Tensor]:
    """`shard_tree(module, mesh, rules)` put into `module`, as the JAX
    package puts a `shard_tree`'d state into a model before `jit(generate)`:
    each rank keeps its own slice of the leaves its modules compute as a
    share (`plan`), and every other leaf whole (the leaves must be equal on
    every rank). Returns `shard_tree`'s leaves."""
    shards = shard_tree(module, mesh, rules)
    if isinstance(mesh, TrivialMesh):
        return shards
    local = plan(module, {n: s.placements for n, s in shards.items() if isinstance(s, DTensor)}, mesh)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name in local:
            params[name].data = shards[name].to_local().clone()
    return shards
