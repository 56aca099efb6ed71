"""A trainer's parameters over a mesh: data parallelism and ZeRO-3 state
sharding, written out with `torch.distributed` collectives.

Data parallel: each rank runs the step on its rows of the global batch
(`rows`), and `reduce` averages every rank's gradients in one all-reduce of
a flat buffer, so the update is the one a single process makes from the
whole batch.

Sharded (`shard=True` on a mesh with an axis of size > 1): each parameter
that `fsdp_partition_specs` shards lives as this rank's slice, a `DTensor`
(`masters`); the optimizer's moments and the EMA are made from the masters
and so shard alike. `materialize` all-gathers the whole weights into the
module's parameters for a step, `release` frees them after it, and
`reduce` leaves each rank its slice of the averaged gradient. The model's
forward and backward see ordinary parameters, so `torch.autograd.grad`
over a subset of them, the R1 penalty's double backward and every custom
kernel run as on one process (PyTorch's FSDP2 hooks would not fire for an
`autograd.grad` over the sharded parameters). The whole model is gathered
at once, not block by block: what a rank keeps between steps is its
shards, what it holds during a step is the whole model and its gradient.

With a `TrivialMesh` (no process group) every method is the identity.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.tensor import DTensor, Shard

from muse_maskgit_pytorch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    TENSOR_AXIS,
    TrivialMesh,
    axis_coordinate,
    fsdp_axis_for,
    fsdp_partition_specs,
    mesh_axes,
)
from muse_maskgit_pytorch_tpu_torch.utils.helpers import not_ported


class DistributedParams:
    def __init__(self, mesh, names: Sequence[str], params: Sequence[torch.Tensor], dim_orders=None, shard: bool = False, rules=None):
        if rules is not None or mesh_axes(mesh).get(TENSOR_AXIS, 1) > 1:
            raise not_ported("tensor parallelism over a `tensor` axis (shard_state_rules=)", "A11b")
        self.mesh = mesh
        self.names, self.params = list(names), list(params)
        self.active = not isinstance(mesh, TrivialMesh)
        self.world = dist.get_world_size() if self.active else 1
        if self.active and mesh.size() != self.world:
            raise ValueError(f"the mesh holds {mesh.size()} ranks, the process group {self.world}: span the whole group")
        self.data_index, self.data_size = axis_coordinate(mesh, DATA_AXIS)
        # the ranks that split the batch: the models' cross-rank statistics reduce over them
        self.data_group = mesh.get_group(DATA_AXIS) if self.data_size > 1 else None
        axis = fsdp_axis_for(mesh) if shard else None
        self.dims: List[Optional[int]] = [None] * len(self.params)
        self.placements: List[Optional[tuple]] = [None] * len(self.params)
        self.shard_index, self.shard_size, self.shard_group = 0, 1, None
        if axis is not None:
            specs = fsdp_partition_specs(dict(zip(self.names, self.params)), mesh, axis=axis, dim_orders=dim_orders)
            for i, name in enumerate(self.names):
                self.placements[i] = specs[name]
                self.dims[i] = next((p.dim for p in specs[name] if isinstance(p, Shard)), None)
            self.shard_index, self.shard_size = axis_coordinate(mesh, axis)
            self.shard_group = mesh.get_group(axis)
        self.sharded = [i for i, d in enumerate(self.dims) if d is not None]
        self.masters = list(self.params)
        with torch.no_grad():
            for i in self.sharded:
                local = self._slice(self.params[i].detach(), i).clone()
                self.masters[i] = DTensor.from_local(local, mesh, self.placements[i], run_check=False)
        self.release()

    def _slice(self, full: torch.Tensor, i: int) -> torch.Tensor:
        return full.chunk(self.shard_size, dim=self.dims[i])[self.shard_index]

    # -- the batch --------------------------------------------------------------

    def rows(self, batch: int) -> Tuple[int, int, int]:
        """(start, stop, parts): this rank's rows of a global batch and the
        number of parts the batch splits into. A batch that does not divide
        over the data axis warns and stays whole on every rank (each rank
        then computes the same gradient), as the JAX trainer leaves it
        replicated."""
        if self.data_size == 1:
            return 0, batch, 1
        if batch % self.data_size:
            warnings.warn(
                f"batch {batch} not divisible by data-parallel size {self.data_size}; batch left UNSHARDED "
                "(replicated). Pick batch_size divisible by the mesh's data axis.",
                stacklevel=3,
            )
            return 0, batch, 1
        per = batch // self.data_size
        return self.data_index * per, (self.data_index + 1) * per, self.data_size

    # -- the weights ------------------------------------------------------------

    @torch.no_grad()
    def gather(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors of a list aligned with the parameters (masters,
        moments or EMA): the sharded ones all-gathered (one collective),
        the others as they are. Every rank calls it."""
        out = list(tensors)
        if not self.sharded:
            return out
        local = [tensors[i].to_local() if isinstance(tensors[i], DTensor) else tensors[i] for i in self.sharded]
        flat = torch.cat([t.reshape(-1) for t in local])
        parts = [torch.empty_like(flat) for _ in range(self.shard_size)]
        dist.all_gather(parts, flat, group=self.shard_group)
        offset = 0
        for i, t in zip(self.sharded, local):
            n = t.numel()
            out[i] = torch.cat([p[offset : offset + n].view(t.shape) for p in parts], dim=self.dims[i])
            offset += n
        return out

    @torch.no_grad()
    def load(self, targets: Sequence[torch.Tensor], whole: Sequence[torch.Tensor]) -> None:
        """Copy whole tensors into a list aligned with the parameters: a
        sharded target takes this rank's slice."""
        for i, (t, w) in enumerate(zip(targets, whole)):
            if isinstance(t, DTensor):
                t.to_local().copy_(self._slice(w.to(t.device), i))
            else:
                t.copy_(w.to(t.device))

    def materialize(self) -> None:
        """The whole weights into the module's parameters (for a step)."""
        if self.sharded:
            whole = self.gather(self.masters)
            for i in self.sharded:
                self.params[i].data = whole[i]

    def release(self) -> None:
        """Free the gathered weights of the sharded parameters."""
        for i in self.sharded:
            p = self.params[i]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None

    # -- the gradient -----------------------------------------------------------

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor], *extra: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(gradients, extras) averaged over every rank in one all-reduce;
        a sharded parameter's gradient as this rank's slice (a `DTensor`).
        `extra` 0-d tensors (the step's losses) ride in the same buffer."""
        grads, extra = list(grads), [e.reshape(1) for e in extra]
        if not self.active:
            return grads, [e[0] for e in extra]
        tensors = grads + extra
        flat = _flatten_dense_tensors(tensors)
        dist.all_reduce(flat)
        flat.div_(self.world)
        out = list(_unflatten_dense_tensors(flat, tensors))
        grads, extra = out[: len(grads)], out[len(grads) :]
        for i in self.sharded:
            grads[i] = DTensor.from_local(self._slice(grads[i], i).contiguous(), self.mesh, self.placements[i], run_check=False)
        return grads, [e[0] for e in extra]
