"""A trainer's parameters over a mesh: data parallelism, ZeRO-3 state
sharding and tensor parallelism, written out with `torch.distributed`
collectives.

Data parallel: each rank runs the step on its rows of the global batch
(`rows`, split over the `data` axis), and `reduce` averages every rank's
gradients in one all-reduce of a flat buffer, so the update is the one a
single process makes from the whole batch.

Sharded (`shard=True` on a mesh with an axis of size > 1): each parameter
that `fsdp_partition_specs` shards lives as this rank's slice, a `DTensor`
(`masters`); the optimizer's moments and the EMA are made from the masters
and so shard alike. `materialize` all-gathers the weights into the module's
parameters for a step, `release` frees them after it, and `reduce` leaves
each rank its slice of the averaged gradient. The model's forward and
backward see ordinary parameters, so `torch.autograd.grad` over a subset of
them, the R1 penalty's double backward and every custom kernel run as on
one process (PyTorch's FSDP2 hooks would not fire for an `autograd.grad`
over the sharded parameters). The whole model is gathered at once, not
block by block: what a rank keeps between steps is its shards, what it
holds during a step is the model and its gradient.

Tensor parallel (`rules`, JAX's `shard_state_rules`, on a mesh with a
`tensor` axis): the rules place leaves on the tensor axis as JAX places
them, leaf by leaf, and `parallel.tensor.plan` sets the modules that compute
on their rank's share to do so (`split_compute`). Such a leaf is
materialized as this rank's tensor slice (gathered over the fsdp axis only)
and its gradient is this slice's whole gradient; every other leaf is
gathered whole, and the modules make its gradient whole on every tensor
rank (`parallel.tensor.copy_in`). So `reduce` averages over the ranks that
hold the same tensor slice (the `data` and `fsdp` ranks of this tensor
index) and the step's loss, which every tensor rank computes whole, counts
once per data index.

With a `TrivialMesh` (no process group) every method is the identity.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

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
    local_shard,
    mesh_axes,
)
from muse_maskgit_pytorch_tpu_torch.parallel.tensor import all_gather


class DistributedParams:
    def __init__(self, mesh, names: Sequence[str], params: Sequence[torch.Tensor], dim_orders=None, shard: bool = False, rules=None):
        self.mesh = mesh
        self.names, self.params = list(names), list(params)
        self.active = not isinstance(mesh, TrivialMesh)
        self.world = dist.get_world_size() if self.active else 1
        if self.active and mesh.size() != self.world:
            raise ValueError(f"the mesh holds {mesh.size()} ranks, the process group {self.world}: span the whole group")
        self.data_index, self.data_size = axis_coordinate(mesh, DATA_AXIS)
        # the ranks that split the batch: the models' cross-rank statistics reduce over them
        self.data_group = mesh.get_group(DATA_AXIS) if self.data_size > 1 else None
        axes = list(mesh_axes(mesh))
        self.placements: List[Optional[tuple]] = [None] * len(self.params)
        # (axis, dim) of each split a leaf is stored in, and of those it is computed in
        self.stored: List[List[Tuple[str, int]]] = [[] for _ in self.params]
        self.computed: List[List[Tuple[str, int]]] = [[] for _ in self.params]
        axis = fsdp_axis_for(mesh) if shard else None
        if self.active and shard and (axis is not None or rules):
            specs = fsdp_partition_specs(
                dict(zip(self.names, self.params)), mesh, axis=axis, base_rules=rules, dim_orders=dim_orders
            )
            for i, name in enumerate(self.names):
                self.placements[i] = specs[name]
                self.stored[i] = [(ax, p.dim) for ax, p in zip(axes, specs[name]) if isinstance(p, Shard)]
        self.sharded = [i for i, s in enumerate(self.stored) if s]
        used = [ax for ax in axes if any(a == ax for s in self.stored for a, _ in s)]  # in mesh order on every rank
        self.coords = {ax: axis_coordinate(mesh, ax) for ax in used}
        self.groups = {ax: mesh.get_group(ax) for ax in used}
        # the gradient's reduction: over the world, or, with leaves split on
        # the tensor axis, over the ranks that hold this rank's tensor slice
        self.replica_group, self.replica_size = None, self.world
        if TENSOR_AXIS in used:
            self.replica_group, self.replica_size = _replica_group(mesh)
        self.masters = list(self.params)
        with torch.no_grad():
            for i in self.sharded:
                local = local_shard(self.params[i].detach(), self.placements[i], mesh).clone()
                self.masters[i] = DTensor.from_local(local, mesh, self.placements[i], run_check=False)
        self.release()

    def split_compute(self, local: Dict[str, int]) -> None:
        """The leaves (name -> dim) that the modules compute as this rank's
        tensor slice (`parallel.tensor.plan`); each must be stored split
        there along that dim."""
        for i, name in enumerate(self.names):
            if name in local:
                split = (TENSOR_AXIS, local[name])
                if split not in self.stored[i]:
                    raise ValueError(f"{name} is computed split as {split} but stored as {self.stored[i]}")
                self.computed[i] = [split]

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

    def _gathered(self, tensors: Sequence[torch.Tensor], keep: Sequence[Sequence[Tuple[str, int]]]) -> List[torch.Tensor]:
        """`tensors` (aligned with the parameters) gathered over each split
        they are stored in but not `keep[i]`: one collective an axis."""
        out = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
        for ax, group in self.groups.items():
            todo = [(i, d) for i in self.sharded for a, d in self.stored[i] if a == ax and (a, d) not in keep[i]]
            if not todo:
                continue
            parts = all_gather(torch.cat([out[i].reshape(-1) for i, _ in todo]), group)
            offset = 0
            for i, d in todo:
                n = out[i].numel()
                out[i] = torch.cat([p[offset : offset + n].view(out[i].shape) for p in parts], dim=d)
                offset += n
        return out

    @torch.no_grad()
    def gather(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors of a list aligned with the parameters (masters,
        moments or EMA): the sharded ones all-gathered, the others as they
        are. Every rank calls it."""
        if not self.sharded:
            return list(tensors)
        return self._gathered(tensors, [[]] * len(tensors))

    @torch.no_grad()
    def load(self, targets: Sequence[torch.Tensor], whole: Sequence[torch.Tensor]) -> None:
        """Copy whole tensors into a list aligned with the parameters: a
        sharded target takes this rank's slice."""
        for i, (t, w) in enumerate(zip(targets, whole)):
            if isinstance(t, DTensor):
                t.to_local().copy_(local_shard(w.to(t.device), self.placements[i], self.mesh))
            else:
                t.copy_(w.to(t.device))

    @torch.no_grad()
    def materialize(self) -> None:
        """The weights a step computes with into the module's parameters:
        this rank's tensor slice of a leaf computed split, the others whole."""
        if self.sharded:
            forms = self._gathered(self.masters, self.computed)
            for i in self.sharded:
                self.params[i].data = forms[i]

    def release(self) -> None:
        """Free the gathered weights of the sharded parameters."""
        for i in self.sharded:
            p = self.params[i]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None

    # -- the gradient -----------------------------------------------------------

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor], *extra: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(gradients, extras) averaged over the ranks that hold this rank's
        tensor slice (every rank without tensor splits) in one all-reduce; a
        sharded parameter's gradient as this rank's slice (a `DTensor`).
        `extra` 0-d tensors (the step's losses) ride in the same buffer."""
        grads, extra = list(grads), [e.reshape(1) for e in extra]
        if not self.active:
            return grads, [e[0] for e in extra]
        tensors = grads + extra
        flat = _flatten_dense_tensors(tensors)
        if self.replica_size > 1:
            dist.all_reduce(flat, group=self.replica_group)
            flat.div_(self.replica_size)
        out = list(_unflatten_dense_tensors(flat, tensors))
        grads, extra = out[: len(grads)], out[len(grads) :]
        for i in self.sharded:
            g = grads[i]
            for ax, d in self.stored[i]:
                if (ax, d) not in self.computed[i]:
                    index, size = self.coords[ax]
                    g = g.chunk(size, dim=d)[index]
            grads[i] = DTensor.from_local(g.contiguous(), self.mesh, self.placements[i], run_check=False)
        return grads, [e[0] for e in extra]


def _replica_group(mesh) -> Tuple[Optional[object], int]:
    """(group, size) of the ranks whose tensor index is this rank's: one
    group per tensor index, made by every rank in the same order (None for
    groups of one)."""
    axes = list(mesh_axes(mesh))
    layout = mesh.mesh.movedim(axes.index(TENSOR_AXIS), 0).reshape(mesh_axes(mesh)[TENSOR_AXIS], -1)
    if layout.shape[1] == 1:
        return None, 1
    group, _ = dist.new_subgroups_by_enumeration([row.tolist() for row in layout])
    return group, layout.shape[1]
