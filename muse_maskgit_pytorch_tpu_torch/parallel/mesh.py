"""Process group, device mesh and sharding specs (counterpart of
`muse_maskgit_pytorch_tpu/parallel/mesh.py`, under its names).

The JAX package builds a `jax.sharding.Mesh` over the devices of a slice and
lets XLA insert the collectives. Here each process drives one device, the
processes form a `torch.distributed` process group (`init_distributed`:
NCCL on CUDA, gloo on the CPU, or gloo on CUDA tensors for several ranks on
one card), and `create_mesh` lays the group's ranks out as a
`torch.distributed.device_mesh.DeviceMesh` with named axes, of the device
type the ranks compute on. With no
process group, `create_mesh` gives a `TrivialMesh` of size 1 that needs
none, so a single-process caller runs as before.

The spec functions are pure functions of a mesh's axis names and sizes (a
`DeviceMesh`, a `TrivialMesh`, or a plain `{name: size}` dict), so one
process can compute what eight would do. They work on the port's state
dicts: names are `named_parameters` names and layouts are the port's
(`Linear.weight` is (out, in) where flax's kernel is (in, out), a
`Conv2d.weight` OIHW where flax's is HWIO). A spec is, as JAX's
`PartitionSpec`, a tuple over a leaf's dims of an axis name or None, with
the trailing Nones dropped; `fsdp_partition_specs` turns it into
placements, one `Shard(dim)` / `Replicate()` a mesh dim, as a `DTensor`
takes them. Where JAX picks "the largest evenly divisible dim", the port
walks the leaf's dims in flax's order (`jax_dim_orders`), so a tie goes to
the same logical dim on both sides.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

DATA_AXIS = "data"
TENSOR_AXIS = "tensor"
FSDP_AXIS = "fsdp"

Spec = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class TrivialMesh:
    """The mesh of a single process without a process group: every axis of
    size 1. It has the `DeviceMesh` attributes the port reads."""

    mesh_dim_names: Tuple[str, ...] = (DATA_AXIS,)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,) * len(self.mesh_dim_names)


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, a `TrivialMesh` or a dict."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def create_mesh(shape: Optional[Dict[str, int]] = None, devices: Optional[Sequence[int]] = None):
    """A mesh over the process group's ranks (or `devices`, a list of
    ranks). Default: all of them on one `data` axis. `shape` maps axis name
    to size; one axis may be -1 (inferred). Without a process group, a
    `TrivialMesh` (every size 1)."""
    grouped = dist.is_available() and dist.is_initialized()
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size() if grouped else 1))
    n = len(ranks)
    shape = dict(shape) if shape else {DATA_AXIS: n}
    names, sizes = tuple(shape), list(shape.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} ranks do not divide by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} != {n} ranks"
            + ("" if grouped else ": a mesh of more than one rank needs init_distributed() first")
        )
    if not grouped:
        return TrivialMesh(names)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_rank_device_type(), torch.tensor(ranks).reshape(sizes), mesh_dim_names=names)


def axis_coordinate(mesh, axis: str) -> Tuple[int, int]:
    """(this rank's index along `axis`, the axis' size); (0, 1) for an axis
    the mesh lacks or a trivial mesh."""
    axes = mesh_axes(mesh)
    if axes.get(axis, 1) == 1 or isinstance(mesh, (TrivialMesh, Mapping)):
        return 0, axes.get(axis, 1)
    return int(mesh.get_local_rank(axis)), axes[axis]


def shard_batch(batch, mesh, axis: str = DATA_AXIS):
    """This rank's rows of a global host batch (a tensor, an array, or
    dicts / lists / tuples of them): the leading dim split evenly over
    `axis`, in rank order."""
    index, size = axis_coordinate(mesh, axis)

    def take(x):
        if isinstance(x, Mapping):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if x is None or size == 1:
            return x
        if x.shape[0] % size:
            raise ValueError(f"batch {x.shape[0]} does not divide over the {size} ranks of axis {axis!r}")
        per = x.shape[0] // size
        return x[index * per : (index + 1) * per]

    return take(batch)


def replicate(tree, mesh):
    """Broadcast every tensor of `tree` (dicts / lists / tuples of tensors)
    from rank 0, in place; returns `tree`."""
    if isinstance(mesh, TrivialMesh) or not dist.is_initialized():
        return tree

    def visit(x):
        if isinstance(x, Mapping):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(x.data, src=0)

    visit(tree)
    return tree


def is_main_process() -> bool:
    """Rank 0 of the process group, or True without one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


# the device type the ranks of the group that `init_distributed` made compute on
_group_device: Dict[int, str] = {}


def _rank_device_type() -> str:
    """"cuda" or "cpu": what `init_distributed` was told, else CUDA under
    NCCL and the CPU under any other backend."""
    group = dist.distributed_c10d._get_default_group()
    return _group_device.get(id(group), "cuda" if dist.get_backend() == "nccl" else "cpu")


def init_distributed(
    backend: Optional[str] = None, init_method: Optional[str] = None, device: Optional[str] = None, **kwargs
) -> None:
    """`torch.distributed.init_process_group`, the rank and world from
    `torchrun`'s environment unless given (`rank=`, `world_size=`,
    `init_method=` or `store=`). `device` is the device type the ranks
    compute on, "cuda" (the default where CUDA is) or "cpu"; the backend
    defaults to NCCL on CUDA and gloo on the CPU. `backend="gloo"` on CUDA
    puts several ranks on one card, which NCCL refuses; gloo's collectives
    then pass through the host. On CUDA the rank's device is `LOCAL_RANK`
    (or rank mod the device count). A no-op when the group exists; a failed
    NCCL init raises."""
    if dist.is_initialized():
        return
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend == "nccl" and device != "cuda":
        raise ValueError("NCCL runs on CUDA tensors only")
    if "store" not in kwargs:
        kwargs["init_method"] = init_method or "env://"
    elif init_method is not None:
        raise ValueError("pass init_method or store, not both")
    if device == "cuda":
        rank = kwargs.get("rank", int(os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs.setdefault("device_id", torch.device("cuda", local))
    dist.init_process_group(backend, **kwargs)
    _group_device.clear()
    _group_device[id(dist.distributed_c10d._get_default_group())] = device


def join_torchrun_group(device) -> bool:
    """Join the process group that `torchrun` describes in the environment
    (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`): gloo for a CPU
    run, NCCL else. Returns whether this call created the group (the
    caller then destroys it); False outside `torchrun` or with a group."""
    if "RANK" not in os.environ or dist.is_initialized():
        return False
    init_distributed(device=torch.device(device).type)
    return True


# ---------------------------------------------------------------------------
# FSDP / ZeRO-style state sharding
# ---------------------------------------------------------------------------


def fsdp_axis_for(mesh) -> Optional[str]:
    """The axis a train state shards over: `fsdp` if the mesh has it with
    size > 1, else `data` (ZeRO: the state sharded over the ranks that
    split the batch), else None."""
    axes = mesh_axes(mesh)
    for ax in (FSDP_AXIS, DATA_AXIS):
        if axes.get(ax, 1) > 1:
            return ax
    return None


def jax_dim_orders(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """For each parameter and buffer of `module` whose layout differs from
    flax's, the port dims in flax's dim order: a `Linear.weight` (out, in)
    is flax's (in, out) -> (1, 0); a `Conv2d.weight` OIHW is HWIO ->
    (2, 3, 1, 0); a `ConvTranspose2d.weight` (in, out, kh, kw) is
    (kh, kw, in, out) -> (2, 3, 0, 1). The other leaves keep their order."""
    orders = {}
    for mod_name, mod in module.named_modules():
        order = None
        if isinstance(mod, nn.ConvTranspose2d):
            order = (2, 3, 0, 1)
        elif isinstance(mod, nn.Conv2d):
            order = (2, 3, 1, 0)
        elif isinstance(mod, nn.Linear):
            order = (1, 0)
        if order is not None and getattr(mod, "weight", None) is not None:
            orders[f"{mod_name}.weight" if mod_name else "weight"] = order
    return orders


def _leaves(tree) -> Dict[str, torch.Tensor]:
    """name -> tensor of a module (parameters, then buffers) or a mapping."""
    if isinstance(tree, nn.Module):
        return {**dict(tree.named_parameters()), **dict(tree.named_buffers())}
    return dict(tree)


def _strip(parts) -> Spec:
    parts = list(parts)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def to_placements(spec: Spec, mesh) -> Tuple:
    """A spec as placements, one a mesh dim: `Shard(d)` on the mesh dims
    that dim d names, `Replicate()` on the others."""
    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, ax in enumerate(spec) if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_spec(placements: Sequence, mesh, ndim: int) -> Spec:
    """The inverse of `to_placements` (one mesh axis a tensor dim)."""
    parts = [None] * ndim
    for name, p in zip(mesh_axes(mesh), placements):
        if isinstance(p, Shard):
            parts[p.dim] = name
    return _strip(parts)


def _fsdp_specs(tree, mesh, axis=None, min_size=16384, base_rules=None, dim_orders=None) -> Dict[str, Spec]:
    axes = mesh_axes(mesh)
    axis = axis or fsdp_axis_for(mesh)
    if axis is not None and axis not in axes:
        raise ValueError(f"fsdp axis {axis!r} not in mesh axes {tuple(axes)}")
    leaves = _leaves(tree)
    if dim_orders is None:
        dim_orders = jax_dim_orders(tree) if isinstance(tree, nn.Module) else {}
    base = partition_specs_for(leaves, base_rules) if base_rules else {}

    def axis_size(ax) -> int:
        return int(np.prod([axes[a] for a in ax])) if isinstance(ax, tuple) else axes[ax]

    def in_mesh(ax) -> bool:
        return all(a in axes for a in (ax if isinstance(ax, tuple) else (ax,)))

    specs = {}
    for name, x in leaves.items():
        shape = tuple(x.shape)
        parts = [None] * len(shape)
        # rules naming axes absent from this mesh replicate
        for i, ax in enumerate(base.get(name, ())[: len(shape)]):
            if ax is not None and in_mesh(ax) and shape[i] % axis_size(ax) == 0:
                parts[i] = ax
        if axis is not None and int(np.prod(shape, initial=1)) >= min_size:
            n = axes[axis]
            best, best_dim = -1, -1
            for i in dim_orders.get(name, range(len(shape))):  # flax's order: ties go the same way
                if parts[i] is None and shape[i] % n == 0 and shape[i] > best:
                    best, best_dim = shape[i], i
            if best_dim >= 0:
                parts[best_dim] = axis
        specs[name] = _strip(parts)
    return specs


def fsdp_partition_specs(tree, mesh, axis: Optional[str] = None, min_size: int = 16384, base_rules=None, dim_orders=None):
    """ZeRO / FSDP placements of a state (a module, or a mapping of name ->
    tensor with `dim_orders` from `jax_dim_orders`): each leaf shards its
    largest evenly divisible dim over `axis` (default `fsdp_axis_for`);
    leaves below `min_size` entries and leaves with no divisible dim
    replicate. With `base_rules` (`DEFAULT_TP_RULES`) a leaf a rule matches
    keeps the rule's dims where they divide and the axis takes the largest
    free dim. Returns name -> placements, one a mesh dim."""
    specs = _fsdp_specs(tree, mesh, axis, min_size, base_rules, dim_orders)
    return {name: to_placements(spec, mesh) for name, spec in specs.items()}


def state_shardings(tree, mesh, axis: Optional[str] = None, base_rules=None, dim_orders=None):
    """name -> (mesh, placements) for `fsdp_partition_specs`: what
    `DTensor.from_local` / `distribute_tensor` take."""
    return {n: (mesh, p) for n, p in fsdp_partition_specs(tree, mesh, axis, base_rules=base_rules, dim_orders=dim_orders).items()}


def sharded_state_bytes(tree) -> Tuple[int, int]:
    """(total bytes, this rank's bytes) of a state (nested dicts / lists of
    tensors): a `DTensor` counts its global shape in the total and its
    local shard in this rank's; a plain tensor counts whole in both."""
    total, local = 0, 0

    def visit(x):
        nonlocal total, local
        if isinstance(x, Mapping):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, DTensor):
            size = x.element_size()
            total += x.numel() * size
            local += x.to_local().numel() * size
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
            local += x.numel() * x.element_size()

    visit(tree)
    return total, local


# ---------------------------------------------------------------------------
# parameter partition rules (tensor parallelism)
# ---------------------------------------------------------------------------

# JAX's DEFAULT_TP_RULES in the port's names and layout: flax's `to_q/kernel`
# (in, out) under P(None, tensor) is `to_q.weight` (out, in) under
# (tensor, None); the embedding has one layout on both sides.
DEFAULT_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*to_q\.weight$", (TENSOR_AXIS, None)),
    (r".*to_kv\.weight$", (TENSOR_AXIS, None)),
    (r".*to_out\.weight$", (None, TENSOR_AXIS)),
    (r".*proj_in\.weight$", (TENSOR_AXIS, None)),
    (r".*proj_out\.weight$", (None, TENSOR_AXIS)),
    (r".*to_logits\.weight$", (TENSOR_AXIS, None)),
    (r".*token_emb\.weight$", (TENSOR_AXIS, None)),
)


def partition_specs_for(tree, rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> Dict[str, Spec]:
    """name -> spec by the first rule whose regex matches the '.'-joined
    name and whose spec fits the leaf's rank; unmatched leaves replicate
    (the empty spec)."""
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
    out = {}
    for name, leaf in _leaves(tree).items():
        out[name] = ()
        for pat, spec in compiled:
            if pat.match(name) and len(spec) <= leaf.dim():
                out[name] = _strip(spec)
                break
    return out


def shard_tree(tree, mesh, rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES):
    """name -> `DTensor` of each leaf under its rule's spec over `mesh`,
    dims that do not divide replicated; each rank keeps its own slice (the
    leaves must be equal on every rank). The leaves as they are on a
    trivial mesh."""
    leaves = _leaves(tree)
    if isinstance(mesh, TrivialMesh):
        return leaves
    axes = mesh_axes(mesh)
    out = {}
    for name, spec in partition_specs_for(leaves, rules).items():
        x = leaves[name].detach()
        fixed = []
        for d, ax in enumerate(spec):
            size = int(np.prod([axes[a] for a in ax])) if isinstance(ax, tuple) else axes.get(ax, 0) if ax else 0
            fixed.append(ax if ax is not None and size and x.shape[d] % size == 0 else None)
        placements = to_placements(_strip(fixed), mesh)
        out[name] = DTensor.from_local(local_shard(x, placements, mesh), mesh, placements, run_check=False)
    return out


def local_shard(full: torch.Tensor, placements: Sequence, mesh) -> torch.Tensor:
    """This rank's slice of `full` under `placements` (a view)."""
    for name, p in zip(mesh_axes(mesh), placements):
        if isinstance(p, Shard):
            index, size = axis_coordinate(mesh, name)
            full = full.chunk(size, dim=p.dim)[index]
    return full
