"""Data-parallel, FSDP and tensor-parallel training and serving over a
`torch.distributed` process group (counterpart of
`muse_maskgit_pytorch_tpu/parallel/`; the collectives of tensor parallelism,
which XLA inserts in JAX, are `parallel.tensor`)."""

from muse_maskgit_pytorch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DEFAULT_TP_RULES,
    FSDP_AXIS,
    TENSOR_AXIS,
    TrivialMesh,
    create_mesh,
    fsdp_axis_for,
    fsdp_partition_specs,
    init_distributed,
    is_main_process,
    mesh_axes,
    partition_specs_for,
    replicate,
    shard_batch,
    shard_tree,
    sharded_state_bytes,
    state_shardings,
)
