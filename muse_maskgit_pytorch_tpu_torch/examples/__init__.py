"""The example command lines of the port (counterparts of the repository's
`examples/*.py`), each run as a module:

    python -m muse_maskgit_pytorch_tpu_torch.examples.<name> --help

Each takes its JAX counterpart's arguments and `--device` (default "cuda":
the models are built on the GPU unless `--device cpu` asks for the CPU),
writes images through the port's own PNG encoder; the trainers run data
parallel under `torchrun` (`--shard-state` shards their state). Each has a
`main(argv=None)` that tests call in-process.
"""
