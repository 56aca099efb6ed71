"""A `VQGanVAETrainer` state's bytes, replicated against sharded over the
ranks (counterpart of `examples/fsdp_memory_report.py`).

    python -m muse_maskgit_pytorch_tpu_torch.examples.fsdp_memory_report --device cpu --ranks 8 \
        --dim 256 --image-size 256

On the CPU it starts `--ranks` gloo processes (a file-store rendezvous in a
temporary directory, loopback only). Each builds the VAE on the `meta`
device, takes `parallel.fsdp_partition_specs`' placements over a
{data: ranks} mesh, and materialises only its own shards of the weights,
Adam's moments and the EMA, as `DTensor`s on the CPU, so N ranks hold one
model between them, not N. Rank 0 prints the state's total bytes and the
bytes of the fullest rank, for the replicated state (every rank holds all
of it) and the sharded one (`parallel.sharded_state_bytes`). The frozen
VGG tower (a small stand-in unless `--real-vgg`) and EMA-VQ's codebook
stay whole on every rank, as the trainer keeps them.

On the card (`--device cuda`, the default) each process drives one GPU
(launched by `torchrun`, or one alone): it builds the real trainer with
`shard_state=True`, runs one step at `--batch`, and prints the state's
bytes and the step's peak device memory.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dim", type=int, default=256, help="VAE base dim")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch", type=int, default=8, help="batch of the step on the card")
    p.add_argument("--codebook", type=int, default=65536)
    p.add_argument("--use-ema-vq", action="store_true", help="EMA vector quantizer instead of LFQ")
    p.add_argument("--ranks", type=int, default=8, help="gloo processes on the CPU")
    p.add_argument("--real-vgg", action="store_true", help="the full VGG16 perceptual tower (else a small stand-in)")
    p.add_argument("--json", default=None, help="also write the numbers to this file")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


class _Tower(torch.nn.Module):
    """A stand-in perceptual tower: the VGG is frozen and replicated, so it
    moves the totals and not the sharded share."""

    def __init__(self, device):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1, device=device)
        self.fc = torch.nn.Linear(8, 16, device=device)

    def forward(self, x):
        h = torch.relu(self.conv(x.permute(0, 3, 1, 2))).mean(dim=(2, 3))
        return torch.relu(self.fc(h))


def _vae(args, device):
    from muse_maskgit_pytorch_tpu_torch import VQGanVAE

    vae = VQGanVAE(
        dim=args.dim, layers=args.layers, codebook_size=args.codebook, use_vgg_and_gan=True,
        lookup_free_quantization=not args.use_ema_vq, generator=torch.Generator().manual_seed(0), device=device,
    )
    if not args.real_vgg:
        vae.set_vgg(_Tower(device))
    vae.vgg  # the tower is part of the state
    return vae


def _state_layout(vae, mesh, sharded: bool) -> dict:
    """The trainer's state (`VQGanVAETrainer.state` and its VGG) with this
    rank's shards materialised on the CPU; the replicated layout on `meta`."""
    from torch.distributed.tensor import DTensor, Shard

    from muse_maskgit_pytorch_tpu_torch.parallel.mesh import fsdp_partition_specs, jax_dim_orders, local_shard
    from muse_maskgit_pytorch_tpu_torch.training.trainers import vqgan_param_groups

    named = dict(vae.named_parameters())
    gen, discr = vqgan_param_groups(vae)
    specs = fsdp_partition_specs({n: named[n] for n in gen + discr}, mesh, dim_orders=jax_dim_orders(vae))

    def leaf(name):
        full = named[name]
        if not sharded:
            return torch.empty_like(full, device="meta")
        placements = specs[name]
        local = torch.zeros(local_shard(full, placements, mesh).shape, dtype=full.dtype)
        if any(isinstance(p, Shard) for p in placements):
            return DTensor.from_local(local, mesh, placements, run_check=False)
        return local

    def group(names):
        return {n: leaf(n) for n in names}

    return dict(
        gen_params=group(gen), discr_params=group(discr), gen_opt=dict(mu=group(gen), nu=group(gen)),
        discr_opt=dict(mu=group(discr), nu=group(discr)), ema=group(gen),
        buffers={n: torch.empty_like(b, device="meta") for n, b in vae.named_buffers()},
        vgg={n: torch.empty_like(p, device="meta") for n, p in vae.vgg.named_parameters()},
    )


def _cpu_rank(rank: int, world: int, store_path: str, args, out_path: str) -> None:
    from muse_maskgit_pytorch_tpu_torch.parallel import create_mesh, init_distributed, sharded_state_bytes

    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks talk over the loopback interface only
    init_distributed(backend="gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        mesh = create_mesh()
        with torch.device("meta"):
            vae = _vae(args, "meta")
        rows = {}
        for name, sharded in (("replicated", False), ("sharded", True)):
            total, local = sharded_state_bytes(_state_layout(vae, mesh, sharded))
            per_rank = [None] * world
            dist.all_gather_object(per_rank, local)
            rows[name] = dict(total=total, per_rank=max(per_rank), ranks=per_rank)
        if rank == 0:
            Path(out_path).write_text(json.dumps(rows))
    finally:
        dist.destroy_process_group()


def _report(rows: dict, axes: dict) -> None:
    for name in ("replicated", "sharded"):
        r = rows[name]
        print(f"[{name}] state {r['total'] / 1e9:.3f}G total, {r['per_rank'] / 1e9:.3f}G per rank", flush=True)
    rep, sh = rows["replicated"]["per_rank"], rows["sharded"]["per_rank"]
    print(f"FSDP state reduction: {rep / 1e9:.3f}G -> {sh / 1e9:.3f}G per rank ({rep / max(sh, 1):.2f}x) over {axes}", flush=True)


def _cpu(args) -> dict:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rows.json"
        mp.start_processes(
            _cpu_rank, args=(args.ranks, str(Path(tmp) / "store"), args, str(out)), nprocs=args.ranks,
            start_method="spawn",
        )
        rows = json.loads(out.read_text())
    _report(rows, {"data": args.ranks})
    return rows


def _card(args) -> dict:
    from muse_maskgit_pytorch_tpu_torch import VQGanVAETrainer
    from muse_maskgit_pytorch_tpu_torch.parallel import create_mesh, is_main_process, sharded_state_bytes
    from muse_maskgit_pytorch_tpu_torch.parallel.mesh import join_torchrun_group, mesh_axes

    joined = join_torchrun_group(args.device)
    mesh = create_mesh()
    world = dist.get_world_size() if dist.is_initialized() else 1
    images = np.random.default_rng(0).uniform(size=(2 * args.batch, args.image_size, args.image_size, 3)).astype(np.float32)
    rows = {}
    for name, shard in (("replicated", False), ("sharded", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            trainer = VQGanVAETrainer(
                _vae(args, args.device), folder=None, dataset=images, num_train_steps=1, batch_size=args.batch,
                image_size=args.image_size, mesh=mesh, shard_state=shard, save_results_every=10**9,
                save_model_every=10**9, results_folder=tmp, valid_frac=0.0,
            )
            total, local = sharded_state_bytes(trainer.state)
            trainer.train_step_arrays(images[None, : args.batch], images[None, args.batch :])
            torch.cuda.synchronize()
            rows[name] = dict(total=total, per_rank=local, peak=torch.cuda.max_memory_allocated())
            del trainer
    if is_main_process():
        _report(rows, mesh_axes(mesh))
        for name in rows:
            print(f"[{name}] step peak {rows[name]['peak'] / 2**30:.3f} GiB on rank 0 of {world}", flush=True)
    if joined:
        dist.destroy_process_group()
    return rows


def main(argv=None):
    """Returns {"replicated": {...}, "sharded": {...}} (bytes)."""
    args = parser().parse_args(argv)
    rows = _cpu(args) if torch.device(args.device).type == "cpu" else _card(args)
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
