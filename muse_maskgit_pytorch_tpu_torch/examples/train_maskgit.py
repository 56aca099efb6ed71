"""Train a base or super-res MaskGit (counterpart of
`examples/train_maskgit.py`).

    python -m muse_maskgit_pytorch_tpu_torch.examples.train_maskgit --folder images/ \
        --vae-checkpoint vae.msgpack [--cond-image-size 256]

Captions come from `<image-stem>.txt` files beside the images; an image
without one trains with an empty prompt (CFG's null conditioning).
`--token-shards` trains from pre-tokenized shards
(`tokenize_dataset`) through the native shard loader instead.

Data parallel over several processes, one a GPU, with the state sharded
(FSDP / ZeRO) across them under `--shard-state`:

    torchrun --nproc-per-node 4 -m muse_maskgit_pytorch_tpu_torch.examples.train_maskgit --folder images/ \
        --vae-checkpoint vae.msgpack --shard-state

`--batch-size` is the global batch. From a folder every rank reads the same
batches (one seeded shuffle) and trains on its rows; from token shards each
rank opens its share of the shards and reads its rows alone. Rank 0 writes
the checkpoints, samples and metrics.
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch
import torch.distributed as dist

from muse_maskgit_pytorch_tpu_torch.parallel.mesh import join_torchrun_group
from muse_maskgit_pytorch_tpu_torch.training.data import ImageDataset


class CaptionedImageDataset(ImageDataset):
    def caption(self, index: int) -> str:
        txt = self.paths[index].with_suffix(".txt")
        return txt.read_text().strip() if txt.exists() else ""

    def __getitem__(self, index):
        return super().__getitem__(index), self.caption(index)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--folder", help="captioned image folder")
    p.add_argument(
        "--token-shards", nargs="+", default=None,
        help="pre-tokenized shard files from tokenize_dataset (the native loader; the data stream resumes "
        "exactly with --resume)",
    )
    p.add_argument(
        "--shard-captions", action="store_true",
        help="join <shard>.captions sidecars for text conditioning (tokenize_dataset --captions)",
    )
    p.add_argument("--vae-checkpoint", required=True, help="VQGanVAE.save file of either package")
    p.add_argument("--vae-dim", type=int, default=256)
    p.add_argument("--codebook-size", type=int, default=65536)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--cond-image-size", type=int, default=None, help="set for the super-res stage")
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--grad-accum-every", type=int, default=1)
    p.add_argument("--num-train-steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--lr-decay-steps", type=int, default=None, help="cosine-decay the lr over this many steps after warmup")
    p.add_argument("--t5-name", default="google/t5-v1_1-base")
    p.add_argument("--self-token-critic", action="store_true")
    p.add_argument("--results-folder", default="./results-maskgit")
    p.add_argument("--resume", action="store_true")
    p.add_argument(
        "--shard-state", action="store_true",
        help="FSDP / ZeRO: shard the weights, Adam's moments and the EMA over the ranks (under torchrun)",
    )
    p.add_argument(
        "--async-checkpoints", action="store_true",
        help="checkpoint saves block only for the device->host copy and write on a background thread",
    )
    p.add_argument("--max-checkpoints", type=int, default=None, help="keep only the newest N train-state checkpoints")
    p.add_argument("--save-results-every", type=int, default=None, help="render a sample grid of --sample-texts every N steps")
    p.add_argument("--sample-texts", nargs="+", default=None, help="prompts of the periodic sample grid")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns the trainer after its last step."""
    p = parser()
    args = p.parse_args(argv)
    if not (args.folder or args.token_shards):
        p.error("pass --folder or --token-shards")
    from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTrainer, MaskGitTransformer, VQGanVAE

    joined = join_torchrun_group(args.device)

    vae = VQGanVAE(
        dim=args.vae_dim, codebook_size=args.codebook_size, generator=torch.Generator().manual_seed(0), device=args.device
    )
    vae.load(args.vae_checkpoint)
    fmap = vae.get_encoded_fmap_size(args.image_size)
    transformer = MaskGitTransformer(
        num_tokens=args.codebook_size, seq_len=fmap * fmap, dim=args.dim, depth=args.depth, t5_name=args.t5_name,
        generator=torch.Generator().manual_seed(0), device=args.device,
    )
    maskgit = MaskGit(
        image_size=args.image_size,
        cond_image_size=args.cond_image_size,
        transformer=transformer,
        vae=vae,
        cond_vae=vae if args.cond_image_size else None,
        self_token_critic=args.self_token_critic,
        device=args.device,
    )
    trainer = MaskGitTrainer(
        maskgit,
        num_train_steps=args.num_train_steps,
        batch_size=args.batch_size,
        lr=args.lr,
        warmup_steps=args.warmup_steps,
        lr_decay_steps=args.lr_decay_steps,
        grad_accum_every=args.grad_accum_every,
        results_folder=args.results_folder,
        auto_resume=args.resume,
        async_checkpoints=args.async_checkpoints,
        max_checkpoints=args.max_checkpoints,
        save_results_every=args.save_results_every,
        sample_texts=args.sample_texts,
        shard_state=args.shard_state,
    )
    if args.token_shards:
        trainer.train_from_shards(args.token_shards, use_captions=args.shard_captions)
    else:
        trainer.train(_folder_batches(args))
    if joined:
        dist.destroy_process_group()
    return trainer


def _folder_batches(args):
    """Global batches of (images, captions), in one seeded order, so every
    rank of a data-parallel run reads the same ones."""
    ds = CaptionedImageDataset(args.folder, args.image_size)
    order = random.Random(0)

    def batches():
        idx = list(range(len(ds)))
        while True:
            order.shuffle(idx)
            for i in range(0, len(idx) - args.batch_size + 1, args.batch_size):
                chunk = idx[i : i + args.batch_size]
                yield np.stack([ds[j][0] for j in chunk]), [ds.caption(j) for j in chunk]

    return batches()


if __name__ == "__main__":
    main()
