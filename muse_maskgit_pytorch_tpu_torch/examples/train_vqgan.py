"""Train the VQ-GAN image tokenizer on a folder of images (counterpart of
`examples/train_vqgan.py`).

    python -m muse_maskgit_pytorch_tpu_torch.examples.train_vqgan --folder images/ --results-folder results/

Checkpoints and reconstructions go to `--results-folder` (`vae.<step>.pt`
files and train-state steps, as `VQGanVAETrainer` writes them).

Data parallel over several processes, one a GPU, with the state sharded
(FSDP / ZeRO) across them under `--shard-state`:

    torchrun --nproc-per-node 4 -m muse_maskgit_pytorch_tpu_torch.examples.train_vqgan --folder images/ --shard-state

Every rank reads the same batches and trains on its rows of each; rank 0
writes the checkpoints, images and metrics.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from muse_maskgit_pytorch_tpu_torch.parallel.mesh import join_torchrun_group


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--folder", required=True, help="image folder (recursive jpg/jpeg/png)")
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--codebook-size", type=int, default=65536)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--grad-accum-every", type=int, default=8)
    p.add_argument("--num-train-steps", type=int, default=50000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--lr-decay-steps", type=int, default=None, help="cosine-decay the lr over this many steps after warmup")
    p.add_argument("--results-folder", default="./results")
    p.add_argument("--use-ema-vq", action="store_true", help="EMA vector quantizer instead of LFQ")
    p.add_argument(
        "--fsq-levels", type=int, nargs="+", default=None, help="FSQ quantizer levels, e.g. 8 8 8 5 5 5 (codebook = product)"
    )
    p.add_argument("--bf16-vgg", action="store_true", help="bf16 compute in the VGG perceptual tower (losses stay f32)")
    p.add_argument(
        "--bf16", action="store_true",
        help="bf16 compute in the encoder / decoder with f32 master weights; discriminator, VGG and losses stay f32",
    )
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
    p.add_argument("--no-random-flip", action="store_true", help="no random horizontal flip of the training images")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns the trainer after its last step."""
    args = parser().parse_args(argv)
    from muse_maskgit_pytorch_tpu_torch import VQGanVAE, VQGanVAETrainer

    joined = join_torchrun_group(args.device)

    vae = VQGanVAE(
        dim=args.dim,
        codebook_size=args.codebook_size,
        lookup_free_quantization=not args.use_ema_vq,
        fsq_levels=tuple(args.fsq_levels) if args.fsq_levels else None,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        vgg_dtype=torch.bfloat16 if args.bf16_vgg else None,
        generator=torch.Generator().manual_seed(0),
        device=args.device,
    )
    trainer = VQGanVAETrainer(
        vae,
        folder=args.folder,
        num_train_steps=args.num_train_steps,
        batch_size=args.batch_size,
        image_size=args.image_size,
        lr=args.lr,
        warmup_steps=args.warmup_steps,
        lr_decay_steps=args.lr_decay_steps,
        grad_accum_every=args.grad_accum_every,
        results_folder=args.results_folder,
        use_ema=True,
        auto_resume=args.resume,
        async_checkpoints=args.async_checkpoints,
        max_checkpoints=args.max_checkpoints,
        random_flip=not args.no_random_flip,
        shard_state=args.shard_state,
    )
    trainer.train()
    if joined:
        dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
