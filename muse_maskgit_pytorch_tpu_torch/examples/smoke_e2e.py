"""End-to-end smoke run: train a tiny VQ-GAN and a tiny MaskGit on
synthetic data, then sample text -> image; the README's workflow in
miniature (counterpart of `examples/smoke_e2e.py`).

    python -m muse_maskgit_pytorch_tpu_torch.examples.smoke_e2e [--device cpu]

The trainers' results folders go to a temporary directory.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--vae-steps", type=int, default=30)
    p.add_argument("--maskgit-steps", type=int, default=30)
    p.add_argument("--out", default="smoke_samples.png")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns the sampled images, (4, 32, 32, 3) in [0, 1]."""
    args = parser().parse_args(argv)
    device = "cpu" if args.cpu else args.device
    from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTrainer, MaskGitTransformer, VQGanVAE, VQGanVAETrainer
    from muse_maskgit_pytorch_tpu_torch.models import t5
    from muse_maskgit_pytorch_tpu_torch.training.data import make_grid, save_image

    # a tiny offline text encoder (random weights, the byte tokenizer)
    name = "smoke/tiny-t5"
    t5.T5_CONFIGS.setdefault(name, t5.T5Config(32, 64, 2, 16, 2, True))

    # synthetic data: coloured gradients
    rng = np.random.default_rng(0)
    size, n = 32, 64
    xs = np.linspace(0, 1, size)
    data, captions = [], []
    for i in range(n):
        gx, gy = rng.uniform(0.2, 1, 2)
        mx, my = np.meshgrid(xs * gx, xs * gy, indexing="ij")
        data.append(np.stack([mx, my, np.full((size, size), rng.uniform())], -1))
        captions.append(f"gradient {i % 4}")
    data = np.stack(data).astype(np.float32)

    with tempfile.TemporaryDirectory() as results:
        print("== training tiny VQ-GAN VAE")
        vae = VQGanVAE(
            dim=32, layers=2, codebook_size=256, use_vgg_and_gan=False, generator=torch.Generator().manual_seed(0),
            device=device,
        )
        vae_trainer = VQGanVAETrainer(
            vae, folder=None, dataset=list(data), num_train_steps=args.vae_steps, batch_size=8, image_size=size,
            lr=2e-3, valid_frac=0.0, use_ema=False, save_results_every=10**9, save_model_every=10**9,
            results_folder=f"{results}/vae",
        )
        t0 = time.perf_counter()
        vae_trainer.train()
        print(f"   {args.vae_steps} steps in {time.perf_counter() - t0:.1f}s")
        trained_vae = vae_trainer.vae_module()

        print("== training tiny MaskGit")
        fmap = trained_vae.get_encoded_fmap_size(size)
        transformer = MaskGitTransformer(
            num_tokens=256, dim=64, seq_len=fmap * fmap, depth=2, dim_head=16, heads=4, t5_name=name,
            generator=torch.Generator().manual_seed(0), device=device,
        )
        maskgit = MaskGit(image_size=size, transformer=transformer, vae=trained_vae, device=device)
        mg_trainer = MaskGitTrainer(
            maskgit, num_train_steps=args.maskgit_steps, batch_size=8, lr=1e-3, results_folder=f"{results}/mg",
            save_model_every=10**9, use_ema=False,
        )

        def batches():
            while True:
                idx = rng.integers(0, n, 8)
                yield data[idx], [captions[i] for i in idx]

        t0 = time.perf_counter()
        mg_trainer.train(batches())
        print(f"   {args.maskgit_steps} steps in {time.perf_counter() - t0:.1f}s")

    print("== sampling")
    trained = mg_trainer.maskgit_module()
    images = trained.generate(
        texts=["gradient 0", "gradient 1", "gradient 2", "gradient 3"],
        generator=torch.Generator(device=device).manual_seed(0), timesteps=8, cond_scale=3.0,
    )
    images = images.clamp(0, 1).float().cpu().numpy()
    save_image(make_grid(images, nrow=2), args.out)
    print(f"saved {args.out}; pixel range [{images.min():.2f}, {images.max():.2f}]")
    return images


if __name__ == "__main__":
    main()
