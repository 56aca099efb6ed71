"""Sample text -> image with a trained base (and optionally super-res)
MaskGit, the cascade included (counterpart of `examples/sample.py`).

    python -m muse_maskgit_pytorch_tpu_torch.examples.sample "a red fox" \
        --base-checkpoint base.msgpack [--superres-checkpoint sr.msgpack]

The checkpoints are `MaskGit.save` files of either package; the images are
written as `<out-prefix>_<i>.png`.
"""

from __future__ import annotations

import argparse

import torch

from muse_maskgit_pytorch_tpu_torch.training.data import save_image


def load_maskgit(ckpt, vae_dim, codebook_size, image_size, dim, depth, t5_name, cond_image_size=None, device="cuda"):
    """A `MaskGit` of these widths (its VAE without the GAN towers) with
    the weights of `ckpt`."""
    from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, VQGanVAE

    vae = VQGanVAE(dim=vae_dim, codebook_size=codebook_size, use_vgg_and_gan=False, device=device)
    fmap = vae.get_encoded_fmap_size(image_size)
    transformer = MaskGitTransformer(
        num_tokens=codebook_size, seq_len=fmap * fmap, dim=dim, depth=depth, t5_name=t5_name,
        generator=torch.Generator().manual_seed(0), device=device,
    )
    mg = MaskGit(
        image_size=image_size, cond_image_size=cond_image_size, transformer=transformer, vae=vae,
        cond_vae=vae if cond_image_size else None, device=device,
    )
    mg.load(ckpt)
    return mg


def parse_size(s):
    """--image-size: '256' (square) or '192x256' ((h, w))."""
    if "x" in s:
        h, w = s.split("x", 1)
        return (int(h), int(w))
    return int(s)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("prompts", nargs="+")
    p.add_argument("--base-checkpoint", required=True)
    p.add_argument("--superres-checkpoint", default=None)
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--vae-dim", type=int, default=256)
    p.add_argument("--codebook-size", type=int, default=65536)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--t5-name", default="google/t5-v1_1-base")
    p.add_argument("--timesteps", type=int, default=18)
    p.add_argument("--cond-scale", type=float, default=3.0)
    p.add_argument(
        "--cond-scale-end", type=float, default=None,
        help="ramp guidance linearly from --cond-scale to this across steps (Muse's guidance schedule)",
    )
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-prefix", default="sample")
    p.add_argument(
        "--image-size", type=parse_size, default=None, metavar="N|HxW",
        help="generate at another resolution: an int, or HxW (divisible by the VAE's factor; for the cascade "
        "the base stage's size, which the super-res stage scales by its trained ratio)",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    from muse_maskgit_pytorch_tpu_torch import Muse

    widths = (args.vae_dim, args.codebook_size)
    base = load_maskgit(args.base_checkpoint, *widths, 256, args.dim, args.depth, args.t5_name, device=args.device)
    cond_scale = (args.cond_scale, args.cond_scale_end) if args.cond_scale_end is not None else args.cond_scale
    kw = dict(cond_scale=cond_scale, temperature=args.temperature, timesteps=args.timesteps, image_size=args.image_size)
    if args.superres_checkpoint:
        sr = load_maskgit(
            args.superres_checkpoint, *widths, 512, args.dim, args.depth, args.t5_name, cond_image_size=256,
            device=args.device,
        )
        muse = Muse(base, sr, device=args.device)
        images = muse(args.prompts, generator=torch.Generator().manual_seed(args.seed), return_pil_images=False, **kw)
    else:
        negative = [args.negative_prompt] * len(args.prompts) if args.negative_prompt else None
        images = base.generate(
            texts=args.prompts, negative_texts=negative,
            generator=torch.Generator(device=args.device).manual_seed(args.seed), **kw,
        )
    images = images.float().cpu().numpy()
    paths = []
    for i, img in enumerate(images):
        paths.append(f"{args.out_prefix}_{i}.png")
        save_image(img, paths[-1])
        print(f"saved {paths[-1]}")
    return paths


if __name__ == "__main__":
    main()
