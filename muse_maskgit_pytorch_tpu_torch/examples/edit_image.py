"""Edit, inpaint or outpaint an image with a trained MaskGit (optionally
the cascade): regenerate only the masked region under a prompt, keeping
every other token of the source (counterpart of `examples/edit_image.py`).
The mask is a greyscale PNG the size of the image: white (> 127) pixels
are regenerated, black ones kept.

    python -m muse_maskgit_pytorch_tpu_torch.examples.edit_image "a red balloon" \
        --image photo.png --mask region.png --base-checkpoint base.msgpack [--superres-checkpoint sr.msgpack]

Images are read and written by the port's own PNG codec (JPEG sources
need Pillow); the source is resized by the port's antialiased bilinear
resize, the mask by nearest neighbour.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from muse_maskgit_pytorch_tpu_torch.examples.sample import load_maskgit
from muse_maskgit_pytorch_tpu_torch.models.maskgit import _resize_nearest
from muse_maskgit_pytorch_tpu_torch.training.data import _read_rgb, resize_bilinear, save_image
from muse_maskgit_pytorch_tpu_torch.utils.png import decode_png


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("prompt")
    p.add_argument("--image", required=True, help="source image (png, or jpg with Pillow)")
    p.add_argument("--mask", required=True, help="greyscale mask png, white = regenerate")
    p.add_argument("--base-checkpoint", required=True)
    p.add_argument("--superres-checkpoint", default=None)
    p.add_argument("--vae-dim", type=int, default=256)
    p.add_argument("--codebook-size", type=int, default=65536)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--t5-name", default="google/t5-v1_1-base")
    p.add_argument("--timesteps", type=int, default=18)
    p.add_argument("--cond-scale", type=float, default=3.0)
    p.add_argument("--cond-scale-end", type=float, default=None, help="ramp guidance linearly from --cond-scale to this")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="edited.png")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns the edited image, (h, w, 3) floats in [0, 1]."""
    args = parser().parse_args(argv)
    from muse_maskgit_pytorch_tpu_torch import Muse

    size = 512 if args.superres_checkpoint else 256
    widths = (args.vae_dim, args.codebook_size)
    base = load_maskgit(args.base_checkpoint, *widths, 256, args.dim, args.depth, args.t5_name, device=args.device)
    device = next(base.parameters()).device
    src = resize_bilinear(_read_rgb(Path(args.image)), size, size).astype(np.float32) / 255.0
    images = torch.from_numpy(src)[None].to(device)
    mask = torch.from_numpy(decode_png(Path(args.mask).read_bytes(), mode="L"))[None, :, :, None].float()
    edit_mask = (_resize_nearest(mask, size, size)[..., 0] > 127).to(device)
    cond_scale = (args.cond_scale, args.cond_scale_end) if args.cond_scale_end is not None else args.cond_scale
    kw = dict(cond_scale=cond_scale, temperature=args.temperature, timesteps=args.timesteps)
    if args.superres_checkpoint:
        sr = load_maskgit(
            args.superres_checkpoint, *widths, 512, args.dim, args.depth, args.t5_name, cond_image_size=256,
            device=args.device,
        )
        out = Muse(base, sr, device=args.device).edit(
            images, edit_mask, [args.prompt], generator=torch.Generator().manual_seed(args.seed),
            return_pil_images=False, **kw,
        )
    else:
        out = base.edit(
            images, edit_mask, texts=[args.prompt], generator=torch.Generator(device=device).manual_seed(args.seed),
            **kw,
        )
    edited = out[0].clamp(0, 1).float().cpu().numpy()
    save_image(edited, args.out)
    print(f"wrote {args.out}")
    return edited


if __name__ == "__main__":
    main()
