"""Pre-tokenize an image folder into binary token shards for MaskGit
training through the native shard loader (counterpart of
`examples/tokenize_dataset.py`).

    python -m muse_maskgit_pytorch_tpu_torch.examples.tokenize_dataset --folder images/ \
        --vae-checkpoint vae.msgpack --out-prefix tokens/shard

Encoding once and streaming int32 ids beats running the frozen encoder
every epoch: a 256px image is 192 KB of pixels and 1 KB of tokens.
`--image-size HxW` tokenizes every image at one rectangular resolution;
`--auto-bucket N` splits the folder into N aspect-ratio buckets (quantiles
of its log-aspects, snapped to the VAE's factor at about the same area) with
shards of their own. The shards carry their grid (fh, fw), so
`MaskGitTrainer.train_from_shards` trains each bucket on its grid.
"""

from __future__ import annotations

import argparse
import struct
from pathlib import Path

import numpy as np
import torch

from muse_maskgit_pytorch_tpu_torch.models.maskgit import _resize_nearest
from muse_maskgit_pytorch_tpu_torch.training.data import DataLoader, ImageDataset, _read_rgb
from muse_maskgit_pytorch_tpu_torch.training.shard_loader import write_shard


def parse_size(s: str):
    """'256' -> (256, 256); '256x192' -> (256, 192) as (h, w)."""
    if "x" in s:
        h, w = s.lower().split("x")
        return int(h), int(w)
    return int(s), int(s)


def image_hw(path: Path):
    """(h, w) of an image file: a PNG's header, else the decoded image (a
    JPEG through the dataset's reader)."""
    if path.suffix.lower() == ".png":
        with open(path, "rb") as f:
            w, h = struct.unpack(">II", f.read(24)[16:24])
        return h, w
    return _read_rgb(path).shape[:2]


def pick_buckets(paths, base_hw, n_buckets, divisor):
    """N bucket shapes from the folder's aspect distribution: quantile
    log-aspects, snapped to multiples of `divisor` at about the base area."""
    aspects = np.asarray([np.log(h / w) for h, w in map(image_hw, paths)])
    qs = np.quantile(aspects, (np.arange(n_buckets) + 0.5) / n_buckets)
    area = base_hw[0] * base_hw[1]
    shapes = []
    for la in qs:
        a = np.exp(la)  # h / w
        h = divisor * max(1, round(np.sqrt(area * a) / divisor))
        w = divisor * max(1, round(np.sqrt(area / a) / divisor))
        if (h, w) not in shapes:
            shapes.append((h, w))
    return shapes, aspects


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--folder", required=True)
    p.add_argument("--vae-checkpoint", required=True)
    p.add_argument("--vae-dim", type=int, default=256)
    p.add_argument("--vae-layers", type=int, default=4)
    p.add_argument("--codebook-size", type=int, default=65536)
    p.add_argument(
        "--image-size", default="256",
        help="'S' (square) or 'HxW' (one rectangular resolution for the folder); with --auto-bucket the base area",
    )
    p.add_argument(
        "--auto-bucket", type=int, default=0, metavar="N",
        help="split the folder into N aspect-ratio buckets (shards of their own, about the --image-size area)",
    )
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--shard-size", type=int, default=8192, help="sequences per shard")
    p.add_argument("--out-prefix", default="tokens/shard")
    p.add_argument(
        "--captions", action="store_true",
        help="also write <shard>.captions sidecars from <image-stem>.txt files (missing: empty prompts) for "
        "MaskGitTrainer.train_from_shards(use_captions=True)",
    )
    p.add_argument(
        "--cond-image-size", type=int, default=None,
        help="also tokenize a downsized copy of each image and append its ids to the row ([target ++ cond]): "
        "paired super-res shards for train_from_shards(cond_token_len=...)",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns the shard files written."""
    args = parser().parse_args(argv)
    from muse_maskgit_pytorch_tpu_torch import VQGanVAE

    vae = VQGanVAE(
        dim=args.vae_dim, layers=args.vae_layers, codebook_size=args.codebook_size, use_vgg_and_gan=False,
        generator=torch.Generator().manual_seed(0), device=args.device,
    )
    vae.load(args.vae_checkpoint)
    div = vae.dim_divisor
    device = next(vae.parameters()).device

    @torch.no_grad()
    def encode(imgs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(imgs).to(device)
        ids = vae.encode(x, train=False)[1]
        row = ids.reshape(ids.shape[0], -1)
        if args.cond_image_size:
            low = _resize_nearest(x, args.cond_image_size, args.cond_image_size)  # MaskGit's auto-resize
            cond = vae.encode(low, train=False)[1]
            row = torch.cat([row, cond.reshape(cond.shape[0], -1)], dim=1)
        return row.cpu().numpy().astype(np.int32)

    base_hw = parse_size(args.image_size)
    if base_hw[0] % div or base_hw[1] % div:
        raise SystemExit(f"--image-size must be divisible by the VAE's downsampling factor {div}")
    Path(args.out_prefix).parent.mkdir(parents=True, exist_ok=True)

    probe = ImageDataset(args.folder, base_hw, random_flip=False)
    if args.auto_bucket > 1:
        shapes, aspects = pick_buckets(probe.paths, base_hw, args.auto_bucket, div)
        # each image joins the bucket of the nearest log-aspect
        las = np.log([h / w for h, w in shapes])
        assign = np.argmin(np.abs(aspects[:, None] - las[None, :]), axis=1)
        buckets = [(hw, [p for p, a in zip(probe.paths, assign) if a == bi]) for bi, hw in enumerate(shapes)]
        print("buckets:", [(f"{h}x{w}", len(ps)) for (h, w), ps in buckets])
    else:
        buckets = [(base_hw, probe.paths)]

    total, written = 0, []
    for (H, W), paths in buckets:
        if not paths:
            continue
        ds = ImageDataset(args.folder, (H, W), random_flip=False)
        ds.paths = paths  # this bucket's images
        grid = (H // div, W // div)
        tag = f"_{H}x{W}" if len(buckets) > 1 else ""

        def caption_for(i: int) -> str:
            txt = ds.paths[i].with_suffix(".txt")
            return txt.read_text().strip() if txt.exists() else ""

        def flush(buf, caps, shard_idx):
            written.append(f"{args.out_prefix}{tag}_{shard_idx:05d}.bin")
            write_shard(written[-1], np.concatenate(buf), captions=caps if args.captions else None, grid=grid)

        buf, caps, shard_idx, done = [], [], 0, 0
        for batch in DataLoader(ds, args.batch_size, shuffle=False):
            row = encode(batch)
            buf.append(row)
            if args.captions:  # the loader is unshuffled: ds.paths order
                caps.extend(caption_for(done + j) for j in range(row.shape[0]))
            done += row.shape[0]
            if sum(b.shape[0] for b in buf) >= args.shard_size:
                flush(buf, caps, shard_idx)
                print(f"wrote shard{tag} {shard_idx} ({done} sequences in bucket)")
                buf, caps, shard_idx = [], [], shard_idx + 1
        if buf:
            flush(buf, caps, shard_idx)
        total += done
    print(f"done: {total} sequences")
    return written


if __name__ == "__main__":
    main()
