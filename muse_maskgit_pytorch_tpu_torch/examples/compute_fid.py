"""Streaming FID between two image folders, or between a folder and saved
reference statistics (counterpart of `examples/compute_fid.py`).

    # folder against folder
    python -m muse_maskgit_pytorch_tpu_torch.examples.compute_fid --real real/ --fake fake/
    # the reference set's statistics once, then against them
    python -m muse_maskgit_pytorch_tpu_torch.examples.compute_fid --real real/ --save-stats coco.npz
    python -m muse_maskgit_pytorch_tpu_torch.examples.compute_fid --stats coco.npz --fake fake/

`--extractor inception` (default) is the standard FID tower (torchvision's
InceptionV3 pool3 features, pytorch-fid's input convention); `--extractor
vgg` the VGG16 fc2 features of the GAN's perceptual loss. `--weights` is a
tower checkpoint in the JAX package's msgpack format (`save_module` of
either package after `utils.convert`). Without it the tower is random-init:
its scores order models and catch drift, but are not comparable to
published numbers (which mostly use pytorch-fid's TF-ported checkpoint, a
different tower again). Statistics files cross between the packages.
"""

from __future__ import annotations

import argparse

from muse_maskgit_pytorch_tpu_torch.utils.eval import (
    FeatureStats,
    compute_feature_stats,
    fid_score,
    make_inception_extractor,
    make_vgg_extractor,
)


def batches(folder, image_size, batch_size):
    """Fixed-size (b, s, s, 3) batches of a folder, in order, without flips;
    the ragged tail is dropped (FID takes a fixed sample count)."""
    from muse_maskgit_pytorch_tpu_torch.training.data import DataLoader, ImageDataset

    ds = ImageDataset(folder, image_size, random_flip=False)
    if len(ds) == 0:
        raise SystemExit(f"no images found under {folder}")
    for batch in DataLoader(ds, batch_size, shuffle=False):
        if batch.shape[0] == batch_size:
            yield batch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--real", default=None, help="folder of real images")
    p.add_argument("--fake", default=None, help="folder of generated images")
    p.add_argument("--stats", default=None, help="saved real-set statistics (.npz)")
    p.add_argument("--save-stats", default=None, help="write the real set's statistics here")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument(
        "--extractor", choices=("inception", "vgg"), default="inception",
        help="inception = the standard FID pool3 tower; vgg = the GAN's perceptual tower",
    )
    p.add_argument("--weights", default=None, help="tower checkpoint (msgpack, `utils.checkpoint.save_module`)")
    p.add_argument("--vgg-weights", default=None, help="deprecated alias for --weights with --extractor vgg")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns the FID, or None when only statistics were saved."""
    args = parser().parse_args(argv)
    if args.vgg_weights:
        args.extractor, args.weights = "vgg", args.vgg_weights

    tower = None
    if args.weights:
        import torch

        from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import load_module
        from muse_maskgit_pytorch_tpu_torch.utils.helpers import resolve_device

        if args.extractor == "vgg":
            from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16 as Tower
        else:
            from muse_maskgit_pytorch_tpu_torch.models.inception import InceptionV3 as Tower
        device = resolve_device(args.device)
        with torch.device("meta"):  # no random init: the file sets every leaf (or load_module raises)
            tower = Tower(device="meta")
        tower.to_empty(device=device)
        load_module(tower, args.weights)
    if args.extractor == "vgg":
        extract = make_vgg_extractor(vgg=tower, device=args.device)
    else:
        extract = make_inception_extractor(inception=tower, device=args.device)

    if args.stats:
        real_stats = FeatureStats.load(args.stats)
        print(f"loaded real stats: n={real_stats.n}, dim={real_stats.dim}")
    else:
        if not args.real:
            raise SystemExit("need --real or --stats")
        real_stats = compute_feature_stats(batches(args.real, args.image_size, args.batch_size), extract)
        print(f"real set: n={real_stats.n}")

    if args.save_stats:
        print(f"saved real stats -> {real_stats.save(args.save_stats)}")
        if not args.fake:
            return None
    if not args.fake:
        raise SystemExit("need --fake to compute a score")
    fake_stats = compute_feature_stats(batches(args.fake, args.image_size, args.batch_size), extract)
    print(f"fake set: n={fake_stats.n}")
    fid = fid_score(real_stats, fake_stats)
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
