"""Full-stack text -> pixels demo with the output pixels checked against
their prompts (counterpart of `examples/e2e_demo.py`).

A procedural dataset of captioned images (coloured shapes: "red circle on
black", ...) is written as PNGs with caption files; a VQGanVAE trains on
the folder; the folder is tokenized into caption-carrying shards (the
`tokenize_dataset` flow); a base MaskGit trains against the captions
through a frozen random-init T5 and the byte tokenizer (distinct captions
give distinct fixed embeddings, which is all the conditioning needs); then
`generate` runs on the captions and a pixel-space classifier (dominant
colour, corner occupancy for the shape, the border for the background)
checks that the images mean what their prompts said.

    python -m muse_maskgit_pytorch_tpu_torch.examples.e2e_demo --out-dir e2e-demo [--device cpu]
    (shrink --vae-steps / --maskgit-steps for a quick run)
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from muse_maskgit_pytorch_tpu_torch.utils.png import encode_png

COLORS = {"red": (1.0, 0, 0), "green": (0, 1.0, 0), "blue": (0, 0, 1.0), "yellow": (1.0, 1.0, 0)}
BGS = {"black": (0.0, 0.0, 0.0), "white": (1.0, 1.0, 1.0)}
SHAPES = ("circle", "square")
COMBOS = [(c, s, b) for c in COLORS for s in SHAPES for b in BGS]


def caption_of(color, shape, bg):
    return f"{color} {shape} on {bg}"


def render(color, shape, bg, size=32, rng=None):
    """One image: a colored circle/square (random center jitter + radius) on
    a black/white background."""
    rng = rng or np.random.default_rng(0)
    c = size / 2 + rng.uniform(-size * 0.12, size * 0.12, 2)
    r = rng.uniform(size * 0.20, size * 0.32)
    yy, xx = np.mgrid[0:size, 0:size] + 0.5
    if shape == "circle":
        mask = (yy - c[0]) ** 2 + (xx - c[1]) ** 2 <= r * r
    else:
        mask = (np.abs(yy - c[0]) <= r) & (np.abs(xx - c[1]) <= r)
    img = np.broadcast_to(np.asarray(BGS[bg], np.float32), (size, size, 3)).copy()
    img[mask] = np.asarray(COLORS[color], np.float32)
    return img


def classify(img):
    """Pixel-space semantic readout -> (color, shape, bg) or None.

    bg: median border color; color: mean foreground color (foreground =
    distance from bg > 0.45); shape: mean occupancy of the four bbox-corner
    cells (a square fills its corners, a circle leaves them empty — robust
    to the VAE's blur, unlike a raw fill-ratio threshold)."""
    border = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]])
    bmed = np.median(border, axis=0)
    bg = min(BGS, key=lambda k: float(np.sum((bmed - BGS[k]) ** 2)))
    fg = np.linalg.norm(img - np.asarray(BGS[bg]), axis=-1) > 0.45
    if fg.sum() < 12:
        return None
    cmean = img[fg].mean(axis=0)
    color = min(COLORS, key=lambda k: float(np.sum((cmean - COLORS[k]) ** 2)))
    ys, xs = np.where(fg)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    ch, cw = max(1, int((y1 - y0) * 0.22)), max(1, int((x1 - x0) * 0.22))
    sub = fg[y0:y1, x0:x1]
    occ = np.mean([sub[:ch, :cw].mean(), sub[:ch, -cw:].mean(),
                   sub[-ch:, :cw].mean(), sub[-ch:, -cw:].mean()])
    return color, "square" if occ > 0.45 else "circle", bg


def write_dataset(folder, n, size, seed=0):
    """PNGs + <stem>.txt caption sidecars: the layout `ImageDataset` and the
    tokenize flow read."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        combo = COMBOS[i % len(COMBOS)]
        img = render(*combo, size, rng)
        (folder / f"{i:05d}.png").write_bytes(encode_png((img * 255).astype(np.uint8)))
        (folder / f"{i:05d}.txt").write_text(caption_of(*combo))
    return folder


def match_stats(preds, truths):
    full = float(np.mean([p == t for p, t in zip(preds, truths)]))
    parts = {
        k: float(np.mean([p is not None and p[j] == t[j] for p, t in zip(preds, truths)]))
        for j, k in enumerate(("color", "shape", "bg"))
    }
    return full, parts


def run_demo(
    out_dir,
    *,
    image_size=32,
    n_images=1024,
    vae_steps=2000,
    maskgit_steps=4000,
    vae_dim=32,
    codebook_size=512,
    mg_dim=128,
    mg_depth=4,
    batch_size=64,
    gen_per_caption=4,
    timesteps=8,
    cond_scale=3.0,
    seed=0,
    device="cuda",
    log=print,
):
    """Returns a dict of measured metrics (also written to out_dir/report.json)."""
    from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTrainer, MaskGitTransformer, VQGanVAE, VQGanVAETrainer
    from muse_maskgit_pytorch_tpu_torch.models import t5
    from muse_maskgit_pytorch_tpu_torch.training.data import DataLoader, ImageDataset, make_grid, save_image
    from muse_maskgit_pytorch_tpu_torch.training.shard_loader import write_shard

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    report = {}

    # -- 1) the dataset on disk
    data_dir = write_dataset(out / "data", n_images, image_size, seed)
    log(f"== dataset: {n_images} captioned {image_size}px images at {data_dir}")

    # -- 2) the VQGanVAE, trained from the folder
    vae = VQGanVAE(
        dim=vae_dim, layers=2, codebook_size=codebook_size, use_vgg_and_gan=False,
        encdec_resnet_groups=math.gcd(vae_dim, 16),  # GroupNorm's groups must divide dim
        generator=torch.Generator().manual_seed(seed), device=device,
    )
    vae_trainer = VQGanVAETrainer(
        vae, folder=str(data_dir), num_train_steps=vae_steps, batch_size=32, image_size=image_size, lr=2e-3,
        valid_frac=0.0, use_ema=False, random_flip=False, save_results_every=10**9, save_model_every=10**9,
        results_folder=str(out / "vae"),
    )
    t0 = time.perf_counter()
    vae_trainer.train()
    vae_wall = time.perf_counter() - t0
    tvae = vae_trainer.vae_module()
    dev = next(tvae.parameters()).device
    log(f"== VAE: {vae_steps} steps in {vae_wall:.0f}s")

    # held-out reconstruction quality (fresh renders the trainer never saw)
    rng_ho = np.random.default_rng(seed + 77)
    fresh = np.stack([render(*COMBOS[i % 16], image_size, rng_ho) for i in range(64)]).astype(np.float32)
    with torch.no_grad():
        _, ho_ids, _ = tvae.encode(torch.from_numpy(fresh).to(dev), train=False)
        rec = tvae.decode_from_ids(ho_ids).clamp(0, 1).cpu().numpy()
    psnr = float(-10 * np.log10(np.mean((rec - fresh) ** 2)))
    rec_match, _ = match_stats([classify(rec[i]) for i in range(64)], [COMBOS[i % 16] for i in range(64)])
    report.update(vae_wall_s=round(vae_wall, 1), recon_psnr_db=round(psnr, 2), recon_classifier_match=rec_match)
    log(f"   held-out recon PSNR {psnr:.1f} dB; classifier match {rec_match:.3f}")

    # -- 3) the folder tokenized into caption shards (the tokenize_dataset flow)
    ds = ImageDataset(data_dir, image_size, random_flip=False)
    rows, caps, done = [], [], 0
    for batch in DataLoader(ds, 128, shuffle=False):
        with torch.no_grad():
            ids = tvae.encode(torch.from_numpy(batch).to(dev), train=False)[1].cpu().numpy()
        rows.append(ids.reshape(ids.shape[0], -1).astype(np.int32))
        caps.extend(ds.paths[done + j].with_suffix(".txt").read_text().strip() for j in range(ids.shape[0]))
        done += ids.shape[0]
    fmap = tvae.get_encoded_fmap_size(image_size)
    shard = out / "tokens" / "shard_00000.bin"
    shard.parent.mkdir(exist_ok=True)
    write_shard(shard, np.concatenate(rows), captions=caps, grid=(fmap, fmap))
    log(f"== tokenized {done} sequences -> {shard} (grid {fmap}x{fmap})")

    # -- 4) the MaskGit, trained against the captions
    t5_name = "e2e-demo/tiny-t5"
    # a frozen random-init text encoder: distinct captions still give
    # distinct deterministic embeddings, which is all conditioning needs
    t5.T5_CONFIGS.setdefault(t5_name, t5.T5Config(64, 128, 2, 16, 2, True))
    transformer = MaskGitTransformer(
        num_tokens=codebook_size, dim=mg_dim, seq_len=fmap * fmap, depth=mg_depth, dim_head=32, heads=4,
        t5_name=t5_name, generator=torch.Generator().manual_seed(seed), device=device,
    )
    maskgit = MaskGit(image_size=image_size, transformer=transformer, vae=tvae, device=device)
    mg_trainer = MaskGitTrainer(
        maskgit, num_train_steps=maskgit_steps, batch_size=batch_size, lr=2e-3, use_ema=False,
        save_model_every=10**9, results_folder=str(out / "maskgit"),
    )
    t0 = time.perf_counter()
    mg_trainer.train_from_shards([shard], use_captions=True)
    mg_wall = time.perf_counter() - t0
    model = mg_trainer.maskgit_module()
    report["maskgit_wall_s"] = round(mg_wall, 1)
    log(f"== MaskGit: {maskgit_steps} steps in {mg_wall:.0f}s")

    # -- 5) generate from the captions and read the pixels back
    def probe(tag, cond_scale, shuffle=False):
        texts, truths = [], []
        for i in range(16):
            cap_combo = COMBOS[(i + 5) % 16] if shuffle else COMBOS[i]
            for _ in range(gen_per_caption):
                texts.append(caption_of(*cap_combo))
                truths.append(COMBOS[i])  # the original prompt's position
        imgs = model.generate(
            texts=texts, generator=torch.Generator(device=dev).manual_seed(seed + 42), timesteps=timesteps,
            cond_scale=cond_scale,
        )
        imgs = imgs.clamp(0, 1).float().cpu().numpy()
        preds = [classify(imgs[i]) for i in range(len(texts))]
        full_vs_original, parts = match_stats(preds, truths)
        stats = {"match": full_vs_original, **{f"match_{k}": v for k, v in parts.items()}}
        if shuffle:
            # and against the caption actually given: does the model follow it?
            followed, _ = match_stats(preds, [COMBOS[(i // gen_per_caption + 5) % 16] for i in range(len(texts))])
            stats["followed_given_caption"] = followed
        log(f"   {tag}: {stats}")
        return imgs, stats

    gen_imgs, s_cond = probe("guided (cond_scale=%.1f)" % cond_scale, cond_scale)
    _, s_uncond = probe("unconditional (cond_scale=0)", 0.0)
    _, s_shuf = probe("shuffled captions", cond_scale, shuffle=True)
    report.update(
        caption_match=s_cond["match"],
        caption_match_parts={k: v for k, v in s_cond.items() if k != "match"},
        unconditional_match=s_uncond["match"],
        shuffled_match_vs_original=s_shuf["match"],
        shuffled_followed_given_caption=s_shuf["followed_given_caption"],
    )
    save_image(make_grid(gen_imgs[::gen_per_caption], nrow=4), out / "samples.png")  # one per caption
    save_image(make_grid(rec[:16], nrow=4), out / "recons.png")
    (out / "report.json").write_text(json.dumps(report, indent=2))
    log(f"== saved {out}/samples.png, recons.png, report.json")
    return report


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", default="e2e-demo")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--n-images", type=int, default=1024)
    p.add_argument("--vae-steps", type=int, default=2000)
    p.add_argument("--maskgit-steps", type=int, default=4000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--assert-gates", action="store_true", help="fail (exit 1) unless the semantic gates hold")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns the report."""
    args = parser().parse_args(argv)
    report = run_demo(
        args.out_dir, image_size=args.image_size, n_images=args.n_images, vae_steps=args.vae_steps,
        maskgit_steps=args.maskgit_steps, seed=args.seed, device="cpu" if args.cpu else args.device,
    )
    print(json.dumps(report, indent=2))
    if args.assert_gates:
        # explicit checks, not asserts: the gate must hold under python -O
        gates = [
            ("caption_match >= 0.8", report["caption_match"] >= 0.8),
            ("unconditional_match <= caption_match - 0.5", report["unconditional_match"] <= report["caption_match"] - 0.5),
            ("shuffled_match_vs_original <= 0.2", report["shuffled_match_vs_original"] <= 0.2),
        ]
        failed = [name for name, ok in gates if not ok]
        if failed:
            raise SystemExit(f"semantic gates FAILED: {failed}; report={report}")
        print("all semantic gates PASSED")
    return report


if __name__ == "__main__":
    main()
