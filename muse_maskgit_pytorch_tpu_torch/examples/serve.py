"""Serve generation over HTTP from trained checkpoints (counterpart of
`examples/serve.py`).

    python -m muse_maskgit_pytorch_tpu_torch.examples.serve --base-checkpoint base.msgpack \
        [--superres-checkpoint sr.msgpack] --port 8000 --batch-size 16

Endpoints (`serving_http.GenerateServer`): POST /generate {"prompts": [...]}
and POST /edit {"prompts", "images", "masks"} (base64 PNGs) answer base64
PNGs; GET /healthz and GET /stats.
"""

from __future__ import annotations

import argparse
import threading

from muse_maskgit_pytorch_tpu_torch.examples.sample import load_maskgit, parse_size


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base-checkpoint", required=True)
    p.add_argument("--superres-checkpoint", default=None)
    p.add_argument("--vae-dim", type=int, default=256)
    p.add_argument("--codebook-size", type=int, default=65536)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--t5-name", default="google/t5-v1_1-base")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--timesteps", type=int, default=18)
    p.add_argument("--cond-scale", type=float, default=3.0)
    p.add_argument("--text-len", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=50.0)
    p.add_argument("--rerank", type=int, default=1, help="best-of-K re-ranking per prompt (K candidates a request)")
    p.add_argument("--no-warmup", action="store_true", help="no warm-up at boot (the first request pays for it)")
    p.add_argument(
        "--warmup-surfaces", default="generate",
        help="comma list of the surfaces to warm at boot: any of generate, dynamic_scale, edit, edit_dynamic_scale, "
        "or 'all'; a surface left cold makes its first live request pay for it",
    )
    p.add_argument(
        "--image-size", default=None, metavar="N|HxW",
        help="serve another resolution: an int, or HxW (the base stage's; a cascade scales it by its trained ratio)",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def start(argv=None):
    """Build the model and pipeline and start the server; returns it
    running (`server.stop()` ends it)."""
    args = parser().parse_args(argv)
    from muse_maskgit_pytorch_tpu_torch import GeneratePipeline, GenerateServer, Muse

    widths = (args.vae_dim, args.codebook_size)
    base = load_maskgit(args.base_checkpoint, *widths, 256, args.dim, args.depth, args.t5_name, device=args.device)
    model = base
    if args.superres_checkpoint:
        sr = load_maskgit(
            args.superres_checkpoint, *widths, 512, args.dim, args.depth, args.t5_name, cond_image_size=256,
            device=args.device,
        )
        model = Muse(base, sr, device=args.device)
    pipe = GeneratePipeline(
        model, batch_size=args.batch_size, timesteps=args.timesteps, cond_scale=args.cond_scale,
        text_len=args.text_len, rerank_candidates=args.rerank,
        image_size=parse_size(args.image_size) if args.image_size else None, device=args.device,
    )
    surfaces = (
        "all" if args.warmup_surfaces.strip() == "all"
        else tuple(s.strip() for s in args.warmup_surfaces.split(",") if s.strip())
    )
    server = GenerateServer(
        pipe, host=args.host, port=args.port, max_wait_ms=args.max_wait_ms, warmup=False if args.no_warmup else surfaces
    )
    print(f"warming up and serving on http://{args.host}:{args.port} ...", flush=True)
    server.start()
    print("ready", flush=True)
    return server


def main(argv=None):
    server = start(argv)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
