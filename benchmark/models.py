"""The port's models as a configuration file describes them, with random
weights made on the device from the run's seed.

Each module is built on the meta device (no memory, no host work), then
`make_weights` draws all of its parameters in one normal draw on the card
from a `torch.Generator` seeded from `--seed`, scales each leaf by the
port's initialiser rule (lecun-normal clipped at two deviations for linear
and convolution kernels, 1 / sqrt(width) for embeddings, ones for norm
scales, zeros for biases) and hands the tensors to the module. The
reference calls `make_weights` again with the same seed after the program
is gone, so it holds the same numbers and nothing the program made.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

# a truncated unit normal's deviation on [-2, 2]
_TRUNC_STD = 0.87962566103423978
# one generator stream per module, so that adding a module changes no other's weights
STREAMS = {"vae": 1, "t5": 2, "base": 3, "superres": 4}


def stream_seed(seed: int, stream: str) -> int:
    return (int(seed) * 1_000_003 + STREAMS[stream]) % (2**63 - 1)


def _rule(module: nn.Module, name: str, p: torch.Tensor) -> Tuple[str, float]:
    """(kind, deviation) of a leaf: "normal" (scaled, clipped when
    `kind == "trunc"`), "ones" or "zeros"."""
    if name == "bias":
        return "zeros", 0.0
    if isinstance(module, nn.Embedding):
        return "normal", p.shape[1] ** -0.5
    if isinstance(module, nn.ConvTranspose2d):  # weight (in, out, kh, kw)
        return "trunc", (1.0 / (p.shape[0] * p.shape[2] * p.shape[3])) ** 0.5 / _TRUNC_STD
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        return "trunc", (1.0 / math.prod(p.shape[1:])) ** 0.5 / _TRUNC_STD
    if name == "null_kv":
        return "normal", 1.0
    if p.dim() == 1:  # LayerNorm gamma, RMSNorm and GroupNorm scales, q / k scales
        return "ones", 0.0
    raise ValueError(f"no initialiser rule for {type(module).__name__}.{name} {tuple(p.shape)}")


def specs(module: nn.Module) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, deviation) of every parameter, in module order."""
    out = []
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            kind, std = _rule(mod, pname, p)
            out.append((f"{mname}.{pname}" if mname else pname, tuple(p.shape), kind, std))
    return out


@torch.no_grad()
def make_weights(leaves, seed: int, stream: str, device) -> Dict[str, torch.Tensor]:
    """f32 tensors for `specs(...)`: one normal draw for all random leaves."""
    total = sum(math.prod(shape) for _, shape, kind, _ in leaves if kind in ("normal", "trunc"))
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, std in leaves:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            part = draw[at : at + n]
            at += n
            if kind == "trunc":
                part = part.clamp(-2.0, 2.0)
            out[name] = (part * std).view(shape)
    return out


def _fill(module: nn.Module, seed: int, stream: str, device) -> nn.Module:
    module.load_state_dict(make_weights(specs(module), seed, stream, device), strict=True, assign=True)
    return module


def t5_config(cfg: dict):
    from muse_maskgit_pytorch_tpu_torch.models.t5 import T5Config

    t = cfg["t5"]
    return T5Config(t["d_model"], t["d_ff"], t["num_heads"], t["d_kv"], t["num_layers"], True, t["vocab_size"])


def meta_modules(cfg: dict) -> Dict[str, nn.Module]:
    """The configuration's modules on the meta device: "vae", "t5", "base"
    and, for a cascade, "superres" (transformers only)."""
    from muse_maskgit_pytorch_tpu_torch import MaskGitTransformer, VQGanVAE
    from muse_maskgit_pytorch_tpu_torch.models.t5 import T5Encoder

    v = cfg["vae"]
    with torch.device("meta"):
        mods = {
            "vae": VQGanVAE(
                dim=v["dim"], layers=v["layers"], codebook_size=v["codebook_size"],
                lookup_free_quantization=v["lookup_free_quantization"], use_vgg_and_gan=False, device="meta",
            ),
            "t5": T5Encoder(t5_config(cfg), device="meta"),
        }
        stages = [("base", cfg["transformer"])]
        if cfg.get("superres"):
            stages.append(("superres", cfg["superres"]["transformer"]))
        for key, t in stages:
            mods[key] = MaskGitTransformer(
                num_tokens=t["num_tokens"], dim=t["dim"], seq_len=t["seq_len"], depth=t["depth"],
                dim_head=t["dim_head"], heads=t["heads"], ff_mult=t["ff_mult"], self_cond=t["self_cond"],
                text_embed_dim=t["text_embed_dim"], t5_name=cfg["t5"]["name"], dtype=torch.bfloat16, device="meta",
            )
    return mods


def build(cfg: dict, seed: int, device, *, with_vae: bool = True):
    """The program under test: a `MaskGit` (or a `Muse` cascade) on
    `device` with the seed's weights, its T5 encoder registered under the
    configuration's name so that nothing looks for files. Returns the model
    and the number of parameters made."""
    from muse_maskgit_pytorch_tpu_torch import MaskGit, Muse
    from muse_maskgit_pytorch_tpu_torch.models.t5 import ByteFallbackTokenizer, set_model

    mods = meta_modules(cfg)
    made = 0
    for key, mod in mods.items():
        if key == "vae" and not with_vae:
            continue
        _fill(mod, seed, key, device)
        made += sum(p.numel() for p in mod.parameters())
    set_model(cfg["t5"]["name"], mods["t5"].eval().requires_grad_(False), ByteFallbackTokenizer())
    vae = mods["vae"] if with_vae else None
    m = cfg["maskgit"]
    base = MaskGit(
        image_size=m["image_size"], transformer=mods["base"], vae=vae, cond_drop_prob=m["cond_drop_prob"],
        self_cond_prob=m["self_cond_prob"], device=device,
    )
    if not cfg.get("superres"):
        return base.eval(), made
    s = cfg["superres"]["maskgit"]
    sr = MaskGit(
        image_size=s["image_size"], cond_image_size=s["cond_image_size"], transformer=mods["superres"], vae=vae,
        cond_vae=vae, cond_drop_prob=s["cond_drop_prob"], self_cond_prob=s["self_cond_prob"], device=device,
    )
    return Muse(base.eval(), sr.eval(), device=device), made
