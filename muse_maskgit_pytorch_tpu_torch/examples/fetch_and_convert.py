"""Convert pretrained towers from local files into checkpoints in the JAX
package's format (counterpart of `examples/fetch_and_convert.py`, its
offline half: this one never fetches).

    python -m muse_maskgit_pytorch_tpu_torch.examples.fetch_and_convert --out weights/ \
        --t5 path/to/t5-v1_1-base --vgg vgg16.pth --inception inception_v3.pth

`--t5` is a local Hugging Face directory, or a name in the local Hugging
Face cache, read with `local_files_only=True` (its tokenizer is saved beside
the weights); `--t5-config` names the port's config of it (default: `--t5`
itself when it is a known name, else google/t5-v1_1-base). `--vgg` and
`--inception` are local torchvision weight files (`.pth` or
`.safetensors`). Each tower goes through `utils.convert` into the port's
module, is written with `utils.checkpoint.save_module` (the JAX package's
msgpack, which its `load_module` reads) and recorded in `<out>/manifest.json`
(sha256, bytes, each leaf's shape), then read back into a fresh module
through the manifest check and compared. On the host that is to use them:

    python -m muse_maskgit_pytorch_tpu_torch.examples.fetch_and_convert --out weights/ --verify

checks every manifest entry. `--dry-run [t5 vgg inception]` runs the whole
path on randomly initialised towers built here (a tiny Hugging Face T5,
synthetic torchvision state dicts; all three when none is named): no file
is read.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

DEFAULT_T5 = "google/t5-v1_1-base"
TOWERS = ("t5", "vgg", "inception")


def _save_and_verify(module, build_fresh, path: Path) -> None:
    """Write, record in the manifest, read back through the manifest check
    into a fresh module, and compare every leaf."""
    from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import load_module, manifest_entry, save_module, write_manifest

    save_module(module, path)
    write_manifest(path.parent, {path.name: manifest_entry(path, module)})
    fresh = build_fresh()
    load_module(fresh, path)  # verifies against the manifest just written
    want, got = module.state_dict(), fresh.state_dict()
    for key in want:
        if not torch.equal(want[key].cpu(), got[key].cpu()):
            raise ValueError(f"{path.name}: {key} differs after the round trip")
    print(f"  wrote + verified {path} (manifest entry recorded)")


def convert_t5(source: str, config_name: str, out: Path, dry_run: bool, device) -> None:
    from muse_maskgit_pytorch_tpu_torch.models import t5 as t5mod
    from muse_maskgit_pytorch_tpu_torch.utils.convert import load_hf_t5_weights

    if dry_run:
        import transformers

        hf_cfg = transformers.T5Config(
            vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
            feed_forward_proj="gated-gelu", dropout_rate=0.0,
        )
        torch.manual_seed(0)
        hf = transformers.T5EncoderModel(hf_cfg).eval()
        cfg = t5mod.T5Config(d_model=32, d_ff=64, num_heads=4, d_kv=8, num_layers=2, gated=True, vocab_size=128)
        slug = "dry-run"
    else:
        hf, cfg, slug = source, t5mod.get_config(config_name), config_name.replace("/", "-")

    def build(seed):
        return t5mod.T5Encoder(cfg, generator=torch.Generator().manual_seed(seed), device=device)

    enc = build(0)
    load_hf_t5_weights(enc, hf)
    if not dry_run:
        # the real vocabulary travels with the weights (the byte tokenizer otherwise)
        from transformers import AutoTokenizer

        from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import manifest_entry, write_manifest

        tdir = out / f"tokenizer-{slug}"
        AutoTokenizer.from_pretrained(source, local_files_only=True).save_pretrained(tdir)
        write_manifest(out, {f"tokenizer-{slug}/{p.name}": manifest_entry(p) for p in sorted(tdir.iterdir()) if p.is_file()})
        print(f"  saved tokenizer -> {tdir} (manifest entries recorded)")
    _save_and_verify(enc, lambda: build(1), out / f"t5-{slug}.msgpack")


def _synthetic_vgg16() -> dict:
    """A torchvision vgg16 state dict of random weights."""
    g = torch.Generator().manual_seed(0)
    sd, idx, in_ch = {}, 0, 3
    for v in [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]:
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = 0.05 * torch.randn(v, in_ch, 3, 3, generator=g)
        sd[f"features.{idx}.bias"] = torch.zeros(v)
        in_ch, idx = v, idx + 2
    sd["classifier.0.weight"] = 0.05 * torch.randn(4096, 512 * 49, generator=g)
    sd["classifier.0.bias"] = torch.zeros(4096)
    sd["classifier.3.weight"] = 0.05 * torch.randn(4096, 4096, generator=g)
    sd["classifier.3.bias"] = torch.zeros(4096)
    return sd


def convert_vgg(weights, out: Path, dry_run: bool, device) -> None:
    from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16
    from muse_maskgit_pytorch_tpu_torch.utils.convert import load_torchvision_vgg16

    build = lambda seed: VGG16(generator=torch.Generator().manual_seed(seed), device=device)  # noqa: E731
    vgg = build(0)
    if dry_run:
        load_torchvision_vgg16(vgg, state_dict=_synthetic_vgg16())
    else:
        load_torchvision_vgg16(vgg, weights_path=weights)
    _save_and_verify(vgg, lambda: build(1), out / "vgg16.msgpack")


def convert_inception(weights, out: Path, dry_run: bool, device) -> None:
    from muse_maskgit_pytorch_tpu_torch.models.inception import InceptionV3
    from muse_maskgit_pytorch_tpu_torch.utils.convert import _basic_convs, load_torchvision_inception_v3

    build = lambda seed: InceptionV3(generator=torch.Generator().manual_seed(seed), device=device)  # noqa: E731
    inc = build(0)
    if dry_run:
        # a torchvision-layout state dict from the module's own units
        g = torch.Generator().manual_seed(0)
        sd = {}
        for path, unit in _basic_convs(inc).items():
            cout = unit.conv.weight.shape[0]
            sd[f"{path}.conv.weight"] = 0.05 * torch.randn(unit.conv.weight.shape, generator=g)
            sd[f"{path}.bn.weight"] = torch.ones(cout)
            sd[f"{path}.bn.bias"] = torch.zeros(cout)
            sd[f"{path}.bn.running_mean"] = 0.01 * torch.randn(cout, generator=g)
            sd[f"{path}.bn.running_var"] = torch.ones(cout)
        load_torchvision_inception_v3(inc, state_dict=sd)
    else:
        load_torchvision_inception_v3(inc, weights_path=weights)
    _save_and_verify(inc, lambda: build(1), out / "inception_v3.msgpack")


def verify(out: Path) -> int:
    from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import MANIFEST_NAME, verify_manifest

    mpath = out / MANIFEST_NAME
    if not mpath.exists():
        raise SystemExit(f"no {MANIFEST_NAME} in {out}")
    manifest = json.loads(mpath.read_text())
    for name in sorted(manifest):
        verify_manifest(out / name, mpath, require=True)
        print(f"  ok {name}")
    print(f"verified {len(manifest)} entries in {mpath}")
    return len(manifest)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="./weights", help="output directory")
    p.add_argument("--t5", default=None, help="local Hugging Face T5 directory, or a name in the local cache")
    p.add_argument("--t5-config", default=None, help=f"the port's T5 config name (default: --t5 if known, else {DEFAULT_T5})")
    p.add_argument("--vgg", default=None, help="local torchvision vgg16 weights file")
    p.add_argument("--inception", default=None, help="local torchvision inception_v3 weights file")
    p.add_argument(
        "--dry-run", nargs="*", choices=TOWERS, default=None,
        help="convert randomly initialised towers built here (all three when none is named), reading no file",
    )
    p.add_argument("--verify", action="store_true", help="verify every manifest.json entry under --out and exit")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Returns the paths written (or the count of entries verified)."""
    args = parser().parse_args(argv)
    out = Path(args.out)
    if args.verify:
        return verify(out)
    dry = args.dry_run is not None
    towers = (args.dry_run or TOWERS) if dry else [t for t in TOWERS if getattr(args, t)]
    if not towers:
        raise SystemExit("nothing requested: pass --t5 / --vgg / --inception (local files) or --dry-run")
    from muse_maskgit_pytorch_tpu_torch.models import t5 as t5mod

    out.mkdir(parents=True, exist_ok=True)
    if "t5" in towers:
        config = args.t5_config or (args.t5 if args.t5 in t5mod.T5_CONFIGS else DEFAULT_T5)
        print(f"T5 {'dry run' if dry else args.t5}:")
        convert_t5(args.t5, config, out, dry, args.device)
    if "vgg" in towers:
        print("VGG16:")
        convert_vgg(args.vgg, out, dry, args.device)
    if "inception" in towers:
        print("InceptionV3:")
        convert_inception(args.inception, out, dry, args.device)
    print(f"done -> {out}")
    return sorted(p for p in out.glob("*.msgpack"))


if __name__ == "__main__":
    main()
