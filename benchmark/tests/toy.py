"""A toy copy of the benchmark for the CPU tests: the harness's files as
they are, a manifest, configurations, traffic and limits of a size the CPU
runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TOY_CONFIG = {
    "name": "toy",
    "transformer": {"num_tokens": 512, "seq_len": 16, "dim": 64, "depth": 2, "dim_head": 32, "heads": 2, "ff_mult": 4,
                    "self_cond": True, "text_embed_dim": 32},
    "maskgit": {"image_size": 16, "cond_drop_prob": 0.5, "self_cond_prob": 0.9},
    "vae": {"dim": 16, "layers": 2, "codebook_size": 512, "lookup_free_quantization": True},
    "t5": {"name": "toy-t5", "d_model": 32, "d_ff": 64, "num_heads": 2, "d_kv": 16, "num_layers": 2, "vocab_size": 32128,
           "tokenizer": "byte"},
    "superres": None,
    "precision": {"transformer": "bfloat16", "vae": "float32", "t5": "float32", "tf32": False},
    "reduced": [],
    "assumed": [],
}

TOY_CASCADE = dict(TOY_CONFIG, name="toy-cascade", superres={
    "transformer": dict(TOY_CONFIG["transformer"], seq_len=64),
    "maskgit": {"image_size": 32, "cond_image_size": 16, "cond_drop_prob": 0.5, "self_cond_prob": 0.9},
})

TOY_GEN = {
    "driver": "generate", "why": "toy", "rate_metric": "gen_img_per_s", "batch_size": 4, "timesteps": 4,
    "cond_scale": 3.0, "temperature": 1.0, "topk_filter_thres": 0.9, "text_len": 16, "prompt_bytes": [2, 14],
    "alphabet": "abc ", "check_batches": 1, "check_pool": 2, "trace_batches": 1,
}

TOY_CASCADE_GEN = dict(TOY_GEN, rate_metric="cascade_img_per_s")

TOY_TRAIN = {
    "driver": "train", "why": "toy", "rate_metric": "train_img_per_s", "batch_size": 4, "text_len": 16,
    "text_tokens": [3, 16], "lr": 1e-3, "ema_beta": 0.995, "reference_steps": 3, "trace_steps": 1,
}

TRAIN_LIMITS = {"grad_gap": 0.2, "change_gap": 0.2, "ema_gap": 0.2, "grad_gap_median": 0.01,
                "change_gap_median": 0.004, "ema_gap_median": 0.001}

GEN_LIMITS = {"t5_err": 1e-4, "logit_gap": 0.5, "conf_gap": 0.5, "selfcond_gap": 0.5, "trajectory_mismatch": 0,
              "pixel_mismatch": 0.01}

# the toy cell that stands in for each real one, in the toy's manifest
STANDS_FOR = {"muse-base-256.gen-b32": "toy.gen", "muse-cascade-512.gen-b16": "toy-cascade.gen",
              "muse-base-256.train-b64": "toy.train"}


def make(tmp: Path) -> Path:
    """A root at `tmp` holding `benchmark/` and a toy `BENCHMARK.json`."""
    shutil.copytree(BENCH, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    configs = {"toy": TOY_CONFIG, "toy-cascade": TOY_CASCADE}
    for name, cfg in configs.items():
        (tmp / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    traffic = {"toy-gen": TOY_GEN, "toy-cascade-gen": TOY_CASCADE_GEN, "toy-train": TOY_TRAIN}
    for name, mix in traffic.items():
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = [
        ("toy.gen", "toy", "toy-gen", GEN_LIMITS),
        ("toy-cascade.gen", "toy-cascade", "toy-cascade-gen",
         dict(GEN_LIMITS, sr_logit_gap=0.5, sr_conf_gap=0.5, sr_selfcond_gap=0.5)),
        ("toy.train", "toy", "toy-train", TRAIN_LIMITS),
    ]
    manifest["configs"] = [
        {"name": n, "source": "toy", "file": f"benchmark/configs/{n}.json", "reduced": [], "why": "toy"} for n in configs
    ]
    manifest["workloads"] = []
    for name, config, mix, limits in cells:
        manifest["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1, "why": "toy"})
        (tmp / "benchmark" / "limits" / f"{name}.json").write_text(json.dumps(limits))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [STANDS_FOR[c] for c in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp
