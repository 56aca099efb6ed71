"""Whole runs of the harness on the CPU at toy size: the port against the
plain reference, the result line's schema, the faults that `correct` has
to catch, the discovery of new cells from new files, and the refusals (no
card, JAX loaded). The look for a card is skipped (`device="cpu"`); the
rest of a run is as on the card."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run as bench
from benchmark.harness import FORBIDDEN, forbidden_modules
from benchmark.tests import toy

ROOT = toy.BENCH.parent
SEED = 3_000_000_019  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make(tmp_path_factory.mktemp("toy"))


def run(root, capsys, cell, trace=0, seconds=3.0, seed=SEED):
    rc = bench.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                    root=root, device="cpu")
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def check_schema(line: dict, trace: int):
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell, trace", [
    ("toy.gen", 0), ("toy.gen", 1), ("toy-cascade.gen", 0), ("toy-cascade.gen", 1), ("toy.train", 0), ("toy.train", 1),
])
def test_port_against_the_reference(root, capsys, cell, trace):
    line, err = run(root, capsys, cell, trace)
    check_schema(line, trace)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    names = {m["name"] for m in manifest["per_layer" if trace else "end_to_end"]}
    assert set(line["metrics"]) <= names
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    else:
        assert line["metrics"]
    # the numbers compared, last on standard error
    assert err.strip().splitlines()[-1].startswith("check ")


def altered_sampler(orig):
    def run(*a, **kw):
        pred, prob = orig(*a, **kw)
        pred = pred.clone()
        pred[0] = (pred[0] + 1) % a[0].shape[-1]  # one token altered where it is produced
        return pred, prob

    return run


def test_fault_token_altered(root, capsys, monkeypatch):
    import muse_maskgit_pytorch_tpu_torch.models.maskgit as m

    monkeypatch.setattr(m, "fused_topk_gumbel_sample", altered_sampler(m.fused_topk_gumbel_sample))
    line, _ = run(root, capsys, "toy.gen")
    assert line["correct"] is False


def test_fault_sampler_without_noise(root, capsys, monkeypatch):
    import muse_maskgit_pytorch_tpu_torch.models.maskgit as m

    orig = m.fused_topk_gumbel_sample

    def argmax(logits, k, temperature, *a, **kw):  # K1 as a plain argmax: no temperature, no noise
        return orig(logits, k, 0.0, *a, **kw)

    monkeypatch.setattr(m, "fused_topk_gumbel_sample", argmax)
    line, _ = run(root, capsys, "toy.gen")
    assert line["correct"] is False and line["checks"]["logit_gap"]["value"] > line["checks"]["logit_gap"]["limit"]


def test_fault_wrong_confidence(root, capsys, monkeypatch):
    import muse_maskgit_pytorch_tpu_torch.models.maskgit as m

    orig = m.fused_topk_gumbel_sample

    def flat(*a, **kw):
        pred, prob = orig(*a, **kw)
        return pred, torch.full_like(prob, 0.5)

    monkeypatch.setattr(m, "fused_topk_gumbel_sample", flat)
    line, _ = run(root, capsys, "toy.gen")
    assert line["correct"] is False and line["checks"]["conf_gap"]["value"] > line["checks"]["conf_gap"]["limit"]


def test_fault_ema_unchanged(root, capsys, monkeypatch):
    from muse_maskgit_pytorch_tpu_torch.training import trainers

    monkeypatch.setattr(trainers, "ema_update", lambda ema, *a, **kw: ema)
    line, _ = run(root, capsys, "toy.train", seconds=0.5)
    assert line["correct"] is False and line["checks"]["ema_gap_median"]["value"] > 0.9


def test_fault_ema_stopped_after_its_copy(root, capsys, monkeypatch):
    from muse_maskgit_pytorch_tpu_torch.training import trainers

    orig = trainers.ema_update
    monkeypatch.setattr(trainers, "ema_update", lambda ema, params, step, **kw: orig(ema, params, step, **kw) if step == 0 else ema)
    line, _ = run(root, capsys, "toy.train", seconds=0.5)
    assert line["correct"] is False
    assert line["checks"]["ema_gap_median"]["value"] > line["checks"]["ema_gap_median"]["limit"]


def test_fault_state_unchanged(root, capsys, monkeypatch):
    from muse_maskgit_pytorch_tpu_torch.training import optim

    monkeypatch.setattr(optim.Adam, "step", lambda self, grads, norm=None: None)
    line, _ = run(root, capsys, "toy.train", seconds=0.5)
    assert line["correct"] is False and line["checks"]["change_gap"]["value"] > 0.9


def test_fault_half_batch(root, capsys, monkeypatch):
    from muse_maskgit_pytorch_tpu_torch.models.maskgit import MaskGit

    orig = MaskGit.forward

    def half(self, ids, *a, text_embeds=None, text_mask=None, draws=None, **kw):
        n = ids.shape[0] // 2
        return orig(self, ids[:n], *a, text_embeds=text_embeds[:n], text_mask=text_mask[:n], draws=draws.rows(0, n), **kw)

    monkeypatch.setattr(MaskGit, "forward", half)
    line, _ = run(root, capsys, "toy.train", seconds=0.5)
    assert line["correct"] is False


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files_only(tmp_path, capsys):
    root = toy.make(tmp_path)
    before = digest(root)
    bench_dir = root / "benchmark"
    cfg = dict(toy.TOY_CONFIG, name="toy2")
    cfg["transformer"] = dict(cfg["transformer"], depth=1)
    (bench_dir / "configs" / "toy2.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "toy-gen2.json").write_text(json.dumps(dict(toy.TOY_GEN, batch_size=2, timesteps=3)))
    (bench_dir / "limits" / "toy2.gen2.json").write_text(json.dumps(toy.GEN_LIMITS))
    (bench_dir / "metrics" / "toy_units.py").write_text('"""Units in the traced window."""\n\n\ndef read(r):\n    return float(r.trace.units)\n')
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "toy2", "source": "toy", "file": "benchmark/configs/toy2.json", "reduced": [], "why": "toy"})
    manifest["workloads"].append({"name": "toy2.gen2", "config": "toy2", "traffic": "toy-gen2", "chips": 1, "why": "toy"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "toy.gen" in m.get("workloads", []):
            m["workloads"].append("toy2.gen2")
    manifest["per_layer"].append({"name": "toy_units", "unit": "img", "better": "higher", "source": "device_trace",
                                  "layer": "device", "moves": "gen_img_per_s", "workloads": ["toy2.gen2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    line, _ = run(root, capsys, "toy2.gen2", trace=1)
    assert line["correct"] is True and line["metrics"]["toy_units"]["value"] == 2.0
    after = digest(root)
    assert all(after[k] == v for k, v in before.items())  # no file the benchmark had was edited
    assert set(after) - set(before) == {
        "benchmark/configs/toy2.json", "benchmark/traffic/toy-gen2.json", "benchmark/limits/toy2.gen2.json",
        "benchmark/metrics/toy_units.py",
    }


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "muse-base-256.gen-b32", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == "" and "no result" in p.stderr


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.nnx", "muse_maskgit_pytorch_tpu", "muse_maskgit_pytorch_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    monkeypatch.setitem(sys.modules, "muse_maskgit_pytorch_tpu_torch_extra", sys)
    found = forbidden_modules()
    assert {f.split(".")[0] for f in found} <= set(FORBIDDEN)
    assert "jaxtyping" not in found and "muse_maskgit_pytorch_tpu_torch_extra" not in found
    assert "muse_maskgit_pytorch_tpu.ops" in found and "jax.numpy" in found


def test_a_run_and_the_reference_load_no_jax(root):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.trunk, benchmark.reference.t5, benchmark.reference.vae, benchmark.reference.train\n"
        "import benchmark.reference.sampler\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'muse_maskgit_pytorch_tpu',"
        " 'muse_maskgit_pytorch_tpu_torch')]\n"
        "print(bad)\n" % str(ROOT)
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import run\n"
        "rc = run.main(['--workload', 'toy.gen', '--seed', '5', '--seconds', '1', '--trace', '0'], root=__import__('pathlib').Path(%r), device='cpu')\n"
        "from benchmark.harness import forbidden_modules\n"
        "print('RC', rc, forbidden_modules())\n" % (str(ROOT), str(root))
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert "RC 0 []" in p.stdout, p.stderr[-2000:]
