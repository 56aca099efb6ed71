"""The control on the card, at a size a test run holds: the reference put
in the program's place one precision below the configuration's (fp8 for
the bf16 transformers, TF32 for the f32 T5 and VAE) has to fail one of a
cell's numbers where the program passes them all. The full-size readings
the limits were set from are `control.py`'s on the cells themselves."""

import json

import pytest
import torch

from benchmark import control
from benchmark.tests import toy

CARD_CONFIG = dict(toy.TOY_CONFIG, name="toy", transformer=dict(
    toy.TOY_CONFIG["transformer"], num_tokens=4096, seq_len=64, dim=128, heads=2, dim_head=64))
CARD_CONFIG["maskgit"] = dict(toy.TOY_CONFIG["maskgit"], image_size=32)
CARD_CONFIG["vae"] = dict(toy.TOY_CONFIG["vae"], codebook_size=4096)


@pytest.fixture
def card_root(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels); the CPU tests cover the rest of a run")
    monkeypatch.setattr(toy, "TOY_CONFIG", CARD_CONFIG)
    root = toy.make(tmp_path)
    # the cells' own limits (the toy's are looser, for the CPU's runs)
    limits = root / "benchmark" / "limits"
    for toy_cell, cell in (("toy.gen", "muse-base-256.gen-b32"), ("toy.train", "muse-base-256.train-b64")):
        (limits / f"{toy_cell}.json").write_text((toy.BENCH / "limits" / f"{cell}.json").read_text())
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["toy.gen", "toy.train"])
def test_control_fails_where_the_program_passes(card_root, capsys, cell):
    assert control.main(["--workload", cell, "--seconds", "3", "--seeds", "11", "12", "13"], root=card_root) == 0
    limits = json.loads((card_root / "benchmark" / "limits" / f"{cell}.json").read_text())
    for line in capsys.readouterr().out.strip().splitlines():
        numbers = json.loads(line)["numbers"]
        assert all(numbers[k] <= v for k, v in limits.items()), numbers
        assert any(numbers[f"control.{k}"] > v for k, v in limits.items() if f"control.{k}" in numbers), numbers
