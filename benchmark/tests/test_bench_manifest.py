"""`BENCHMARK.json` against its format: exact keys, names, units
and lines of the allowed characters, the files it names present, every
cell reporting `setup_s`, another end-to-end metric and a per-layer one, and
a metric reader for every per-layer metric (its own file, or its
quantity's)."""

import json
import re

import pytest

from benchmark.harness import Cell
from benchmark.tests.toy import BENCH

ROOT = BENCH.parent
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in M["paths"])
    assert len(M["command"]) <= 32 and all(line(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024
    # a full check of 24 cells at this length fits in its time
    assert 2 + 14 * 24 * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200 or len(M["workloads"]) < 24


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in M["workloads"])
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    assert len({w["name"] for w in M["workloads"]}) == len(M["workloads"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(names)) == len(names)
    for m in M[kind]:
        assert set(m) - {"workloads"} == allowed - {"workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert line(m["layer"]) and m["moves"] in {e["name"] for e in M["end_to_end"]}
            own, quantity = (BENCH / "metrics" / f"{m['name']}.py"), (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py")
            assert own.is_file() or quantity.is_file()
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in M["workloads"]}
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in M["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_enough(cell):
    c = Cell(cell, ROOT)
    e2e = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = c.per_layer()
    assert layer and all(m["moves"] in e2e for m in layer)
    assert any("mfu" in m["name"] for m in layer)
