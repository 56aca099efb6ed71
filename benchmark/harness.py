"""The harness's general parts: the manifest and the files it names, the
device's description, the profiler's trace reduced to what the per-layer
metrics read, the breakdown, the import check and the result line.

Everything that belongs to one configuration, traffic mix, metric or cell
lives in a file of its own that is found by its name in `BENCHMARK.json`:
`configs/<config>.json` (through the manifest's `file`),
`traffic/<traffic>.json` (whose `driver` names a module in `drivers/`),
`metrics/<metric>.py` (or, where a metric `<quantity>.<cells>` has no
file of its own, `metrics/<quantity>.py`: one reader for the same quantity
in cells that report different end-to-end metrics) and
`limits/<workload>.json`.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "muse_maskgit_pytorch_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """Import a file of the benchmark by its path (a metric's name may hold
    dots, which a package path may not)."""
    spec = importlib.util.spec_from_file_location(name or f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with the files it names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.manifest = load_json(root / "BENCHMARK.json")
        found = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        (conf,) = [c for c in self.manifest["configs"] if c["name"] == self.workload["config"]]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
        self.name = name

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports: those without a
        `workloads` key and those that list it."""
        return [m for m in self.manifest["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move an end-to-end metric of the cell."""
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.manifest["per_layer"]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in mine:
                out.append(m)
        return out

    def driver(self):
        return load_module(self.root / "benchmark" / "drivers" / f"{self.traffic['driver']}.py")

    def metric_reader(self, name: str):
        folder = self.root / "benchmark" / "metrics"
        path = folder / f"{name}.py"
        if not path.exists():
            path = folder / f"{name.split('.')[0]}.py"
        return load_module(path)


# -- the device ------------------------------------------------------------------------


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20,
        ).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(torch, count: int, memory_peak: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": memory_peak,
        "power_limit_w": power_limit_w(),
    }


# -- the trace ---------------------------------------------------------------------------


class Trace:
    """A `torch.profiler` run reduced to plain data.

    `kernels`: (kernel name, seconds, names of the CPU operators above its
    launch, innermost first) for every device activity (kernels, copies,
    sets), attributed through the launch that the profiler links it to;
    `busy_s`: the union of the device intervals over all streams;
    `window_s`: the traced window on the host's clock; `gaps`: the idle
    gaps with what the host was doing at their middle."""

    def __init__(self, prof, window_s: float, units: int):
        import numpy as np

        self.window_s = window_s
        self.units = units  # images or steps inside the traced window
        events = list(prof.events())
        device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
        cpu = [e for e in events if str(getattr(e, "device_type", "")).endswith("CPU")]
        self.device_s = sum(e.time_range.end - e.time_range.start for e in device) / 1e6
        rows = []
        for e in cpu:
            for k in getattr(e, "kernels", None) or ():
                chain, p = [], e
                while p is not None:
                    chain.append(p.name)
                    p = p.cpu_parent
                rows.append((k.name, k.duration / 1e6, tuple(chain)))
        attributed = sum(r[1] for r in rows)
        if attributed < 0.9 * self.device_s:
            # the profiler linked too few launches: the device's own records, by name
            rows = [(e.name, (e.time_range.end - e.time_range.start) / 1e6, ()) for e in device]
        self.kernels = rows
        spans = sorted((e.time_range.start, e.time_range.end) for e in device)
        union, busy = [], 0.0
        for a, b in spans:
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], b)
            else:
                union.append([a, b])
        busy = sum(b - a for a, b in union)
        self.busy_s = busy / 1e6
        gaps = sorted(((b2[0] - b1[1], (b1[1] + b2[0]) / 2) for b1, b2 in zip(union, union[1:])), reverse=True)
        ops = [e for e in cpu if e.time_range.end > e.time_range.start]
        starts = np.array([e.time_range.start for e in ops], np.float64)
        ends = np.array([e.time_range.end for e in ops], np.float64)
        labelled: Dict[str, float] = {}
        for length, mid in gaps[:200]:
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = ops[inside[np.argmax(starts[inside])]].name if len(inside) else "nothing traced"
            labelled[label] = labelled.get(label, 0.0) + length / 1e6
        self.gaps = sorted(labelled.items(), key=lambda kv: -kv[1])

    def seconds(self, match) -> float:
        """Device seconds of the activities for which `match(name, chain)`
        holds."""
        return sum(s for name, s, chain in self.kernels if match(name, chain))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, _ in self.kernels:
            by[name] = by.get(name, 0.0) + s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


# -- checks and the result line ------------------------------------------------------------


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The check's numbers beside their limits, last on standard error, and
    the result line, with them last, on standard output."""
    for name, c in checks.items():
        ok = "ok" if c["value"] is not None and c["value"] <= c["limit"] else "FAILS"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps({**result, "checks": checks}), flush=True)
