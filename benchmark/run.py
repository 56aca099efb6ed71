"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

One process: set-up (imports, CUDA, the kernel libraries from
`build/torch_kernels/`, the weights made on the card from the seed, one
warm-up of the cell's shape), a window of `--seconds`, the check against
the plain reference, then one JSON line on standard output. With
`--trace 0` the line carries the cell's end-to-end metrics; with `--trace
1` the per-layer ones, read from a profiled part of the window, and the
breakdown. A run without enough cards, or that finds JAX loaded, exits
non-zero without a result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout; nothing that would load JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))


class Run:
    """What a driver is handed: the cell, the run's settings and the
    harness's services (synchronise, window, profiler, log)."""

    def __init__(self, torch, cell, args, device):
        self.torch, self.cell, self.device = torch, cell, device
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.on_card = device.type == "cuda"
        self.t_window = None
        self.setup_s = None
        self.trace_data = None
        self.memory_peak = 0
        self.control = False  # `control.py`: the control's readings besides the program's

    def since_start(self) -> float:
        return time.perf_counter() - T0

    def log(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize()

    def window_open(self) -> None:
        self.sync()
        self.t_window = time.perf_counter()
        self.setup_s = self.t_window - T0

    def window_close(self) -> None:
        self.sync()
        if self.on_card:
            self.memory_peak = max(
                self.torch.cuda.max_memory_allocated(i) for i in range(self.cell.workload["chips"])
            )

    def profiler_start(self):
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def profiler_stop(self, prof, t_start: float, t_end: float, units: int) -> None:
        """Stop after the traced units; `t_start` / `t_end` bound them on
        the host's clock."""
        self.sync()
        prof.__exit__(None, None, None)
        self.trace_data = (prof, t_end - t_start, units)

    def free(self) -> None:
        gc.collect()
        if self.on_card:
            self.torch.cuda.empty_cache()


def main(argv=None, *, root: Path = ROOT, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment(root)

    from benchmark.harness import Cell, Trace, device_info, emit, forbidden_modules

    cell = Cell(args.workload, root)
    import torch

    chips = cell.workload["chips"]
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"this cell needs {chips} CUDA card(s); {found} found: no result", file=sys.stderr)
            return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(torch, cell, args, torch.device(device))
    out = cell.driver().run(run)

    loaded = forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded in this run: {', '.join(loaded)}: no result", file=sys.stderr)
        return 4

    limits = cell.limits
    numbers = out["numbers"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    missing = [k for k in limits if k not in numbers]
    correct = not missing and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    correct = correct and out["failed"] == 0
    if missing:
        run.log(f"numbers not read: {missing}")

    metrics = {}
    if not args.trace:
        values = dict(out["e2e"], setup_s=run.setup_s)
        for m in cell.end_to_end():
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result_device = (
        device_info(torch, chips, run.memory_peak) if run.on_card
        else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, "power_limit_w": None}
    )
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics}
    if args.trace:
        prof, window_s, units = run.trace_data
        trace = Trace(prof, window_s, units)
        result_device.update(busy_s=trace.busy_s, window_s=trace.window_s)

        class Reading:
            pass

        reading = Reading()
        reading.trace, reading.layer, reading.config, reading.traffic = trace, out["layer"], cell.config, cell.traffic
        for m in cell.per_layer():
            value = cell.metric_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = trace.breakdown()
    result["device"] = result_device
    emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
