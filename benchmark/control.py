"""The readings a cell's limits are set from: the program's numbers and the
control's, over many seeds, in one process.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed the cell runs as `run.py` runs it (a short window, which has
to hold the batches the check draws), and its check reports, beside the
program's numbers, the control's: the reference put in the program's place
one precision below the configuration's (fp8 for the bf16 transformers,
TF32 for the f32 T5 and VAE), on the same prompts and tokens; for a
training cell also the reference with half of each batch left out and
with its moving average stopped after its first copy. One JSON line a
seed on standard output. The benchmark's own runs do not run
this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, *, root: Path = ROOT, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(root))
    from benchmark import run as bench

    bench._environment(root)
    import torch

    from benchmark.harness import Cell

    cell = Cell(args.workload, root)
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card: no readings", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = cell.driver()
    for seed in args.seeds:
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        r = bench.Run(torch, cell, ns, torch.device(device))
        r.control = True
        out = driver.run(r)
        print(json.dumps({"seed": seed, "failed": out["failed"], "numbers": out["numbers"]}), flush=True)
        del out, r
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
