"""Concurrent load drive of the HTTP generation server (counterpart of
`examples/load_test.py`).

N client threads fire mixed traffic at a running `GenerateServer`: plain
generate, per-request guidance (a scalar and one per prompt), per-request
negative prompts, and edits. The drive then checks the envelope: every
request answers 200 with the right image count, the p99 latency stays
under `--latency-budget` seconds, and `/stats` `backend_compiles` stays
flat through the traffic (a surface left cold would build in mid-traffic).

    python -m muse_maskgit_pytorch_tpu_torch.examples.serve --base-checkpoint base.msgpack \
        --warmup-surfaces all --port 8000 &
    python -m muse_maskgit_pytorch_tpu_torch.examples.load_test --port 8000 --threads 8 --requests 64

A client only: it builds no model, so it has no `--device`.
"""

from __future__ import annotations

import argparse
import base64
import json
import threading
import time
import urllib.request

import numpy as np

from muse_maskgit_pytorch_tpu_torch.utils.png import encode_png

GEN_KINDS = ("scale", "per_scale", "neg", "plain")


def _call(port, path, payload, timeout):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _b64_png(arr) -> str:
    return base64.b64encode(encode_png(arr)).decode()


def drive(port, *, threads=8, requests=64, prompts_per_request=2, edit_frac=0.25, timeout=600.0, log=print):
    """Fire `requests` mixed requests from `threads` workers; returns a
    stats dict (latencies, failures, the compile delta, server stats)."""
    size = _get(port, "/healthz")["image_size"]
    h, w = (size, size) if isinstance(size, int) else size
    src = _b64_png(np.zeros((h, w, 3), np.uint8))
    mask = _b64_png(np.full((h, w), 255, np.uint8))

    compiles_before = _get(port, "/stats").get("backend_compiles")
    lat, failures = [], []
    lock = threading.Lock()
    counter = iter(range(10**9))
    period = max(1, round(1 / edit_frac)) if edit_frac > 0 else 0

    def one(i):
        if period and i % period == 0:
            kind = "edit"
        else:
            # the generate kinds cycle over the non-edit ordinals, so all four
            # appear whatever the edit period
            gen_ordinal = i - (i // period + 1) if period else i
            kind = GEN_KINDS[gen_ordinal % 4]
        ps = [f"prompt {i}-{j}" for j in range(prompts_per_request)]
        if kind == "edit":
            path, payload = "/edit", {"prompts": ps, "images": [src] * len(ps), "masks": [mask] * len(ps)}
        elif kind == "scale":
            path, payload = "/generate", {"prompts": ps, "cond_scale": 4.0}
        elif kind == "per_scale":
            path, payload = "/generate", {"prompts": ps, "cond_scale": [2.0 + j for j in range(len(ps))]}
        elif kind == "neg":
            path, payload = "/generate", {"prompts": ps, "negative_prompt": ["blurry"] + [None] * (len(ps) - 1)}
        else:
            path, payload = "/generate", {"prompts": ps}
        t0 = time.perf_counter()
        try:
            status, out = _call(port, path, payload, timeout)
            dt = time.perf_counter() - t0
            ok = status == 200 and len(out.get("images", ())) == len(ps)
            with lock:
                lat.append(dt)
                if not ok:
                    failures.append((kind, status, out.get("error")))
        except Exception as e:  # noqa: BLE001 - a failed request is recorded, the drive goes on
            with lock:
                failures.append((kind, "exc", repr(e)))

    def worker():
        while True:
            with lock:
                i = next(counter)
            if i >= requests:
                return
            one(i)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0

    stats = _get(port, "/stats")
    compiles_after = stats.get("backend_compiles")
    lat.sort()
    result = {
        "requests": requests,
        "threads": threads,
        "wall_s": round(wall, 2),
        "failures": failures,
        "latency_p50_s": round(lat[len(lat) // 2], 3) if lat else None,
        "latency_p99_s": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3) if lat else None,
        "latency_max_s": round(lat[-1], 3) if lat else None,
        "mid_traffic_compiles": (
            compiles_after - compiles_before if None not in (compiles_after, compiles_before) else None
        ),
        "avg_batch_fill": stats.get("avg_batch_fill"),
        "images": stats.get("images"),
    }
    log(json.dumps(result, indent=2))
    return result


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--prompts-per-request", type=int, default=2)
    p.add_argument("--edit-frac", type=float, default=0.25)
    p.add_argument("--latency-budget", type=float, default=30.0, help="p99 per-request budget in seconds")
    p.add_argument("--timeout", type=float, default=600.0)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    r = drive(
        args.port, threads=args.threads, requests=args.requests, prompts_per_request=args.prompts_per_request,
        edit_frac=args.edit_frac, timeout=args.timeout,
    )
    ok = not r["failures"] and (r["latency_p99_s"] or 0) <= args.latency_budget and r["mid_traffic_compiles"] in (0, None)
    print("LOAD TEST", "PASSED" if ok else "FAILED")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
