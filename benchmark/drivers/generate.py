"""Closed-loop batch generation: back-to-back `GeneratePipeline` calls of
one full batch of prompts each, the next sent when the last one's uint8
images are on the host.

The traffic file gives the end-to-end metric its rate is reported as
(`rate_metric`), the batch, the decode's settings (the sampler's top-k
share is the one the port and upstream default to, which the reference
applies), the prompts' byte lengths, how many of the first `check_pool`
batches the check reads and how many whole batches a traced run profiles.
Prompts are drawn from (seed, batch index), so a batch's prompts do not
depend on how many batches ran before it. The window ends with the last
batch started within `--seconds`, or with the last one the trace or the
check needs, if that comes later.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from benchmark import flops, gencheck
from benchmark.models import build


def prompts(traffic: dict, seed: int, batch, n: int):
    """Batch `batch`'s prompts (None: the warm-up's)."""
    lo, hi = traffic["prompt_bytes"]
    rng = np.random.default_rng([seed & (2**63 - 1), 0] if batch is None else [seed & (2**63 - 1), 1, batch])
    alphabet = np.array(list(traffic["alphabet"]))
    return ["".join(rng.choice(alphabet, int(rng.integers(lo, hi + 1)))) for _ in range(n)]


def chosen(traffic: dict, seed: int, candidates) -> list:
    """The batches the check reads, drawn from the seed among `candidates`
    (batches that finish early in every window)."""
    rng = np.random.default_rng([seed & (2**63 - 1), 7])
    return sorted(rng.choice(list(candidates), traffic["check_batches"], replace=False).tolist())


def work(cfg: dict, traffic: dict, text_bytes) -> dict:
    """Least seconds a batch at the peaks (whole request, K1, K2), from the
    configuration and the traffic: `text_bytes` are the prompts' lengths."""
    b, T, L = traffic["batch_size"], traffic["timesteps"], traffic["text_len"]
    keys_on = [min(n + 1, L) for n in text_bytes] + [1] * (b - len(text_bytes))  # bytes, then the end token
    stages = [(cfg["transformer"], 0, cfg["maskgit"]["image_size"])]
    if cfg.get("superres"):
        base_seq = cfg["transformer"]["seq_len"]
        stages.append((cfg["superres"]["transformer"], base_seq, cfg["superres"]["maskgit"]["image_size"]))
    bf16 = k1 = k2 = 0.0
    for t, cond_len, _ in stages:
        rows = flops.compact_rows(t["seq_len"], T)
        bf16 += flops.maskgit_generate_flops(
            batch=b, timesteps=T, seq_len=t["seq_len"], text_len=L, dim=t["dim"], depth=t["depth"],
            vocab=t["num_tokens"], ff_mult=t["ff_mult"], cond_scale=traffic["cond_scale"], self_cond=t["self_cond"],
            cond_seq_len=cond_len, head_positions_per_step=rows,
        )
        k1 += sum(flops.k1_launch(b * r, t["num_tokens"]).bound_s for r in rows)
        n, hd = t["seq_len"], dict(heads=t["heads"], dim_head=t["dim_head"])
        self_attn = flops.k2_forward(2 * b, n, [n] * (2 * b), keys=n, **hd)
        if cond_len:  # both halves attend the conditioning tokens, the null half no text
            cross = flops.k2_forward(2 * b, n, [k + cond_len for k in keys_on] + [cond_len] * b, keys=L + cond_len, **hd)
        else:  # the null half's cross-attention is a constant: cond rows only
            cross = flops.k2_forward(b, n, keys_on, keys=L, **hd)
        k2 += T * t["depth"] * (self_attn.bound_s + cross.bound_s)
    final = stages[-1][2]
    v = cfg["vae"]
    f32 = b * flops.vae_decode_flops(final, dim=v["dim"], layers=v["layers"], codebook_size=v["codebook_size"])
    t5 = cfg["t5"]
    f32 += b * flops.t5_encoder_flops(L, **{k: t5[k] for k in ("d_model", "d_ff", "num_heads", "d_kv", "num_layers")})
    return {"least_s": bf16 / flops.PEAK_BF16 + f32 / flops.PEAK_F32, "k1_bound_s": k1, "k2_bound_s": k2}


def run(r):
    """`r`: the run (see `run.py`). Returns the outcome the harness reports."""
    torch = r.torch
    cfg, traffic = r.cell.config, r.cell.traffic
    b = traffic["batch_size"]
    from muse_maskgit_pytorch_tpu_torch.serving import GeneratePipeline

    model, made = build(cfg, r.seed, r.device)
    r.log(f"set-up: {made} parameters made on the device by {r.since_start():.1f} s")
    pipe = GeneratePipeline(
        model, batch_size=b, timesteps=traffic["timesteps"], cond_scale=traffic["cond_scale"],
        temperature=traffic["temperature"], text_len=traffic["text_len"], seed=r.seed % (2**63), return_pil=False,
        device=r.device,
    )
    if cfg.get("superres"):
        stages = {"base": model.base_maskgit.transformer, "superres": model.superres_maskgit.transformer}
        decode_vae = model.superres_maskgit.vae
    else:
        stages, decode_vae = {"base": model.transformer}, model.vae
    checked = chosen(traffic, r.seed, range(traffic["check_pool"]))
    rec = gencheck.Recorder(pipe, model, stages, decode_vae, checked)
    # warm-up: this cell's one shape, through the same call
    pipe(prompts(traffic, r.seed, None, b))
    r.sync()
    r.window_open()
    r.log(f"set-up: warmed by {r.setup_s:.1f} s")

    spans, outputs, i = [], 0, 0
    trace_at = 1 if r.trace else None
    trace_end = (trace_at + traffic["trace_batches"]) if r.trace else 0
    prof = traced = None
    attempted = failed = 0
    # the window runs on past `seconds` until the traced batches and those the
    # check reads have run (the first `check_pool` batches: only on a slow host)
    last = max(trace_end, max(checked) + 1)
    while time.perf_counter() - r.t_window < r.seconds or i < last:
        batch = prompts(traffic, r.seed, i, b)
        if i == trace_at:
            prof, traced = r.profiler_start(), []
        rec.arm(i)
        t0 = time.perf_counter()
        attempted += len(batch)
        try:
            images = pipe(batch)
        except Exception:  # noqa: BLE001 (a failed request is counted, not raised)
            r.log(f"batch {i} failed:\n{traceback.format_exc()}")
            failed += len(batch)
            images = None
        t1 = time.perf_counter()
        if images is not None:
            outputs += len(images)
            rec.served(i, batch, images)
        spans.append((t0, t1, len(batch) if images is not None else 0, trace_at is not None and trace_at <= i < trace_end))
        if traced is not None and i < trace_end:
            traced.append(batch)
            if i == trace_end - 1:
                r.profiler_stop(prof, spans[trace_at][0], t1, units=sum(len(x) for x in traced))
        i += 1
    t_end = spans[-1][1]
    rec.arm(None)
    r.window_close()
    window = t_end - r.t_window
    # where the window's time went: slow batches (a stalled host or card) or
    # the host between batches
    times = sorted(t1 - t0 for t0, t1, _, traced_ in spans if not traced_)
    med = times[len(times) // 2]
    slow = [t for t in times if t > 1.5 * med]
    between = spans[0][0] - r.t_window + sum(b[0] - a[1] for a, b in zip(spans, spans[1:]))
    r.log(f"window: {len(spans)} batches in {window:.3f} s; a batch {med * 1e3:.1f} ms median, "
          f"{times[-1] * 1e3:.1f} slowest, {len(slow)} over 1.5x the median ({sum(slow) - len(slow) * med:.3f} s "
          f"beyond it); the host between batches {between:.3f} s")

    # per-layer inputs: the rate over the batches that were not profiled
    plain = [(t1 - t0, n) for t0, t1, n, prof_ in spans if not prof_]
    rate = sum(n for _, n in plain) / sum(dt for dt, _ in plain)
    text_bytes = [len(p.encode()) for p in prompts(traffic, r.seed, 0, b)]
    per_batch = work(cfg, traffic, text_bytes)
    layer = {"img_per_s_untraced": rate, "least_s_per_img": per_batch["least_s"] / b}
    if traced:
        lens = [[len(p.encode()) for p in batch] for batch in traced]
        layer["k1_bound_s"] = sum(work(cfg, traffic, x)["k1_bound_s"] for x in lens)
        layer["k2_bound_s"] = sum(work(cfg, traffic, x)["k2_bound_s"] for x in lens)

    # the check, once the program's state is gone
    rec.close()
    records = rec.records
    del pipe, model, rec
    r.free()
    done = sorted(k for k, v in records.items() if "images" in v)
    numbers = {}
    if len(done) == traffic["check_batches"]:
        numbers = gencheck.check(cfg, traffic, records, done, gencheck.reference_weights(cfg, r.seed, r.device), r.device,
                                 control=r.control)
    else:
        r.log(f"the batches drawn for the check did not all finish: {done}")
    return {
        "attempted": attempted, "failed": failed,
        "e2e": {traffic["rate_metric"]: outputs / window},
        "layer": layer, "numbers": numbers,
    }
