"""Back-to-back `MaskGitTrainer` steps on token ids (the pre-tokenised
path), one micro-batch a step.

Every step's rows are new: token grids uniform over the vocabulary, text
embeddings drawn normal with a ragged length a row (their padding zeroed
and masked), and the step's draws (mask times and scores, the CFG dropout
uniforms, the self-conditioning coin), all made by the benchmark from
(seed, step) and handed to `train_step_arrays`. The coin takes the values
(k + 1/2) / 10, k = 0..9, once in every ten steps, in an order drawn from
the seed: every seed runs the same number of self-conditioning passes. The set-up drives the same
trainer through its first `reference_steps` steps (its warm-up) and keeps
what the check compares; the window continues from there.
"""

from __future__ import annotations

import time
import traceback
from pathlib import Path

import numpy as np

from benchmark import flops
from benchmark.models import build, make_weights, meta_modules, specs


def batch(torch, traffic: dict, cfg: dict, seed: int, step: int, device) -> dict:
    t = cfg["transformer"]
    b, n, L = traffic["batch_size"], t["seq_len"], traffic["text_len"]
    rng = np.random.default_rng([seed & (2**63 - 1), 2, step])
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2**62)))
    ids = torch.randint(0, t["num_tokens"], (b, n), generator=gen, device=device)
    lo, hi = traffic["text_tokens"]
    lengths = torch.from_numpy(rng.integers(lo, hi + 1, b)).to(device)
    text_mask = torch.arange(L, device=device)[None] < lengths[:, None]
    text = torch.randn(b, L, t["text_embed_dim"], generator=gen, device=device) * text_mask[..., None]
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)  # noqa: E731
    draws = dict(
        rand_time=u(b), mask_scores=u(b, n), nomask_scores=u(b, n), keep_u=u(b, 1),
        self_cond_u=torch.tensor(coin(seed, step)), sample_temperature=torch.tensor(float(rng.random())),
    )
    return dict(ids=ids, text=text, text_mask=text_mask, draws=draws, keys_on=lengths.tolist())


def coin(seed: int, step: int) -> float:
    order = np.random.default_rng([seed & (2**63 - 1), 4, step // 10]).permutation(10)
    return (float(order[step % 10]) + 0.5) / 10


def step(trainer, bt):
    from muse_maskgit_pytorch_tpu_torch.models.maskgit import TrainDraws

    return trainer.train_step_arrays(bt["ids"][None], bt["text"][None], bt["text_mask"][None],
                                     draws=[TrainDraws(**bt["draws"])])


def k2_backward_bound(cfg: dict, traffic: dict, bt: dict) -> float:
    """Least seconds of one step's K2 backward calls: a self- and a
    cross-attention a layer, the cross keys of a dropped text all off."""
    t = cfg["transformer"]
    b, n, L = traffic["batch_size"], t["seq_len"], traffic["text_len"]
    hd = dict(heads=t["heads"], dim_head=t["dim_head"])
    kept = (bt["draws"]["keep_u"].reshape(-1) >= cfg["maskgit"]["cond_drop_prob"]).tolist()
    cross_on = [k if keep else 0 for k, keep in zip(bt["keys_on"], kept)]
    bwd = flops.k2_backward(b, n, [n] * b, keys=n, **hd).bound_s + flops.k2_backward(b, n, cross_on, keys=L, **hd).bound_s
    return t["depth"] * bwd


def run(r):
    torch = r.torch
    cfg, traffic = r.cell.config, r.cell.traffic
    from muse_maskgit_pytorch_tpu_torch.training.trainers import MaskGitTrainer

    model, made = build(cfg, r.seed, r.device, with_vae=False)
    r.log(f"set-up: {made} parameters made on the device by {r.since_start():.1f} s")
    folder = Path(r.cell.root) / "build" / "bench_train"
    trainer = MaskGitTrainer(
        model, num_train_steps=10**9, batch_size=traffic["batch_size"], lr=traffic["lr"],
        ema_beta=traffic["ema_beta"], use_ema=True, seed=r.seed % (2**63), results_folder=str(folder),
    )
    names = [n[len("transformer."):] for n in trainer.param_names]
    start = [p.detach().clone() for p in trainer.params]
    seen = {"losses": []}
    n_ref = traffic["reference_steps"]
    for i in range(n_ref):  # the first steps: the warm-up, and what the reference follows
        logs = step(trainer, batch(torch, traffic, cfg, r.seed, i, r.device))
        seen["losses"].append(logs["loss"])
        if i == 0:
            b1 = 1.0 - 0.9
            seen["grad_norm"] = {k: float(m.norm()) / b1 for k, m in zip(names, trainer.optimizer.mu)}
    seen["change_norm"] = {k: float((p.detach() - s).norm()) for k, p, s in zip(names, trainer.params, start)}
    seen["ema_norm"] = {k: float((e.detach() - s).norm()) for k, e, s in zip(names, trainer.ema, start)}
    del start
    r.window_open()

    spans, i = [], n_ref
    trace_at = n_ref + 1 if r.trace else None
    trace_end = trace_at + traffic["trace_steps"] if r.trace else 0
    prof = None
    k2b = 0.0
    attempted = failed = 0
    while time.perf_counter() - r.t_window < r.seconds or i < trace_end:
        bt = batch(torch, traffic, cfg, r.seed, i, r.device)
        if i == trace_at:
            prof = r.profiler_start()
        t0 = time.perf_counter()
        attempted += 1
        try:
            step(trainer, bt)  # reads the loss on the host: the step has ended
            ok = True
        except Exception:  # noqa: BLE001 (a failed step is counted, not raised)
            r.log(f"step {i} failed:\n{traceback.format_exc()}")
            failed += 1
            ok = False
        t1 = time.perf_counter()
        traced = trace_at is not None and trace_at <= i < trace_end
        spans.append((t0, t1, int(ok), traced))
        if traced:
            k2b += k2_backward_bound(cfg, traffic, bt)
            if i == trace_end - 1:
                r.profiler_stop(prof, spans[trace_at - n_ref][0], t1, units=traffic["trace_steps"])
        i += 1
    r.window_close()
    window = spans[-1][1] - r.t_window
    steps = sum(ok for _, _, ok, _ in spans)

    t = cfg["transformer"]
    step_flops = flops.maskgit_train_flops(
        batch=traffic["batch_size"], seq_len=t["seq_len"], text_len=traffic["text_len"], dim=t["dim"],
        depth=t["depth"], vocab=t["num_tokens"], ff_mult=t["ff_mult"], self_cond=t["self_cond"],
        self_cond_prob=cfg["maskgit"]["self_cond_prob"],
    )
    plain = [(t1 - t0, ok) for t0, t1, ok, traced in spans if not traced]
    layer = {
        "steps_per_s_untraced": sum(ok for _, ok in plain) / sum(dt for dt, _ in plain),
        "flops_per_step": step_flops, "k2_bwd_bound_s": k2b,
    }

    del trainer, model
    r.free()
    numbers = compare(torch, cfg, traffic, r.seed, r.device, seen, names, control=r.control)
    return {
        "attempted": attempted, "failed": failed,
        "e2e": {traffic["rate_metric"]: steps * traffic["batch_size"] / window},
        "layer": layer, "numbers": numbers,
    }


def relative_gaps(got: dict, ref: dict, names) -> dict:
    """|got - ref| of each leaf over max(ref, the median leaf's ref)."""
    med = float(np.median([ref[k] for k in names]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in names}


def compare(torch, cfg: dict, traffic: dict, seed: int, device, seen: dict, names, control: bool = False) -> dict:
    """The reference over the same first steps; the numbers compared: the
    first gradient (`grad_gap*`), the parameters' change (`change_gap*`)
    and the moving average's change (`ema_gap*`), each by its worst leaf
    and its median leaf. Leaves whose reference gradient is under a
    thousandth of the median leaf's (a key bias under softmax, an unused
    norm) move under Adam by round-off alone and are left out of both
    changes. With `control`, also the readings of the reference put in the
    program's place in fp8 (`control.*`), with half of each batch left out
    (`half_batch.*`) and with its moving average stopped after the first
    copy (`ema_frozen.*`)."""
    from benchmark.reference import train as ref_train

    w = make_weights(specs(meta_modules(cfg)["base"]), seed, "base", device)
    w = {k: w[k] for k in names}
    batches = [batch(torch, traffic, cfg, seed, i, device) for i in range(traffic["reference_steps"])]

    def follow(mode="f32", rows=None):
        bts = batches if rows is None else [_rows(bt, rows) for bt in batches]
        losses, first, change, ema, frozen = ref_train.follow(
            w, cfg["transformer"], cfg["maskgit"], bts, traffic["lr"], traffic["ema_beta"], mode
        )
        norms = lambda d: {k: float(v.norm()) for k, v in d.items()}  # noqa: E731
        return dict(losses=losses, grad_norm=norms(first), change_norm=norms(change), ema_norm=norms(ema),
                    frozen_norm=norms(frozen))

    ref = follow()
    med = float(np.median(list(ref["grad_norm"].values())))
    moving = [k for k in names if ref["grad_norm"][k] >= 1e-3 * med]

    def numbers(got: dict) -> dict:
        grad = list(relative_gaps(got["grad_norm"], ref["grad_norm"], names).values())
        change = list(relative_gaps(got["change_norm"], ref["change_norm"], moving).values())
        ema = list(relative_gaps(got["ema_norm"], ref["ema_norm"], moving).values())
        return {
            "loss_gap": max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": max(grad), "change_gap": max(change), "ema_gap": max(ema),
            "grad_gap_median": float(np.median(grad)), "change_gap_median": float(np.median(change)),
            "ema_gap_median": float(np.median(ema)),
        }

    out = numbers(seen)
    if control:
        for key, got in (("control", follow("fp8")), ("half_batch", follow(rows=traffic["batch_size"] // 2))):
            out.update({f"{key}.{k}": v for k, v in numbers(got).items()})
        out.update({f"ema_frozen.{k}": v for k, v in numbers(dict(ref, ema_norm=ref["frozen_norm"])).items()
                    if k.startswith("ema")})
    return out


def _rows(bt: dict, n: int) -> dict:
    """The first `n` rows of a batch (the scalars shared)."""
    cut = {k: (v[:n] if k in ("rand_time", "mask_scores", "nomask_scores", "keep_u") else v) for k, v in bt["draws"].items()}
    return dict(ids=bt["ids"][:n], text=bt["text"][:n], text_mask=bt["text_mask"][:n], draws=cut)
