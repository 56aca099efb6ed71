#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's hand-written CUDA kernels from `csrc/`, holds each against
its plain PyTorch version at the main path's shapes, then drives the main
path -- `MaskGit.generate` from text embeddings to 256px images at the
width `bench.py` uses (transformer dim 512, depth 8, 8 heads x 64, seq 256,
vocab 65536, bf16; VAE dim 256, 4 layers, LFQ 65536; batch 32, 18 steps,
CFG 3), random weights from a seed -- and checks that it went through the
kernels. Each phase prints one line; any failed check raises and the exit
code is non-zero. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Run from the root of a checkout: `python3 chip_smoke.py`. `--phases`
selects a subset (env, build, k1, k2, generate, parity) while iterating;
a subset prints its phases' lines and no result lines.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ALL_PHASES = ("env", "build", "k1", "k2", "generate", "parity")

# main-path shapes
BATCH, STEPS, CFG = 32, 18, 3.0
SEQ, VOCAB, DIM, DEPTH, HEADS, DIM_HEAD, TEXT_LEN, TEXT_DIM = 256, 65536, 512, 8, 8, 64, 64, 768
TOPK = math.ceil(0.1 * VOCAB)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def plain_path(attend=None):
    """Route the models through the kernels' plain PyTorch versions (or the
    attention `attend`), for comparison only: the package itself runs a
    plain version only for CPU tensors, so this swaps the names the model
    modules call."""
    from muse_maskgit_pytorch_tpu_torch.models import maskgit, transformer
    from muse_maskgit_pytorch_tpu_torch.ops import attention, sampling_kernel

    saved = transformer.qknorm_attend, maskgit.fused_topk_gumbel_sample
    transformer.qknorm_attend = attend or attention.qknorm_attend_plain
    maskgit.fused_topk_gumbel_sample = sampling_kernel.fused_topk_gumbel_sample_plain
    try:
        yield
    finally:
        transformer.qknorm_attend, maskgit.fused_topk_gumbel_sample = saved


def attend_f64(q, k, v, null_k, null_v, q_scale, k_scale, mask=None, scale=8.0):
    """K2's plain version computed in f64, rounded to the inputs' dtype: an
    attention as exact as the card can give, to measure how far two correct
    attentions' bf16 roundings move the tokens."""
    from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend_plain

    args = (t.double() for t in (q, k, v, null_k, null_v, q_scale, k_scale))
    return qknorm_attend_plain(*args, mask=mask, scale=scale).to(q.dtype)


def phase_env(torch, ctx):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    ctx["smi"] = smi
    log(
        f"[env] torch {torch.__version__} cuda {torch.version.cuda} | {smi} | "
        f"devices {torch.cuda.device_count()} | tf32 matmul/cudnn off"
    )


def phase_build(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.ops import attention, sampling_kernel

    t0 = time.perf_counter()
    sampling_kernel._lib()
    t1 = time.perf_counter()
    attention._lib()
    t2 = time.perf_counter()
    log(f"[build] nvcc sm_90a: sampling_kernel {t1 - t0:.1f}s, qknorm_attention {t2 - t1:.1f}s")


def phase_k1(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import (
        fused_topk_gumbel_sample as sample,
        fused_topk_gumbel_sample_plain as plain,
        topk_threshold_plain,
    )

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    rows = BATCH * SEQ
    temp = 17.0 / 18.0
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)

    def compare(tag, logits, noise, **kw):
        idx, prob = sample(logits, TOPK, temp, seed, noise=noise, **kw)
        pidx, pprob = plain(logits, TOPK, temp, seed, noise=noise, **kw)
        torch.cuda.synchronize()
        require(torch.equal(idx, pidx), f"K1 {tag}: idx differ at {(idx != pidx).sum().item()} rows")
        rel = ((prob - pprob).abs() / pprob.abs().clamp_min(1e-30)).max().item()
        # the logsumexp is summed in another order than the plain version's
        require(rel <= 1e-5, f"K1 {tag}: prob rel err {rel:.3g} > 1e-5")
        return (prob - pprob).abs().max().item()

    # bf16 logits at the main-path shape, injected noise: exact ids
    logits = (torch.randn(rows, VOCAB, generator=g, device=dev) * 3).to(torch.bfloat16)
    noise = -torch.log(-torch.log(torch.rand(rows, VOCAB, generator=g, device=dev).clamp(1e-9, 1 - 1e-9)))
    err = compare("bf16 injected", logits, noise)
    # cfg_pair: cond rows then null rows, combined in the kernel
    pair = (torch.randn(2 * rows, VOCAB, generator=g, device=dev) * 3).to(torch.bfloat16)
    err = max(err, compare("cfg_pair", pair, noise, cfg_pair=True, cond_scale=CFG))
    del pair
    # an odd row count, f32 logits
    odd = torch.randn(1001, VOCAB, generator=g, device=dev) * 3
    err = max(err, compare("odd rows f32", odd, noise[:1001]))
    del odd

    # in-kernel Philox noise
    # temperature 0: the draw is a row maximum (bf16 rows hold tied maxima,
    # which the vanishing noise may order either way)
    l32 = logits.float()
    idx0, _ = sample(logits, TOPK, 0.0, seed)
    at_max = l32.gather(1, idx0.long()[:, None])[:, 0] == l32.amax(-1)
    require(bool(at_max.all()), "K1 temp 0 is not the argmax")
    idx, _ = sample(logits, TOPK, 1.0, seed)
    thresh = topk_threshold_plain(l32, TOPK)
    chosen = l32.gather(1, idx.long()[:, None])
    require(bool((chosen >= thresh).all()), "K1 sampled outside the top-k set")
    pidx, _ = plain(logits[:256], TOPK, 1.0, seed)
    agree_philox = (idx[:256] == pidx).float().mean().item()
    require(agree_philox >= 0.99, f"K1 Philox stream vs plain Philox agree {agree_philox:.4f}")
    # frequencies on a small vocabulary (k = V: no filtering) against softmax;
    # bound 0.01 is > 5 sigma of a frequency at 2^16 draws
    p = torch.tensor([0.5, 0.2, 0.1, 0.05, 0.05, 0.04, 0.03, 0.03], device=dev)
    small = p.log().expand(1 << 16, 8).contiguous()
    sidx, _ = sample(small, 8, 1.0, seed)
    freq = torch.bincount(sidx.long(), minlength=8).float() / (1 << 16)
    dev_max = (freq - p).abs().max().item()
    require(dev_max <= 0.01, f"K1 frequencies off softmax by {dev_max:.4f}")

    # time at the main-path step-0 shape: kernel with its Philox stream, and
    # the plain version with the same stream
    ms = cuda_ms(lambda: sample(logits, TOPK, temp, seed))
    plain_ms = cuda_ms(lambda: plain(logits, TOPK, temp, seed), iters=3, warmup=1)
    ctx["k1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log(
        f"[k1] fused_topk_gumbel_sample ok: ids exact (bf16, cfg_pair, odd f32), prob abs err "
        f"{err:.3g}; temp0=argmax, top-k set, Philox agree {agree_philox:.4f}, freq dev "
        f"{dev_max:.4f}; ({rows}, {VOCAB}) bf16 {ms:.3f} ms vs plain {plain_ms:.3f} ms"
    )


def phase_k2(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend, qknorm_attend_plain

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    hd = HEADS * DIM_HEAD

    def inputs(b, n, m, dtype, masked_rows=0):
        # k and v as column slices of one to_kv output, as the model passes them
        q = torch.randn(b, n, hd, generator=g, device=dev).to(dtype).reshape(b, n, HEADS, DIM_HEAD)
        kv = torch.randn(b, m, 2 * hd, generator=g, device=dev).to(dtype)
        k = kv[..., :hd].reshape(b, m, HEADS, DIM_HEAD)
        v = kv[..., hd:].reshape(b, m, HEADS, DIM_HEAD)
        nk = torch.randn(HEADS, DIM_HEAD, generator=g, device=dev).to(dtype)
        nv = torch.randn(HEADS, DIM_HEAD, generator=g, device=dev).to(dtype)
        qs = 1 + 0.1 * torch.randn(DIM_HEAD, generator=g, device=dev)
        ks = 1 + 0.1 * torch.randn(DIM_HEAD, generator=g, device=dev)
        mask = None
        if masked_rows:
            mask = torch.rand(b, m, generator=g, device=dev) > 0.3
            mask[:masked_rows] = False  # only the null position remains
        return (q, k, v, nk, nv, qs, ks), mask

    shapes = {
        "self": (2 * BATCH, SEQ, SEQ, 0),
        "cross": (BATCH, SEQ, TEXT_LEN, 0),
        "cross_masked": (BATCH, SEQ, TEXT_LEN, 4),
    }
    # f32: both sides compute in f32, differing only in summation order
    # (<= 1e-4); bf16: outputs are rounded to bf16 (2^-8 relative) after
    # f32 math on each side, so one rounding step apart (<= 2e-2)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    errs = {}
    for name, (b, n, m, masked) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            args, mask = inputs(b, n, m, dtype, masked)
            out = qknorm_attend(*args, mask=mask)
            ref = qknorm_attend_plain(*args, mask=mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            require(math.isfinite(err) and err <= tol[dtype], f"K2 {name} {dtype}: max abs err {err:.3g}")
            errs[(name, dtype)] = err
            if masked:
                nv = args[4].float()
                got = out[:masked].float()
                require(
                    (got - nv[None, None]).abs().max().item() <= tol[dtype],
                    "K2 fully masked rows must return null_v",
                )

    args, _ = inputs(2 * BATCH, SEQ, SEQ, torch.bfloat16)
    ms = cuda_ms(lambda: qknorm_attend(*args))
    plain_ms = cuda_ms(lambda: qknorm_attend_plain(*args))
    cargs, _ = inputs(BATCH, SEQ, TEXT_LEN, torch.bfloat16)
    cms = cuda_ms(lambda: qknorm_attend(*cargs))
    cplain_ms = cuda_ms(lambda: qknorm_attend_plain(*cargs))
    ctx["k2"] = dict(max_abs_err=errs[("self", torch.bfloat16)], ms=ms, plain_ms=plain_ms)
    err_s = ", ".join(f"{n} {str(d)[6:]} {e:.2g}" for (n, d), e in errs.items())
    log(
        f"[k2] qknorm_attend ok: max abs err {err_s}; self (64,256,8,64) bf16 {ms:.3f} ms vs "
        f"plain {plain_ms:.3f} ms; cross (32,256|64,8,64) {cms:.3f} ms vs plain {cplain_ms:.3f} ms"
    )


def build_models(torch, dtype=None, with_vae=True):
    """The main path's MaskGit, random weights from seed 0 (bf16 compute
    unless `dtype` says otherwise)."""
    from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, VQGanVAE

    gen = torch.Generator().manual_seed(0)
    vae = VQGanVAE(dim=256, layers=4, codebook_size=VOCAB, generator=gen) if with_vae else None
    transformer = MaskGitTransformer(
        num_tokens=VOCAB, dim=DIM, seq_len=SEQ, depth=DEPTH, dim_head=DIM_HEAD, heads=HEADS,
        text_embed_dim=TEXT_DIM, dtype=dtype or torch.bfloat16, generator=gen,
    )
    return MaskGit(image_size=256, transformer=transformer, vae=vae).cuda().eval()


def phase_generate(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend, qknorm_attend_plain
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample

    t0 = time.perf_counter()
    maskgit = ctx.get("maskgit") or build_models(torch)
    ctx["maskgit"] = maskgit
    t_build = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(0)
    text = torch.randn(BATCH, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    mask = torch.ones(BATCH, TEXT_LEN, dtype=torch.bool, device="cuda")

    def request(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = maskgit.generate(
            generator=gen, text_embeds=text, text_mask=mask, timesteps=STEPS, cond_scale=CFG
        )
        torch.cuda.synchronize()
        return img, time.perf_counter() - t

    t0 = time.perf_counter()
    request(100)  # warm-up: cuBLAS / cuDNN choose their algorithms
    t_warm = time.perf_counter() - t0

    fused_topk_gumbel_sample.launches = 0
    qknorm_attend.launches = 0
    times, per_request = [], []
    for i in range(3):
        k1_0, k2_0 = fused_topk_gumbel_sample.launches, qknorm_attend.launches
        img, dt = request(i)
        per_request.append(
            (fused_topk_gumbel_sample.launches - k1_0, qknorm_attend.launches - k2_0)
        )
        times.append(dt)
        require(tuple(img.shape) == (BATCH, 256, 256, 3), f"image shape {tuple(img.shape)}")
        require(bool(torch.isfinite(img).all()), "non-finite pixels")
    launches = (fused_topk_gumbel_sample.launches, qknorm_attend.launches)
    for k1, k2 in per_request:
        require(k1 == STEPS, f"K1 launched {k1} times in a request, expected {STEPS}")
        require(k2 == STEPS * DEPTH * 2, f"K2 launched {k2} times in a request, expected {STEPS * DEPTH * 2}")
    ctx["k1"]["launches"], ctx["k2"]["launches"] = launches
    img_s = BATCH / statistics.median(times)

    with plain_path():
        request(100)
        ptimes = [request(i)[1] for i in range(3)]
    plain_img_s = BATCH / statistics.median(ptimes)
    ctx["img_s"], ctx["plain_img_s"] = img_s, plain_img_s
    log(
        f"[generate] b{BATCH} T{STEPS} cfg{CFG:g} 256px: {img_s:.3f} img/s (median of "
        f"{', '.join(f'{t * 1000:.1f}' for t in times)} ms) | plain kernels {plain_img_s:.3f} img/s "
        f"({', '.join(f'{t * 1000:.1f}' for t in ptimes)} ms) | K1 +{per_request[0][0]}, "
        f"K2 +{per_request[0][1]} launches per request | {ctx['smi']} | models built "
        f"{t_build:.1f}s, warm-up {t_warm:.1f}s"
    )


def phase_parity(torch, ctx):
    """Kernel path against plain path on the card, under the same injected
    noise.

    In f32 compute the whole 18-step `generate` must agree (batch 2). In
    bf16 it cannot: with random weights the logits are flat (p ~ 1/V), the
    bf16 residual stream turns one rounding flip anywhere into ulp-sized
    changes of most logits eight layers later, and a flipped near-tie early
    changes which positions every later step remasks. So in bf16 each
    agreement is held against a floor measured in the same run: the plain
    path against the plain path with an f64 attention (`attend_f64`), two
    correct attentions that differ only in rounding. Single bf16 decode
    steps of the main path (all masked at step 0; half masked, compact, at
    step 9), each at its step's temperature, batch 16, must agree at least
    as well as that floor less 0.01 (> 3 sigma of the difference at 4096
    tokens); the 18-step bf16 agreement is printed beside its floor."""
    from muse_maskgit_pytorch_tpu_torch.models import maskgit as mg
    from muse_maskgit_pytorch_tpu_torch.utils.sampling import step_temperatures

    g = torch.Generator(device="cuda").manual_seed(7)
    temps = step_temperatures(1.0, STEPS)
    seed = torch.zeros(1, dtype=torch.int32, device="cuda")

    def gumbel(*shape):
        u = torch.rand(*shape, generator=g, device="cuda").clamp(1e-9, 1 - 1e-9)
        return -torch.log(-torch.log(u))

    def agreement(fn):
        """(kernel path vs plain path, f64-attention path vs plain path)."""
        out = fn()
        with plain_path():
            ref = fn()
        with plain_path(attend=attend_f64):
            exact = fn()
        return (out == ref).float().mean().item(), (exact == ref).float().mean().item()

    maskgit = ctx.get("maskgit") or build_models(torch)
    ctx["maskgit"] = maskgit

    # -- whole generate, batch 2
    b = 2
    text = torch.randn(b, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    noise = gumbel(STEPS, b, SEQ, VOCAB)

    def generate(model):
        return lambda: model.generate(
            text_embeds=text, timesteps=STEPS, cond_scale=CFG,
            injected_gumbel_noise=noise, return_ids=True,
        )

    bf16_full, bf16_full_floor = agreement(generate(maskgit))
    f32 = build_models(torch, dtype=torch.float32, with_vae=False)
    f32_full, _ = agreement(generate(f32))
    del f32, noise
    require(f32_full >= 0.99, f"f32 T{STEPS} kernel vs plain token agreement {f32_full:.4f} < 0.99")

    # -- single bf16 decode steps, batch 16
    bs = 16
    text = torch.randn(bs, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")

    @torch.inference_mode()
    def decode_step(x_in, cand, step, noise):
        # the body of one decode step, through the models' entry points
        tr = maskgit.transformer
        ctx_kv = mg._double_ctx_kv(tr.precompute_context_kv(text_embeds=text))
        logits = tr.forward_with_cond_scale(
            x_in, text_embeds=text, cond_scale=CFG, gather_positions=cand, context_kv=ctx_kv,
        )
        idx, _ = mg.fused_topk_gumbel_sample(
            logits.reshape(-1, VOCAB), TOPK, float(temps[step]), seed, noise=noise.reshape(-1, VOCAB),
        )
        return idx

    mask_id = maskgit.mask_id
    all_masked = torch.full((bs, SEQ), mask_id, dtype=torch.long, device="cuda")
    noise0 = gumbel(bs, SEQ, VOCAB)
    step0, floor0 = agreement(lambda: decode_step(all_masked, None, 0, noise0))
    cand = torch.argsort(torch.rand(bs, SEQ, generator=g, device="cuda"), dim=-1)[:, : SEQ // 2]
    half = torch.randint(0, VOCAB, (bs, SEQ), generator=g, device="cuda").scatter(1, cand, mask_id)
    noise9 = gumbel(bs, SEQ // 2, VOCAB)
    step9, floor9 = agreement(lambda: decode_step(half, cand, 9, noise9))
    require(step0 >= floor0 - 0.01, f"bf16 step 0 token agreement {step0:.4f} < floor {floor0:.4f} - 0.01")
    require(step9 >= floor9 - 0.01, f"bf16 step 9 token agreement {step9:.4f} < floor {floor9:.4f} - 0.01")
    log(
        f"[parity] injected noise, token agreement with the plain path (kernel path | f64-attention "
        f"floor): f32 generate b{b} T{STEPS} {f32_full:.4f} (checked >= 0.99); bf16 step 0 b{bs} "
        f"{step0:.4f} | {floor0:.4f}, bf16 step 9 b{bs} {step9:.4f} | {floor9:.4f} (checked >= "
        f"floor - 0.01); bf16 generate b{b} T{STEPS} {bf16_full:.4f} | {bf16_full_floor:.4f} "
        f"(printed)"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES))
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES:
            parser.error(f"unknown phase {p!r}")

    # the port must come from this checkout; without it there is nothing to run
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    import muse_maskgit_pytorch_tpu_torch  # noqa: F401

    ctx = {"k1": {}, "k2": {}}
    phase_env(torch, ctx)
    for name in phases:
        if name != "env":
            globals()[f"phase_{name}"](torch, ctx)
    if set(phases) != set(ALL_PHASES):
        return 0  # a subset measures too little for the result lines

    kernels = [
        dict(
            name="fused_topk_gumbel_sample", route="cuda",
            source="muse_maskgit_pytorch_tpu_torch/csrc/sampling_kernel.cu",
            replaces="muse_maskgit_pytorch_tpu/ops/sampling_kernel.py:57",
            **{k: ctx["k1"].get(k) for k in ("launches", "max_abs_err", "ms", "plain_ms")},
        ),
        dict(
            name="qknorm_attend", route="cuda",
            source="muse_maskgit_pytorch_tpu_torch/csrc/qknorm_attention.cu",
            replaces="muse_maskgit_pytorch_tpu/ops/attention.py:242",
            **{k: ctx["k2"].get(k) for k in ("launches", "max_abs_err", "ms", "plain_ms")},
        ),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ctx["smi"], flush=True)
    result = {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
