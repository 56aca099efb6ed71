#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's hand-written CUDA kernels from `csrc/` (one nvcc per
source, all at once), holds each against its plain PyTorch version at the
shapes its path gives it, then drives the port's paths through the entry
points a user calls, with random weights from a seed, and checks that each
went through its kernels (launch counts set to 0 just before a path and
read just after):

  * `generate`: `MaskGit.generate` from text embeddings to 256px images at
    the width `bench.py` uses (transformer dim 512, depth 8, 8 heads x 64,
    seq 256, vocab 65536, bf16; VAE dim 256, 4 layers, LFQ 65536; batch 32,
    18 steps, CFG 3) -- K1 and K2;
  * `cascade`: texts -> 512px at that width: the base stage's token grid
    conditions a super-res stage (seq 1024, `cond_image_size` 256, the same
    VAE), batch 16, 18 steps each, CFG 3, as the chain `bench.py` defines
    and through `Muse(texts)` with a T5 v1.1-base shaped encoder in front,
    handing over ids and pixels -- K1 and K2 at the super-res shapes;
  * `tokenize`: `VQGanVAE.encode` -> ids -> `decode_from_ids` at the
    tokenizer's full width (dim 256, 4 layers, 256px, batch 32) with LFQ and
    with EMA-VQ at the reference vq_kwargs (K 65536, codebook_dim 256,
    cosine) -- K3 on every EMA-VQ encode;
  * the public `ops.attend` op at the unfused attention's shapes -- K4, which
    no model path calls (as in the JAX package);
  * `surfaces`: every other sampling surface at the base stage's width --
    a negative prompt, a guidance ramp with `cfg_fold=False` (K1 reading its
    scale from device memory), per-row scales, 256x384 and 320px requests,
    `can_remask_prev_masked`, a SelfCritic and a TokenCritic decode,
    `MaskGit.edit`, `generate_reranked` by log-likelihood and by critic,
    `Muse.edit` at 512px and `Muse(texts)` re-ranked at 256x384 -> 512x768
    -- K1 and K2 at the shapes these give them;
  * `train`: `MaskGitTrainer` at `bench_sweep.py`'s exp_train_mfu width
    (b64, the base stage's width, self-conditioning, EMA) -- K2's forward
    and K2's backward kernel on every step, checked against the plain
    backward at the train shapes of both stages first;
  * `gan`: `VQGanVAETrainer` at `bench_sweep.py`'s exp_gan_step scale (VAE
    dim 256, 4 layers, codebook 65536, 256px, VGG16 and the discriminator,
    micro-batch 8) in f32 with LFQ and with EMA-VQ and in bf16 with LFQ, the
    R1 penalty on and off, and `bench_ema_vq.py`'s EMA-VQ run from a folder
    of PNGs (memorisation, exact resume) -- K3 three times an EMA-VQ step;
  * `eval`: the FID towers alone at b64 (InceptionV3 at 299px, VGG16 fc2 at
    256px, random weights from a seed; held against the same towers on the
    CPU), then FID end to end: 256 images from `MaskGit.generate` at the
    base stage's width (8 requests of b32 -- K1 and K2), written as PNGs
    beside 256 seeded "real" ones, through the port's `compute_fid` command
    line (`--save-stats`, `--stats`, a set against itself);
  * `tensor`: tensor parallelism over a `tensor` axis of two ranks on the
    one card (gloo on CUDA tensors): `MaskGitTrainer(shard_state=True,
    shard_state_rules=DEFAULT_TP_RULES)` at the base stage's width, f32
    against the unwrapped trainer and bf16 timed, a TP forward and
    `generate` against one process, a TP checkpoint read whole -- K2 on
    each rank's 4 heads, forward and backward, K1 on the gathered logits;
  * `serving`: the base model saved in the JAX package's checkpoint format
    and loaded into a fresh model (tensor- and image-equal), then served:
    `GeneratePipeline` at b16, T18, CFG 3 with T5 in front (warmup, timed
    calls, per-row guidance and negative prompts, an edit), a cascade
    pipeline at b8, and `GenerateServer` answering a burst of concurrent
    HTTP requests -- K1 and K2 on every batch.

Each phase prints one line (`surfaces` one a request); any failed check
raises and the exit code is non-zero. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Run from the root of a checkout: `python3 chip_smoke.py`. `--phases`
selects a subset (env, build, k1, k2, k3, k4, generate, parity, tokenize,
t5, surfaces, serving, train, gan, cascade, eval, parallel, tensor, profile) while iterating; a
subset prints its phases' lines and no result lines.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# `profile` runs last, and `cascade` profiles at its end: once torch.profiler
# has run in a process, every later launch costs the host more, and the
# requests of `generate` and `cascade` are paced by the host's launches
ALL_PHASES = (
    "env", "build", "k1", "k2", "k3", "k4", "generate", "parity", "tokenize", "t5", "surfaces", "serving", "train",
    "gan", "cascade", "eval", "parallel", "tensor", "profile",
)
KERNEL_SOURCES = ("sampling_kernel", "qknorm_attention", "qknorm_attention_bwd", "vq_search", "flash_attention")

# main-path shapes
BATCH, STEPS, CFG = 32, 18, 3.0
SEQ, VOCAB, DIM, DEPTH, HEADS, DIM_HEAD, TEXT_LEN, TEXT_DIM = 256, 65536, 512, 8, 8, 64, 64, 768
TOPK = math.ceil(0.1 * VOCAB)
IMAGE, VAE_DIM, VAE_LAYERS, CODE_DIM = 256, 256, 4, 256
NEAR_TIE = 1e-5  # f64 score gap within which two f32 searches may differ (unit vectors)
# the cascade: batch, the super-res stage's sequence and image, its conditioning grid
CAS_BATCH, SR_SEQ, SR_IMAGE, COND_TOKENS = 16, 1024, 512, 256
# the sampling surfaces: base-stage and cascade batches, a negative text's length
SURF_BATCH, SURF_CAS_BATCH, NEG_TEXT_LEN = 8, 4, 16
# serving: the pipeline's batch, the cascade pipeline's, the server's burst
SERVE_BATCH, SERVE_CAS_BATCH, BURST_REQUESTS, BURST_CLIENTS = 16, 8, 48, 16
# training (`bench_sweep.py`'s exp_train_mfu): batch, timed steps after the
# warm-up, the learning rate and its warmup; the memorisation and resume
# checks' depth and rate
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARM, TRAIN_LR, TRAIN_WARMUP = 64, 10, 2, 1e-4, 2
# the super-res stage's step (batch CAS_BATCH at seq SR_SEQ): warm-up and timed steps
SR_TRAIN_WARM, SR_TRAIN_STEPS = 2, 5
# tensor parallelism: ranks on the one card, the train and generate batches,
# the bf16 step's warm-up, timed steps and steps with the collectives timed
TP_WORLD, TP_BATCH, TP_GEN_BATCH, TP_WARM, TP_STEPS, TP_COLL_STEPS = 2, 16, 8, 2, 5, 3
# the share of the train state a rank holds under DEFAULT_TP_RULES at this
# width, counted from the specs on the CPU (103,325,181 parameters)
TP_STATE_SHARE_EXPECTED = 0.696
SMALL_DEPTH, SMALL_LR = 2, 1e-3
# the VQ-GAN step (`bench_sweep.py`'s exp_gan_step: the tokenizer's width,
# micro-batch 8, accumulation 1, EMA) with the reference EMA-VQ settings
# (`vqgan_vae.py`'s vq_kwargs); warm-up and timed steps
GAN_BATCH, GAN_WARM, GAN_STEPS = 8, 2, 5
EMA_VQ_KW = dict(codebook_dim=CODE_DIM, decay=0.8, commitment_weight=1.0, kmeans_init=True, use_cosine_sim=True)
# `bench_ema_vq.py`'s EMA-VQ run: dim 64, 2 layers, 128px, batch 16, dead
# codes revived below 2.0, no GAN, lr 1e-3; fed from a folder of PNGs
MEM_DIM, MEM_LAYERS, MEM_IMAGE, MEM_BATCH, MEM_LR, MEM_STEPS, MEM_FILES = 64, 2, 128, 16, 1e-3, 30, 24
# evaluation: the towers' batch, the generate requests of BATCH images whose
# FID is taken, the images the towers are held against the CPU with
EVAL_BATCH, EVAL_REQUESTS, EVAL_CPU_IMAGES = 64, 8, 4
# the CPU tests' limits for the towers: rtol, and atol as a share of max |ref|
TOWER_RTOL = 1e-4
# 57-63 bytes each: with the end token, a T5 length of 64, so 64 + 256 cross-attention keys
PROMPTS = (
    "a watercolor painting of a lighthouse on a cliff at sunrise",
    "two red foxes playing in fresh snow under tall pine trees",
    "an astronaut riding a bicycle across the surface of the moon",
    "a bowl of ripe cherries on a wooden table by a sunny window",
    "a steam locomotive crossing an old stone bridge in autumn fog",
    "a close-up photograph of a dragonfly resting on a green reed",
    "a small sailing boat on a calm lake with mountains behind it",
    "an old library with tall shelves and a ladder, warm lamp lights",
    "a street market at night with paper lanterns and wet cobbles",
    "a field of sunflowers under a stormy sky, oil on canvas style",
    "a robot watering potted plants on a balcony above the city",
    "a slice of lemon cake on a blue plate beside a cup of coffee",
    "a herd of elephants walking along a wide river at golden hour",
    "a snowy mountain village with smoke rising from its chimneys",
    "a hummingbird hovering at a bright pink flower, macro photo",
    "a cozy cabin interior with a fireplace and a sleeping dog",
)

# the H100 SXM's peaks (NVIDIA data sheet), for each kernel's bound
HBM_BYTES_S = 3.35e12   # device memory
PEAK_BF16_TC = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_TF32_TC = 495e12   # dense TF32 tensor-core FLOP/s
PEAK_F32 = 67e12        # f32 FMA outside the tensor cores

# K2's backward kernels a call, in launch order, on its two multi-kernel
# routes (`csrc/qknorm_attention_bwd.cu`): f32 at any n, and bf16 above 256
# queries
BWD_F32_KERNELS = ["qknorm_bwd_keys_f32", "qknorm_bwd_queries_f32", "qknorm_bwd_sum_rows", "qknorm_bwd_reduce"]
BWD_BF16_SPLIT_KERNELS = ["qknorm_bwd_queries_bf16", "qknorm_bwd_keys_bf16", "qknorm_bwd_sum_rows", "qknorm_bwd_reduce"]
# K2's f32 forward kernel (`csrc/qknorm_attention.cu`), one launch a call
F32_FWD_KERNEL = "qknorm_fwd_f32"


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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms: `iters` calls captured in one CUDA
    graph and replayed, so no host work sits between the launches. For the
    attention kernels, whose device time is below their wrappers' Python
    time, an eager loop would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()  # outside the graph: first-use work and the allocator's warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def host_us(fn, iters: int = 50) -> float:
    """Host microseconds a call of fn() takes to enqueue its work (no
    synchronize inside the timed loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flop: float, moved: int, peak: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes that must move (each input read once, each output written
    once) at the memory rate and the operations at their type's peak."""
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, flop / peak * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def plain_path(attend=None):
    """Route the models through the kernels' plain PyTorch versions (or the
    attention `attend`), for comparison only: the package itself runs a
    plain version only for CPU tensors, so this swaps the names the model
    modules call."""
    from muse_maskgit_pytorch_tpu_torch.models import maskgit, quantizers, transformer
    from muse_maskgit_pytorch_tpu_torch.ops import attention, sampling_kernel, vq

    saved = transformer.qknorm_attend, maskgit.fused_topk_gumbel_sample, quantizers.nearest_code
    transformer.qknorm_attend = attend or attention.qknorm_attend_plain
    maskgit.fused_topk_gumbel_sample = sampling_kernel.fused_topk_gumbel_sample_plain
    quantizers.nearest_code = vq.nearest_code_plain
    try:
        yield
    finally:
        transformer.qknorm_attend, maskgit.fused_topk_gumbel_sample, quantizers.nearest_code = saved


def attend_f64(q, k, v, null_k, null_v, q_scale, k_scale, mask=None, scale=8.0):
    """K2's plain version computed in f64, rounded to the inputs' dtype: an
    attention as exact as the card can give, to measure how far two correct
    attentions' bf16 roundings move the tokens."""
    from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend_plain

    args = (t.double() for t in (q, k, v, null_k, null_v, q_scale, k_scale))
    return qknorm_attend_plain(*args, mask=mask, scale=scale).to(q.dtype)


def attend_bf16_rounded(*args, **kw):
    """K2's plain version rounding q^, k^ and P to bf16 where the JAX
    package's `_qknorm_kernel` rounds: a correct attention with the TPU
    kernel's roundings, the floor of the bf16 parity checks."""
    import torch
    from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend_plain

    return qknorm_attend_plain(*args, round_to=torch.bfloat16, **kw)


def phase_env(torch, ctx):
    ctx["tf32_defaults"] = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    ctx["smi"] = smi
    log(
        f"[env] torch {torch.__version__} cuda {torch.version.cuda} | {smi} | "
        f"devices {torch.cuda.device_count()} | tf32: torch's defaults matmul {ctx['tf32_defaults'][0]}, cudnn "
        f"{ctx['tf32_defaults'][1]}; the run sets both off (`[tokenize]` turns cudnn's back on for its F5 check)"
    )


def phase_build(torch, ctx):
    from concurrent.futures import ThreadPoolExecutor

    from muse_maskgit_pytorch_tpu_torch.ops import _build, attention, sampling_kernel, vq

    # each source with the flags its module loads it with, and the
    # instrumented builds that `[k1]` and `[train]` read the clocks of the
    # sampler's and K2 backward's parts from
    flags = {name: () for name in KERNEL_SOURCES}
    flags["sampling_kernel"] = sampling_kernel.FLAGS
    timing = [("sampling_kernel", sampling_kernel.TIMING_FLAGS), ("qknorm_attention_bwd", attention.BACKWARD_TIMING_FLAGS)]
    jobs = [*flags.items(), *timing]

    def timed_build(job):
        t = time.perf_counter()
        _build.build(*job)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        times = list(pool.map(timed_build, jobs))
    secs = dict(zip(KERNEL_SOURCES, times))
    secs.update({f"{name} (timing)": t for (name, _), t in zip(timing, times[len(KERNEL_SOURCES):])})
    wall = time.perf_counter() - t0
    for lib in (sampling_kernel._lib, attention._lib, attention._bwd_lib, attention._flash_lib, vq._lib):
        lib()  # load each library and bind its entry points
    each = ", ".join(f"{name} {t:.1f}s" for name, t in secs.items())
    log(f"[build] nvcc sm_90a, in parallel: {each}; {wall:.1f}s wall")


def phase_k1(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import (
        fused_topk_gumbel_sample as sample,
        fused_topk_gumbel_sample_plain as plain,
        sample_part_clocks,
        topk_threshold_plain,
    )

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    rows = BATCH * SEQ
    temp = 17.0 / 18.0
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)

    def compare(tag, logits, noise, k=TOPK, **kw):
        idx, prob = sample(logits, k, temp, seed, noise=noise, **kw)
        pidx, pprob = plain(logits, k, temp, seed, noise=noise, **kw)
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
    # the same route with the scale read from device memory, as a guidance
    # ramp's step gives it (1 + 4 * 1/17: not a bf16 value)
    ramp_scale = torch.tensor([1.0 + 4.0 / 17.0], device=dev)
    err = max(err, compare("cfg_pair device scale", pair, noise, cfg_pair=True, cond_scale=ramp_scale))
    # an odd row count, f32 logits
    odd = torch.randn(1001, VOCAB, generator=g, device=dev) * 3
    err = max(err, compare("odd rows f32", odd, noise[:1001]))
    del odd

    # rows built to stress the threshold and the persistent loop: row counts
    # below the SM count, one past a multiple of it and the compact steps';
    # k = 1 and k = V; heavy ties (five distinct bf16 values); a constant
    # row; a range far below the magnitude (the tree's mids collide); V not
    # a multiple of 8 (bf16 and f32, read from global memory)
    tied = (torch.randint(0, 5, (133, VOCAB), generator=g, device=dev).float() * 0.75 - 1.0).to(torch.bfloat16)
    tied[1] = 2.5
    narrow = 1000.0 + torch.rand(7, VOCAB, generator=g, device=dev) * 1e-3
    stress = {
        "7 rows": (logits[:7], TOPK, {}),
        "133 rows": (logits[:133], TOPK, {}),
        "1024 rows": (logits[:1024], TOPK, {}),
        "k=1": (logits[:133], 1, {}),
        "k=V": (logits[:133], VOCAB, {}),
        "tied and constant": (tied, TOPK, {}),
        "tied k=V": (tied, VOCAB, {}),
        "tied cfg_pair": (torch.cat([tied[:66], tied[66:132]]), TOPK, dict(cfg_pair=True, cond_scale=CFG)),
        "narrow f32": (narrow, TOPK, {}),
        "V=1000 bf16": (logits[:133, :1000], 100, {}),
        "V=1001 bf16": (logits[:133, :1001], 101, {}),
        "V=4099 f32": (logits[:133, :4099].float() * 1.7, 410, {}),
        "V=4096 bf16": (logits[:1024, :4096], 410, {}),
    }
    for tag, (x, k, kw) in stress.items():
        n_rows = x.shape[0] // (2 if kw else 1)
        err = max(err, compare(tag, x.contiguous(), noise[:n_rows, : x.shape[1]].contiguous(), k=k, **kw))
    del tied, narrow
    # a NaN and an infinity in a row guess no bins: no fault, and the rows
    # beside them are as exact as before
    broken = logits[:133].clone()
    broken[3, 77] = float("nan")
    broken[5, 4099] = float("inf")
    broken[8, 12] = float("-inf")
    bidx, _ = sample(broken, TOPK, temp, seed, noise=noise[:133])
    pidx, _ = plain(logits[:133], TOPK, temp, seed, noise=noise[:133])
    torch.cuda.synchronize()
    sound = torch.ones(133, dtype=torch.bool, device=dev)
    sound[[3, 5, 8]] = False
    require(torch.equal(bidx[sound], pidx[sound]), "K1 rows beside a NaN or infinite row differ")
    require(int(bidx[5]) == 4099, "K1 did not pick the +inf logit of its row")
    del broken

    # in-kernel Philox noise
    # temperature 0: the draw is a row maximum (bf16 rows hold tied maxima,
    # which the vanishing noise may order either way)
    l32 = logits.float()
    idx0, _ = sample(logits, TOPK, 0.0, seed)
    at_max = l32.gather(1, idx0.long()[:, None])[:, 0] == l32.amax(-1)
    require(bool(at_max.all()), "K1 temp 0 is not the argmax")
    idx, prob_whole = sample(logits, TOPK, 1.0, seed)
    thresh = topk_threshold_plain(l32, TOPK)
    chosen = l32.gather(1, idx.long()[:, None])
    require(bool((chosen >= thresh).all()), "K1 sampled outside the top-k set")
    pidx, _ = plain(logits[:256], TOPK, 1.0, seed)
    agree_philox = (idx[:256] == pidx).float().mean().item()
    require(agree_philox >= 0.99, f"K1 Philox stream vs plain Philox agree {agree_philox:.4f}")
    # a data-parallel rank's rows: `row_offset` keys the Philox stream on the
    # global row, so rows [off, off + n) of a batch sample what they sample
    # in the whole batch, in the kernel and in the plain version alike
    off, n_off = 133, 256
    idx_off, prob_off = sample(logits[off : off + n_off], TOPK, 1.0, seed, row_offset=off)
    pidx_whole, pprob_whole = plain(logits[: off + n_off], TOPK, 1.0, seed)
    pidx_off, pprob_off = plain(logits[off : off + n_off], TOPK, 1.0, seed, row_offset=off)
    torch.cuda.synchronize()
    require(
        torch.equal(idx_off, idx[off : off + n_off]) and torch.equal(prob_off, prob_whole[off : off + n_off]),
        "K1 with a row offset differs from its own rows of the whole batch",
    )
    require(
        torch.equal(pidx_off, pidx_whole[off:]) and torch.equal(pprob_off, pprob_whole[off:]),
        "the plain version with a row offset differs from its rows of the whole batch",
    )
    agree_offset = (idx_off == pidx_off).float().mean().item()
    require(agree_offset >= 0.99, f"K1 with a row offset vs the plain version agree {agree_offset:.4f}")
    ctx["k1_row_offset"] = dict(offset=off, rows=n_off, agree_plain=agree_offset, exact_vs_whole_batch=True)
    # frequencies on a small vocabulary (k = V: no filtering) against softmax;
    # bound 0.01 is > 5 sigma of a frequency at 2^16 draws
    p = torch.tensor([0.5, 0.2, 0.1, 0.05, 0.05, 0.04, 0.03, 0.03], device=dev)
    small = p.log().expand(1 << 16, 8).contiguous()
    sidx, _ = sample(small, 8, 1.0, seed)
    freq = torch.bincount(sidx.long(), minlength=8).float() / (1 << 16)
    dev_max = (freq - p).abs().max().item()
    require(dev_max <= 0.01, f"K1 frequencies off softmax by {dev_max:.4f}")

    # time at the main-path step-0 shape: kernel with its Philox stream, and
    # the plain version with the same stream (calls of milliseconds: an eager
    # loop keeps the card busy, so events around it time the device)
    ms = cuda_ms(lambda: sample(logits, TOPK, temp, seed))
    plain_ms = cuda_ms(lambda: plain(logits, TOPK, temp, seed), iters=3, warmup=1)
    # bytes: the logits read once, ids and probabilities written once; its
    # arithmetic, a few f32 operations per logit, takes less
    bound_ms, bound_by = bound(0, nbytes(logits, seed) + rows * 8, PEAK_F32)
    ctx["k1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    # the compact steps' row counts, by device time (CUDA-graph replay: the
    # wrapper's Python would outlast the kernel in an eager loop)
    small = {n: graph_ms(lambda: sample(logits[:n], TOPK, temp, seed)) for n in (1024, 4096)}
    small_bound = {n: bound(0, nbytes(logits[:n], seed) + n * 8, PEAK_F32)[0] for n in small}
    # the routes that read global memory: cfg_pair bf16 (two rows read for
    # one sampled) and f32 logits (four-byte reads), each with its own bound
    pair_ms = cuda_ms(lambda: sample(pair, TOPK, temp, seed, cfg_pair=True, cond_scale=CFG))
    pair_bound, _ = bound(0, nbytes(pair, seed) + rows * 8, PEAK_F32)
    dev_scale_ms = cuda_ms(lambda: sample(pair, TOPK, temp, seed, cfg_pair=True, cond_scale=ramp_scale))
    dev_scale_plain_ms = cuda_ms(
        lambda: plain(pair, TOPK, temp, seed, cfg_pair=True, cond_scale=ramp_scale), iters=2, warmup=1
    )
    dev_scale_bound, _ = bound(0, nbytes(pair, seed, ramp_scale) + rows * 8, PEAK_F32)
    del pair
    f32_ms = cuda_ms(lambda: sample(l32, TOPK, temp, seed))
    f32_bound, _ = bound(0, nbytes(l32, seed) + rows * 8, PEAK_F32)
    ctx["k1_routes"] = dict(
        cfg_pair_bf16=dict(ms=pair_ms, bound_ms=pair_bound), f32=dict(ms=f32_ms, bound_ms=f32_bound),
        cfg_pair_bf16_device_scale=dict(ms=dev_scale_ms, plain_ms=dev_scale_plain_ms, bound_ms=dev_scale_bound),
        **{f"bf16_rows_{n}": dict(ms=small[n], bound_ms=small_bound[n]) for n in small},
    )
    small_s = ", ".join(f"{n} rows {small[n]:.4f} ms (bound {small_bound[n]:.4f})" for n in small)
    # where a row's time goes: SM clocks per row in each part, from the
    # instrumented build (block 0, averaged over its rows)
    parts = sample_part_clocks(logits, TOPK, temp, seed)
    # the super-res stage's step 0: 16 x 1024 rows, ids exact under injected noise
    del l32, noise
    sr_rows = CAS_BATCH * SR_SEQ
    big = torch.cat([logits, (torch.randn(sr_rows - rows, VOCAB, generator=g, device=dev) * 3).to(torch.bfloat16)])
    big_noise = -torch.log(-torch.log(torch.rand(sr_rows, VOCAB, generator=g, device=dev).clamp(1e-9, 1 - 1e-9)))
    err = max(err, compare(f"{sr_rows} rows bf16 injected", big, big_noise))
    del big_noise
    sr_ms = cuda_ms(lambda: sample(big, TOPK, temp, seed))
    sr_plain_ms = cuda_ms(lambda: plain(big, TOPK, temp, seed), iters=2, warmup=1)
    sr_bound, _ = bound(0, nbytes(big, seed) + sr_rows * 8, PEAK_F32)
    del big
    ctx["k1"]["max_abs_err"] = err
    ctx["k1_routes"][f"bf16_rows_{sr_rows}"] = dict(ms=sr_ms, plain_ms=sr_plain_ms, bound_ms=sr_bound)
    ctx["k1_routes"]["part_clocks_per_row"] = parts
    parts_s = ", ".join(f"{name} {c:.0f}" for name, c in parts.items())
    log(
        f"[k1] fused_topk_gumbel_sample ok: ids exact (bf16, cfg_pair, cfg_pair device scale, odd f32; {', '.join(stress)}), "
        f"prob abs err {err:.3g} (rel <= 1e-5); temp0=argmax, top-k set, Philox agree {agree_philox:.4f}, "
        f"row_offset {off}: rows {off}..{off + n_off - 1} ids and probs bit-equal to the whole batch's in the kernel "
        f"and in the plain version, kernel vs plain agree {agree_offset:.4f}, "
        f"freq dev {dev_max:.4f}; ({rows}, {VOCAB}) bf16 {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}), {bound_ms / ms:.0%} of it reached; device time by graph replay: "
        f"{small_s}; super-res step 0 ({sr_rows}, {VOCAB}) bf16 ids exact, {sr_ms:.3f} ms vs plain "
        f"{sr_plain_ms:.3f} ms, bound {sr_bound:.3f} ms (bytes), {sr_bound / sr_ms:.0%} of it reached; "
        f"cfg_pair bf16 (2 x {rows}, {VOCAB}) {pair_ms:.3f} ms, with the scale in device memory {dev_scale_ms:.3f} "
        f"ms vs plain {dev_scale_plain_ms:.3f} ms, bound {pair_bound:.3f} ms (bytes); "
        f"f32 ({rows}, {VOCAB}) {f32_ms:.3f} ms, bound {f32_bound:.3f} ms (bytes); SM clocks a row by part "
        f"(instrumented build, {sum(parts.values()):.0f} in all): {parts_s}"
    )


def phase_k2(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.ops.attention import (
        BF16_VS_ROUNDED,
        K2_BF16_FROM_F32,
        key_mask_bias,
        qknorm_attend,
        qknorm_attend_plain,
    )

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    hd = HEADS * DIM_HEAD

    def sr_mask(b, text):
        """The super-res cross-attention's key mask under CFG: `text` text
        keys then 256 conditioning keys; the cond half (rows 0..b/2-1) sees
        its text (all of it at 64, ragged lengths 8..`text` else), the null
        half has every text key off; the conditioning keys are on for all."""
        mask = torch.ones(b, text + COND_TOKENS, dtype=torch.bool, device=dev)
        mask[b // 2 :, :text] = False
        if text != TEXT_LEN:
            lengths = torch.randint(8, text + 1, (b // 2, 1), generator=g, device=dev)
            mask[: b // 2, :text] = torch.arange(text, device=dev)[None] < lengths
        return mask

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
        if masked_rows == "superres":
            mask = sr_mask(b, m - COND_TOKENS)
        elif masked_rows == "negative":
            # negative prompts: the cond half sees its 64-token text, the
            # other half a negative text of 16, padded to 64
            mask = torch.ones(b, m, dtype=torch.bool, device=dev)
            mask[b // 2 :, NEG_TEXT_LEN:] = False
        elif masked_rows:
            mask = torch.rand(b, m, generator=g, device=dev) > 0.3
            mask[:masked_rows] = False  # only the null position remains
        return (q, k, v, nk, nv, qs, ks), mask

    shapes = {
        "self": (2 * BATCH, SEQ, SEQ, 0),
        "cross": (BATCH, SEQ, TEXT_LEN, 0),
        "cross_masked": (BATCH, SEQ, TEXT_LEN, 4),
        # the super-res stage at batch 16 under CFG: self-attention over 1024
        # positions; cross-attention over 64 text + 256 conditioning keys, a
        # key tile fully off for half the rows and fully on for the others;
        # and a text of 16, where the last tile of 272 keys is ragged
        "sr_self": (2 * CAS_BATCH, SR_SEQ, SR_SEQ, 0),
        "sr_cross": (2 * CAS_BATCH, SR_SEQ, TEXT_LEN + COND_TOKENS, "superres"),
        "sr_cross_272": (2 * CAS_BATCH, SR_SEQ, 16 + COND_TOKENS, "superres"),
        # the sampling surfaces at batch 8 under CFG (phase `surfaces`): a
        # 320px base stage (400 queries, 3 x 128 + 16), a 256 x 384
        # rectangle (384), a negative prompt's cross-attention, and the
        # 512 x 768 super-res stage at batch 4 (1536)
        "surf_self_400": (2 * SURF_BATCH, 400, 400, 0),
        "surf_self_384": (2 * SURF_BATCH, 384, 384, 0),
        "surf_neg_cross": (2 * SURF_BATCH, SEQ, TEXT_LEN, "negative"),
        "surf_sr_self_1536": (2 * SURF_CAS_BATCH, 1536, 1536, 0),
    }
    # f32: both sides compute in f32, differing only in summation order
    # (<= 1e-4). bf16: against the plain version with the TPU kernel's
    # roundings, one bf16 step of the output apart (BF16_VS_ROUNDED); against
    # the f32 plain version, as far as the Pallas kernel itself keeps from its
    # f32 oracle (K2_BF16_FROM_F32)
    errs, rounded_errs = {}, {}
    for name, (b, n, m, masked) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            args, mask = inputs(b, n, m, dtype, masked)
            out = qknorm_attend(*args, mask=mask)
            ref = qknorm_attend_plain(*args, mask=mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else K2_BF16_FROM_F32
            require(math.isfinite(err) and err <= tol, f"K2 {name} {dtype}: max abs err {err:.3g} > {tol:g}")
            errs[(name, dtype)] = err
            if dtype == torch.bfloat16:
                rounded = qknorm_attend_plain(*args, mask=mask, round_to=torch.bfloat16)
                rerr = (out.float() - rounded.float()).abs().max().item()
                require(
                    rerr <= BF16_VS_ROUNDED,
                    f"K2 {name} bf16 vs the TPU-rounding plain version: {rerr:.3g} > {BF16_VS_ROUNDED:g}",
                )
                rounded_errs[name] = rerr
            if masked and masked not in ("superres", "negative"):
                nv = args[4].float()
                got = out[:masked].float()
                require(
                    (got - nv[None, None]).abs().max().item() <= tol,
                    "K2 fully masked rows must return null_v",
                )

    def timed(b, n, m, masked=0):
        args, mask = inputs(b, n, m, torch.bfloat16, masked)
        q, k, v = args[:3]
        # the products over the keys that this mask leaves on (all, without one)
        keys_on = float(mask.sum()) if mask is not None else b * m
        flop = 4.0 * HEADS * n * keys_on * DIM_HEAD
        bound_ms, bound_by = bound(flop, nbytes(*args, mask) + nbytes(q), PEAK_BF16_TC)  # + the output
        # SDPA on the already-normalised inputs with the null key and value
        # concatenated: the attention core only, not the same function
        qn, kn, nk = (t.float() / t.float().norm(dim=-1, keepdim=True) for t in (q, k, args[3]))
        qn = (qn * args[5] * 8.0).bfloat16().transpose(1, 2)
        kn = torch.cat([nk.expand(b, 1, HEADS, DIM_HEAD), kn * args[6]], dim=1).bfloat16().transpose(1, 2)
        vn = torch.cat([args[4].expand(b, 1, HEADS, DIM_HEAD), v], dim=1).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        return dict(
            ms=graph_ms(lambda: qknorm_attend(*args, mask=mask)),
            eager_ms=cuda_ms(lambda: qknorm_attend(*args, mask=mask), iters=20),
            plain_ms=graph_ms(lambda: qknorm_attend_plain(*args, mask=mask), iters=5),
            core_ms=graph_ms(lambda: sdpa(qn, kn, vn, scale=1.0)),
            bound_ms=bound_ms,
            bound_by=bound_by,
        )

    t_self, t_cross = timed(2 * BATCH, SEQ, SEQ), timed(BATCH, SEQ, TEXT_LEN)
    sr_times = {name: timed(*shapes[name]) for name in ("sr_self", "sr_cross", "sr_cross_272")}
    surf_times = {name: timed(*shapes[name]) for name in shapes if name.startswith("surf_")}
    ctx["k2_shapes"] = {
        name: dict(shape=list(shapes[name][:3]), max_abs_err=errs[(name, torch.bfloat16)], **t)
        for name, t in (sr_times | surf_times).items()
    }
    # inputs that need a gradient go through the autograd Function (K2
    # forward with the row logsumexp, K2's backward kernel); under no_grad
    # K2 runs alone and keeps no graph (`[train]` checks the gradients)
    (q, *rest), _ = inputs(2, 70, 70, torch.bfloat16)
    out = qknorm_attend(q.detach().requires_grad_(), *rest)
    require(type(out.grad_fn).__name__ == "_QKNormAttentionBackward", f"K2 with a gradient: {out.grad_fn}")
    with torch.no_grad():
        require(qknorm_attend(q.detach().requires_grad_(), *rest).grad_fn is None, "K2 under no_grad kept a graph")
    # the wrapper turns the bool key mask into an f32 bias on every call
    # (inside each masked time above): its own device time at the super-res shape
    sr_key_mask = sr_mask(2 * CAS_BATCH, TEXT_LEN)
    bias_ms = graph_ms(lambda: key_mask_bias(sr_key_mask, *sr_key_mask.shape, dev))
    ctx["k2_shapes"]["sr_cross"]["mask_bias_ms"] = bias_ms
    ctx["k2"] = dict(
        max_abs_err=errs[("self", torch.bfloat16)], library_ms=None,
        **{k: t_self[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
    )
    err_s = ", ".join(f"{n} {str(d)[6:]} {e:.2g}" for (n, d), e in errs.items())
    rerr_s = ", ".join(f"{n} {e:.2g}" for n, e in rounded_errs.items())

    def line(t):
        return (
            f"{t['ms']:.4f} ms (eager loop {t['eager_ms']:.4f}) vs plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}); SDPA {t['core_ms']:.4f} ms (attention core only, "
            f"not the same function)"
        )

    log(
        f"[k2] qknorm_attend ok: max abs err vs f32 plain {err_s}; bf16 vs TPU-rounding plain {rerr_s}; "
        f"self (64,256,8,64) bf16 {line(t_self)}; cross (32,256|64,8,64) {line(t_cross)}; super-res self "
        f"(32,1024,8,64) {line(sr_times['sr_self'])}; super-res cross (32,1024|320,8,64), the null half's text "
        f"keys off, {line(sr_times['sr_cross'])}; super-res cross (32,1024|272,8,64), ragged text, "
        f"{line(sr_times['sr_cross_272'])}; surfaces: self (16,400,8,64) {line(surf_times['surf_self_400'])}; "
        f"self (16,384,8,64) {line(surf_times['surf_self_384'])}; negative-prompt cross (16,256|64,8,64), the "
        f"negative half's keys {NEG_TEXT_LEN}..63 off, {line(surf_times['surf_neg_cross'])}; super-res self "
        f"(8,1536,8,64) {line(surf_times['surf_sr_self_1536'])} (the SDPA beside a masked shape runs without the "
        f"mask; each masked time holds the wrapper's mask -> bias conversion, {bias_ms:.4f} ms at (32, 320)); "
        f"inputs that need a gradient take the autograd route (its gradients: [train])"
    )


def phase_k3(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.models.quantizers import l2norm
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code, nearest_code_plain, score_gap

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    n, k, d = BATCH * SEQ, VOCAB, CODE_DIM
    zeros = torch.zeros(k, device=dev)

    # cosine search at the EMA-VQ encode's shape, held to the near-tie rule:
    # each side's pick scores within 1e-5 of the f64 best
    x = l2norm(torch.randn(n, d, generator=g, device=dev))
    cb = l2norm(torch.randn(k, d, generator=g, device=dev))
    ids = nearest_code(x, cb, zeros)
    plain = nearest_code_plain(x, cb, zeros)
    torch.cuda.synchronize()
    gap = score_gap(x, cb, ids, zeros).max().item()
    plain_gap = score_gap(x, cb, plain, zeros).max().item()
    differ = (ids != plain).sum().item()
    require(gap <= NEAR_TIE and plain_gap <= NEAR_TIE, f"K3 picks off the f64 best by {gap:.3g} (plain {plain_gap:.3g})")

    # a codebook of exact duplicates (as k-means init makes): exact ids
    distinct = l2norm(torch.randn(1024, d, generator=g, device=dev))
    cb_dup = distinct[torch.randint(0, 1024, (k,), generator=g, device=dev)]
    x_dup = l2norm(distinct[torch.randint(0, 1024, (n,), generator=g, device=dev)] + 0.02 * torch.randn(n, d, generator=g, device=dev))
    dup_ids = nearest_code(x_dup, cb_dup, zeros)
    require(torch.equal(dup_ids, nearest_code_plain(x_dup, cb_dup, zeros)), "K3 ids differ on a duplicated codebook")
    del cb_dup, x_dup, distinct

    # ragged K and n, euclidean scores (cb_sq = |c|^2 inside the wrapper)
    xr, cbr = torch.randn(1001, d, generator=g, device=dev), torch.randn(4099, d, generator=g, device=dev)
    scale = (xr.double() ** 2).sum(-1) + (cbr.double() ** 2).sum(-1).max()
    for side in (nearest_code(xr, cbr), nearest_code_plain(xr, cbr)):
        require(bool((score_gap(xr, cbr, side) <= NEAR_TIE * scale).all()), "K3 ragged euclidean off the near-tie rule")

    ms = cuda_ms(lambda: nearest_code(x, cb, zeros))
    plain_ms = cuda_ms(lambda: nearest_code_plain(x, cb, zeros))
    # an f32 search: 2 n K d FLOP at the f32 FMA peak
    bound_ms, bound_by = bound(2.0 * n * k * d, nbytes(x, cb, zeros) + n * 4, PEAK_F32)
    # a 3xTF32 tensor-core search, which keeps f32-level picks, does three TF32 products
    tf32_ms, _ = bound(3 * 2.0 * n * k * d, nbytes(x, cb, zeros) + n * 4, PEAK_TF32_TC)
    ctx["k3"] = dict(max_abs_err=gap, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    log(
        f"[k3] nearest_code ok: cosine ({n}, {d}) x ({k}, {d}) f32, {differ} rows differ from plain, "
        f"max f64 score gap {gap:.3g} (plain {plain_gap:.3g}, rule <= {NEAR_TIE:g}); duplicated codebook "
        f"ids exact; ragged (1001 x 4099) euclidean by the rule; {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}); a 3xTF32 design's bound {tf32_ms:.3f} ms"
    )


def phase_k4(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.models.quantizers import l2norm
    from muse_maskgit_pytorch_tpu_torch.ops.attention import BF16_VS_ROUNDED, K4_BF16_FROM_F32, attend, attend_plain

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    # (b, h, n, d, kv): the unfused attention's base-stage self-attention
    # (kv = seq + the null key) and super-res self-attention
    shapes = {"base": (2 * BATCH, HEADS, SEQ, DIM_HEAD, SEQ + 1), "superres": (BATCH, HEADS, 1024, DIM_HEAD, 1025)}

    def inputs(b, h, n, d, m, dtype):
        # qk-normed queries and keys at scale 8, as the models attend
        q = l2norm(torch.randn(b, h, n, d, generator=g, device=dev)).to(dtype)
        k = l2norm(torch.randn(b, h, m, d, generator=g, device=dev)).to(dtype)
        v = torch.randn(b, h, m, d, generator=g, device=dev).to(dtype)
        return q, k, v

    # f32: summation order only (<= 1e-4). bf16: against the plain version
    # with the TPU kernel's roundings (q * scale and P), one bf16 step of the
    # output apart (BF16_VS_ROUNDED); against the f32 plain version, as far
    # as the Pallas kernel itself keeps from its f32 oracle (K4_BF16_FROM_F32)
    tol = {torch.float32: 1e-4, torch.bfloat16: K4_BF16_FROM_F32}
    errs, rounded_errs = {}, {}
    for name, shape in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(*shape, dtype)
            mask = torch.rand(shape[0], shape[4], generator=g, device=dev) > 0.3
            mask[:4] = False  # fully masked rows: an average over the kv length
            for tag, m_ in (("", None), (" masked", mask)):
                out = attend(q, k, v, mask=m_, scale=8.0, impl="flash")
                ref = attend_plain(q, k, v, mask=m_, scale=8.0)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                require(math.isfinite(err) and err <= tol[dtype], f"K4 {name}{tag} {dtype}: max abs err {err:.3g}")
                errs[(name + tag, dtype)] = err
                if dtype == torch.bfloat16:
                    rounded = attend_plain(q, k, v, mask=m_, scale=8.0, round_to=torch.bfloat16)
                    rerr = (out.float() - rounded.float()).abs().max().item()
                    require(
                        rerr <= BF16_VS_ROUNDED,
                        f"K4 {name}{tag} bf16 vs the TPU-rounding plain version: {rerr:.3g} > {BF16_VS_ROUNDED:g}",
                    )
                    rounded_errs[name + tag] = rerr
            mean_v = v[:4].float().mean(dim=2, keepdim=True)
            err = (out[:4].float() - mean_v).abs().max().item()
            limit = 1e-4 if dtype == torch.float32 else BF16_VS_ROUNDED
            require(err <= limit, f"K4 {dtype} fully masked rows off the mean of v by {err:.3g} > {limit:g}")
            del q, k, v, out, ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for name, shape in shapes.items():
        q, k, v = inputs(*shape, torch.bfloat16)
        b, h, n, d, m = shape
        mask = torch.rand(b, m, generator=g, device=dev) > 0.1
        bias = torch.where(mask, 0.0, -1e30)[:, None, None, :].to(torch.bfloat16)  # SDPA's additive form
        bound_ms, bound_by = bound(4.0 * b * h * n * m * d, nbytes(q, k, v, q), PEAK_BF16_TC)
        times[name] = dict(
            ms=graph_ms(lambda: attend(q, k, v, scale=8.0)),
            eager_ms=cuda_ms(lambda: attend(q, k, v, scale=8.0), iters=20),
            plain_ms=graph_ms(lambda: attend_plain(q, k, v, scale=8.0), iters=5),
            library_ms=graph_ms(lambda: sdpa(q, k, v, scale=8.0)),
            masked_ms=graph_ms(lambda: attend(q, k, v, mask=mask, scale=8.0)),
            library_masked_ms=graph_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=8.0)),
            bound_ms=bound_ms,
            bound_by=bound_by,
        )
        del q, k, v

    # the path: the public op as a user calls it ("auto" is the kernel for
    # CUDA tensors), once at each shape
    attend.launches = 0
    for shape in shapes.values():
        q, k, v = inputs(*shape, torch.bfloat16)
        out = attend(q, k, v, scale=8.0)
        require(out.shape == q.shape and bool(torch.isfinite(out).all()), "K4 path output")
    launches = attend.launches
    require(launches == len(shapes), f"K4 launched {launches} times on the attend path, expected {len(shapes)}")
    base = times["base"]
    ctx["k4"] = dict(
        launches=launches, max_abs_err=errs[("base", torch.bfloat16)],
        **{k: base[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    )
    err_s = ", ".join(f"{n} {str(d)[6:]} {e:.2g}" for (n, d), e in errs.items())
    rerr_s = ", ".join(f"{n} {e:.2g}" for n, e in rounded_errs.items())

    def line(t):
        return (
            f"{t['ms']:.4f} ms (eager loop {t['eager_ms']:.4f}) vs plain {t['plain_ms']:.4f} ms, SDPA "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); masked {t['masked_ms']:.4f} "
            f"ms vs SDPA with the bias {t['library_masked_ms']:.4f} ms"
        )

    log(
        f"[k4] attend(flash) ok: max abs err vs f32 plain {err_s}; bf16 vs TPU-rounding plain {rerr_s}; "
        f"bf16 base (64,8,256|257,64) {line(times['base'])}; super-res (32,8,1024|1025,64) {line(times['superres'])}; attend path +{launches} launches"
    )


def build_models(torch, dtype=None, with_vae=True, seed=0, self_cond=False, depth=DEPTH):
    """The main path's MaskGit, random weights from `seed` (bf16 compute
    unless `dtype` says otherwise; training turns `self_cond` on)."""
    from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, VQGanVAE

    gen = torch.Generator().manual_seed(seed)
    vae = VQGanVAE(dim=VAE_DIM, layers=VAE_LAYERS, codebook_size=VOCAB, use_vgg_and_gan=False, generator=gen) if with_vae else None
    transformer = MaskGitTransformer(
        num_tokens=VOCAB, dim=DIM, seq_len=SEQ, depth=depth, dim_head=DIM_HEAD, heads=HEADS,
        text_embed_dim=TEXT_DIM, dtype=dtype or torch.bfloat16, generator=gen, self_cond=self_cond,
    )
    return MaskGit(image_size=IMAGE, transformer=transformer, vae=vae).eval()


def build_superres(torch, vae, dtype=None):
    """The cascade's super-res MaskGit at `bench.py`'s width: seq 1024 on a
    32x32 grid, conditioned on the 256 tokens of a 256px image; `vae` is
    both its VAE and its cond VAE (None: ids in, ids out). Random weights
    from seed 1."""
    from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer

    gen = torch.Generator().manual_seed(1)
    transformer = MaskGitTransformer(
        num_tokens=VOCAB, dim=DIM, seq_len=SR_SEQ, depth=DEPTH, dim_head=DIM_HEAD, heads=HEADS,
        text_embed_dim=TEXT_DIM, dtype=dtype or torch.bfloat16, generator=gen,
    )
    return MaskGit(
        image_size=SR_IMAGE, cond_image_size=IMAGE, transformer=transformer, vae=vae, cond_vae=vae
    ).eval()


def centre_half_mask(b: int, h: int, w: int):
    """(b, h, w) bool pixel mask, True over the centre half of each side."""
    import torch

    mask = torch.zeros(b, h, w, dtype=torch.bool, device="cuda")
    mask[:, h // 4 : h - h // 4, w // 4 : w - w // 4] = True
    return mask


def known_tokens_kept(grid, vae, source, pixel_mask) -> bool:
    """The token grid (b, fh, fw) holds `source`'s tokens (encoded by `vae`)
    wherever the pixel mask (b, H, W) edits none of a token's pixels."""
    _, src, _ = vae.encode(source)
    fh, fw = src.shape[1:]
    ph, pw = pixel_mask.shape[1] // fh, pixel_mask.shape[2] // fw
    edited = pixel_mask.reshape(-1, fh, ph, fw, pw).any(dim=4).any(dim=2)
    return bool((grid[~edited] == src.long()[~edited]).all())


def profile_rows(prof):
    """(device ms, count, name) of every kernel a torch.profiler run saw,
    largest first: the device's rows only, since where CPU events are
    recorded an op's row holds its kernels' time too."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1000, e.count, e.key))
    return sorted(rows, reverse=True)


def device_busy(prof, pattern=None):
    """(ms, streams, repeats) of the device work a torch.profiler run saw
    whose name matches `pattern` (all of it when None): the union of the
    kernels' intervals, which cannot exceed the wall time, the streams they
    ran on, and the records that repeat an earlier one's name and interval.
    Where kernels overlap or repeat, their summed durations exceed the union."""
    spans, streams, seen, repeats = [], set(), set(), 0
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and (pattern is None or re.search(pattern, e.name)):
            span = (e.time_range.start, e.time_range.end)
            repeats += (e.name, span) in seen
            seen.add((e.name, span))
            spans.append(span)
            streams.add(getattr(e, "device_resource_id", None))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1000, len(streams), repeats


def kernels_by_name(torch, call, pattern):
    """The names (the match of `pattern`) of the device kernels that one
    `call` launched, in launch order, as torch.profiler saw them, those
    that do not match (memsets, casts) left out; None where the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    call()  # warm: the library is loaded and each kernel's attribute set
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not kernels:
        return None
    kernels.sort(key=lambda e: e.time_range.start)
    found = (re.search(pattern, e.name) for e in kernels)
    return [f.group(0) for f in found if f is not None]


def busy_within(busy_ms, host_ms, what):
    require(busy_ms <= host_ms, f"{what}: the device was busy {busy_ms:.1f} ms in {host_ms:.1f} ms of wall time")


def kernel_total(rows, part):
    """(device ms, launches) of the profiled kernels whose name holds `part`.
    K1 is `sample_kernel`; K2 is the attention core's qk-norm instance,
    `flash_core_kernel<64, true>` (K4's bf16 instances are <32|64, false>)."""
    hits = [r for r in rows if part in r[2]]
    return sum(r[0] for r in hits), sum(r[1] for r in hits)


def phase_generate(torch, ctx):
    from muse_maskgit_pytorch_tpu_torch.ops.attention import attend, qknorm_attend
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

    counted = (fused_topk_gumbel_sample, qknorm_attend, attend)  # K1, K2, K4
    for fn in counted:
        fn.launches = 0
    times, per_request = [], []
    for i in range(3):
        before = [fn.launches for fn in counted]
        img, dt = request(i)
        per_request.append(tuple(fn.launches - b for fn, b in zip(counted, before)))
        times.append(dt)
        require(tuple(img.shape) == (BATCH, 256, 256, 3), f"image shape {tuple(img.shape)}")
        require(bool(torch.isfinite(img).all()), "non-finite pixels")
    for k1, k2, k4 in per_request:
        require(k1 == STEPS, f"K1 launched {k1} times in a request, expected {STEPS}")
        require(k2 == STEPS * DEPTH * 2, f"K2 launched {k2} times in a request, expected {STEPS * DEPTH * 2}")
        require(k4 == 0, f"K4 launched {k4} times in a request, expected 0")
    ctx["k1"]["launches"], ctx["k2"]["launches"] = fused_topk_gumbel_sample.launches, qknorm_attend.launches
    ctx["k1"]["launches_per_request"], ctx["k2"]["launches_per_request"] = per_request[0][:2]
    ctx["k4_per_request"] = per_request[0][2]
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
        f"K2 +{per_request[0][1]}, K4 +{per_request[0][2]} launches per request | {ctx['smi']} | models built "
        f"{t_build:.1f}s, warm-up {t_warm:.1f}s"
    )


def phase_parallel(torch, ctx):
    """[parallel]: data-parallel and FSDP training and serving over a
    process group of world size 1 (the card's machine holds one H100): an
    NCCL group on 127.0.0.1, destroyed at the phase's end, so every later
    phase runs without one.

    (a) `MaskGitTrainer(mesh=create_mesh(), shard_state=True)` at [train]'s
        full width (b64, seq 256, dim 512, depth 8, vocab 65536, text
        64x768, self-conditioning), f32: 2 steps from one seed against the
        unwrapped trainer (`mesh=TrivialMesh()`): losses within 1e-4
        relative and every leaf within 1e-3 of the largest change of the
        leaf ([train]'s f32 limits; bit-equality is printed), K2's forward
        16 or 32 and its backward 16 launches a step inside the wrapped step.
    (b) the bf16 wrapped trainer: ms a step over 10 after 2 (host clock
        around synchronised steps, as [train] times it) beside [train]'s
        unwrapped step of this run, peak memory, `sharded_state_bytes`.
    (c) a save of the wrapped trainer's state and a load into a fresh
        wrapped trainer, seconds each, then one step on each: the losses
        and every weight bit-equal.
    (d) one `VQGanVAETrainer` EMA-VQ step at [gan]'s scale with
        `shard_state=True` against the unwrapped step, after the k-means
        step on both: K3 3 launches in it, the k-means step's logs within
        1e-5 relative and the next's within 1e-4, the codebooks bit-equal
        after the k-means step and at most 0.1% of their rows apart by more
        than 1e-5 after the next.
    (e) `GeneratePipeline(mesh=)` b16 T18 CFG 3 against the pipeline
        without a mesh, one seed: uint8 images equal.
    """
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from muse_maskgit_pytorch_tpu_torch import VGG16, VQGanVAE, VQGanVAETrainer
    from muse_maskgit_pytorch_tpu_torch.ops.attention import attend, qknorm_attend, qknorm_attend_backward
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code
    from muse_maskgit_pytorch_tpu_torch.parallel import TrivialMesh, create_mesh, init_distributed, sharded_state_bytes
    from muse_maskgit_pytorch_tpu_torch.serving import GeneratePipeline
    from muse_maskgit_pytorch_tpu_torch.training import MaskGitTrainer

    t_phase = time.perf_counter()
    dev = "cuda"
    counted = dict(k1=fused_topk_gumbel_sample, k2=qknorm_attend, k3=nearest_code, k4=attend)
    launches = dict.fromkeys(counted, 0)
    with socket.socket() as s:  # a free port on the loopback interface
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    init_distributed(backend="nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    t_init = time.perf_counter() - t0
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "the NCCL group of one rank did not form")
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=scratch))
    out = {}
    try:
        mesh = create_mesh()
        g = torch.Generator(device=dev).manual_seed(21)
        ids = torch.randint(0, VOCAB, (1, TRAIN_BATCH, SEQ), generator=g, device=dev)
        te = torch.randn(1, TRAIN_BATCH, TEXT_LEN, TEXT_DIM, generator=g, device=dev)
        tm = torch.arange(TEXT_LEN, device=dev) < torch.randint(8, TEXT_LEN + 1, (1, TRAIN_BATCH, 1), generator=g, device=dev)
        batch = (ids, te * tm[..., None], tm)

        def trainer(name, dtype, wrapped, **kw):
            model = build_models(torch, dtype=dtype, with_vae=False, self_cond=True)
            return MaskGitTrainer(
                model, num_train_steps=10**6, batch_size=TRAIN_BATCH, lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                results_folder=str(tmp / name), save_model_every=10**9, mesh=mesh if wrapped else TrivialMesh(),
                shard_state=wrapped, **kw,
            )

        # -- (a) f32: the wrapped step against the unwrapped one
        plain_t, wrapped_t = trainer("f32_plain", torch.float32, False), trainer("f32_wrapped", torch.float32, True)
        start = [p.detach().clone() for p in plain_t.params]
        k2_fwd, k2_bwd, losses = [], [], {"plain": [], "wrapped": []}
        for _ in range(2):
            losses["plain"].append(plain_t.train_step_arrays(*batch)["loss"])
            f0, b0 = qknorm_attend.launches, qknorm_attend_backward.launches
            losses["wrapped"].append(wrapped_t.train_step_arrays(*batch)["loss"])
            k2_fwd.append(qknorm_attend.launches - f0)
            k2_bwd.append(qknorm_attend_backward.launches - b0)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["wrapped"], losses["plain"]))
        leaf = max(
            (w - p).abs().max().item() / max((p - s).abs().max().item(), 1e-30)
            for w, p, s in zip(wrapped_t.dp.gather(wrapped_t.dp.masters), plain_t.params, start)
        )
        bitwise = all(torch.equal(w, p) for w, p in zip(wrapped_t.dp.gather(wrapped_t.dp.masters), plain_t.params))
        require(rel <= 1e-4, f"[parallel] f32 wrapped loss {losses['wrapped']} vs unwrapped {losses['plain']}")
        require(leaf <= 1e-3, f"[parallel] f32 wrapped weights differ by {leaf:.3g} of a leaf's change")
        require(all(n in (2 * DEPTH, 4 * DEPTH) for n in k2_fwd), f"[parallel] K2 forward launches a step {k2_fwd}")
        require(all(n == 2 * DEPTH for n in k2_bwd), f"[parallel] K2 backward launches a step {k2_bwd}")
        del plain_t, wrapped_t, start
        log(
            f"[parallel] NCCL group of 1 on 127.0.0.1:{port} in {t_init:.2f} s; MaskGitTrainer(mesh=create_mesh(), "
            f"shard_state=True) f32 b{TRAIN_BATCH} seq {SEQ} dim {DIM} depth {DEPTH} vocab {VOCAB}, 2 steps vs the "
            f"unwrapped trainer: loss {', '.join(f'{x:.6f}' for x in losses['wrapped'])} vs "
            f"{', '.join(f'{x:.6f}' for x in losses['plain'])} ({rel:.2g} relative), weights within {leaf:.2g} of a "
            f"leaf's change (bit-equal: {bitwise}); launches a wrapped step K2 {k2_fwd}, K2 backward {k2_bwd}"
        )

        # -- (b) bf16: the wrapped step's time, memory and state
        torch.cuda.empty_cache()
        bf = trainer("bf16", None, True)
        for _ in range(TRAIN_WARM):
            bf.train_step_arrays(*batch)
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_losses = [bf.train_step_arrays(*batch)["loss"] for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1000
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k, fn in counted.items():
            launches[k] += fn.launches
        require(all(math.isfinite(x) for x in step_losses), f"[parallel] bf16 losses {step_losses}")
        require(launches["k2"] in range(2 * DEPTH * TRAIN_STEPS, 4 * DEPTH * TRAIN_STEPS + 1), f"K2 {launches}")
        total, local = sharded_state_bytes(bf.state)
        unwrapped_ms = ctx.get("train", {}).get("ms_per_step")

        # -- (c) save, load into a fresh wrapped trainer, one step on each
        t0 = time.perf_counter()
        bf.save()
        t_save = time.perf_counter() - t0
        fresh = trainer("bf16", None, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load()
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        next_a, next_b = bf.train_step_arrays(*batch)["loss"], fresh.train_step_arrays(*batch)["loss"]
        same = next_a == next_b and all(
            torch.equal(a, b) for a, b in zip(bf.dp.gather(bf.dp.masters) + bf.ema, fresh.dp.gather(fresh.dp.masters) + fresh.ema)
        )
        require(same and fresh.steps == bf.steps, f"[parallel] the resumed step differs: loss {next_b} vs {next_a}")
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "bf16" / "checkpoints").rglob("*") if f.is_file())
        del bf, fresh
        torch.cuda.empty_cache()
        out["train"] = dict(
            f32_loss_rel=rel, f32_leaf_rel=leaf, f32_bitwise=bitwise, k2_forward_per_step=k2_fwd,
            k2_backward_per_step=k2_bwd, bf16_ms_per_step=step_ms, unwrapped_ms_per_step=unwrapped_ms,
            peak_gib=peak, state_bytes_total=total, state_bytes_per_rank=local, save_s=t_save, load_s=t_load,
            checkpoint_bytes=ckpt_bytes,
        )
        beside = f" ([train]'s unwrapped step {unwrapped_ms:.2f} ms in this run)" if unwrapped_ms else ""
        log(
            f"[parallel] bf16 wrapped step: {step_ms:.2f} ms/step over {TRAIN_STEPS} after {TRAIN_WARM}{beside}, "
            f"{TRAIN_BATCH / step_ms * 1000:.2f} img/s, peak {peak:.2f} GiB, sharded_state_bytes {total / 2**30:.3f} "
            f"GiB total, {local / 2**30:.3f} GiB this rank | save {t_save:.2f} s, load {t_load:.2f} s "
            f"({ckpt_bytes / 2**30:.3f} GiB), the resumed step bit-equal (loss {next_b:.6f}) | {ctx['smi']}"
        )

        # -- (d) an EMA-VQ GAN step at [gan]'s scale, wrapped and not
        imgs = torch.rand(1, GAN_BATCH, IMAGE, IMAGE, 3, generator=g, device=dev)

        def card_built(cls, **kw):
            with torch.device(dev):
                return cls(generator=torch.Generator(dev).manual_seed(0), device=dev, **kw)

        vgg = card_built(VGG16)
        gan = {}
        # deterministic kernels where there are any, as [gan]'s exact resume
        # takes them (warn_only: the GAN's towers run ops that have none)
        saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        for name, wrapped in (("plain", False), ("wrapped", True)):
            vae = card_built(
                VQGanVAE, dim=VAE_DIM, layers=VAE_LAYERS, codebook_size=VOCAB, use_vgg_and_gan=True, vgg=vgg,
                lookup_free_quantization=False, vq_kwargs=EMA_VQ_KW,
            )
            t = VQGanVAETrainer(
                vae, folder=None, dataset=[np.zeros((IMAGE, IMAGE, 3), np.float32)], num_train_steps=10**6,
                batch_size=GAN_BATCH, image_size=IMAGE, results_folder=str(tmp / f"gan_{name}"),
                save_results_every=10**9, save_model_every=10**9, valid_frac=0.0, use_ema=True,
                mesh=mesh if wrapped else TrivialMesh(), shard_state=wrapped,
            )
            logs0 = t.train_step_arrays(imgs, imgs)  # k-means and the first update
            first = t.vae.quantizer.codebook.clone()
            nearest_code.launches = 0
            logs = t.train_step_arrays(imgs, imgs)
            gan[name] = ((logs0, logs), nearest_code.launches, first, t.vae.quantizer.codebook.clone())
            launches["k3"] += nearest_code.launches
            del t, vae
        torch.use_deterministic_algorithms(False)
        if saved_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
        (lp, k3p, first_p, cbp), (lw, k3w, first_w, cbw) = gan["plain"], gan["wrapped"]

        def rel(step):
            return max(abs(lw[step][k] - lp[step][k]) / max(abs(lp[step][k]), 1e-30) for k in ("loss", "discr_loss", "grad_norm"))

        gan_rel0, gan_rel = rel(0), rel(1)
        require(k3w == k3p == 3, f"[parallel] K3 launches in the EMA-VQ step: wrapped {k3w}, unwrapped {k3p}")
        # the first step starts from one state; the second from weights that
        # the first step's non-deterministic kernels moved apart at rounding
        # level, which Adam can turn into lr-sized moves of a few weights
        require(gan_rel0 <= 1e-5, f"[parallel] the first EMA-VQ step's logs differ by {gan_rel0:.3g}: {lw[0]} vs {lp[0]}")
        require(gan_rel <= 1e-4, f"[parallel] EMA-VQ step logs differ by {gan_rel:.3g}: {lw[1]} vs {lp[1]}")
        # the first step's codebook (k-means and an EMA update from the same
        # weights) is bit-equal; the second's rests on weights that one step
        # of gradients with non-deterministic kernels (the towers' pooling
        # backward) moved, and a latent that changes its nearest code moves
        # two rows of the codebook whole: at most 0.1% of the rows may differ
        require(torch.equal(first_w, first_p), "[parallel] the EMA-VQ codebooks differ after the k-means step")
        rows_off = int(((cbw - cbp).abs().amax(dim=-1) > 1e-5).sum())
        require(rows_off <= cbw.shape[0] // 1000, f"[parallel] {rows_off} EMA-VQ codebook rows differ after the step")
        cb_equal = torch.equal(cbw, cbp)
        del vgg, gan
        torch.cuda.empty_cache()
        out["gan"] = dict(
            k3_per_step=k3w, first_step_logs_rel=gan_rel0, logs_rel=gan_rel, codebook_rows_differing=rows_off,
            codebook_equal=cb_equal,
        )

        # -- (e) the pipeline over the mesh
        base = ctx.get("maskgit") or build_models(torch)
        ctx["maskgit"] = base
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            images = {}
            for name, m in (("plain", None), ("mesh", mesh)):
                pipe = GeneratePipeline(
                    base, batch_size=SERVE_BATCH, timesteps=STEPS, cond_scale=CFG, text_len=TEXT_LEN,
                    return_pil=False, seed=3, mesh=m,
                )
                k1_before = fused_topk_gumbel_sample.launches
                images[name] = pipe(list(PROMPTS))
                launches["k1"] += fused_topk_gumbel_sample.launches - k1_before
        finally:
            torch.backends.cudnn.deterministic = deterministic
        require(
            images["mesh"].shape == (len(PROMPTS), IMAGE, IMAGE, 3) and np.array_equal(images["mesh"], images["plain"]),
            "[parallel] GeneratePipeline(mesh=) gave other images than without a mesh",
        )
        out["serving"] = dict(images_equal=True, prompts=len(PROMPTS))
        log(
            f"[parallel] VQGanVAETrainer EMA-VQ step at [gan]'s scale (dim {VAE_DIM}, {VAE_LAYERS} layers, K {VOCAB}, "
            f"{IMAGE}px, b{GAN_BATCH}, VGG16 + discriminator), shard_state=True vs unwrapped: K3 {k3w} a step, logs "
            f"within {gan_rel0:.2g} relative in the k-means step, {gan_rel:.2g} in the next, codebooks bit-equal after the k-means step, {rows_off} of "
            f"{cbw.shape[0]} rows apart by > 1e-5 after the next (bit-equal: {cb_equal}) | GeneratePipeline(mesh=) b{SERVE_BATCH} T{STEPS} CFG "
            f"{CFG:g}, {len(PROMPTS)} prompts: uint8 images equal to the pipeline without a mesh | "
            f"{time.perf_counter() - t_phase:.1f} s"
        )
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    ctx["parallel"] = out
    ctx["parallel_launches"] = launches


def tp_inputs(torch, dev="cuda"):
    """The `[tensor]` phase's train batch (1, TP_BATCH, ...), forward ids
    and texts, from a card generator with a fixed seed: equal in every
    process on the card."""
    g = torch.Generator(device=dev).manual_seed(23)
    ids = torch.randint(0, VOCAB, (1, TP_BATCH, SEQ), generator=g, device=dev)
    te = torch.randn(1, TP_BATCH, TEXT_LEN, TEXT_DIM, generator=g, device=dev)
    tm = torch.arange(TEXT_LEN, device=dev) < torch.randint(8, TEXT_LEN + 1, (1, TP_BATCH, 1), generator=g, device=dev)
    x = torch.randint(0, VOCAB + 1, (2, SEQ), generator=g, device=dev)
    text = torch.randn(TP_GEN_BATCH, TEXT_LEN, TEXT_DIM, generator=g, device=dev)
    return (ids, te * tm[..., None], tm), x, text


def tp_noise(torch, dev="cuda"):
    """(STEPS, TP_GEN_BATCH, SEQ, VOCAB) f32 Gumbel noise from a card
    generator with a fixed seed (the same in every process), made in place."""
    g = torch.Generator(device=dev).manual_seed(29)
    u = torch.rand(STEPS, TP_GEN_BATCH, SEQ, VOCAB, generator=g, device=dev)
    return u.clamp_(1e-9, 1 - 1e-9).log_().neg_().log_().neg_()


def tp_trainer(torch, folder, dtype, mesh=None):
    """A `MaskGitTrainer` at the base stage's width with self-conditioning:
    tensor-parallel over `mesh`, or unwrapped without one."""
    from muse_maskgit_pytorch_tpu_torch.parallel import DEFAULT_TP_RULES, TrivialMesh
    from muse_maskgit_pytorch_tpu_torch.training import MaskGitTrainer

    wrap = dict(mesh=mesh, shard_state=True, shard_state_rules=DEFAULT_TP_RULES) if mesh is not None else dict(mesh=TrivialMesh())
    model = build_models(torch, dtype=dtype, with_vae=False, self_cond=True)
    return MaskGitTrainer(
        model, num_train_steps=10**6, batch_size=TP_BATCH, lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
        results_folder=str(folder), save_model_every=10**9, **wrap,
    )


def tp_generate(model, text, **kw):
    """One b8 T18 CFG 3 request through K1 ("fused") and the ids K1 gave
    at its first step."""
    from muse_maskgit_pytorch_tpu_torch.models import maskgit as mg

    first, real = [], mg.fused_topk_gumbel_sample

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        if not first:
            first.append(out[0].clone())
        return out

    mg.fused_topk_gumbel_sample = record
    try:
        out = model.generate(text_embeds=text, timesteps=STEPS, cond_scale=CFG, sampler="fused", **kw)
    finally:
        mg.fused_topk_gumbel_sample = real
    return out, first[0]


def tp_rank(rank: int, port: int, folder: str, dev: str = "cuda"):
    """One rank of `[tensor]` (a spawned process): (a) the f32 TP trainer's
    2 steps, its K2 launches and the heads each saw, its state's bytes, its
    weights (rank 0 writes them and the checkpoint); (b) the bf16 TP step's
    time and its collectives' host time; (c) the f32 TP forward's logits and
    one f32 request under injected noise (rank 0 writes them), and one bf16
    request to PNGs. The numbers go to `rank<r>.json`."""
    import datetime

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    import torch
    import torch.distributed as dist

    from muse_maskgit_pytorch_tpu_torch.models import transformer
    from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend, qknorm_attend_backward
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
    from muse_maskgit_pytorch_tpu_torch.parallel import create_mesh, init_distributed, sharded_state_bytes
    from muse_maskgit_pytorch_tpu_torch.parallel.tensor import shard_module
    from muse_maskgit_pytorch_tpu_torch.utils.png import encode_png

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    folder = Path(folder)
    init_distributed(
        backend="gloo", device=dev, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=TP_WORLD,
        timeout=datetime.timedelta(seconds=300),
    )
    out = {}
    try:
        mesh = create_mesh({"tensor": TP_WORLD})
        heads, real_attend = set(), transformer.qknorm_attend

        def attend(q, *args, **kwargs):
            heads.add(q.shape[2])
            return real_attend(q, *args, **kwargs)

        transformer.qknorm_attend = attend
        batch, x, text = tp_inputs(torch, dev)

        # -- (a) f32: 2 steps, launches, the state's bytes, the weights and a checkpoint
        t = tp_trainer(torch, folder / "f32", torch.float32, mesh)
        total, local = sharded_state_bytes(t.state)
        losses, k2_fwd, k2_bwd = [], [], []
        for _ in range(2):
            f0, b0 = qknorm_attend.launches, qknorm_attend_backward.launches
            losses.append(t.train_step_arrays(*batch)["loss"])
            k2_fwd.append(qknorm_attend.launches - f0)
            k2_bwd.append(qknorm_attend_backward.launches - b0)
        weights = t.dp.gather(t.dp.masters)
        t.save()  # gathered on every rank, written by rank 0
        if rank == 0:
            torch.save({n: w.cpu() for n, w in zip(t.param_names, weights)}, folder / "tp_params.pt")
        out["a"] = dict(losses=losses, k2_forward=k2_fwd, k2_backward=k2_bwd, state_total=total, state_local=local)
        del t, weights
        torch.cuda.empty_cache()

        # -- (b) bf16: the step's time, then its collectives' host time
        t = tp_trainer(torch, folder / "bf16", None, mesh)
        for _ in range(TP_WARM):
            t.train_step_arrays(*batch)
        launches0 = qknorm_attend.launches, qknorm_attend_backward.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf_losses = [t.train_step_arrays(*batch)["loss"] for _ in range(TP_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TP_STEPS * 1000
        launches = qknorm_attend.launches - launches0[0], qknorm_attend_backward.launches - launches0[1]
        spent, real_all_reduce = [0.0, 0, 0], dist.all_reduce

        def timed_all_reduce(tensor, *args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            work = real_all_reduce(tensor, *args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - start
            spent[1] += 1
            spent[2] += tensor.numel() * tensor.element_size()
            return work

        dist.all_reduce = timed_all_reduce
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TP_COLL_STEPS):
                t.train_step_arrays(*batch)
            torch.cuda.synchronize()
            timed_ms = (time.perf_counter() - t0) / TP_COLL_STEPS * 1000
        finally:
            dist.all_reduce = real_all_reduce
        out["b"] = dict(
            ms_per_step=step_ms, losses=bf_losses, k2_forward=launches[0], k2_backward=launches[1],
            timed_ms_per_step=timed_ms, collective_ms_per_step=spent[0] / TP_COLL_STEPS * 1000,
            collectives_per_step=spent[1] / TP_COLL_STEPS, collective_bytes_per_step=spent[2] / TP_COLL_STEPS,
        )
        del t
        torch.cuda.empty_cache()

        # -- (c) the f32 forward and a request under injected noise; a bf16 request to PNGs
        model = build_models(torch, dtype=torch.float32, with_vae=False, self_cond=True)
        shard_module(model.transformer, mesh)
        k1_before = fused_topk_gumbel_sample.launches
        with torch.inference_mode():
            logits = model.transformer(x, text_embeds=text[: x.shape[0]])
            noise = tp_noise(torch, dev)
            ids, first = tp_generate(model, text, injected_gumbel_noise=noise, return_ids=True)
        k1_f32 = fused_topk_gumbel_sample.launches - k1_before
        if rank == 0:
            torch.save(dict(logits=logits.cpu(), ids=ids.cpu(), first=first.cpu()), folder / "tp_outputs.pt")
        del model, noise, logits
        torch.cuda.empty_cache()
        model = build_models(torch)
        shard_module(model.transformer, mesh)
        k1_before, k2_before = fused_topk_gumbel_sample.launches, qknorm_attend.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            images, _ = tp_generate(model, text)
        torch.cuda.synchronize()
        request_ms = (time.perf_counter() - t0) * 1000
        k1_bf16, k2_bf16 = fused_topk_gumbel_sample.launches - k1_before, qknorm_attend.launches - k2_before
        pixels = (images.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
        finite = bool(torch.isfinite(images).all())
        written = 0
        if rank == 0:
            for i, im in enumerate(pixels):
                (folder / f"tp_{i}.png").write_bytes(encode_png(im))
                written += 1
        out["c"] = dict(
            k1_f32=k1_f32, k1_bf16=k1_bf16, k2_bf16=k2_bf16, request_ms=request_ms, images_shape=list(pixels.shape),
            images_finite=finite, pngs=written,
        )
        out["heads"] = sorted(heads)
        (folder / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def phase_tensor(torch, ctx):
    """[tensor]: tensor parallelism over a `tensor` axis of TP_WORLD ranks on
    the one card. NCCL puts no two ranks on one device, so the ranks form a
    gloo group on CUDA tensors (spawned processes on 127.0.0.1): every
    collective passes through the host, and the times say nothing of TP over
    NVLink. Each rank runs `tp_rank`; the references run here, unwrapped, on
    the same card from the same seeds.

    (a) `MaskGitTrainer(shard_state=True, shard_state_rules=DEFAULT_TP_RULES)`
        over `create_mesh({"tensor": 2})`, f32, b16 at the base stage's width
        (dim 512, depth 8, 8 heads x 64, seq 256, vocab 65536, text 64 x 768,
        self-conditioning), 2 steps against the unwrapped trainer: losses
        within 1e-4 relative; the weights by tests/test_torch_parallel.py's
        rule for two summation orders: within 1e-3 of the leaf's largest
        change (`[parallel]`'s limit) plus 8 ulps of the weight for all but
        0.1% of a leaf's entries, every entry within 2 x the steps' summed
        lr (Adam moves an entry whose gradient is at rounding level by about
        its lr, either way); K2's forward 16 or 32 and its
        backward 16 launches a rank a step, every one at 4 heads; the state's
        bytes a rank over the total beside the share counted on the CPU.
    (b) the bf16 TP step: ms over TP_STEPS after TP_WARM, then TP_COLL_STEPS
        steps with every all-reduce timed on the host between synchronises
        (the collectives' ms, count and bytes a step). Printed, not gated.
    (c) the f32 forward of a `shard_module`d model: logits within 1e-4 of the
        largest |logit| of one process's; one b8 T18 CFG 3 request under
        injected noise through K1 on the gathered logits: the first step's
        ids agree on at least 0.999 of the positions (the logits differ by
        the split's summation order, so equality would rest on near-ties),
        the 18-step grids' agreement printed; one bf16 request with the VAE
        to PNGs, finite.
    (d) the TP trainer's checkpoint loaded into an unwrapped trainer here:
        every weight bit-equal to the TP trainer's gathered weights.
    """
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=scratch))
    try:
        with socket.socket() as s:  # a free port on the loopback interface
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        torch.cuda.empty_cache()  # the ranks allocate on the same card
        t0 = time.perf_counter()
        mp.start_processes(tp_rank, args=(port, str(tmp)), nprocs=TP_WORLD, join=True, start_method="spawn")
        t_ranks = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(TP_WORLD)]
        tp_params = torch.load(tmp / "tp_params.pt")
        tp_out = torch.load(tmp / "tp_outputs.pt")
        batch, x, text = tp_inputs(torch)

        # -- (a) against the unwrapped trainer
        plain = tp_trainer(torch, tmp / "plain", torch.float32)
        start = [p.detach().clone() for p in plain.params]
        plain_losses = [plain.train_step_arrays(*batch)["loss"] for _ in range(2)]
        a = [r["a"] for r in ranks]
        rel = max(abs(l - p) / abs(p) for r in a for l, p in zip(r["losses"], plain_losses))
        # the weights by tests/test_torch_parallel.py's rule for two summation
        # orders: each entry within 1e-3 of its leaf's largest change plus 8
        # ulps of the weight (a gamma near 1 moves by about 5e-5 in two
        # steps, and one rounding of it is 1.2e-3 of that), for all but 0.1%
        # of a leaf's entries, and every entry within 2 x the steps' summed
        # lr: Adam moves an entry whose gradient is at rounding level by
        # about its lr, either way
        lr_sum = sum(plain.optimizer.lr_at(i) for i in range(2))
        leaf, worst_share, worst_move, off = 0.0, 0.0, 0.0, []
        for n, p, s in zip(plain.param_names, plain.params, start):
            err, change = (tp_params[n].cuda() - p).abs(), (p - s).abs().max()
            leaf = max(leaf, err.max().item() / max(change.item(), 1e-30))
            big = torch.maximum(p.abs(), s.abs())
            outside = (err > 1e-3 * change + 8 * (torch.nextafter(big, big + 1) - big)).float().mean().item()
            worst_share, worst_move = max(worst_share, outside), max(worst_move, err.max().item() / (2 * lr_sum))
            if outside > 1e-3 or err.max().item() > 2 * lr_sum:
                off.append((n, outside, err.max().item()))
        share = a[0]["state_local"] / a[0]["state_total"]
        require(rel <= 1e-4, f"[tensor] f32 TP losses {[r['losses'] for r in a]} vs unwrapped {plain_losses}")
        require(not off, f"[tensor] f32 TP weights off (leaf, share of entries outside, max err): {off}")
        for r in a:
            require(all(n in (2 * DEPTH, 4 * DEPTH) for n in r["k2_forward"]), f"[tensor] K2 forward launches a step {r['k2_forward']}")
            require(all(n == 2 * DEPTH for n in r["k2_backward"]), f"[tensor] K2 backward launches a step {r['k2_backward']}")
        require(all(r["heads"] == [HEADS // TP_WORLD] for r in ranks), f"[tensor] K2 saw heads {[r['heads'] for r in ranks]}")
        require(share < 0.75, f"[tensor] a rank holds {share:.3f} of the train state")

        # -- (d) the TP checkpoint, loaded into the unwrapped trainer
        plain.load(tmp / "f32" / "checkpoints")
        bitwise = all(torch.equal(p.detach().cpu(), tp_params[n]) for n, p in zip(plain.param_names, plain.params))
        require(bitwise and plain.steps == 2, "[tensor] the TP checkpoint read in one process differs from the TP weights")
        del plain, start, tp_params
        torch.cuda.empty_cache()

        # -- (c) the forward and the request, against one process
        model = build_models(torch, dtype=torch.float32, with_vae=False, self_cond=True)
        with torch.inference_mode():
            logits = model.transformer(x, text_embeds=text[: x.shape[0]])
            logit_err = (tp_out["logits"].cuda() - logits).abs().max().item() / logits.abs().max().item()
            noise = tp_noise(torch)
            ids, first = tp_generate(model, text, injected_gumbel_noise=noise, return_ids=True)
        first_same = int((tp_out["first"].cuda() == first).sum())
        grid_agree = (tp_out["ids"].cuda() == ids).float().mean().item()
        del model, noise, logits
        torch.cuda.empty_cache()
        require(logit_err <= 1e-4, f"[tensor] f32 TP logits {logit_err:.3g} of the largest |logit| from one process's")
        require(first_same >= 0.999 * first.numel(), f"[tensor] first step ids agree at {first_same} of {first.numel()}")
        c = [r["c"] for r in ranks]
        for r in c:
            require(r["images_finite"] and r["images_shape"] == [TP_GEN_BATCH, IMAGE, IMAGE, 3], f"[tensor] bf16 images {r}")
            require(r["k1_f32"] == STEPS and r["k1_bf16"] == STEPS and r["k2_bf16"] > 0, f"[tensor] launches {r}")
        require(c[0]["pngs"] == TP_GEN_BATCH, f"[tensor] {c[0]['pngs']} PNGs written")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = [r["b"] for r in ranks]
    launches = dict(k1=0, k2=0, k3=0, k4=0)
    for r in ranks:
        launches["k2"] += sum(r["a"]["k2_forward"]) + r["b"]["k2_forward"] + r["c"]["k2_bf16"]
        launches["k1"] += r["c"]["k1_f32"] + r["c"]["k1_bf16"]
    ctx["tensor_launches"] = launches
    # K2 at a rank's heads: its launches here; its times are `[train]`'s self_h4 / cross_h4 shapes
    ctx["k2_tensor"] = dict(
        heads_per_rank=ranks[0]["heads"], forward_launches_per_rank_step=a[0]["k2_forward"],
        backward_launches_per_rank_step=a[0]["k2_backward"],
        backward_launches=sum(sum(r["a"]["k2_backward"]) + r["b"]["k2_backward"] for r in ranks),
    )
    ctx["tensor"] = dict(
        world=TP_WORLD, backend="gloo on CUDA tensors", f32_loss_rel=rel, f32_leaf_rel=leaf,
        f32_entries_outside_share=worst_share, f32_largest_move_of_lr_bound=worst_move,
        k2_forward_per_rank_step=a[0]["k2_forward"], k2_backward_per_rank_step=a[0]["k2_backward"],
        k2_heads=ranks[0]["heads"], state_share=share, state_share_expected=TP_STATE_SHARE_EXPECTED,
        state_bytes_total=a[0]["state_total"], state_bytes_per_rank=a[0]["state_local"],
        bf16_ms_per_step=[r["ms_per_step"] for r in b], bf16_collective_ms_per_step=[r["collective_ms_per_step"] for r in b],
        bf16_ms_per_step_collectives_timed=[r["timed_ms_per_step"] for r in b],
        collectives_per_step=b[0]["collectives_per_step"], collective_bytes_per_step=b[0]["collective_bytes_per_step"],
        logits_rel=logit_err, first_step_ids_same=first_same, first_step_ids=first.numel(), grid_agreement=grid_agree,
        bf16_request_ms=[r["request_ms"] for r in c], checkpoint_bitwise=bitwise, ranks_s=t_ranks,
    )
    def each(key, rows, fmt=".1f"):
        return ", ".join(format(r[key], fmt) for r in rows)

    log(
        f"[tensor] {TP_WORLD} ranks on one card, gloo on CUDA tensors (every collective through the host: no "
        f"figure here is TP over NVLink), create_mesh({{'tensor': {TP_WORLD}}}), ranks' run {t_ranks:.1f} s | (a) "
        f"MaskGitTrainer(shard_state=True, shard_state_rules=DEFAULT_TP_RULES) f32 b{TP_BATCH} seq {SEQ} dim {DIM} depth "
        f"{DEPTH} vocab {VOCAB}, 2 steps vs unwrapped: loss {', '.join(f'{v:.6f}' for v in a[0]['losses'])} vs "
        f"{', '.join(f'{v:.6f}' for v in plain_losses)} ({rel:.2g} relative), weights within {leaf:.2g} of a leaf's "
        f"change, at most {worst_share:.2e} of a leaf's entries past 1e-3 of it + 8 ulps, the largest move "
        f"{worst_move:.2f} of 2 x the steps' lr; K2 a rank a step {a[0]['k2_forward']} forward, {a[0]['k2_backward']} backward, at {ranks[0]['heads']} "
        f"heads; state {a[0]['state_local'] / 2**30:.3f} of {a[0]['state_total'] / 2**30:.3f} GiB a rank ({share:.3f}; "
        f"{TP_STATE_SHARE_EXPECTED} counted on the CPU) | (b) bf16 TP step {each('ms_per_step', b)} "
        f"ms a rank ({TP_BATCH / b[0]['ms_per_step'] * 1000:.2f} img/s), with each all-reduce timed between "
        f"synchronises {each('timed_ms_per_step', b)} ms of which collectives "
        f"{each('collective_ms_per_step', b)} ms ({b[0]['collectives_per_step']:.0f} a step, "
        f"{b[0]['collective_bytes_per_step'] / 2**20:.1f} MiB) | (c) f32 TP logits within {logit_err:.2g} of the "
        f"largest |logit|; b{TP_GEN_BATCH} T{STEPS} CFG {CFG:g} under injected noise, K1 on the gathered logits: first "
        f"step ids {first_same} of {first.numel()} equal, 18-step grids {grid_agree:.4f} equal; bf16 request "
        f"{each('request_ms', c, '.0f')} ms a rank, {c[0]['pngs']} PNGs | (d) TP checkpoint read "
        f"in one process: bit-equal | {ctx.get('smi', '')} | {time.perf_counter() - t_phase:.1f} s"
    )


def phase_profile(torch, ctx):
    """One `generate` request (as in `[generate]`) under torch.profiler:
    device time in all and by kernel, for PERF.md's breakdown."""
    from torch.profiler import ProfilerActivity, profile

    maskgit = ctx.get("maskgit") or build_models(torch)
    ctx["maskgit"] = maskgit
    g = torch.Generator(device="cuda").manual_seed(0)
    text = torch.randn(BATCH, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    maskgit.generate(generator=gen, text_embeds=text, timesteps=STEPS, cond_scale=CFG)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        maskgit.generate(generator=gen, text_embeds=text, timesteps=STEPS, cond_scale=CFG)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1000
    rows = profile_rows(prof)
    if not rows:
        log(f"[profile] the profiler saw no device time: not measured | {ctx['smi']}")
        return
    device_ms, streams, repeats = device_busy(prof)
    busy_within(device_ms, host_ms, "the profiled request")

    k2_ms, k2_n = kernel_total(rows, "flash_core_kernel<64, true>")
    k1_ms, k1_n = kernel_total(rows, "sample_kernel")
    require(
        (k1_n, k2_n) == (STEPS, STEPS * DEPTH * 2),
        f"the profiler counted K1 x{k1_n}, K2 x{k2_n} in a request, expected x{STEPS}, x{STEPS * DEPTH * 2}",
    )
    top = "; ".join(f"{ms:.1f} ms x{n} {name[:70]}" for ms, n, name in rows[:10])
    log(
        f"[profile] generate b{BATCH} T{STEPS} cfg{CFG:g}: device busy {device_ms:.1f} ms (kernels' sum "
        f"{sum(r[0] for r in rows):.1f} ms, {streams} stream(s), {repeats} repeated records) in a request of "
        f"{host_ms:.1f} ms ({device_ms / host_ms:.1%} busy); K2 {k2_ms:.2f} ms x{k2_n}, K1 {k1_ms:.2f} ms "
        f"x{k1_n}; top kernels: {top} | {ctx['smi']}"
    )
    if "trainer" in ctx:
        profile_train_step(torch, ctx)
    if "sr_trainer" in ctx:
        profile_train_step(torch, ctx, superres=True)
    if "gan_trainer" in ctx:
        profile_gan_step(torch, ctx)


def profile_gan_step(torch, ctx):
    """Where an f32 EMA-VQ GAN step of `[gan]` goes: its parts by CUDA
    events on a fresh trainer after one step (the generator's loss and
    gradient, the codebook update, the discriminator's loss and gradient
    without and with the R1 penalty, the rest: both updates, the norms,
    the EMA), then one whole step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    trainer, imgs = ctx.pop("gan_trainer")(), ctx.pop("gan_images")
    vae, img = trainer.vae, imgs[0]
    trainer.train_step_arrays(imgs)  # k-means and the first update
    gen_params = trainer.gen_params
    discr_params = trainer.discr_params

    def gen_part():
        loss = vae(img, return_loss=True, train=True, update_stats=False)
        torch.autograd.grad(loss, gen_params)

    def discr_part(penalty):
        loss = vae(img, return_discr_loss=True, add_gradient_penalty=penalty, train=False)
        torch.autograd.grad(loss, discr_params)

    parts = {
        "generator loss + gradient": gen_part,
        "codebook update": lambda: vae.update_quantizer_stats(img, rng=torch.Generator().manual_seed(0)),
        "discriminator loss + gradient": lambda: discr_part(False),
        "the same with the R1 penalty": lambda: discr_part(True),
    }
    with torch.no_grad():
        state = [t.detach().clone() for t in _train_tensors(trainer)]
    part_ms = {name: cuda_ms(fn, iters=3, warmup=1) for name, fn in parts.items()}
    with torch.no_grad():
        torch._foreach_copy_(_train_tensors(trainer), state)
    del state
    trainer.apply_grad_penalty_every = 10**9  # the profiled step without the penalty
    step_ms = cuda_ms(lambda: trainer.train_step_arrays(imgs), iters=3, warmup=1)
    rest_ms = step_ms - sum(part_ms[k] for k in ("generator loss + gradient", "codebook update", "discriminator loss + gradient"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_step_arrays(imgs)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1000
    rows = profile_rows(prof)
    if not rows:
        log(f"[profile] GAN step: the profiler saw no device time: not measured | {ctx['smi']}")
        return
    device_ms, streams, repeats = device_busy(prof)
    busy_within(device_ms, host_ms, "the profiled GAN step")
    kernels_ms = sum(r[0] for r in rows)
    k3_ms, k3_n = kernel_total(rows, "vq_search_kernel")
    require(k3_n == 3, f"the profiled GAN step launched K3's search {k3_n} times, expected 3")
    conv_ms, _, _ = device_busy(prof, r"(?i)conv|xmma|cudnn|implicit|dgrad|wgrad|fprop|fft")
    parts_s = "; ".join(f"{name} {ms:.1f} ms" for name, ms in part_ms.items())
    top = "; ".join(f"{ms:.1f} ms x{n} {name[:70]}" for ms, n, name in rows[:10])
    ctx["gan"]["profile"] = dict(
        parts_ms=part_ms, rest_ms=rest_ms, step_ms=step_ms, device_ms=device_ms, kernels_ms=kernels_ms,
        streams=streams, repeats=repeats, host_ms=host_ms, conv_ms=conv_ms, k3_ms=k3_ms,
    )
    log(
        f"[profile] GAN step b{GAN_BATCH} f32 EMA-VQ, no penalty, {step_ms:.1f} ms by CUDA events: {parts_s}; "
        f"the rest (updates, norms, EMA) {rest_ms:.1f} ms | under torch.profiler: device busy {device_ms:.1f} ms "
        f"(kernels' sum {kernels_ms:.1f} ms, {streams} stream(s), {repeats} repeated records) in a step of "
        f"{host_ms:.1f} ms ({device_ms / host_ms:.1%} busy), convolution kernels busy {conv_ms:.1f} ms "
        f"({conv_ms / device_ms:.1%}), K3 {k3_ms:.2f} ms x{k3_n} ({k3_ms / device_ms:.1%}); top kernels (summed): "
        f"{top} | {ctx['smi']}"
    )


def profile_train_step(torch, ctx, superres=False):
    """One bf16 train step of `[train]`'s trainer (or, with `superres`, of
    its super-res stage's trainer) under torch.profiler: device time in all,
    by kernel, K2's backward kernels by name and share, and the kernels under
    the autograd node of K2's backward."""
    from torch.profiler import ProfilerActivity, profile

    key = "sr_train" if superres else "train"
    trainer, (batch, kw) = ctx[f"{key}er"], ctx[f"{key}_batch"]
    seq, label = (SR_SEQ, f"super-res train step b{CAS_BATCH}") if superres else (SEQ, f"train step b{TRAIN_BATCH}")
    trainer.train_step_arrays(*batch, **kw)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_step_arrays(*batch, **kw)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1000
    averages = prof.key_averages()
    rows = profile_rows(prof)
    if not rows:
        log(f"[profile] {label}: the profiler saw no device time: not measured | {ctx['smi']}")
        return
    device_ms, streams, repeats = device_busy(prof)
    busy_within(device_ms, host_ms, f"the profiled {label}")
    k2_ms, k2_n = kernel_total(rows, "flash_core_kernel<64, true>")
    # K2's backward kernels (`csrc/qknorm_attention_bwd.cu`): at the base
    # step's n = 256 in bf16 the one-pass kernel, one launch a call; at the
    # super-res step's n = 1024 the split route's four
    from muse_maskgit_pytorch_tpu_torch.ops import attention

    kb = [(ms, n, re.search(r"qknorm_bwd_\w+", name).group(0)) for ms, n, name in rows if "qknorm_bwd_" in name]
    kb_ms = sum(r[0] for r in kb)
    want = (
        ["qknorm_bwd_onepass_bf16"] if attention._backward_one_pass(seq, torch.bfloat16)
        else sorted(BWD_BF16_SPLIT_KERNELS)
    )
    require(
        sorted(name for _, _, name in kb) == want and all(n == 2 * DEPTH for _, n, _ in kb),
        f"the profiled step's K2 backward kernels: {[(n, name) for _, n, name in kb]}, expected {want} x{2 * DEPTH}",
    )
    kb_s = "; ".join(f"{ms:.2f} ms x{n} {name}" for ms, n, name in kb)
    # the autograd node's own rows (the engine's evaluate_function row holds
    # the same kernels again, so it is left out)
    bwd = [e for e in averages if e.key == "_QKNormAttentionBackward"]
    bwd_us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) for e in bwd)
    bwd_s = f"{bwd_us / 1000:.1f} ms ({bwd_us / 1000 / device_ms:.1%})" if bwd_us else "not measured"
    # the kernels launched under K2's backward nodes, by name
    under: dict = {}
    stack = [e for e in prof.events() if "evaluate_function" in e.name and "_QKNormAttentionBackward" in e.name]
    while stack:
        e = stack.pop()
        for k in e.kernels:
            under[k.name] = under.get(k.name, 0.0) + k.duration / 1000
        stack.extend(e.cpu_children)
    under_s = "; ".join(f"{ms:.2f} ms {name[:60]}" for name, ms in sorted(under.items(), key=lambda kv: -kv[1])[:8])
    top = "; ".join(f"{ms:.2f} ms x{n} {name[:70]}" for ms, n, name in rows[:12])
    ctx["train"]["superres_profile" if superres else "profile"] = dict(
        device_ms=device_ms, host_ms=host_ms, k2_fwd_ms=k2_ms, attn_bwd_ms=bwd_us / 1000, k2_bwd_kernels_ms=kb_ms,
        k2_bwd_kernels={name: ms for ms, _, name in kb},
    )
    log(
        f"[profile] {label}: device busy {device_ms:.1f} ms (kernels' sum "
        f"{sum(r[0] for r in rows):.1f} ms, {streams} stream(s), {repeats} repeated records) in a step of "
        f"{host_ms:.1f} ms ({device_ms / host_ms:.1%} busy); K2 forward {k2_ms:.2f} ms x{k2_n}; K2's backward "
        f"kernels {kb_ms:.2f} ms ({kb_ms / device_ms:.1%} of the step): {kb_s}; K2's backward autograd node "
        f"{bwd_s}, by kernel: "
        f"{under_s or 'not measured'}; top kernels of the step: {top} | {ctx['smi']}"
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
    path against the plain path with the TPU kernel's roundings in its
    attention (`attend_bf16_rounded`: q^, k^ and P in bf16), two correct
    attentions that differ only where the kernel rounds as the TPU does.
    Single bf16 decode steps of the main path (all masked at step 0; half
    masked, compact, at step 9), each at its step's temperature, batch 16,
    must agree at least as well as that floor less 0.01 (> 3 sigma of the
    difference at 4096 tokens). The plain path against an f64 attention
    (`attend_f64`) is printed beside it, and the 18-step bf16 agreement
    beside its floors."""
    from muse_maskgit_pytorch_tpu_torch.models import maskgit as mg
    from muse_maskgit_pytorch_tpu_torch.utils.sampling import step_temperatures

    g = torch.Generator(device="cuda").manual_seed(7)
    temps = step_temperatures(1.0, STEPS)
    seed = torch.zeros(1, dtype=torch.int32, device="cuda")

    def gumbel(*shape):
        u = torch.rand(*shape, generator=g, device="cuda").clamp(1e-9, 1 - 1e-9)
        return -torch.log(-torch.log(u))

    def agreement(fn, floors=True):
        """Agreement with the plain path of: the kernel path and, with
        `floors`, the path with the TPU-rounding attention (the floor) and
        the path with the f64 one."""
        out = [fn()]
        with plain_path():
            ref = fn()
        if floors:
            with plain_path(attend=attend_bf16_rounded):
                out.append(fn())
            with plain_path(attend=attend_f64):
                out.append(fn())
        return tuple((t == ref).float().mean().item() for t in out)

    maskgit = ctx.get("maskgit") or build_models(torch)
    ctx["maskgit"] = maskgit

    # -- whole generate, batch 2
    b = 2
    text = torch.randn(b, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    noise = gumbel(STEPS, b, SEQ, VOCAB)

    def generate(model, sampler="fused", **cond):
        return lambda: model.generate(
            text_embeds=text, timesteps=STEPS, cond_scale=CFG, sampler=sampler,
            injected_gumbel_noise=noise, return_ids=True, **cond,
        )

    bf16_full, bf16_full_floor, bf16_full_f64 = agreement(generate(maskgit))
    # the exact top-k sampler against the fused one, same noise: they differ
    # by design (the bisection threshold keeps a few more candidates, and
    # the exact path takes the chosen probability in bf16); printed only
    xla_vs_fused = (generate(maskgit, "xla")() == generate(maskgit)()).float().mean().item()
    f32 = build_models(torch, dtype=torch.float32, with_vae=False)
    f32_full = agreement(generate(f32), floors=False)[0]
    del f32, noise
    require(f32_full >= 0.99, f"f32 T{STEPS} kernel vs plain token agreement {f32_full:.4f} < 0.99")

    # -- single bf16 decode steps, batch 16
    bs = 16
    text = torch.randn(bs, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")

    @torch.inference_mode()
    def decode_step(x_in, cand, step, noise, model=maskgit, cond=None):
        # the body of one decode step, through the models' entry points
        tr = model.transformer
        ctx_kv = mg._double_ctx_kv(tr.precompute_context_kv(text_embeds=text, conditioning_token_ids=cond))
        logits = tr.forward_with_cond_scale(
            x_in, text_embeds=text, conditioning_token_ids=cond, cond_scale=CFG, gather_positions=cand,
            context_kv=ctx_kv,
        )
        idx, _ = mg.fused_topk_gumbel_sample(
            logits.reshape(-1, VOCAB), TOPK, float(temps[step]), seed, noise=noise.reshape(-1, VOCAB),
        )
        return idx

    mask_id = maskgit.mask_id
    all_masked = torch.full((bs, SEQ), mask_id, dtype=torch.long, device="cuda")
    noise0 = gumbel(bs, SEQ, VOCAB)
    step0, floor0, f64_0 = agreement(lambda: decode_step(all_masked, None, 0, noise0))
    cand = torch.argsort(torch.rand(bs, SEQ, generator=g, device="cuda"), dim=-1)[:, : SEQ // 2]
    half = torch.randint(0, VOCAB, (bs, SEQ), generator=g, device="cuda").scatter(1, cand, mask_id)
    noise9 = gumbel(bs, SEQ // 2, VOCAB)
    step9, floor9, f64_9 = agreement(lambda: decode_step(half, cand, 9, noise9))
    require(step0 >= floor0 - 0.01, f"bf16 step 0 token agreement {step0:.4f} < floor {floor0:.4f} - 0.01")
    require(step9 >= floor9 - 0.01, f"bf16 step 9 token agreement {step9:.4f} < floor {floor9:.4f} - 0.01")
    del noise0, noise9

    # -- the super-res stage the same way, batch 4 (4096 tokens a step, as
    # above): every attention has 1024 queries, the cross-attention 64 text
    # + 256 conditioning keys with the null half's text keys off
    sbs = 4
    text = torch.randn(sbs, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    cond = torch.randint(0, VOCAB, (sbs, IMAGE >> VAE_LAYERS, IMAGE >> VAE_LAYERS), generator=g, device="cuda")
    superres = ctx.get("superres") or build_superres(torch, maskgit.vae)
    ctx["superres"] = superres
    noise = gumbel(STEPS, sbs, SR_SEQ, VOCAB)
    sr_f32 = build_superres(torch, None, dtype=torch.float32)
    sr_f32_full = agreement(generate(sr_f32, cond_token_ids=cond), floors=False)[0]
    del sr_f32, noise
    require(sr_f32_full >= 0.99, f"super-res f32 T{STEPS} kernel vs plain token agreement {sr_f32_full:.4f} < 0.99")
    all_masked = torch.full((sbs, SR_SEQ), mask_id, dtype=torch.long, device="cuda")
    noise0 = gumbel(sbs, SR_SEQ, VOCAB)
    sr0, sr_floor0, sr_f64_0 = agreement(lambda: decode_step(all_masked, None, 0, noise0, superres, cond))
    cand = torch.argsort(torch.rand(sbs, SR_SEQ, generator=g, device="cuda"), dim=-1)[:, : SR_SEQ // 2]
    half = torch.randint(0, VOCAB, (sbs, SR_SEQ), generator=g, device="cuda").scatter(1, cand, mask_id)
    noise9 = gumbel(sbs, SR_SEQ // 2, VOCAB)
    sr9, sr_floor9, sr_f64_9 = agreement(lambda: decode_step(half, cand, 9, noise9, superres, cond))
    require(sr0 >= sr_floor0 - 0.01, f"super-res bf16 step 0 token agreement {sr0:.4f} < floor {sr_floor0:.4f} - 0.01")
    require(sr9 >= sr_floor9 - 0.01, f"super-res bf16 step 9 token agreement {sr9:.4f} < floor {sr_floor9:.4f} - 0.01")
    del noise0, noise9

    # -- the sampling surfaces in f32, batch 4, 18 steps, injected noise:
    # a negative prompt, an edit, a 320px request, a guidance ramp with
    # cfg_fold=False (K1's cfg_pair route with the scale in device memory)
    sb, side = 4, IMAGE * 5 // 4  # 320px: 400 tokens
    f32 = build_models(torch, dtype=torch.float32)
    text = torch.randn(sb, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    neg = torch.randn(sb, NEG_TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    images = torch.rand(sb, IMAGE, IMAGE, 3, generator=g, device="cuda")
    surfaces = {
        "negative prompt": (SEQ, lambda **kw: f32.generate(text_embeds=text, neg_text_embeds=neg, **kw)),
        "edit": (SEQ, lambda **kw: f32.edit(images, centre_half_mask(sb, IMAGE, IMAGE), text_embeds=text, **kw)),
        f"{side}px": ((side >> VAE_LAYERS) ** 2, lambda **kw: f32.generate(text_embeds=text, image_size=side, **kw)),
        "ramp cfg_fold=False": (
            SEQ, lambda **kw: f32.generate(text_embeds=text, cfg_fold=False, **(kw | dict(cond_scale=(1.0, 5.0)))),
        ),
    }
    surface_agree = {}
    for name, (seq, run) in surfaces.items():
        noise = gumbel(STEPS, sb, seq, VOCAB)
        surface_agree[name] = agreement(
            lambda: run(timesteps=STEPS, cond_scale=CFG, sampler="fused", injected_gumbel_noise=noise, return_ids=True),
            floors=False,
        )[0]
        del noise
        require(surface_agree[name] >= 0.99, f"f32 {name} T{STEPS} kernel vs plain token agreement {surface_agree[name]:.4f} < 0.99")
    del f32
    surfaces_s = ", ".join(f"{n} {a:.4f}" for n, a in surface_agree.items())
    log(
        f"[parity] injected noise, token agreement with the plain path (kernel path | TPU-rounding "
        f"attention floor | f64 attention): f32 generate b{b} T{STEPS} {f32_full:.4f} (checked >= 0.99); "
        f"bf16 step 0 b{bs} {step0:.4f} | {floor0:.4f} | {f64_0:.4f}, bf16 step 9 b{bs} {step9:.4f} | "
        f"{floor9:.4f} | {f64_9:.4f} (checked >= floor - 0.01); bf16 generate b{b} T{STEPS} "
        f"{bf16_full:.4f} | {bf16_full_floor:.4f} | {bf16_full_f64:.4f} (printed); super-res (seq {SR_SEQ}, "
        f"{COND_TOKENS} conditioning tokens) b{sbs}: f32 generate T{STEPS} {sr_f32_full:.4f} (checked >= 0.99), "
        f"bf16 step 0 {sr0:.4f} | {sr_floor0:.4f} | {sr_f64_0:.4f}, bf16 step 9 {sr9:.4f} | {sr_floor9:.4f} | "
        f"{sr_f64_9:.4f} (checked >= floor - 0.01); sampler=\"xla\" vs \"fused\" bf16 generate b{b} "
        f"T{STEPS}, same noise: {xla_vs_fused:.4f} (printed: they differ by design); sampling surfaces, f32 "
        f"b{sb} T{STEPS}: {surfaces_s} (checked >= 0.99)"
    )


def phase_tokenize(torch, ctx):
    """images -> encode -> ids -> decode_from_ids at the tokenizer's full
    width, for LFQ and for EMA-VQ; encode and decode ms per image as
    `bench.py` defines them (batch time / batch), median of 3 after a
    warm-up, host clock around work that ends in a synchronize."""
    from muse_maskgit_pytorch_tpu_torch import VQGanVAE
    from muse_maskgit_pytorch_tpu_torch.models.quantizers import l2norm
    from muse_maskgit_pytorch_tpu_torch.ops.attention import attend
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code, score_gap

    g = torch.Generator(device="cuda").manual_seed(5)
    img = torch.rand(BATCH, IMAGE, IMAGE, 3, generator=g, device="cuda")
    grid = IMAGE >> VAE_LAYERS

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def build(**kw):
        gen = torch.Generator().manual_seed(1)
        return VQGanVAE(
            dim=VAE_DIM, layers=VAE_LAYERS, codebook_size=VOCAB, use_vgg_and_gan=False, generator=gen, **kw
        ).eval()

    maskgit = ctx.get("maskgit")
    configs = {"lfq": maskgit.vae if maskgit is not None else build(), "ema_vq": build(lookup_free_quantization=False)}
    conv_tf32_check(torch, configs["lfq"], ctx)
    parts = []
    for name, vae in configs.items():
        with torch.inference_mode():
            _, ids, _ = vae.encode(img)  # warm-up: cuDNN chooses its algorithms
            vae.decode_from_ids(ids)
            nearest_code.launches = attend.launches = 0
            enc, per_encode, k4_per_encode = [], [], []
            for _ in range(3):
                before, k4_before = nearest_code.launches, attend.launches
                (fmap, ids, aux), dt = timed(lambda: vae.encode(img))
                per_encode.append(nearest_code.launches - before)
                k4_per_encode.append(attend.launches - k4_before)
                enc.append(dt)
            launches = nearest_code.launches
            dec = []
            for _ in range(3):
                out, dt = timed(lambda: vae.decode_from_ids(ids))
                dec.append(dt)
        require(tuple(ids.shape) == (BATCH, grid, grid) and ids.dtype == torch.int32, f"{name} ids {tuple(ids.shape)} {ids.dtype}")
        require(0 <= ids.min().item() and ids.max().item() < VOCAB, f"{name} ids out of range")
        require(tuple(out.shape) == (BATCH, IMAGE, IMAGE, 3) and bool(torch.isfinite(out).all()), f"{name} decode output")
        require(bool(torch.isfinite(fmap).all()) and math.isfinite(float(aux)), f"{name} encode output")
        enc_ms = statistics.median(enc) * 1000 / BATCH
        dec_ms = statistics.median(dec) * 1000 / BATCH
        line = (
            f"{name} encode {enc_ms:.3f} ms/img, decode {dec_ms:.3f} ms/img, K3 +{per_encode[0]}, "
            f"K4 +{k4_per_encode[0]} per encode"
        )
        require(k4_per_encode == [0, 0, 0], f"{name} encode launched K4 {k4_per_encode} times, expected 0")
        ctx["k4_per_encode"] = ctx.get("k4_per_encode", 0) + k4_per_encode[0]
        if name == "lfq":
            require(launches == 0, f"LFQ encode launched K3 {launches} times")
        else:
            require(per_encode == [1, 1, 1], f"K3 launches per EMA-VQ encode {per_encode}, expected 1")
            ctx["k3"]["launches"], ctx["k3"]["launches_per_request"] = launches, per_encode[0]
            q = vae.quantizer
            with torch.inference_mode():
                with plain_path():
                    (_, plain_ids, _), plain_dt = timed(lambda: vae.encode(img))
                z = l2norm(q.project_in(vae.enc_dec.encode(img)).reshape(-1, q.codebook_dim).float())
                zeros = torch.zeros(VOCAB, device="cuda")
                k3_ms = cuda_ms(lambda: nearest_code(z, q.codebook, zeros), iters=5, warmup=1)
                gaps = [score_gap(z, q.codebook, t.reshape(-1), zeros).max().item() for t in (ids, plain_ids)]
            differ = (ids != plain_ids).sum().item()
            require(max(gaps) <= NEAR_TIE, f"EMA-VQ ids off the f64 best by {gaps}")
            share = k3_ms / (statistics.median(enc) * 1000)
            line += (
                f"; ids vs plain path: {differ} of {ids.numel()} differ, max f64 gap {gaps[0]:.3g} (plain "
                f"{gaps[1]:.3g}); plain-path encode {plain_dt * 1000 / BATCH:.3f} ms/img; K3 {k3_ms:.3f} ms "
                f"= {share:.1%} of the encode"
            )
        parts.append(line)
        del vae
    configs.clear()
    log(f"[tokenize] b{BATCH} {IMAGE}px dim {VAE_DIM} K {VOCAB}: " + " | ".join(parts) + f" | {ctx['smi']}")


def conv_tf32_check(torch, vae, ctx):
    """F5: the port's f32 convolutions run in IEEE f32 whatever cuDNN's TF32
    flag says. With torch's default (`cudnn.allow_tf32` True) turned back on,
    `decode_from_ids` of a b4 grid at the tokenizer's width and one
    convolution's output, input and weight gradients (the backward run after
    the forward's call, as a trainer's) equal the TF32-off results bit for
    bit; cuDNN deterministic for both, so only TF32 could tell them apart,
    and PyTorch's own convolution at this shape must show that it does."""
    from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d

    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.deterministic
    g = torch.Generator(device="cuda").manual_seed(9)
    grid = IMAGE >> VAE_LAYERS
    ids = torch.randint(0, VOCAB, (4, grid, grid), generator=g, device="cuda")
    conv = Conv2d(VAE_DIM, VAE_DIM, 3, padding=1, generator=torch.Generator().manual_seed(7)).cuda()
    x = torch.randn(4, VAE_DIM, 64, 64, generator=g, device="cuda")
    gy = torch.randn(4, VAE_DIM, 64, 64, generator=g, device="cuda")

    def run(allow_tf32, layer=conv):
        cudnn.allow_tf32, cudnn.deterministic = allow_tf32, True
        with torch.inference_mode():
            img = vae.decode_from_ids(ids) if layer is conv else None
        conv.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        y = layer(xi)
        y.backward(gy)
        torch.cuda.synchronize()
        return img, y.detach(), xi.grad, conv.weight.grad

    native = lambda xi: torch.nn.Conv2d.forward(conv, xi)  # noqa: E731 (PyTorch's own convolution)
    try:
        # the check can see TF32: PyTorch's convolution of the same weights
        # changes its output and both gradients with it
        seen = [not torch.equal(a, b) for a, b in zip(run(True, native)[1:], run(False, native)[1:])]
        on, off = run(True), run(False)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved
    names = ("decode_from_ids", "conv output", "input gradient", "weight gradient")
    require(all(seen), f"F5: TF32 leaves PyTorch's {[n for n, s in zip(names[1:], seen) if not s]} unchanged: the check cannot see it")
    differ = [name for name, a, b in zip(names, on, off) if not torch.equal(a, b)]
    require(not differ, f"F5: with cudnn.allow_tf32 on, {differ} differ from the TF32-off results")
    require(bool(torch.isfinite(on[0]).all()), "F5: decode output")
    log(
        f"[tokenize] F5: with torch's cudnn.allow_tf32 True, decode_from_ids (4, {grid}, {grid}) and a "
        f"{VAE_DIM}->{VAE_DIM} 3x3 conv's output, input and weight gradients are bit-equal to TF32 off "
        f"(PyTorch's own conv of the same weights: all three differ with TF32 on)"
    )


def phase_t5(torch, ctx):
    """`t5_encode_text_with_mask` of the 16 fixed prompts with a T5
    v1.1-base shaped encoder (d_model 768, d_ff 2048, 12 heads x 64, 12
    layers, gated; random weights from seed 0, the byte tokenizer), f32
    with TF32 off: ms per batch, median of 5 after a warm-up, host clock
    around work that ends in a synchronize."""
    from muse_maskgit_pytorch_tpu_torch.models import t5

    for p in PROMPTS:
        require(57 <= len(p.encode()) <= 63, f"prompt of {len(p.encode())} bytes: {p!r}")
    t0 = time.perf_counter()
    model, _ = t5.get_model_and_tokenizer(t5.DEFAULT_T5_NAME)
    t_build = time.perf_counter() - t0
    cfg = model.cfg
    require(
        (cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.d_kv, cfg.num_layers, cfg.gated) == (768, 2048, 12, 64, 12, True),
        f"not the v1.1-base shape: {cfg}",
    )
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        embeds, mask = t5.t5_encode_text_with_mask(list(PROMPTS))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    require(tuple(embeds.shape) == (CAS_BATCH, TEXT_LEN, TEXT_DIM), f"T5 embeddings {tuple(embeds.shape)}")
    require(embeds.is_cuda and embeds.dtype == torch.float32, f"T5 embeddings on {embeds.device} in {embeds.dtype}")
    require(bool(torch.isfinite(embeds).all()), "non-finite T5 embeddings")
    lengths = mask.sum(-1).tolist()
    require(lengths == [len(p.encode()) + 1 for p in PROMPTS], f"T5 mask lengths {lengths}")
    require(bool((embeds[~mask] == 0).all()), "T5 padding is not zero")
    require(bool(((embeds != 0).any(-1) == mask).all()), "the mask cannot be read back from the embeddings")
    ms = statistics.median(times[1:]) * 1000
    ctx["t5_ms"] = ms
    params = sum(p.numel() for p in model.parameters())
    log(
        f"[t5] t5_encode_text_with_mask ok: {CAS_BATCH} prompts of {min(lengths)}-{max(lengths)} tokens -> "
        f"{tuple(embeds.shape)} f32, padding exactly 0, finite; v1.1-base shape ({params / 1e6:.1f}M parameters, "
        f"random init), {ms:.2f} ms per batch (median of 5, first call {times[0] * 1000:.1f} ms) | {ctx['smi']} | "
        f"encoder built {t_build:.1f}s"
    )


def phase_surfaces(torch, ctx):
    """Every sampling surface of `MaskGit` and `Muse` through its entry
    point, at the base stage's full width (bf16, 18 steps, CFG 3, batch 8
    unless stated; the cascade's super-res stage at batch 4): three requests
    each after a warm-up, timed by the host clock around work that ends in a
    synchronize (median). The launch counts are set to 0 just before each
    request and read just after: K1 > 0, K2 > 0, K3 = K4 = 0. Checked: the
    output's shape, finite values, no mask id in any grid a decode returned,
    and for the edits every known token equal to the source's. One line a
    request, then the cost of `vaes_share_weights` that `Muse(cond_via=
    "ids")` pays now that each stage holds its own VAE clone."""
    from muse_maskgit_pytorch_tpu_torch import MaskGit, Muse, TokenCritic, vaes_share_weights
    from muse_maskgit_pytorch_tpu_torch.models.maskgit import _resize_nearest
    from muse_maskgit_pytorch_tpu_torch.ops.attention import attend, qknorm_attend
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code

    t0 = time.perf_counter()
    base = ctx.get("maskgit") or build_models(torch)
    ctx["maskgit"] = base
    superres = ctx.get("superres") or build_superres(torch, base.vae)
    ctx["superres"] = superres
    tr, vae = base.transformer, base.vae
    critic = TokenCritic(
        num_tokens=VOCAB, dim=DIM, seq_len=SEQ, depth=2, dim_head=DIM_HEAD, heads=HEADS, text_embed_dim=TEXT_DIM,
        dtype=torch.bfloat16, generator=torch.Generator().manual_seed(2),
    )
    remask = MaskGit(image_size=IMAGE, transformer=tr, vae=vae, no_mask_token_prob=0.1).eval()
    self_critic = MaskGit(image_size=IMAGE, transformer=tr, vae=vae, self_token_critic=True).eval()
    token_critic = MaskGit(image_size=IMAGE, transformer=tr, vae=vae, token_critic=critic).eval()
    muse = Muse(base, superres)
    t_build = time.perf_counter() - t0

    g = torch.Generator(device="cuda").manual_seed(11)
    b, cb = SURF_BATCH, SURF_CAS_BATCH
    text = torch.randn(b, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    neg = torch.randn(b, NEG_TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    images = torch.rand(b, IMAGE, IMAGE, 3, generator=g, device="cuda")
    sr_images = torch.rand(cb, SR_IMAGE, SR_IMAGE, 3, generator=g, device="cuda")
    edit_mask, sr_edit_mask = centre_half_mask(b, IMAGE, IMAGE), centre_half_mask(cb, SR_IMAGE, SR_IMAGE)
    per_row = torch.linspace(1.0, 5.0, b, device="cuda")[None]
    kw = dict(text_embeds=text, timesteps=STEPS, cond_scale=CFG)
    few = dict(kw, text_embeds=text[:cb])
    img = (IMAGE, IMAGE, 3)
    # a landscape 2:3 (256 x 384, 384 tokens) and a 320px square (400)
    rect, square = (IMAGE, IMAGE * 3 // 2), IMAGE * 5 // 4
    grid, sr_grid = IMAGE >> VAE_LAYERS, SR_IMAGE >> VAE_LAYERS
    # name: (images a request, output shape, the request from a seed)
    requests = {
        "negative prompt (64 + 16 tokens)": (b, (b, *img), lambda s: base.generate(generator=s, neg_text_embeds=neg, **kw)),
        "guidance ramp (1, 5), cfg_fold=False": (
            b, (b, *img), lambda s: base.generate(generator=s, cfg_fold=False, **(kw | dict(cond_scale=(1.0, 5.0)))),
        ),
        "per-row scale (1, b)": (b, (b, *img), lambda s: base.generate(generator=s, **(kw | dict(cond_scale=per_row)))),
        f"image_size {rect}": (b, (b, *rect, 3), lambda s: base.generate(generator=s, image_size=rect, **kw)),
        f"image_size {square}": (b, (b, square, square, 3), lambda s: base.generate(generator=s, image_size=square, **kw)),
        "can_remask_prev_masked": (
            b, (b, *img), lambda s: remask.generate(generator=s, can_remask_prev_masked=True, **kw),
        ),
        "SelfCritic": (b, (b, *img), lambda s: self_critic.generate(generator=s, **kw)),
        "TokenCritic (depth 2)": (b, (b, *img), lambda s: token_critic.generate(generator=s, **kw)),
        "edit (centre half)": (b, (b, *img), lambda s: base.edit(images, edit_mask, generator=s, **kw)),
        "generate_reranked 4 x 4, logprob": (
            cb, (cb, *img), lambda s: base.generate_reranked(generator=s, num_candidates=4, score_method="logprob", **few),
        ),
        "generate_reranked 4 x 4, critic": (
            cb, (cb, *img),
            lambda s: token_critic.generate_reranked(generator=s, num_candidates=4, score_method="critic", **few),
        ),
        "Muse.edit 512px": (
            cb, (cb, SR_IMAGE, SR_IMAGE, 3),
            lambda s: muse.edit(sr_images, sr_edit_mask, generator=s, return_pil_images=False, **few),
        ),
        f"Muse(texts, rerank 2, {rect}, ids)": (
            cb, (cb, SR_IMAGE, SR_IMAGE * 3 // 2, 3),
            lambda s: muse(
                list(PROMPTS[:cb]), generator=s, rerank_candidates=2, image_size=rect, cond_via="ids",
                timesteps=STEPS, cond_scale=CFG, return_pil_images=False,
            ),
        ),
    }

    # every grid a decode returns, from any entry point, for the mask-id check
    decoded = []
    decode = MaskGit._decode

    def recording(self, **k):
        ids = decode(self, **k)
        decoded.append((self, ids))
        return ids

    counted = (fused_topk_gumbel_sample, qknorm_attend, attend, nearest_code)  # K1, K2, K4, K3
    results, runs = {}, {}
    MaskGit._decode = recording
    try:
        for name, (n_img, shape, run) in requests.items():
            with torch.inference_mode():
                run(torch.Generator(device="cuda").manual_seed(100))  # warm-up at the request's shapes
                times, counts = [], []
                for seed in range(3):
                    decoded.clear()
                    for fn in counted:
                        fn.launches = 0
                    gen = torch.Generator(device="cuda").manual_seed(seed)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = run(gen)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                    counts.append(tuple(fn.launches for fn in counted))
                    require(tuple(out.shape) == shape, f"{name}: output shape {tuple(out.shape)}, expected {shape}")
                    require(bool(torch.isfinite(out).all()), f"{name}: non-finite pixels")
                    require(decoded, f"{name}: no decode ran")
                    for model, ids in decoded:
                        require(int(ids.max()) < model.mask_id, f"{name}: a mask id is left in a decoded grid")
                    if name.startswith("edit"):
                        require(
                            known_tokens_kept(decoded[0][1].reshape(b, grid, grid), base.vae, images, edit_mask),
                            f"{name}: known tokens changed",
                        )
                    if name.startswith("Muse.edit"):
                        (_, low), (_, high) = decoded
                        r = SR_IMAGE // IMAGE
                        low_src = _resize_nearest(sr_images, IMAGE, IMAGE)
                        low_mask = sr_edit_mask.reshape(cb, IMAGE, r, IMAGE, r).any(dim=4).any(dim=2)
                        require(
                            known_tokens_kept(low.reshape(cb, grid, grid), base.vae, low_src, low_mask),
                            f"{name}: base known tokens changed",
                        )
                        require(
                            known_tokens_kept(high.reshape(cb, sr_grid, sr_grid), superres.vae, sr_images, sr_edit_mask),
                            f"{name}: super-res known tokens changed",
                        )
            k1, k2, k4, k3 = counts[0]
            # the LFQ tokenizer of an edit's source searches no codebook
            require(k1 > 0 and k2 > 0 and k4 == k3 == 0, f"{name}: K1 +{k1}, K2 +{k2}, K4 +{k4}, K3 +{k3} launches")
            require(len(set(counts)) == 1, f"{name}: launches differ between requests: {counts}")
            dt = statistics.median(times)
            results[name] = dict(ms=dt * 1000, img_s=n_img / dt, k1=k1, k2=k2, k4=k4, k3=k3)
            runs[name] = dict(zip(("k1", "k2", "k4", "k3"), map(sum, zip(*counts))))  # all three requests
            log(
                f"[surfaces] {name}: b{n_img} T{STEPS} cfg{CFG:g} {n_img / dt:.3f} img/s (median of "
                f"{', '.join(f'{t * 1000:.1f}' for t in times)} ms); K1 +{k1}, K2 +{k2}, K4 +{k4}, K3 +{k3} a "
                f"request; output {shape}"
            )
            del out
    finally:
        MaskGit._decode = decode

    # what `Muse(cond_via="ids")` pays on every call: the stages hold two
    # VAE clones with equal weights, compared on the card, one flag read
    require(vaes_share_weights(superres.cond_vae, base.vae), "the cascade's VAE clones differ")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        vaes_share_weights(superres.cond_vae, base.vae)
    share_ms = (time.perf_counter() - t) * 100
    ctx["vaes_share_weights_ms"] = share_ms
    ctx["surfaces"] = results
    for tag in ("k1", "k2", "k4", "k3"):
        ctx[tag]["launches_per_surface_request"] = {n: r[tag] for n, r in results.items()}
        ctx["surface_launches"] = ctx.get("surface_launches", {}) | {tag: sum(r[tag] for r in runs.values())}
    log(
        f"[surfaces] {len(results)} requests ok: K1 and K2 launched in each, K4 and K3 in none, no mask id left, known tokens "
        f"kept; vaes_share_weights on the cascade's two VAE clones {share_ms:.3f} ms a call (mean of 10) | "
        f"{ctx['smi']} | models built {t_build:.1f}s"
    )


def phase_serving(torch, ctx):
    """The serving path at the base stage's full width (random weights from
    seed 0, TF32 off), through the entry points a deployment calls:

    (a) checkpoint: `save_module` of the base MaskGit (its VAE clone
        included) in the JAX package's msgpack format, with a manifest;
        `verify_manifest(require=True)`; `load_module` into a MaskGit built
        from seed 1. Every state-dict tensor must be equal, and one b16 T18
        `generate` from one seed must give equal ids and equal uint8 images
        from both models (cuDNN deterministic for that comparison).
    (b) `GeneratePipeline` b16, T18, CFG 3, T5 v1.1-base shape in front:
        warmup("all"), then 3 timed calls of 32 prompts (two batches each;
        T5 and the uint8 fetch timed by CUDA events around them), K1 +18
        and K2 +288 a batch, K3 = K4 = 0; one call with per-prompt scales
        and negative prompts; an edit of 4 images, the centre half masked,
        whose decoded grid keeps the sources' tokens outside the mask.
    (c) a cascade pipeline, b8: `cond_via` resolves to "ids"; one timed call
        of 8 prompts -> (8, 512, 512, 3) uint8.
    (d) `GenerateServer` on 127.0.0.1 (port 0, max_wait_ms 50, warmed on
        "all"): 48 one-prompt POST /generate from 16 client threads, every
        third with a `cond_scale`, every fourth with a `negative_prompt`;
        then one POST /edit of 2 images, GET /healthz and GET /stats. Every
        reply 200, every PNG (256, 256, 3) by the port's own decoder,
        coalesced batches, `backend_compiles` flat through the traffic.
    """
    import tempfile
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from muse_maskgit_pytorch_tpu_torch import MaskGit, Muse
    from muse_maskgit_pytorch_tpu_torch.ops.attention import attend, qknorm_attend
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code
    from muse_maskgit_pytorch_tpu_torch.serving import GeneratePipeline, _quantize_u8
    from muse_maskgit_pytorch_tpu_torch.serving_http import GenerateServer
    from muse_maskgit_pytorch_tpu_torch.utils import checkpoint
    from muse_maskgit_pytorch_tpu_torch.utils.png import decode_png, encode_png

    base = ctx.get("maskgit") or build_models(torch)
    ctx["maskgit"] = base
    superres = ctx.get("superres") or build_superres(torch, base.vae)
    ctx["superres"] = superres
    counted = (fused_topk_gumbel_sample, qknorm_attend, attend, nearest_code)  # K1, K2, K4, K3
    steps_k2 = STEPS * DEPTH * 2
    per_batch = (STEPS, steps_k2, 0, 0)
    launches = dict.fromkeys(("k1", "k2", "k4", "k3"), 0)

    def zero():
        for fn in counted:
            fn.launches = 0

    def read(batches):
        got = tuple(fn.launches for fn in counted)
        for tag, n in zip(launches, got):
            launches[tag] += n
        return got, tuple(n * batches for n in per_batch)

    def is_u8(out, shape):
        return isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.shape == shape

    # -- (a) the checkpoint round trip
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = Path(tmp) / "maskgit.msgpack"
        t = time.perf_counter()
        checkpoint.save_module(base, path)
        t_save = time.perf_counter() - t
        t = time.perf_counter()
        checkpoint.write_manifest(tmp, {path.name: checkpoint.manifest_entry(path, base)})
        require(checkpoint.verify_manifest(path, require=True), "the manifest did not verify the checkpoint")
        t_manifest = time.perf_counter() - t
        fresh = build_models(torch, seed=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        unused = checkpoint.load_module(fresh, path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t
        file_bytes = path.stat().st_size
    require(unused == [], f"the checkpoint holds leaves the port did not take: {unused[:5]}")
    mine, theirs = base.state_dict(), fresh.state_dict()
    require(mine.keys() == theirs.keys(), "the loaded model's state dict has other keys")
    differ = [k for k in mine if not torch.equal(mine[k], theirs[k])]
    require(not differ, f"{len(differ)} tensors differ after the round trip, e.g. {differ[:3]}")
    g = torch.Generator(device="cuda").manual_seed(0)
    text = torch.randn(SERVE_BATCH, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = []
        for model in (base, fresh):
            gen = torch.Generator(device="cuda").manual_seed(5)
            ids = model.generate(text_embeds=text, generator=gen, timesteps=STEPS, cond_scale=CFG, return_ids=True)
            with torch.inference_mode():
                outs.append((ids, _quantize_u8(model.vae.decode_from_ids(ids))))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    require(torch.equal(outs[0][0], outs[1][0]), "the loaded model sampled other tokens from one seed")
    require(torch.equal(outs[0][1], outs[1][1]), "the loaded model decoded other uint8 images from one seed")
    del fresh, mine, theirs, outs
    ckpt_s = (
        f"checkpoint: {file_bytes} bytes, save {t_save:.2f} s, manifest + verify {t_manifest:.2f} s, load "
        f"{t_load:.2f} s (read, sha256, decode, copy to the card); every tensor equal, b{SERVE_BATCH} T{STEPS} ids "
        f"and uint8 images equal"
    )

    # -- (b) the pipeline
    pipe = GeneratePipeline(
        base, batch_size=SERVE_BATCH, timesteps=STEPS, cond_scale=CFG, text_len=TEXT_LEN, return_pil=False
    )
    t_warm = pipe.warmup("all")
    warmup_s = dict(pipe.stats["warmup_seconds"])  # the server's warmup below writes them again
    warm_s = ", ".join(f"{k} {v:.2f}" for k, v in warmup_s.items())
    spans = {"t5": [], "fetch": []}

    def evented(name, fn):
        """fn, with CUDA events recorded around each call."""

        def run(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans[name].append((start, end))
            return out

        return run

    # the floor of a pipeline batch: the model's own b16 request from text
    # embeddings to uint8 images on the host, without T5 or the pipeline
    embeds, tmask = pipe._encode_prompts(list(PROMPTS[:SERVE_BATCH]))
    bare = []
    for seed in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = base.generate(
            text_embeds=embeds, text_mask=tmask, generator=torch.Generator(device="cuda").manual_seed(seed),
            timesteps=STEPS, cond_scale=CFG,
        )
        _quantize_u8(img).cpu()
        bare.append((time.perf_counter() - t) * 1000)
    bare_ms = statistics.median(bare)
    pipe._encode_prompts = evented("t5", pipe._encode_prompts)
    pipe._to_host = evented("fetch", pipe._to_host)
    prompts = [PROMPTS[i % len(PROMPTS)] for i in range(2 * SERVE_BATCH)]  # two batches a call
    calls = []
    for _ in range(3):
        for v in spans.values():
            v.clear()
        zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(prompts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got, want = read(2)
        require(got == want, f"pipeline call of two batches launched K1, K2, K4, K3 {got}, expected {want}")
        require(is_u8(out, (len(prompts), IMAGE, IMAGE, 3)), f"pipeline output {type(out)} {getattr(out, 'shape', '')}")
        part = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
        calls.append(dict(ms=dt * 1000, t5_ms=part["t5"], fetch_ms=part["fetch"]))
    call_ms = statistics.median(c["ms"] for c in calls)
    pipe_img_s = len(prompts) / call_ms * 1000
    t5_share = statistics.median(c["t5_ms"] / c["ms"] for c in calls)
    fetch_share = statistics.median(c["fetch_ms"] / c["ms"] for c in calls)

    # per-prompt scales and negative prompts in one batch
    scales = [2.0 if i % 2 else 5.0 for i in range(SERVE_BATCH)]
    negs = ["blurry, low quality" if i % 3 == 0 else None for i in range(SERVE_BATCH)]
    zero()
    t = time.perf_counter()
    mixed = pipe(prompts[:SERVE_BATCH], cond_scale=scales, negative_prompts=negs)
    per_row_ms = (time.perf_counter() - t) * 1000
    got, want = read(1)
    require(got == want, f"the per-row call launched K1, K2, K4, K3 {got}, expected {want}")
    require(is_u8(mixed, (SERVE_BATCH, IMAGE, IMAGE, 3)), "per-row call output")

    # an edit of 4 images: the grid a decode returns keeps the sources' tokens
    src = (torch.rand(4, IMAGE, IMAGE, 3, generator=torch.Generator().manual_seed(9)) * 255).to(torch.uint8)
    mask = centre_half_mask(4, IMAGE, IMAGE)
    decoded, decode = [], MaskGit._decode

    def recording(self, **k):
        decoded.append(decode(self, **k))
        return decoded[-1]

    MaskGit._decode = recording
    try:
        zero()
        t = time.perf_counter()
        edited = pipe.edit(src.numpy(), mask.cpu().numpy(), list(PROMPTS[:4]))
        edit_ms = (time.perf_counter() - t) * 1000
    finally:
        MaskGit._decode = decode
    got, want = read(1)
    require(got == want, f"the pipeline's edit launched K1, K2, K4, K3 {got}, expected {want}")
    require(is_u8(edited, (4, IMAGE, IMAGE, 3)), "edit output")
    grid = IMAGE >> VAE_LAYERS
    with torch.inference_mode():
        kept = known_tokens_kept(
            decoded[0].reshape(SERVE_BATCH, grid, grid)[:4], base.vae, src.to("cuda").float() / 255.0, mask
        )
    require(kept, "the pipeline's edit changed tokens outside the mask")

    # -- (c) the cascade pipeline
    cascade = GeneratePipeline(
        Muse(base, superres), batch_size=SERVE_CAS_BATCH, timesteps=STEPS, cond_scale=CFG, text_len=TEXT_LEN,
        return_pil=False,
    )
    require(cascade.cond_via == "ids", f"the cascade pipeline resolved cond_via to {cascade.cond_via!r}")
    cascade.warmup("generate")
    zero()
    torch.cuda.synchronize()
    t = time.perf_counter()
    cas_out = cascade(list(PROMPTS[:SERVE_CAS_BATCH]))
    cas_ms = (time.perf_counter() - t) * 1000
    got = tuple(fn.launches for fn in counted)
    require(got == (2 * STEPS, 2 * steps_k2, 0, 0), f"the cascade batch launched K1, K2, K4, K3 {got}")
    require(is_u8(cas_out, (SERVE_CAS_BATCH, SR_IMAGE, SR_IMAGE, 3)), "cascade pipeline output")
    del cascade, cas_out

    # -- (d) the HTTP server
    server = GenerateServer(pipe, host="127.0.0.1", port=0, max_wait_ms=50.0, warmup="all")
    server.start()
    url = f"http://127.0.0.1:{server.port}"

    def http(path, payload=None):
        req = urllib.request.Request(
            url + path, data=None if payload is None else json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="GET" if payload is None else "POST",
        )
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                status, body = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            status, body = e.code, json.loads(e.read())
        return status, body, time.perf_counter() - t

    def generate_request(i):
        payload = {"prompts": [PROMPTS[i % len(PROMPTS)]]}
        if i % 3 == 0:
            payload["cond_scale"] = 2.0 if i % 2 else 5.0
        if i % 4 == 0:
            payload["negative_prompt"] = "blurry, low quality"
        return http("/generate", payload)

    try:
        _, before, _ = http("/stats")
        zero()
        t = time.perf_counter()
        with ThreadPoolExecutor(BURST_CLIENTS) as pool:
            replies = list(pool.map(generate_request, range(BURST_REQUESTS)))
        burst_s = time.perf_counter() - t
        burst_launches = tuple(fn.launches for fn in counted)
        _, after, _ = http("/stats")
        pngs = [r[1]["images"] for r in replies if r[0] == 200]
        edit_payload = {
            "prompts": list(PROMPTS[:2]),
            "images": [base64.b64encode(encode_png(im)).decode() for im in src.numpy()[:2]],
            "masks": [base64.b64encode(encode_png(m)).decode() for m in mask[:2].cpu().numpy().astype(np.uint8) * 255],
        }
        edit_status, edit_body, edit_s = http("/edit", edit_payload)
        health_status, health, _ = http("/healthz")
        stats_status, final, _ = http("/stats")
    finally:
        server.stop()
    statuses = [r[0] for r in replies]
    require(statuses.count(200) == BURST_REQUESTS, f"burst replies {sorted(set(statuses))}, errors {[r[1] for r in replies if r[0] != 200][:2]}")
    require(all(len(p) == 1 for p in pngs), "a reply without exactly one image")
    for b64 in [p[0] for p in pngs] + (edit_body.get("images") or []):
        require(decode_png(base64.b64decode(b64)).shape == (IMAGE, IMAGE, 3), "a reply's PNG is not an RGB image of the model's size")
    require(edit_status == 200 and len(edit_body["images"]) == 2, f"/edit replied {edit_status}: {edit_body}")
    require(health_status == 200 and health["ok"] and set(health["warm_surfaces"]) == set(pipe.WARMUP_SURFACES), f"/healthz {health}")
    require(stats_status == 200, "/stats")
    batches = after["batches"] - before["batches"]
    coalesced = after["coalesced_batches"] - before["coalesced_batches"]
    require(coalesced > 0, "the server coalesced no requests")
    require(
        after["backend_compiles"] == before["backend_compiles"] == final["backend_compiles"],
        f"kernel builds or loads during the traffic: {before['backend_compiles']} -> {final['backend_compiles']}",
    )
    want = tuple(n * batches for n in per_batch)
    require(burst_launches == want, f"the burst's {batches} batches launched K1, K2, K4, K3 {burst_launches}, expected {want}")
    for tag, n in zip(launches, burst_launches):
        launches[tag] += n
    latency = sorted(r[2] * 1000 for r in replies)
    p50, p95 = statistics.median(latency), statistics.quantiles(latency, n=20)[18]
    fill = (after["images"] - before["images"]) / batches
    burst_img_s = BURST_REQUESTS / burst_s
    # the pipeline's own seconds a batch during the burst (T5 excluded)
    burst_batch_ms = (after["pipeline"]["generate_seconds"] - before["pipeline"]["generate_seconds"]) / batches * 1000

    ctx["serving"] = dict(
        checkpoint=dict(bytes=file_bytes, save_s=t_save, manifest_s=t_manifest, load_s=t_load),
        pipeline=dict(
            batch=SERVE_BATCH, img_s=pipe_img_s, call_ms=[c["ms"] for c in calls], t5_share=t5_share,
            fetch_share=fetch_share, warmup_s=warmup_s, per_row_call_ms=per_row_ms, bare_generate_ms=bare_ms,
            edit_ms=edit_ms,
        ),
        cascade=dict(batch=SERVE_CAS_BATCH, ms=cas_ms, img_s=SERVE_CAS_BATCH / cas_ms * 1000),
        server=dict(
            requests=BURST_REQUESTS, clients=BURST_CLIENTS, img_s=burst_img_s, p50_ms=p50, p95_ms=p95,
            batches=batches, coalesced_batches=coalesced, avg_batch_fill=fill, edit_ms=edit_s * 1000,
            batch_ms=burst_batch_ms,
        ),
    )
    ctx["serving_launches"] = launches
    for tag, n in zip(("k1", "k2", "k4", "k3"), per_batch):
        ctx[tag]["launches_per_serving_batch"] = n
    call_s = ", ".join(f"{c['ms']:.1f}" for c in calls)
    log(
        f"[serving] {ckpt_s} | pipeline b{SERVE_BATCH} T{STEPS} cfg{CFG:g} text_len {TEXT_LEN}: warmup all "
        f"{t_warm:.2f} s ({warm_s}); {len(prompts)} prompts {pipe_img_s:.3f} img/s (median of {call_s} ms a call), T5 {t5_share:.1%} and uint8 fetch "
        f"{fetch_share:.1%} of a call (CUDA events), the model's own b{SERVE_BATCH} request from embeddings to "
        f"uint8 on the host {bare_ms:.1f} ms (median of 3); K1 +{per_batch[0]}, K2 +{per_batch[1]}, K4 +0, K3 +0 a batch; "
        f"per-row scales and negatives b{SERVE_BATCH} {per_row_ms:.1f} ms; edit 4 images {edit_ms:.1f} ms, known "
        f"tokens kept | cascade pipeline b{SERVE_CAS_BATCH} cond_via=ids: {cas_ms:.1f} ms, "
        f"{SERVE_CAS_BATCH / cas_ms * 1000:.3f} img/s, {(SERVE_CAS_BATCH, SR_IMAGE, SR_IMAGE, 3)} uint8 | server max_wait 50 ms: "
        f"{BURST_REQUESTS} requests from {BURST_CLIENTS} clients, all 200, {burst_img_s:.3f} img/s over the burst "
        f"({burst_s:.2f} s), latency p50 {p50:.1f} ms p95 {p95:.1f} ms, {batches} batches ({coalesced} coalesced), "
        f"average fill {fill:.2f}, {burst_batch_ms:.1f} ms of pipeline time a batch, backend_compiles flat at {final['backend_compiles']}; /edit of 2 images "
        f"{edit_s * 1000:.1f} ms; PNGs {IMAGE} x {IMAGE} RGB by the port's decoder | {ctx['smi']}"
    )


def phase_train(torch, ctx):
    """MaskGit training at `bench_sweep.py`'s exp_train_mfu width: the ids
    path, batch 64, seq 256, text 64 x 768, dim 512, depth 8, 8 x 64 heads,
    vocab 65536, bf16, self-conditioning on, EMA on, one micro-batch a step.

    (a) K2's gradient at the train shapes: the base stage's self (64, 256,
        8, 64) x 256 keys and cross x 64 text keys with a CFG-dropped row,
        the super-res stage's self (16, 1024) x 1024 and cross x 320 keys
        (the null half's text keys off), and the base stage's self and cross
        at the 4 heads a rank of `[tensor]` runs, f32 and bf16. One forward and one
        backward launch a call; the forward output against
        `qknorm_attend_plain` (1e-4 f32, K2_BF16_FROM_F32 bf16; bf16 also
        against the TPU-rounding form within BF16_VS_ROUNDED; the dropped row
        gives null_v); the backward kernel's gradients against
        `qknorm_attend_backward_plain` (1e-4 of each gradient's max f32,
        K2_BWD_BF16_FROM_F32 bf16, and K2_BWD_BF16_VS_ROUNDED against its
        `round_to` form), a repeat bit-identical. The backward alone by graph
        replay beside its bound, the plain backward and SDPA's backward on
        the normalised inputs (the attention core only); forward + backward
        by CUDA events beside SDPA's; the forward alone by graph replay
        beside SDPA's forward and its bound. Each route's kernels by name as
        torch.profiler saw one call (the forward: f32 `qknorm_fwd_f32`, bf16
        `flash_core_kernel<64, true>`; the backward: its route's list).
    (b) one f32 `MaskGit.forward` + backward with the kernels and under
        `plain_path()`, on the same draws: losses to 1e-4 relative, each
        gradient leaf to 1e-3 of its largest |g|.
    (c) `MaskGitTrainer` in bf16 (lr 1e-4, warmup 2, EMA on; the model
        holds the VAE clone for (e) and never runs it): 2 warm-up steps, 10
        timed steps, launches per step (K2 16, or 32 with the
        self-conditioning pass; K2's backward 16; K1 = K3 = K4 = 0), ms/step,
        img/s, MFU (`maskgit_train_flops` / step / 989e12), peak memory; the
        step in turns with the backward kernel and with the plain backward
        patched in here (kernel, plain, plain, kernel, 5 steps each); then a
        memorisation check at depth 2, lr 1e-3, one batch for 8 steps. The
        super-res stage's trainer at the same width (b16, seq 1024, 256
        conditioning ids, text 64 x 768, no self-conditioning): 2 warm-up and
        5 timed steps, ms/step, img/s, peak memory, K2 16 a step and its
        backward 16, every backward call on the bf16 split route.
    (d) resume on the card at depth 2: 2 steps, save, a new trainer with
        `auto_resume`, 2 steps, against 4 straight steps; then the EMA model
        through `save_module` -> `load_module` into a fresh MaskGit gives
        equal logits.
    (e) `save_sample_results` of 4 prompts (T18, CFG 3) to a PNG, and
        `train_from_shards` for 2 steps from 2 shards with captions written
        on the spot.
    """
    import shutil
    import tempfile

    import numpy as np

    from muse_maskgit_pytorch_tpu_torch.models.maskgit import TrainDraws
    from muse_maskgit_pytorch_tpu_torch.ops import attention
    from muse_maskgit_pytorch_tpu_torch.ops.attention import (
        BF16_VS_ROUNDED,
        K2_BF16_FROM_F32,
        K2_BWD_BF16_FROM_F32,
        K2_BWD_BF16_VS_ROUNDED,
        attend,
        qknorm_attend,
        qknorm_attend_backward,
        qknorm_attend_backward_plain,
        qknorm_attend_plain,
        qknorm_attend_with_lse,
    )
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code
    from muse_maskgit_pytorch_tpu_torch.training import MaskGitTrainer, write_shard
    from muse_maskgit_pytorch_tpu_torch.utils import checkpoint
    from muse_maskgit_pytorch_tpu_torch.utils.metrics import H100_BF16_PEAK_FLOPS, maskgit_train_flops
    from muse_maskgit_pytorch_tpu_torch.utils.png import decode_png

    dev = "cuda"
    t_phase = time.perf_counter()
    counted = dict(k1=fused_topk_gumbel_sample, k2=qknorm_attend, k3=nearest_code, k4=attend)
    g = torch.Generator(device=dev).manual_seed(8)

    # -- (a) K2's gradient at the train shapes: the forward and the backward kernel
    def grad_inputs(b, n, m, dtype, mask_kind, heads):
        hd = heads * DIM_HEAD
        q = torch.randn(b, n, hd, generator=g, device=dev).to(dtype).reshape(b, n, heads, DIM_HEAD)
        kv = torch.randn(b, m, 2 * hd, generator=g, device=dev).to(dtype)
        k, v = (t.reshape(b, m, heads, DIM_HEAD) for t in kv.chunk(2, dim=-1))  # views of one to_kv output
        nk, nv = (torch.randn(heads, DIM_HEAD, generator=g, device=dev).to(dtype) for _ in range(2))
        qs, ks = (1 + 0.1 * torch.randn(DIM_HEAD, generator=g, device=dev) for _ in range(2))
        mask = None
        if mask_kind == "dropped":
            mask = torch.ones(b, m, dtype=torch.bool, device=dev)
            mask[0] = False  # a CFG-dropped row: the null position only
        elif mask_kind == "superres":
            # the super-res cross-attention under CFG: 64 text keys, then 256
            # conditioning keys; the null half's text keys are off
            mask = torch.ones(b, m, dtype=torch.bool, device=dev)
            mask[b // 2 :, : m - COND_TOKENS] = False
        cot = torch.randn(b, n, heads, DIM_HEAD, generator=g, device=dev).to(dtype)
        return [q, k, v, nk, nv, qs, ks], mask, cot

    def fwd_bwd(fn, args, mask, cot, **kw):
        leaves = [t.detach().requires_grad_() for t in args]
        out = fn(*leaves, mask=mask, **kw)
        return out, torch.autograd.grad(out, leaves, cot)

    def rel_err(got, want):
        return max(
            (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
            for a, b in zip(got, want) if b.numel()
        )

    # the base stage's self- and cross-attention (a CFG-dropped row), and the
    # super-res stage's at b16 (the JAX trainer trains it with paired
    # conditioning ids): self over 1024 positions, cross over 64 text + 256
    # conditioning keys with the null half's text keys off; then the base
    # stage's at the 4 heads a tensor rank of `[tensor]` runs (h / 2)
    tp_heads = HEADS // TP_WORLD
    grad_shapes = {
        "self": (TRAIN_BATCH, SEQ, SEQ, None, HEADS),
        "cross": (TRAIN_BATCH, SEQ, TEXT_LEN, "dropped", HEADS),
        "sr_self": (CAS_BATCH, SR_SEQ, SR_SEQ, None, HEADS),
        "sr_cross": (CAS_BATCH, SR_SEQ, TEXT_LEN + COND_TOKENS, "superres", HEADS),
        "self_h4": (TRAIN_BATCH, SEQ, SEQ, None, tp_heads),
        "cross_h4": (TRAIN_BATCH, SEQ, TEXT_LEN, "dropped", tp_heads),
    }
    grad_errs, grad_times = {}, {}
    for name, (b, n, m, mask_kind, heads) in grad_shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            args, mask, cot = grad_inputs(b, n, m, dtype, mask_kind, heads)
            before = qknorm_attend.launches, qknorm_attend_backward.launches
            out, got = fwd_bwd(qknorm_attend, args, mask, cot)
            launched = qknorm_attend.launches - before[0], qknorm_attend_backward.launches - before[1]
            require(launched == (1, 1), f"K2's gradient route launched (forward, backward) {launched}, not (1, 1)")
            _, again = fwd_bwd(qknorm_attend, args, mask, cot)
            require(all(torch.equal(a, c) for a, c in zip(got, again)), f"K2 backward {name} {dtype}: a repeat differs")
            ref = qknorm_attend_plain(*args, mask=mask)
            want = qknorm_attend_backward_plain(cot, *args, mask=mask)
            torch.cuda.synchronize()
            # K2's forward at the train shapes, with the limits of `[k2]`
            tol = 1e-4 if f32 else K2_BF16_FROM_F32
            out_err = (out.float() - ref.float()).abs().max().item()
            require(math.isfinite(out_err) and out_err <= tol, f"K2 forward {name} {dtype}: max abs err {out_err:.3g} > {tol:g}")
            if mask_kind == "dropped":
                null_err = (out[0].float() - args[4].float()[None, None]).abs().max().item()
                require(null_err <= tol, f"K2 forward {name} {dtype}: the dropped row is {null_err:.3g} from null_v")
            # the backward kernel against the plain backward, relative to each gradient's max
            tol = 1e-4 if f32 else K2_BWD_BF16_FROM_F32
            err = rel_err(got, want)
            require(math.isfinite(err) and err <= tol, f"K2 backward {name} {dtype}: {err:.3g} of max |g| > {tol:g}")
            errs = {"fwd vs plain": out_err, "bwd vs plain": err}
            if not f32:
                rounded_out = qknorm_attend_plain(*args, mask=mask, round_to=torch.bfloat16)
                rout = (out.float() - rounded_out.float()).abs().max().item()
                require(rout <= BF16_VS_ROUNDED, f"K2 forward {name} bf16 vs the TPU-rounding plain: {rout:.3g}")
                rounded = qknorm_attend_backward_plain(cot, *args, mask=mask, round_to=torch.bfloat16)
                rerr = rel_err(got, rounded)
                require(rerr <= K2_BWD_BF16_VS_ROUNDED, f"K2 backward {name} bf16 vs the rounding plain: {rerr:.3g}")
                errs.update({"fwd vs rounded": rout, "bwd vs rounded": rerr})
                del rounded_out, rounded
            grad_errs[(name, dtype)] = errs
            del ref, want, again
            keys_on = float(mask.sum()) if mask is not None else b * m
            peak = PEAK_F32 if f32 else PEAK_BF16_TC
            # forward + backward: QK^T and PV forward; S, dP, dV, dQ, dK backward
            # (4 + 10 n m d a head); the backward alone: 10 n m d
            lse_bytes = b * heads * n * 4
            fb_bound = bound(14.0 * heads * n * keys_on * DIM_HEAD, nbytes(*args, mask, cot) + 2 * nbytes(args[0]) + nbytes(*args[1:3]) + lse_bytes, peak)
            bwd_bound = bound(10.0 * heads * n * keys_on * DIM_HEAD, nbytes(*args, mask, cot, out) + lse_bytes + nbytes(*args[:3]), peak)
            leaves = [t.detach().requires_grad_() for t in args]
            fwd_out, lse = qknorm_attend_with_lse(*args, mask=mask)
            # SDPA on the normalised inputs with the null key and value in
            # front: the attention core only (no mask), its flash backward
            qn, kn, nkn = (t.float() / t.float().norm(dim=-1, keepdim=True) for t in (args[0], args[1], args[3]))
            qn = (qn * args[5] * 8.0).to(dtype).transpose(1, 2).detach().requires_grad_()
            kn = torch.cat([nkn.expand(b, 1, heads, DIM_HEAD), kn * args[6]], 1).to(dtype).transpose(1, 2)
            vn = torch.cat([args[4].expand(b, 1, heads, DIM_HEAD), args[2]], 1).transpose(1, 2)
            kn, vn = kn.detach().requires_grad_(), vn.detach().requires_grad_()
            sdpa_cot = cot.transpose(1, 2)

            def sdpa_step():
                o = torch.nn.functional.scaled_dot_product_attention(qn, kn, vn, scale=1.0)
                torch.autograd.grad(o, (qn, kn, vn), sdpa_cot)

            plain_iters = 3 if n > SEQ else 10
            bwd_call = lambda: qknorm_attend_backward(cot, *args, fwd_out, lse, mask=mask)  # noqa: E731
            one_pass = attention._backward_one_pass(n, dtype)
            bwd_names = kernels_by_name(torch, bwd_call, r"qknorm_bwd_\w+")
            if bwd_names is not None:
                # the f32 route: the key-stationary kernel and the query side,
                # then the two fixed-order sums; bf16 one pass, or the split route
                want_names = (
                    BWD_F32_KERNELS if f32 else ["qknorm_bwd_onepass_bf16"] if one_pass else BWD_BF16_SPLIT_KERNELS
                )
                require(bwd_names == want_names, f"K2 backward {name} {dtype}: the profiler saw {bwd_names} in a call")
            fwd_call = lambda: qknorm_attend(*args, mask=mask)  # noqa: E731
            fwd_names = kernels_by_name(torch, fwd_call, r"qknorm_fwd_f32|flash_core_kernel<64, true>")
            if fwd_names is not None:
                # f32: the CUDA-core kernel, one launch a call; bf16: the Hopper core's qk-norm instance
                want_names = [F32_FWD_KERNEL if f32 else "flash_core_kernel<64, true>"]
                require(fwd_names == want_names, f"K2 forward {name} {dtype}: the profiler saw {fwd_names} in a call")
            sdpa_fwd = lambda: torch.nn.functional.scaled_dot_product_attention(qn, kn, vn, scale=1.0)  # noqa: E731
            sdpa_fwd_ms = graph_ms(sdpa_fwd)  # under autograd, as the pair it is taken from
            qd, kd, vd = qn.detach(), kn.detach(), vn.detach()
            # the forward alone beside K2's, both with no gradient: QK^T and PV
            # over the keys left on, 4 n m d a head; q, k, v, mask in and out out
            sdpa_fwd_alone_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, scale=1.0))
            fwd_bound = bound(4.0 * heads * n * keys_on * DIM_HEAD, nbytes(*args, mask) + nbytes(args[0]), peak)
            grad_times[(name, dtype)] = dict(
                bwd_ms=graph_ms(bwd_call),
                bwd_host_us=host_us(bwd_call),
                bwd_kernels=None if bwd_names is None else len(bwd_names),
                bwd_kernel_names=bwd_names,
                bwd_plain_ms=cuda_ms(lambda: qknorm_attend_backward_plain(cot, *args, mask=mask), iters=plain_iters, warmup=1),
                # SDPA's backward: its forward + backward less its forward,
                # both by graph replay (a backward runs on its forward's stream,
                # so the pair is captured together)
                bwd_library_ms=graph_ms(sdpa_step) - sdpa_fwd_ms,
                bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
                ms=cuda_ms(lambda: torch.autograd.grad(qknorm_attend(*leaves, mask=mask), leaves, cot), iters=20),
                fwd_ms=graph_ms(fwd_call), fwd_kernel_names=fwd_names,
                fwd_library_ms=sdpa_fwd_alone_ms, fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                plain_ms=cuda_ms(lambda: torch.autograd.grad(qknorm_attend_plain(*leaves, mask=mask), leaves, cot), iters=plain_iters, warmup=1),
                library_ms=cuda_ms(sdpa_step, iters=20),
                bound_ms=fb_bound[0], bound_by=fb_bound[1],
            )
            t_now = grad_times[(name, dtype)]
            t_now["bwd_vs_sdpa"] = t_now["bwd_ms"] / t_now["bwd_library_ms"]
            if not f32:  # the bf16 kernels: where a block's time goes
                t_now["bwd_clocks"] = attention.backward_part_clocks(cot, *args, fwd_out, lse, mask=mask)
            del args, leaves, qn, kn, vn, qd, kd, vd, out, got, fwd_out, lse
    bf = torch.bfloat16

    def tline(name, dtype):
        t, e = grad_times[(name, dtype)], grad_errs[(name, dtype)]
        errs = ", ".join(f"{k} {v:.2g}" for k, v in e.items())
        return (
            f"{str(dtype)[6:]}: backward {t['bwd_ms']:.4f} ms (graph replay; kernels a call by the profiler: "
            f"{'not measured' if t['bwd_kernels'] is None else ' + '.join(t['bwd_kernel_names'])}, "
            f"{t['bwd_host_us']:.1f} us of host a call to enqueue) vs plain {t['bwd_plain_ms']:.3f}, SDPA "
            f"backward {t['bwd_library_ms']:.4f} (core only; ours {t['bwd_vs_sdpa']:.2f}x its time), bound "
            f"{t['bwd_bound_ms']:.4f} ({t['bwd_bound_by']}, {t['bwd_bound_ms'] / t['bwd_ms']:.0%}); fwd+bwd {t['ms']:.4f} ms (eager) vs plain {t['plain_ms']:.3f}, "
            f"SDPA {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']}); forward alone {t['fwd_ms']:.4f} "
            f"ms (graph replay; its kernels a call by the profiler: "
            f"{'not measured' if t['fwd_kernel_names'] is None else ' + '.join(t['fwd_kernel_names'])}) vs SDPA's forward {t['fwd_library_ms']:.4f} (core only; ours "
            f"{t['fwd_ms'] / t['fwd_library_ms']:.2f}x its time), bound {t['fwd_bound_ms']:.4f} ({t['fwd_bound_by']}, "
            f"{t['fwd_bound_ms'] / t['fwd_ms']:.0%}); {errs}"
        )

    def clocks_line(name):
        out = []
        for kernel, c in grad_times[(name, bf)].get("bwd_clocks", {}).items():
            total = sum(c["parts"].values())
            parts = ", ".join(f"{k} {v:.0f} ({v / total:.0%})" for k, v in c["parts"].items())
            out.append(
                f" [{labels[name]} bf16, {kernel}'s -DQKNORM_BWD_TIMING build: SM clocks a block by part, "
                f"{parts}; a block {c['block_ns'] / 1000:.2f} us, {c['concurrent']} at once, the kernel's span "
                f"{c['span_ns'] / 1000:.1f} us]"
            )
        return "".join(out)

    labels = {
        "self": "self (64,256,8,64)x256", "cross": "cross (64,256|64) with a dropped row (null_v)",
        "self_h4": "a tensor rank's self (64,256,4,64)x256", "cross_h4": "a tensor rank's cross (64,256|64) at 4 heads",
        "sr_self": f"super-res self ({CAS_BATCH},1024,8,64)x1024",
        "sr_cross": f"super-res cross ({CAS_BATCH},1024|320), the null half's text keys off",
    }
    log(
        f"[train] K2's gradient ok (K2 forward with the row logsumexp + the backward kernel, 1 + 1 launches a call, "
        f"a repeat bit-identical; forward errors max abs, backward errors relative to each gradient's max |g|, "
        f"against qknorm_attend_backward_plain; limits f32 1e-4, bf16 {K2_BWD_BF16_FROM_F32:g} vs f32 plain, "
        f"{K2_BWD_BF16_VS_ROUNDED:g} vs the rounding plain): "
        + " | ".join(f"{labels[nm]} {tline(nm, torch.float32)}; {tline(nm, bf)}" for nm in grad_shapes)
        + "".join(clocks_line(nm) for nm in grad_shapes)
        + f" | {ctx['smi']}"
    )

    # -- (b) one f32 step on both routes, the same draws
    gcpu = torch.Generator().manual_seed(0)
    ids = torch.randint(0, VOCAB, (TRAIN_BATCH, SEQ), generator=g, device=dev)
    te = torch.randn(TRAIN_BATCH, TEXT_LEN, TEXT_DIM, generator=g, device=dev)
    tm = torch.arange(TEXT_LEN, device=dev)[None] < torch.randint(8, TEXT_LEN + 1, (TRAIN_BATCH, 1), generator=g, device=dev)
    te = te * tm[..., None]
    model32 = build_models(torch, dtype=torch.float32, with_vae=False, self_cond=True)
    while True:  # draws that take the self-conditioning pass and drop some rows' text
        draws = TrainDraws.draw(TRAIN_BATCH, SEQ, VOCAB, critic=False, generator=gcpu, device=dev)
        if float(draws.self_cond_u) < model32.self_cond_prob:
            break
    trainable = [p for p in model32.parameters() if p.requires_grad]

    def loss_and_grads():
        for p in trainable:
            p.grad = None
        loss = model32(ids, text_embeds=te, text_mask=tm, draws=draws)
        loss.backward()
        return loss.item(), [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p) for p in trainable]

    before = qknorm_attend.launches
    loss_k, grads_k = loss_and_grads()
    k2_f32 = qknorm_attend.launches - before
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    leaf_err = max(
        (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(grads_k, grads_p)
    )
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    require(k2_f32 == 2 * 2 * DEPTH, f"the f32 step launched K2 {k2_f32} times, expected {4 * DEPTH}")
    require(loss_rel <= 1e-4, f"f32 step: kernel loss {loss_k} vs plain {loss_p}")
    require(leaf_err <= 1e-3, f"f32 step: a gradient leaf differs by {leaf_err:.3g} of its max")
    kept = int((draws.keep_u >= model32.cond_drop_prob).sum())
    log(
        f"[train] f32 step, kernels vs plain on the same draws ({kept}/{TRAIN_BATCH} rows keep their text, "
        f"self-conditioning on, K2 +{k2_f32}): loss {loss_k:.6f} vs {loss_p:.6f} ({loss_rel:.2g} relative), "
        f"gradients within {leaf_err:.2g} of each leaf's max over {len(trainable)} leaves"
    )
    del model32, trainable, grads_k, grads_p, draws

    # -- (c) the bf16 trainer at full width
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=scratch))
    batch = (ids[None], te[None], tm[None])
    t0 = time.perf_counter()
    model = build_models(torch, self_cond=True)
    trainer = MaskGitTrainer(
        model, num_train_steps=10**6, batch_size=TRAIN_BATCH, lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
        results_folder=str(tmp / "bf16"), save_model_every=10**9, sample_texts=list(PROMPTS[:4]),
        sample_kwargs=dict(timesteps=STEPS, cond_scale=CFG),
    )
    t_build = time.perf_counter() - t0
    logs = [trainer.train_step_arrays(*batch) for _ in range(TRAIN_WARM)]
    for fn in (*counted.values(), qknorm_attend_backward):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    per_step, bwd_steps = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = {k: fn.launches for k, fn in counted.items()}
        bwd_before = qknorm_attend_backward.launches
        logs.append(trainer.train_step_arrays(*batch))
        per_step.append({k: fn.launches - before[k] for k, fn in counted.items()})
        bwd_steps.append(qknorm_attend_backward.launches - bwd_before)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    train_launches = {k: fn.launches for k, fn in counted.items()}
    train_bwd_launches = qknorm_attend_backward.launches
    require(all(n == 2 * DEPTH for n in bwd_steps), f"K2 backward launches per step {bwd_steps}, expected {2 * DEPTH}")

    # the within-call pair: the step with the backward kernel and with the
    # plain backward patched in here (the package has no switch for it), in
    # turns kernel, plain, plain, kernel
    def timed_steps(count=5):
        trainer.train_step_arrays(*batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(count):
            trainer.train_step_arrays(*batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / count * 1000

    kernel_backward = attention._qknorm_backward_launch

    def plain_backward(g_, q, k, v, nk, nv, qs, ks, bias, out, lse, scale):
        return attention._qknorm_backward_plain(g_, q, k, v, nk, nv, qs, ks, bias, scale)

    ab = []
    for leg in ("kernel", "plain", "plain", "kernel"):
        attention._qknorm_backward_launch = plain_backward if leg == "plain" else kernel_backward
        try:
            ab.append((leg, timed_steps()))
        finally:
            attention._qknorm_backward_launch = kernel_backward
    losses = [l["loss"] for l in logs]
    norms = [l["grad_norm"] for l in logs]
    require(all(math.isfinite(x) for x in losses + norms), f"non-finite losses {losses} or grad norms {norms}")
    k2_steps = [s["k2"] for s in per_step]
    require(all(n in (2 * DEPTH, 4 * DEPTH) for n in k2_steps), f"K2 launches per step {k2_steps}")
    for k in ("k1", "k3", "k4"):
        require(all(s[k] == 0 for s in per_step), f"{k.upper()} launched in a train step: {per_step}")
    require(logs[0]["lr"] == 0.0, f"the first step's lr is {logs[0]['lr']}, not 0 under the warmup")
    flops = maskgit_train_flops(
        batch=TRAIN_BATCH, seq_len=SEQ, text_len=TEXT_LEN, dim=DIM, depth=DEPTH, vocab=VOCAB, self_cond=True
    )
    mfu = flops / step_s / H100_BF16_PEAK_FLOPS
    lrs = ", ".join(f"{x.get('lr', TRAIN_LR):.2e}" for x in logs[:4])
    log(
        f"[train] MaskGitTrainer bf16 b{TRAIN_BATCH} seq {SEQ} text {TEXT_LEN}x{TEXT_DIM} dim {DIM} depth {DEPTH} "
        f"vocab {VOCAB}, self-cond, EMA: {step_s * 1000:.2f} ms/step over {TRAIN_STEPS} steps after {TRAIN_WARM}, "
        f"{TRAIN_BATCH / step_s:.2f} img/s, MFU {mfu:.2%} ({flops / 1e12:.3f} TFLOP a step at self-cond 0.9), peak "
        f"{peak_gib:.2f} GiB | launches per step K2 {k2_steps}, K2 backward {bwd_steps}, K1 = K3 = K4 = 0 | "
        f"in turns, ms/step (5 steps a leg): {', '.join(f'{leg} {ms:.2f}' for leg, ms in ab)} | loss "
        f"{', '.join(f'{x:.4f}' for x in losses)} | grad norm {', '.join(f'{x:.3f}' for x in norms)} | lr "
        f"{lrs}, ... | {ctx['smi']} | built {t_build:.1f}s"
    )

    # the super-res stage's bf16 step at the same width (seq 1024, 256
    # conditioning ids, no self-conditioning): K2 at n = 1024, so every
    # backward call takes the split route
    sr_trainer = MaskGitTrainer(
        build_superres(torch, None), num_train_steps=10**6, batch_size=CAS_BATCH, lr=TRAIN_LR,
        warmup_steps=TRAIN_WARMUP, results_folder=str(tmp / "superres"), save_model_every=10**9,
    )
    sr_ids = torch.randint(0, VOCAB, (CAS_BATCH, SR_SEQ), generator=g, device=dev)
    sr_cond = torch.randint(0, VOCAB, (1, CAS_BATCH, COND_TOKENS), generator=g, device=dev)
    sr_batch = (sr_ids[None], te[None, :CAS_BATCH], tm[None, :CAS_BATCH])
    sr_logs = [sr_trainer.train_step_arrays(*sr_batch, cond_token_ids=sr_cond) for _ in range(SR_TRAIN_WARM)]
    sr_k2, sr_bwd = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(SR_TRAIN_STEPS):
        before = qknorm_attend.launches, qknorm_attend_backward.launches
        sr_logs.append(sr_trainer.train_step_arrays(*sr_batch, cond_token_ids=sr_cond))
        sr_k2.append(qknorm_attend.launches - before[0])
        sr_bwd.append(qknorm_attend_backward.launches - before[1])
    torch.cuda.synchronize()
    sr_step_s = (time.perf_counter() - t0) / SR_TRAIN_STEPS
    sr_peak = torch.cuda.max_memory_allocated() / 2**30
    sr_losses = [l["loss"] for l in sr_logs]
    require(not attention._backward_one_pass(SR_SEQ, torch.bfloat16), "the super-res step's backward is not on the split route")
    require(all(x == 2 * DEPTH for x in sr_k2) and all(x == 2 * DEPTH for x in sr_bwd),
            f"super-res step: K2 launches {sr_k2}, K2 backward {sr_bwd}, expected {2 * DEPTH} each")
    require(all(math.isfinite(x) for x in sr_losses + [l["grad_norm"] for l in sr_logs]), f"super-res losses {sr_losses}")
    log(
        f"[train] MaskGitTrainer bf16 super-res b{CAS_BATCH} seq {SR_SEQ} cond ids {COND_TOKENS} text {TEXT_LEN}x{TEXT_DIM} "
        f"dim {DIM} depth {DEPTH} vocab {VOCAB}, EMA: {sr_step_s * 1000:.2f} ms/step over {SR_TRAIN_STEPS} steps after "
        f"{SR_TRAIN_WARM}, {CAS_BATCH / sr_step_s:.2f} img/s, peak {sr_peak:.2f} GiB | launches per step K2 {sr_k2}, "
        f"K2 backward {sr_bwd} (the split route: {' + '.join(BWD_BF16_SPLIT_KERNELS)} a call) | loss "
        f"{', '.join(f'{x:.4f}' for x in sr_losses)} | {ctx['smi']}"
    )

    # memorisation: one fixed batch at depth 2, lr 1e-3
    small = MaskGitTrainer(
        build_models(torch, with_vae=False, seed=2, self_cond=True, depth=SMALL_DEPTH), num_train_steps=10**6,
        batch_size=TRAIN_BATCH, lr=SMALL_LR, results_folder=str(tmp / "memo"), save_model_every=10**9,
    )
    mem = [small.train_step_arrays(*batch)["loss"] for _ in range(8)]
    require(statistics.mean(mem[-3:]) < statistics.mean(mem[:3]), f"memorisation: losses did not fall {mem}")
    del small

    # -- (d) resume on the card
    batches = [
        (torch.randint(0, VOCAB, (1, TRAIN_BATCH, SEQ), generator=g, device=dev), te[None], tm[None]) for _ in range(4)
    ]

    def resume_trainer(folder, **kw):
        return MaskGitTrainer(
            build_models(torch, with_vae=False, seed=3, self_cond=True, depth=SMALL_DEPTH), num_train_steps=10**6,
            batch_size=TRAIN_BATCH, lr=SMALL_LR, warmup_steps=1, results_folder=str(tmp / folder),
            save_model_every=10**9, **kw,
        )

    straight = resume_trainer("straight")
    want = [straight.train_step_arrays(*b)["loss"] for b in batches]
    first = resume_trainer("resumed")
    got = [first.train_step_arrays(*b)["loss"] for b in batches[:2]]
    t0 = time.perf_counter()
    first.save()
    t_save = time.perf_counter() - t0
    del first
    t0 = time.perf_counter()
    second = resume_trainer("resumed", auto_resume=True)
    t_load = time.perf_counter() - t0
    require(second.steps == 2, f"auto_resume found step {second.steps}")
    got += [second.train_step_arrays(*b)["loss"] for b in batches[2:]]
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    diffs = [(a - b).abs() for a, b in zip(second.params + second.ema, straight.params + straight.ema)]
    max_diff = max(d.max().item() for d in diffs)
    share = sum(int((d <= 1e-6).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    # equal up to the order of the f32 atomic sums in the backward of the
    # embeddings; Adam's first steps move a weight by about lr whatever its
    # gradient, so a gradient at rounding level may move one entry that far
    require(loss_diff <= 1e-5, f"resume: losses {got} vs straight {want}")
    require(max_diff <= 2 * SMALL_LR * 4 and share >= 0.999, f"resume: params/EMA max diff {max_diff}, share {share}")
    ema_model = second.maskgit_module(use_ema=True)
    path = tmp / "ema.msgpack"
    checkpoint.save_module(ema_model, path)
    fresh = build_models(torch, with_vae=False, seed=4, self_cond=True, depth=SMALL_DEPTH)
    require(checkpoint.load_module(fresh, path) == [], "the EMA checkpoint has leaves the model does not take")
    with torch.no_grad():
        x = batches[0][0][0]
        same = torch.equal(ema_model.transformer(x, text_embeds=te, text_mask=tm), fresh.transformer(x, text_embeds=te, text_mask=tm))
    require(same, "the EMA model loaded from its checkpoint gives other logits")
    ckpt_mb = sum(f.stat().st_size for f in (tmp / "resumed" / "checkpoints").rglob("*") if f.is_file()) / 1e6
    log(
        f"[train] resume at depth {SMALL_DEPTH} (b{TRAIN_BATCH}, lr {SMALL_LR:g}): 2 + save + auto_resume + 2 steps vs "
        f"4 straight: losses within {loss_diff:.2g} relative, params and EMA max diff {max_diff:.3g}, "
        f"{share:.6f} of entries within 1e-6; train state {ckpt_mb:.1f} MB, save {t_save:.2f}s, resume {t_load:.2f}s | "
        f"EMA model -> save_module -> load_module: equal logits | memorisation at depth {SMALL_DEPTH}, lr {SMALL_LR:g}, "
        f"one batch: loss {', '.join(f'{x:.3f}' for x in mem)}"
    )
    del straight, second, ema_model, fresh

    # -- (e) samples and shards on the bf16 trainer
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.save_sample_results()
    t_sample = time.perf_counter() - t0
    sample_k = {k: fn.launches for k, fn in counted.items()}
    require((sample_k["k1"], sample_k["k2"]) == (STEPS, STEPS * DEPTH * 2), f"a render launched {sample_k}")
    png = decode_png((tmp / "bf16" / f"maskgit.{trainer.steps}.png").read_bytes())
    require(png.shape == (IMAGE + 4, 4 * (IMAGE + 2) + 2, 3), f"sample grid {png.shape}")
    rs = np.random.RandomState(0)
    shards = []
    for i in range(2):
        p = tmp / f"shard{i}.bin"
        write_shard(p, rs.randint(0, VOCAB, (80, SEQ)).astype(np.int32), captions=[PROMPTS[(i + j) % 16] for j in range(80)], grid=(16, 16))
        shards.append(p)
    start = trainer.steps
    trainer.num_train_steps = start + 2
    shard_losses = []
    t0 = time.perf_counter()
    trainer.train_from_shards(shards, use_captions=True, log_fn=lambda l: shard_losses.append(l["loss"]))
    t_shards = time.perf_counter() - t0
    require(trainer.steps == start + 2 and all(math.isfinite(x) for x in shard_losses), f"shard steps {shard_losses}")
    log(
        f"[train] save_sample_results: 4 prompts T{STEPS} CFG {CFG:g} -> {png.shape} PNG in {t_sample:.2f}s (K1 "
        f"+{sample_k['k1']}, K2 +{sample_k['k2']}) | train_from_shards: 2 steps from 2 shards of 80 x {SEQ} ids "
        f"(grid 16x16, captions through T5) in {t_shards:.2f}s, loss {', '.join(f'{x:.4f}' for x in shard_losses)} | "
        f"phase {time.perf_counter() - t_phase:.1f}s"
    )
    shutil.rmtree(tmp, ignore_errors=True)
    for k, fn in counted.items():
        ctx[k]["launches_per_train_step"] = [s[k] for s in per_step]
    ctx["train_launches"] = train_launches
    t_self = grad_times[("self", torch.bfloat16)]
    ctx["k2_backward"] = dict(
        name="qknorm_attend_backward", route="cuda", source="muse_maskgit_pytorch_tpu_torch/csrc/qknorm_attention_bwd.cu",
        replaces="none: JAX's _qknorm_bwd (muse_maskgit_pytorch_tpu/ops/attention.py:420) is XLA's vjp of _qknorm_xla",
        ms=t_self["bwd_ms"], bound_ms=t_self["bwd_bound_ms"], bound_by=t_self["bwd_bound_by"],
        library_ms=t_self["bwd_library_ms"], plain_ms=t_self["bwd_plain_ms"],
        max_abs_err=grad_errs[("self", torch.bfloat16)]["bwd vs plain"],
        launches=train_bwd_launches, launches_per_train_step=bwd_steps,
        shapes={
            f"{n}_{str(d)[6:]}": {
                k: grad_times[(n, d)][k]
                for k in (
                    "bwd_ms", "bwd_plain_ms", "bwd_library_ms", "bwd_bound_ms", "bwd_bound_by", "bwd_vs_sdpa",
                    "bwd_host_us", "bwd_kernels", "bwd_kernel_names", "bwd_clocks", "fwd_ms", "fwd_library_ms",
                    "fwd_bound_ms", "fwd_bound_by", "fwd_kernel_names",
                )
                if k in grad_times[(n, d)]
            }
            for n, d in grad_times
        },
    )
    # K2's f32 forward alone at the train shapes (graph replay, no gradient)
    # beside SDPA's f32 forward on the normalised inputs and the bound
    ctx["k2_f32_forward"] = {
        name: dict(
            ms=t["fwd_ms"], sdpa_ms=t["fwd_library_ms"], bound_ms=t["fwd_bound_ms"], bound_by=t["fwd_bound_by"],
            share=t["fwd_bound_ms"] / t["fwd_ms"], kernel_names=t["fwd_kernel_names"],
        )
        for (name, dtype), t in grad_times.items()
        if dtype == torch.float32
    }
    ctx["train"] = dict(
        ms_per_step=step_s * 1000, img_s=TRAIN_BATCH / step_s, mfu=mfu, flops_per_step=flops, peak_gib=peak_gib,
        losses=losses, grad_norms=norms, k2_launches_per_step=k2_steps, k2_backward_launches_per_step=bwd_steps,
        ab_ms_per_step=ab,
        superres=dict(ms_per_step=sr_step_s * 1000, img_s=CAS_BATCH / sr_step_s, peak_gib=sr_peak, losses=sr_losses,
                      k2_launches_per_step=sr_k2, k2_backward_launches_per_step=sr_bwd),
        k2_grad={f"{n}_{str(d)[6:]}": dict(grad_times[(n, d)], errs=grad_errs[(n, d)]) for n, d in grad_times},
        f32_step=dict(loss_rel=loss_rel, leaf_err=leaf_err), resume=dict(loss_rel=loss_diff, max_diff=max_diff),
        memorisation=mem, shard_losses=shard_losses,
    )
    ctx["trainer"], ctx["train_batch"] = trainer, (batch, {})
    ctx["sr_trainer"], ctx["sr_train_batch"] = sr_trainer, (sr_batch, dict(cond_token_ids=sr_cond))


def phase_gan(torch, ctx):
    """VQ-GAN training through `VQGanVAETrainer`, two configurations.

    (a) `bench_sweep.py`'s exp_gan_step: VAE dim 256, 4 layers, codebook
        65536, 256px, `use_vgg_and_gan=True` (random-init VGG16 and the
        discriminator), micro-batch 8, accumulation 1, EMA on, TF32 off. Three
        arms: f32 LFQ, f32 EMA-VQ at the reference vq_kwargs, bf16 enc/dec
        with LFQ; each 2 warm-up steps and 5 timed ones (host clock around
        synchronised steps): median ms a step, img/s, peak memory. EMA-VQ
        launches K3 three times a step (the generator loss, the codebook
        update, the discriminator phase's forward) and ten more on its first
        step (k-means); K3 at (2048, 256) x (65536, 256) by CUDA events
        beside its plain version and its bound, and its share of the step.
        Then one step with the R1 penalty and one without (finite, the
        adaptive weight in (0, 1e4]), and one EMA-VQ step twice from one
        state and one draw: with K3 and with `nearest_code_plain` patched
        in here (ids equal or within the near-tie rule, losses and gradient
        norms within 1e-5 relative).
    (b) `bench_ema_vq.py`'s EMA-VQ run through `VQGanVAETrainer(folder=...)`
        on 24 PNGs of 160x150 written here (resize and crop both run): the
        reconstruction loss of a fixed batch after 30 steps below half of
        its value before them, the live codes; then exact resume (2 steps,
        save, a fresh trainer with `auto_resume`, 1 step, against 3
        straight steps) under `torch.use_deterministic_algorithms(True)`.
    """
    import shutil
    import tempfile

    import numpy as np

    from muse_maskgit_pytorch_tpu_torch import VGG16, VQGanVAE, VQGanVAETrainer
    from muse_maskgit_pytorch_tpu_torch.models import quantizers, vqgan_vae
    from muse_maskgit_pytorch_tpu_torch.models.quantizers import VQDraws, l2norm
    from muse_maskgit_pytorch_tpu_torch.ops.attention import attend, qknorm_attend
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code, nearest_code_plain, score_gap
    from muse_maskgit_pytorch_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    dev = "cuda"
    counted = dict(k1=fused_topk_gumbel_sample, k2=qknorm_attend, k3=nearest_code, k4=attend)
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=scratch))
    g = torch.Generator(device=dev).manual_seed(11)
    imgs = torch.rand(1, GAN_BATCH, IMAGE, IMAGE, 3, generator=g, device=dev)  # (accum, B, H, W, C)
    grid = IMAGE >> VAE_LAYERS
    n_rows = GAN_BATCH * grid * grid

    # the adaptive weight, read where the VAE computes it (the script's
    # instrument: the package has no switch for it)
    weights = []
    safe_div = vqgan_vae.safe_div

    def recording_safe_div(numer, denom, eps=1e-8):
        out = safe_div(numer, denom, eps)
        weights.append(out.detach())
        return out

    # weights drawn on the card from a card generator (a CPU draw of the
    # reference VAE's 375 M parameters takes tens of seconds); one random-init
    # VGG16, f32 as exp_gan_step's arms keep it, for every arm
    def card_built(cls, **kw):
        with torch.device(dev):
            return cls(generator=torch.Generator(dev).manual_seed(0), device=dev, **kw)

    resident = torch.cuda.memory_allocated()  # what earlier phases hold: not the arms'
    vgg = card_built(VGG16)

    def gan_trainer(name, vae_kw, **kw):
        vae = card_built(
            VQGanVAE, dim=VAE_DIM, layers=VAE_LAYERS, codebook_size=VOCAB, use_vgg_and_gan=True, vgg=vgg, **vae_kw
        )
        return VQGanVAETrainer(
            vae, folder=None, dataset=[np.zeros((IMAGE, IMAGE, 3), np.float32)], num_train_steps=10**6,
            batch_size=GAN_BATCH, image_size=IMAGE, results_folder=str(tmp / name), save_results_every=10**9,
            save_model_every=10**9, valid_frac=0.0, use_ema=True, **kw,
        )

    def timed_step(trainer):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs = trainer.train_step_arrays(imgs, imgs)
        torch.cuda.synchronize()
        return logs, (time.perf_counter() - t) * 1000

    # EMA-VQ last: its trainer stays for the checks below, out of the
    # other arms' peak memory
    arms = {
        "f32 LFQ": {},
        "bf16 LFQ": dict(dtype=torch.bfloat16),
        "f32 EMA-VQ": dict(lookup_free_quantization=False, vq_kwargs=EMA_VQ_KW),
    }
    tf_gen, tf_discr, tf_discr_gp, tf_enc = gan_step_tflop(torch, GAN_BATCH)
    step_tflop = tf_gen + tf_discr  # an LFQ step without the penalty
    results, lines = {}, []
    for fn in counted.values():
        fn.launches = 0
    vqgan_vae.safe_div = recording_safe_div
    try:
        for arm, vae_kw in arms.items():
            t0 = time.perf_counter()
            trainer = gan_trainer(arm.replace(" ", "_"), vae_kw)
            t_build = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            k3_steps, times, logs = [], [], []
            for i in range(GAN_WARM + GAN_STEPS):
                before = nearest_code.launches
                out, ms = timed_step(trainer)
                k3_steps.append(nearest_code.launches - before)
                logs.append(out)
                if i >= GAN_WARM:
                    times.append(ms)
            step_ms = statistics.median(times)
            # the arm's own peak: its trainer, the shared VGG16 and the step
            peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
            require(all(math.isfinite(v) for x in logs for v in x.values()), f"{arm}: logs not finite {logs}")
            want_k3 = [13] + [3] * (len(k3_steps) - 1) if "EMA-VQ" in arm else [0] * len(k3_steps)
            require(k3_steps == want_k3, f"{arm}: K3 launches per step {k3_steps}, expected {want_k3}")
            # one step with the penalty and one without
            gp = {}
            for every, tag in ((1, "with"), (10**9, "without")):
                trainer.apply_grad_penalty_every = every
                weights.clear()
                out, ms = timed_step(trainer)
                aw = [w.item() for w in weights]
                require(all(math.isfinite(v) for v in out.values()), f"{arm}: a step {tag} the penalty: {out}")
                require(len(aw) == 1 and 0.0 < aw[0] <= 1e4, f"{arm}: adaptive weight {aw} not in (0, 1e4]")
                gp[tag] = dict(ms=ms, loss=out["loss"], discr_loss=out["discr_loss"], adaptive_weight=aw[0])
            tflop = step_tflop + (tf_enc if "EMA-VQ" in arm else 0.0)
            results[arm] = dict(
                ms_per_step=step_ms, img_s=GAN_BATCH / step_ms * 1000, peak_gib=peak, times_ms=times,
                tflop_per_step=tflop, tflop_s=tflop / step_ms * 1000,
                k3_launches_per_step=k3_steps, loss=[x["loss"] for x in logs], discr_loss=[x["discr_loss"] for x in logs],
                penalty=gp, built_s=t_build,
            )
            lines.append(
                f"{arm} {step_ms:.1f} ms/step ({GAN_BATCH / step_ms * 1000:.2f} img/s, "
                f"{tflop / step_ms * 1000:.1f} TFLOP/s, steps "
                f"{', '.join(f'{t:.1f}' for t in times)}), peak {peak:.2f} GiB above the "
                f"{resident / 2**30:.2f} GiB earlier phases hold, K3 per step {k3_steps}, with the "
                f"penalty {gp['with']['ms']:.1f} ms (discr loss {gp['with']['discr_loss']:.4f}), without "
                f"{gp['without']['ms']:.1f} ms ({gp['without']['discr_loss']:.4f}), adaptive weight "
                f"{gp['with']['adaptive_weight']:.4g}; built {t_build:.1f}s"
            )
            if "EMA-VQ" in arm:
                vq_trainer = trainer
            else:
                del trainer
    finally:
        vqgan_vae.safe_div = safe_div
    gan_launches = {k: fn.launches for k, fn in counted.items()}
    require(gan_launches["k1"] == gan_launches["k2"] == gan_launches["k4"] == 0, f"GAN steps launched {gan_launches}")

    # K3 at the training shape, its share of the EMA-VQ step
    vae, q = vq_trainer.vae, vq_trainer.vae.quantizer
    with torch.no_grad():
        z = l2norm(q.project_in(vae.enc_dec.encode(imgs[0])).reshape(-1, CODE_DIM).float())
        zeros = torch.zeros(VOCAB, device=dev)
        k3_ms = cuda_ms(lambda: nearest_code(z, q.codebook, zeros), iters=10)
        k3_plain_ms = cuda_ms(lambda: nearest_code_plain(z, q.codebook, zeros), iters=5)
    require(tuple(z.shape) == (n_rows, CODE_DIM), f"K3 rows {tuple(z.shape)}")
    k3_bound_ms, k3_bound_by = bound(2.0 * n_rows * VOCAB * CODE_DIM, nbytes(z, q.codebook, zeros) + n_rows * 4, PEAK_F32)
    vq_step = results["f32 EMA-VQ"]["ms_per_step"]
    k3_share = 3 * k3_ms / vq_step

    # one EMA-VQ step twice from one state: with K3, then with the plain
    # search patched in here (the package runs it for CPU tensors only)
    state = [t.detach().clone() for t in _train_tensors(vq_trainer)]
    counts = (vq_trainer.gen_opt.count, vq_trainer.discr_opt.count, vq_trainer._step)
    gen_state = vq_trainer.generator.get_state()
    draws = [VQDraws.draw(VOCAB, n_rows, torch.Generator().manual_seed(5))]
    calls = {}

    def recorded(search, tag):
        def run(x, codebook, cb_sq=None):
            ids = search(x, codebook, cb_sq)
            calls.setdefault(tag, []).append((x.detach().clone(), codebook.clone(), cb_sq, ids))
            return ids

        return run

    ab_logs = {}
    for tag, search in (("kernel", nearest_code), ("plain", nearest_code_plain)):
        with torch.no_grad():
            torch._foreach_copy_(_train_tensors(vq_trainer), state)
        vq_trainer.gen_opt.count, vq_trainer.discr_opt.count, vq_trainer._step = counts
        vq_trainer.generator.set_state(gen_state)
        quantizers.nearest_code = recorded(search, tag)
        try:
            ab_logs[tag] = vq_trainer.train_step_arrays(imgs, imgs, draws=draws)
        finally:
            quantizers.nearest_code = nearest_code
    del state
    require(len(calls["kernel"]) == len(calls["plain"]) == 3, f"searches a step {len(calls['kernel'])}, {len(calls['plain'])}")
    differ, gaps = 0, []
    for (x, cb, cb_sq, ids), (_, _, _, plain_ids) in zip(calls["kernel"], calls["plain"]):
        differ += int((ids != plain_ids).sum())
        gaps.append(score_gap(x, cb, ids, cb_sq).max().item())
    require(max(gaps) <= NEAR_TIE, f"K3 ids in the GAN step off the f64 best by {gaps}")
    ab_rel = {
        k: abs(ab_logs["kernel"][k] - ab_logs["plain"][k]) / max(abs(ab_logs["plain"][k]), 1e-12)
        for k in ("loss", "grad_norm", "discr_loss", "discr_grad_norm")
    }
    require(max(ab_rel.values()) <= 1e-5, f"the EMA-VQ step with K3 and with the plain search: {ab_rel}")
    del calls, vq_trainer, vae, q, z
    # `[profile]` (last) profiles one EMA-VQ GAN step of a trainer built anew
    ctx["gan_trainer"] = lambda: gan_trainer("profile", arms["f32 EMA-VQ"])
    ctx["gan_images"] = imgs
    log(
        f"[gan] reference scale b{GAN_BATCH} {IMAGE}px dim {VAE_DIM} K {VOCAB}, VGG16 + discriminator, EMA; "
        f"TFLOP a step by PyTorch's formulas on the meta device: generator {tf_gen:.3f}, discriminator "
        f"{tf_discr:.3f} ({tf_discr_gp:.3f} with the penalty), EMA-VQ's extra encode {tf_enc:.3f}, K3 "
        f"{3 * 2.0 * n_rows * VOCAB * CODE_DIM / 1e12:.3f}: "
        + " | ".join(lines)
        + f" | K3 ({n_rows}, {CODE_DIM}) x ({VOCAB}, {CODE_DIM}) {k3_ms:.3f} ms vs plain {k3_plain_ms:.3f} ms, bound "
        f"{k3_bound_ms:.3f} ms ({k3_bound_by}), 3 a step = {k3_share:.1%} of the EMA-VQ step | one step with K3 and with "
        f"the plain search: {differ} ids differ, max f64 gap {max(gaps):.3g}, loss / grad norm / discr loss / discr grad "
        f"norm within {max(ab_rel.values()):.2g} relative | {ctx['smi']}"
    )

    # -- (b) bench_ema_vq's run from a folder of PNGs
    folder = tmp / "pngs"
    folder.mkdir()
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:150, 0:160] / 150.0
    for i in range(MEM_FILES):
        f = rs.uniform(1.0, 4.0, (3, 2))
        ph = rs.uniform(0, 2 * np.pi, (3, 2))
        img = np.stack([0.5 + 0.25 * np.sin(f[c, 0] * 2 * np.pi * xx + ph[c, 0]) + 0.25 * np.cos(f[c, 1] * 2 * np.pi * yy + ph[c, 1]) for c in range(3)], -1)
        (folder / f"{i:03d}.png").write_bytes(encode_png((img * 255).round().clip(0, 255).astype(np.uint8)))

    def mem_trainer(name, **kw):
        vae = card_built(
            VQGanVAE, dim=MEM_DIM, layers=MEM_LAYERS, codebook_size=VOCAB, lookup_free_quantization=False,
            vq_kwargs=dict(EMA_VQ_KW, threshold_ema_dead_code=2.0), use_vgg_and_gan=False,
        )
        return VQGanVAETrainer(
            vae, folder=str(folder), num_train_steps=MEM_STEPS, batch_size=MEM_BATCH, image_size=MEM_IMAGE, lr=MEM_LR,
            results_folder=str(tmp / name), save_results_every=10, save_model_every=10**9, **kw,
        )

    t0 = time.perf_counter()
    trainer = mem_trainer("memo")
    ds = trainer.ds
    fixed = torch.from_numpy(np.stack([ds.load(i, False) for i in range(MEM_BATCH)])).to(dev)
    require(tuple(fixed.shape) == (MEM_BATCH, MEM_IMAGE, MEM_IMAGE, 3), f"dataset items {tuple(fixed.shape)}")

    def recon_loss():
        with torch.no_grad():
            return trainer.vae(fixed, return_loss=True, train=False).item()

    before = recon_loss()
    launches = nearest_code.launches
    trainer.train()
    mem_k3 = nearest_code.launches - launches
    after = recon_loss()
    t_mem = time.perf_counter() - t0
    cluster = trainer.vae.quantizer.cluster_size
    with torch.no_grad():
        _, ids, _ = trainer.vae.encode(fixed)
    live = int((cluster > 2.0).sum())
    used = int(ids.unique().numel())
    require(trainer.steps == MEM_STEPS and after < 0.5 * before, f"memorisation: recon loss {before:.4f} -> {after:.4f}")
    # k-means, the loss and the codebook update of each step, and the two
    # reconstruction grids (live and EMA) of every tenth step
    want_k3 = 10 + 2 * MEM_STEPS + 2 * -(-MEM_STEPS // 10)
    require(mem_k3 == want_k3, f"K3 launches in {MEM_STEPS} steps {mem_k3}, expected {want_k3}")
    require((tmp / "memo" / "0.png").exists() and (tmp / "memo" / "0.ema.png").exists(), "no reconstruction grids")
    del trainer, fixed

    # exact resume, with deterministic algorithms in this check only
    batches = [torch.rand(1, MEM_BATCH, MEM_IMAGE, MEM_IMAGE, 3, generator=g, device=dev) for _ in range(3)]
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        straight = mem_trainer("straight")
        want = [straight.train_step_arrays(b) for b in batches]
        first = mem_trainer("resumed")
        got = [first.train_step_arrays(b) for b in batches[:2]]
        first.save()
        del first
        second = mem_trainer("resumed", auto_resume=True)
        require(second.steps == 2, f"auto_resume found step {second.steps}")
        got.append(second.train_step_arrays(batches[2]))
    finally:
        torch.use_deterministic_algorithms(False)
        if saved_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
    pairs = list(zip(_train_tensors(second), _train_tensors(straight)))
    exact = all(torch.equal(a, b) for a, b in pairs) and got[2]["loss"] == want[2]["loss"]
    resume_rel = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in pairs if b.is_floating_point())
    loss_rel = abs(got[2]["loss"] - want[2]["loss"]) / abs(want[2]["loss"])
    require(exact or (resume_rel <= 1e-6 and loss_rel <= 1e-6), f"resume: state off by {resume_rel:.3g}, loss by {loss_rel:.3g}")
    del straight, second
    shutil.rmtree(tmp, ignore_errors=True)
    log(
        f"[gan] bench_ema_vq b{MEM_BATCH} {MEM_IMAGE}px dim {MEM_DIM} K {VOCAB} from {MEM_FILES} PNGs of 160x150: "
        f"fixed-batch recon loss {before:.4f} -> {after:.4f} in {MEM_STEPS} steps ({after / before:.1%}), live codes "
        f"{live} (cluster size > 2.0), {used} codes in the fixed batch, K3 +{mem_k3} (10 k-means, 2 a step at "
        f"({MEM_BATCH * (MEM_IMAGE >> MEM_LAYERS) ** 2}, {CODE_DIM}), 2 a reconstruction grid), {t_mem:.1f}s | resume 2 + save + auto_resume + "
        f"1 vs 3 straight, deterministic algorithms: {'bit-identical' if exact else 'not bitwise'} (state within "
        f"{resume_rel:.2g} of each tensor's max, loss {loss_rel:.2g}) | phase {time.perf_counter() - t_phase:.1f}s"
    )
    for k, fn in counted.items():
        ctx[k]["launches_per_gan_step"] = results["f32 EMA-VQ"]["k3_launches_per_step"] if k == "k3" else 0
    ctx["gan_launches"] = gan_launches
    ctx["gan"] = dict(
        tflop=dict(generator=tf_gen, discriminator=tf_discr, discriminator_penalty=tf_discr_gp, encode=tf_enc),
        arms=results, k3=dict(shape=[n_rows, CODE_DIM, VOCAB], ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound_ms,
                              bound_by=k3_bound_by, share_of_step=k3_share),
        k3_vs_plain=dict(ids_differ=differ, max_gap=max(gaps), rel=ab_rel),
        memorisation=dict(before=before, after=after, live_codes=live, used_codes=used, k3_launches=mem_k3),
        resume=dict(exact=exact, state_rel=resume_rel, loss_rel=loss_rel),
    )


def gan_step_tflop(torch, image_batch):
    """TFLOP of one LFQ GAN step's parts at the reference scale for
    `image_batch` images: (generator phase, discriminator phase, the same
    with the R1 penalty, one encoder pass), from PyTorch's FLOP formulas
    (`torch.utils.flop_counter`) over the shapes of a run on the meta
    device (no data, no card time). Counted by a dispatch mode of its own:
    `FlopCounterMode`'s module hooks refuse `autograd.grad` on leaves."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    from muse_maskgit_pytorch_tpu_torch import VGG16, VQGanVAE

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **(kwargs or {}), out_val=out)
            return out

    with torch.device("meta"):
        vae = VQGanVAE(dim=VAE_DIM, layers=VAE_LAYERS, codebook_size=VOCAB, vgg=VGG16(device="meta"), device="meta")
    img = torch.empty(image_batch, IMAGE, IMAGE, 3, device="meta")
    gen = [p for n, p in vae.named_parameters() if not n.startswith(("discr.", "_vgg."))]
    discr = [p for n, p in vae.named_parameters() if n.startswith("discr.")]

    def counted(fn):
        with Count() as c:
            fn()
        return c.total / 1e12

    def gen_part():
        torch.autograd.grad(vae(img, return_loss=True, train=True, update_stats=False), gen)

    def discr_part(penalty):
        torch.autograd.grad(vae(img, return_discr_loss=True, add_gradient_penalty=penalty, train=False), discr)

    def encode():
        with torch.no_grad():
            vae.enc_dec.encode(img)

    return counted(gen_part), counted(lambda: discr_part(False)), counted(lambda: discr_part(True)), counted(encode)


def _train_tensors(trainer):
    """Every tensor of a `VQGanVAETrainer`'s state: both parameter groups,
    the VAE's buffers, both optimizers' moments and the EMA."""
    return [
        *trainer.gen_params, *trainer.discr_params, *trainer.vae.buffers(), *trainer.gen_opt.mu,
        *trainer.gen_opt.nu, *trainer.discr_opt.mu, *trainer.discr_opt.nu, *(trainer.ema or []),
    ]


def phase_cascade(torch, ctx):
    """texts -> 512px at batch 16: (a) the chain `bench.py` times, the base
    stage's token grid handed to the super-res stage, from text embeddings;
    (b) `Muse(texts)` in both hand-offs; (c) one chain request under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from muse_maskgit_pytorch_tpu_torch import Muse
    from muse_maskgit_pytorch_tpu_torch.models.maskgit import child_generators
    from muse_maskgit_pytorch_tpu_torch.ops.attention import attend, qknorm_attend
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code

    t0 = time.perf_counter()
    base = ctx.get("maskgit") or build_models(torch)
    ctx["maskgit"] = base
    superres = ctx.get("superres") or build_superres(torch, base.vae)
    ctx["superres"] = superres
    muse = Muse(base, superres)
    t_build = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(0)
    text = torch.randn(CAS_BATCH, TEXT_LEN, TEXT_DIM, generator=g, device="cuda")
    mask = torch.ones(CAS_BATCH, TEXT_LEN, dtype=torch.bool, device="cuda")
    kw = dict(text_embeds=text, text_mask=mask, timesteps=STEPS, cond_scale=CFG)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def chain(seed):
        g_base, g_sr = child_generators(torch.Generator().manual_seed(seed), "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        marks[0].record()
        ids = base.generate(generator=g_base, return_ids=True, **kw)
        marks[1].record()
        img = superres.generate(generator=g_sr, cond_token_ids=ids, **kw)
        marks[2].record()
        torch.cuda.synchronize()
        return img, time.perf_counter() - t, marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])

    def check(img, what):
        require(tuple(img.shape) == (CAS_BATCH, SR_IMAGE, SR_IMAGE, 3), f"{what}: image shape {tuple(img.shape)}")
        require(bool(torch.isfinite(img).all()), f"{what}: non-finite pixels")

    # -- (a) the chain
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chain(100)  # warm-up: cuBLAS / cuDNN choose their algorithms at the new shapes
    t_warm = time.perf_counter() - t0
    counted = (fused_topk_gumbel_sample, qknorm_attend, attend, nearest_code)  # K1, K2, K4, K3
    for fn in counted:
        fn.launches = 0
    times, base_ms, sr_ms, per_request = [], [], [], []
    for i in range(3):
        before = [fn.launches for fn in counted]
        img, dt, b_ms, s_ms = chain(i)
        per_request.append(tuple(fn.launches - n for fn, n in zip(counted, before)))
        times.append(dt)
        base_ms.append(b_ms)
        sr_ms.append(s_ms)
        check(img, "chain")
    chain_launches = [fn.launches for fn in counted]
    # each stage: one K1 a step; a self- and a cross-attention a layer a step;
    # the LFQ tokenizer searches no codebook, so K3 stays at 0 like K4
    want = (2 * STEPS, 2 * STEPS * DEPTH * 2, 0, 0)
    for got in per_request:
        require(got == want, f"K1, K2, K4, K3 launched {got} times in a cascade request, expected {want}")
    chain_peak = torch.cuda.max_memory_allocated() / 2**30
    req = statistics.median(times)
    img_s = CAS_BATCH / req
    base_med, sr_med = statistics.median(base_ms), statistics.median(sr_ms)

    # -- (b) Muse, from prompts, in both hand-offs
    def muse_request(cond_via):
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator().manual_seed(3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = muse(
            list(PROMPTS), generator=gen, cond_scale=CFG, timesteps=STEPS, cond_via=cond_via,
            return_pil_images=False,
        )
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        check(img, f"Muse cond_via={cond_via}")
        require(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, f"Muse cond_via={cond_via}: pixels outside [0, 1]")
        return img, dt * 1000, torch.cuda.max_memory_allocated() / 2**30

    muse_request("pixels")  # warm-up: the tokenizer's encode at this batch, T5
    for fn in counted:
        fn.launches = 0
    ids_img, ids_ms, ids_peak = muse_request("ids")
    muse_ids_launches = tuple(fn.launches for fn in counted)
    pix_img, pix_ms, pix_peak = muse_request("pixels")
    muse_launches = tuple(fn.launches for fn in counted)
    require(muse_ids_launches == want, f"Muse(ids) launched K1, K2, K4, K3 {muse_ids_launches}, expected {want}")
    require(muse_launches == tuple(2 * n for n in want), f"Muse launched K1, K2, K4, K3 {muse_launches} in two requests")
    # one seed twice: the stages' seeds are the same (checked, and for a
    # generator on the card as for one on the host); the pixels are printed,
    # not checked, since cuBLAS and cuDNN may sum in another order each run
    again, _, _ = muse_request("ids")
    repeat_diff = (again - ids_img).abs().max().item()
    seeds = [
        [c.initial_seed() for c in child_generators(torch.Generator(device=d).manual_seed(3), "cuda")]
        for d in ("cpu", "cuda", "cpu")
    ]
    require(seeds[0] == seeds[1] == seeds[2], f"Muse's child seeds depend on where the generator lives: {seeds}")
    differ = (pix_img != ids_img).float().mean().item()

    # -- (c) one chain request under the profiler
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_host, _, _ = chain(7)
    rows = profile_rows(prof)
    require(rows, "torch.profiler saw no device time in a cascade request")
    device_ms, streams, repeats = device_busy(prof)
    busy_within(device_ms, prof_host * 1000, "the profiled cascade request")
    k2_ms, k2_n = kernel_total(rows, "flash_core_kernel<64, true>")
    k1_ms, k1_n = kernel_total(rows, "sample_kernel")
    require((k1_n, k2_n) == want[:2], f"the profiler counted K1 x{k1_n}, K2 x{k2_n} in a cascade request")
    top = "; ".join(f"{ms:.1f} ms x{n} {name[:70]}" for ms, n, name in rows[:12])
    prof_s = (
        f"one request under torch.profiler: device busy {device_ms:.1f} ms (kernels' sum "
        f"{sum(r[0] for r in rows):.1f} ms, {streams} stream(s), {repeats} repeated records) in "
        f"{prof_host * 1000:.1f} ms; K2 "
        f"{k2_ms:.2f} ms x{k2_n}, K1 {k1_ms:.2f} ms x{k1_n}; top kernels: {top}"
    )

    ctx["cascade"] = dict(
        img_s=img_s, request_ms=req * 1000, base_ms=base_med, superres_ms=sr_med,
        muse_ids_ms=ids_ms, muse_pixels_ms=pix_ms, peak_gib=max(chain_peak, ids_peak, pix_peak),
    )
    ctx["cascade_launches"] = dict(zip(("k1", "k2", "k4", "k3"), chain_launches))
    ctx["cascade_per_request"] = dict(zip(("k1", "k2", "k4", "k3"), per_request[0]))
    log(
        f"[cascade] b{CAS_BATCH} T{STEPS}+{STEPS} cfg{CFG:g} text embeddings -> base ids -> super-res -> "
        f"{SR_IMAGE}px: {img_s:.3f} img/s (median of {', '.join(f'{t * 1000:.1f}' for t in times)} ms); device "
        f"time by stage (CUDA events, median): base {base_med:.1f} ms = {base_med / (base_med + sr_med):.1%}, "
        f"super-res {sr_med:.1f} ms = {sr_med / (base_med + sr_med):.1%}; K1 +{per_request[0][0]}, K2 "
        f"+{per_request[0][1]}, K4 +{per_request[0][2]}, K3 +{per_request[0][3]} launches per request; peak memory "
        f"{chain_peak:.2f} GiB | "
        f"Muse(texts) {tuple(ids_img.shape)} in [0, 1]: cond_via=ids {ids_ms:.1f} ms (peak {ids_peak:.2f} GiB), "
        f"cond_via=pixels {pix_ms:.1f} ms (peak {pix_peak:.2f} GiB), {differ:.1%} of the pixels differ between "
        f"the hand-offs; one seed twice: equal child seeds from a host and a card generator, max pixel difference "
        f"{repeat_diff:.3g} | {prof_s} | {ctx['smi']} | models built "
        f"{t_build:.1f}s, warm-up {t_warm:.1f}s"
    )


def tower_close(got, ref) -> float:
    """max |got - ref| / max |ref|; raises beyond the CPU tests' limits
    (rtol TOWER_RTOL, atol TOWER_RTOL * max |ref|)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = float(ref.abs().max())
    excess = ((got - ref).abs() - TOWER_RTOL * (ref.abs() + scale)).max().item()
    require(bool(got.isfinite().all()) and excess <= 0, f"tower features beyond rtol/atol {TOWER_RTOL}: {excess:.3g}")
    return float((got - ref).abs().max()) / scale


def phase_eval(torch, ctx):
    """Evaluation at the base stage's full width: (a) the two FID towers
    alone, random weights from a seed drawn on the card: InceptionV3 pool3
    at b64 299px and VGG16 fc2 at b64 256px through their extractors, img/s
    by CUDA events (median of 5 after 2 warm-ups) and peak memory, and the
    same 4 images through each tower on the CPU; (b) FID end to end: 256
    images from `MaskGit.generate` (8 requests of b32, T18, CFG 3, each
    K1 +18 and K2 +288), written as PNGs beside 256 seeded smooth "real"
    images, then the port's `examples.compute_fid` `main(argv)` on the
    card: `--real` with `--save-stats`, `--stats` with `--fake`, `--real`
    against itself; the saved statistics load bit-equal, a set against
    itself scores < 1e-4, the generated set against the real one a finite
    FID above that. The extractor's device time and the Fréchet distance's
    host time are read by wrapping the names the command line calls."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch.nn.functional as F

    from muse_maskgit_pytorch_tpu_torch.examples import compute_fid
    from muse_maskgit_pytorch_tpu_torch.models.inception import InceptionV3
    from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16
    from muse_maskgit_pytorch_tpu_torch.ops.attention import attend, qknorm_attend
    from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
    from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code
    from muse_maskgit_pytorch_tpu_torch.utils import eval as ev
    from muse_maskgit_pytorch_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(21)

    # -- (a) the towers alone
    towers = {}
    for name, cls, size, make in (
        ("inception", InceptionV3, 299, lambda m: ev.make_inception_extractor(inception=m)),
        ("vgg", VGG16, IMAGE, lambda m: ev.make_vgg_extractor(vgg=m)),
    ):
        with torch.device(dev):  # drawn on the card: a CPU draw of VGG16 takes seconds
            tower = cls(generator=torch.Generator(dev).manual_seed(0), device=dev)
        extract = make(tower)
        x = torch.rand(EVAL_BATCH, size, size, 3, generator=g, device=dev)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            extract(x)
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            feats = extract(x)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        require(feats.shape == (EVAL_BATCH, 2048 if name == "inception" else 4096), f"{name}: features {tuple(feats.shape)}")
        require(bool(feats.isfinite().all()), f"{name}: non-finite features")
        # the same images through the same weights on the CPU
        few = x[:EVAL_CPU_IMAGES]
        cpu_feats = make(copy.deepcopy(tower).cpu())(few.cpu())
        rel = tower_close(extract(few), cpu_feats)
        again = extract(few)
        require(torch.equal(again, extract(few)), f"{name}: a repeat on the card is not bit-identical")
        ms = statistics.median(times)
        towers[name] = dict(
            batch=EVAL_BATCH, px=size, ms=ms, img_s=EVAL_BATCH / ms * 1e3, peak_gib=peak, cpu_max_rel_err=rel,
        )
        if name == "inception":
            # at the command line's input, 256px: on the card (the resize
            # included), and as the host batch the loader hands over
            x256 = torch.rand(EVAL_BATCH, IMAGE, IMAGE, 3, generator=g, device=dev)
            host = x256.cpu().numpy()
            towers[name]["ms_256px_on_card"] = cuda_ms(lambda: extract(x256), iters=5)
            towers[name]["ms_256px_from_host"] = cuda_ms(lambda: extract(host), iters=5)
            del x256, host
        del tower, extract, x, feats
    torch.cuda.empty_cache()

    # -- (b) FID end to end
    maskgit = ctx.get("maskgit") or build_models(torch)
    ctx["maskgit"] = maskgit
    counted = (fused_topk_gumbel_sample, qknorm_attend, attend, nearest_code)  # K1, K2, K4, K3
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=scratch))
    fake_dir, real_dir = tmp / "fake", tmp / "real"
    fake_dir.mkdir()
    real_dir.mkdir()
    mask = torch.ones(BATCH, TEXT_LEN, dtype=torch.bool, device=dev)

    def request(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        text = torch.randn(BATCH, TEXT_LEN, TEXT_DIM, generator=gen, device=dev)
        return maskgit.generate(generator=gen, text_embeds=text, text_mask=mask, timesteps=STEPS, cond_scale=CFG)

    request(1000)  # warm-up
    for fn in counted:
        fn.launches = 0
    per_request, images = [], []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(EVAL_REQUESTS):
        before = [fn.launches for fn in counted]
        images.append(request(i))
        per_request.append(tuple(fn.launches - b for fn, b in zip(counted, before)))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    eval_launches = dict(zip(("k1", "k2", "k4", "k3"), (fn.launches for fn in counted)))
    for got in per_request:
        require(got == (STEPS, STEPS * DEPTH * 2, 0, 0), f"K1, K2, K4, K3 launched {got} in an eval request")
    fake = torch.cat(images)
    n_images = fake.shape[0]
    require(tuple(fake.shape) == (n_images, IMAGE, IMAGE, 3) and bool(fake.isfinite().all()), "generated images")
    fake_u8 = (fake.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()
    # "real": smooth seeded images (bilinear 8x8 noise), another distribution
    low = torch.rand(n_images, 3, 8, 8, generator=torch.Generator(dev).manual_seed(22), device=dev)
    real_u8 = (F.interpolate(low, size=(IMAGE, IMAGE), mode="bilinear") * 255).round().to(torch.uint8)
    real_u8 = real_u8.permute(0, 2, 3, 1).cpu().numpy()
    t = time.perf_counter()
    for i in range(n_images):
        (fake_dir / f"{i:04d}.png").write_bytes(encode_png(fake_u8[i]))
        (real_dir / f"{i:04d}.png").write_bytes(encode_png(real_u8[i]))
    png_s = time.perf_counter() - t

    # the command line on the card, with its extractor's device time and
    # the distance's host time read through the names it calls
    extract_ms, distance_s, stats_seen = [], [], []
    make, distance, compute = compute_fid.make_inception_extractor, ev.frechet_distance, compute_fid.compute_feature_stats

    def timed_make(**kw):
        inner = make(**kw)

        def extract(images):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(images)
            end.record()
            extract_ms.append((start, end, out.shape[0]))
            return out

        return extract

    def timed_distance(*a, **kw):
        t0 = time.perf_counter()
        out = distance(*a, **kw)
        distance_s.append(time.perf_counter() - t0)
        return out

    def kept_stats(*a, **kw):
        stats_seen.append(compute(*a, **kw))
        return stats_seen[-1]

    common = ["--image-size", str(IMAGE), "--batch-size", str(EVAL_BATCH)]
    stats_file = tmp / "real_stats"
    compute_fid.make_inception_extractor, ev.frechet_distance = timed_make, timed_distance
    compute_fid.compute_feature_stats = kept_stats
    try:
        cli_s = []
        t = time.perf_counter()
        require(compute_fid.main(["--real", str(real_dir), "--save-stats", str(stats_file), *common]) is None, "stats only")
        cli_s.append(time.perf_counter() - t)
        saved = stats_seen[-1]
        loaded = ev.FeatureStats.load(f"{stats_file}.npz")
        require(
            loaded.n == saved.n == n_images and np.array_equal(loaded._sum, saved._sum)
            and np.array_equal(loaded._outer, saved._outer),
            "the loaded statistics differ from the saved ones",
        )
        t = time.perf_counter()
        fid = compute_fid.main(["--stats", f"{stats_file}.npz", "--fake", str(fake_dir), *common])
        cli_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        fid_self = compute_fid.main(["--real", str(real_dir), "--fake", str(real_dir), *common])
        cli_s.append(time.perf_counter() - t)
    finally:
        compute_fid.make_inception_extractor, ev.frechet_distance = make, distance
        compute_fid.compute_feature_stats = compute
    torch.cuda.synchronize()
    shutil.rmtree(tmp, ignore_errors=True)
    require(abs(fid_self) < 1e-4, f"FID of a set against itself {fid_self}")
    require(math.isfinite(fid) and fid > fid_self, f"FID of the generated set {fid}")
    require(tuple(fn.launches for fn in counted) == tuple(eval_launches.values()), "compute_fid launched a kernel")
    ext_ms = sum(s.elapsed_time(e) for s, e, _ in extract_ms)
    ext_n = sum(n for _, _, n in extract_ms)
    ctx["eval"] = dict(
        towers=towers, images=n_images, generate_img_s=n_images / gen_s, extract_img_s=ext_n / ext_ms * 1e3,
        extract_device_ms=ext_ms, frechet_s=distance_s, fid=fid, fid_self=fid_self, cli_s=cli_s, png_s=png_s,
        wall_s=time.perf_counter() - t_phase,
    )
    ctx["eval_launches"] = eval_launches
    ctx["eval_per_request"] = dict(zip(("k1", "k2", "k4", "k3"), per_request[0]))
    tw = "; ".join(
        f"{n} b{r['batch']} {r['px']}px {r['img_s']:.1f} img/s ({r['ms']:.1f} ms a batch, median of 5), peak "
        f"{r['peak_gib']:.2f} GiB, CPU agreement max rel err {r['cpu_max_rel_err']:.2e}"
        for n, r in towers.items()
    )
    inc = towers["inception"]
    tw += (
        f"; inception's extractor at 256px (resized to 299 on the card): {inc['ms_256px_on_card']:.1f} ms a batch "
        f"from the card, {inc['ms_256px_from_host']:.1f} ms from a host array (CUDA events, mean of 5)"
    )
    log(
        f"[eval] towers (random init, f32): {tw} | generate {n_images} images (b{BATCH} x {EVAL_REQUESTS}, T{STEPS}, "
        f"cfg{CFG:g}): {n_images / gen_s:.2f} img/s, K1 +{per_request[0][0]}, K2 +{per_request[0][1]} per request; "
        f"PNGs written {png_s:.1f}s | compute_fid (Inception, random init): extraction {ext_n} images "
        f"{ext_n / ext_ms * 1e3:.1f} img/s by CUDA events; frechet_distance (two eigh, 2048 x 2048 f64) "
        f"{', '.join(f'{x:.2f}' for x in distance_s)} s on the host; FID generated vs real {fid:.6g}, real vs "
        f"itself {fid_self:.3g}; stats saved and loaded bit-equal; the three calls {', '.join(f'{x:.1f}' for x in cli_s)} s "
        f"| {ctx['smi']} | phase {time.perf_counter() - t_phase:.1f} s"
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
    root = Path(__file__).resolve().parent
    if not (root / "muse_maskgit_pytorch_tpu_torch").is_dir():
        print(f"chip_smoke.py: no muse_maskgit_pytorch_tpu_torch/ beside {root}: run it from a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    import muse_maskgit_pytorch_tpu_torch  # noqa: F401

    ctx = {"k1": {}, "k2": {}, "k3": {}, "k4": {}}
    t_start = time.perf_counter()
    phase_env(torch, ctx)
    for name in phases:
        if name != "env":
            globals()[f"phase_{name}"](torch, ctx)
    log(f"[done] {', '.join(phases)} in {time.perf_counter() - t_start:.1f} s")
    if set(phases) != set(ALL_PHASES):
        return 0  # a subset measures too little for the result lines

    # launches per request, as counted: K1 and K2 per `generate` request and
    # per cascade request, K3 per EMA-VQ encode, K4 in one `generate`
    # request, one cascade request and one encode of each tokenizer (the
    # model paths). `launches` sums the timed requests of every driven path.
    ctx["k4"]["launches_per_request"] = (
        ctx["k4_per_request"] + ctx["k4_per_encode"] + ctx["cascade_per_request"]["k4"]
    )
    for tag in ("k1", "k2", "k4", "k3"):
        ctx[tag]["launches"] += (
            ctx["cascade_launches"][tag] + ctx["surface_launches"][tag] + ctx["serving_launches"][tag]
            + ctx["train_launches"][tag] + ctx["gan_launches"][tag] + ctx["eval_launches"][tag]
            + ctx["parallel_launches"][tag] + ctx["tensor_launches"][tag]
        )
        ctx[tag]["launches_per_cascade_request"] = ctx["cascade_per_request"][tag]
        ctx[tag]["launches_per_eval_request"] = ctx["eval_per_request"][tag]
    rows = [
        ("k1", "fused_topk_gumbel_sample", "sampling_kernel.cu", "sampling_kernel.py:57"),
        ("k2", "qknorm_attend", "qknorm_attention.cu", "attention.py:242"),
        ("k3", "nearest_code", "vq_search.cu", "vq.py:54"),
        ("k4", "attend", "flash_attention.cu", "attention.py:83"),
    ]
    keys = (
        "launches", "launches_per_request", "launches_per_cascade_request", "launches_per_surface_request",
        "launches_per_serving_batch", "launches_per_train_step", "launches_per_gan_step", "launches_per_eval_request",
        "max_abs_err", "ms",
        "plain_ms", "bound_ms",
        "bound_by", "library_ms",
    )
    kernels = [
        dict(
            name=name, route="cuda", source=f"muse_maskgit_pytorch_tpu_torch/csrc/{src}",
            replaces=f"muse_maskgit_pytorch_tpu/ops/{tpu}", **{k: ctx[tag][k] for k in keys},
            **({"routes": ctx["k1_routes"]} if tag == "k1" else {}),
            **(
                {
                    "shapes": ctx["k2_shapes"], "backward": ctx["k2_backward"], "f32_forward": ctx["k2_f32_forward"],
                    "tensor": ctx["k2_tensor"],
                }
                if tag == "k2"
                else {}
            ),
        )
        for tag, name, src, tpu in rows
    ]
    print(
        json.dumps(
            {
                "cascade": ctx["cascade"], "t5_ms": ctx["t5_ms"], "surfaces": ctx["surfaces"],
                "vaes_share_weights_ms": ctx["vaes_share_weights_ms"], "serving": ctx["serving"],
                "train": ctx["train"], "gan": ctx["gan"], "eval": ctx["eval"], "parallel": ctx["parallel"],
                "tensor": ctx["tensor"],
                "k1_row_offset": ctx["k1_row_offset"],
            }
        ),
        flush=True,
    )
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
