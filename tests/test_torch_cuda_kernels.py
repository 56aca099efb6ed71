"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small odd shapes that the main path does not reach.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode. On a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest -o addopts=""

(`--noconftest` because the suite's conftest sets up JAX, which a GPU
machine need not have; `-o addopts=""` drops the suite's xdist options).
`chip_smoke.py` checks the same kernels at the main path's shapes.
"""

import contextlib

import pytest
import torch

from muse_maskgit_pytorch_tpu_torch import LFQ, MaskGitTransformer, VQGanVAE
from muse_maskgit_pytorch_tpu_torch.ops import attention, sampling_kernel, vq

# bf16 attention: against the plain version with the TPU kernels' roundings,
# one bf16 step of the output apart; against the f32 plain version, as far
# as each Pallas kernel keeps from its f32 oracle (`ops/attention.py`)
from muse_maskgit_pytorch_tpu_torch.ops.attention import (
    BF16_VS_ROUNDED,
    K2_BF16_FROM_F32,
    K2_BWD_BF16_FROM_F32,
    K2_BWD_BF16_VS_ROUNDED,
    K4_BF16_FROM_F32,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gumbel(shape, g, dev):
    u = torch.rand(shape, generator=g, device=dev).clamp(1e-9, 1 - 1e-9)
    return -torch.log(-torch.log(u))


# (rows, V): 1000 is a multiple of 8 but not of a 16 KB chunk, 1001 is neither
# (read from global memory); 7 rows are fewer than the persistent grid's
# blocks, 133 one more than it on an H100, 1024 a compact step's count;
# 65536 fills the staged ring's 8 chunks a row, 70000 is past the staged limit
SAMPLER_SHAPES = [(37, 4096), (37, 1000), (37, 1001), (7, 65536), (133, 65536), (1024, 4096), (133, 70000)]


@pytest.mark.parametrize("cfg_pair", [False, True], ids=["single", "cfg_pair"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows, V", SAMPLER_SHAPES)
def test_sampler_matches_plain(dev, dtype, cfg_pair, rows, V):
    g = torch.Generator(device=dev).manual_seed(V + 2 * cfg_pair)
    k = -(-V // 10)
    logits = (torch.randn((2 if cfg_pair else 1) * rows, V, generator=g, device=dev) * 3).to(dtype)
    noise = _gumbel((rows, V), g, dev)
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (logits, k, 0.8, seed)
    kw = dict(noise=noise, cfg_pair=cfg_pair, cond_scale=3.0)
    before = sampling_kernel.fused_topk_gumbel_sample.launches
    idx, prob = sampling_kernel.fused_topk_gumbel_sample(*args, **kw)
    assert sampling_kernel.fused_topk_gumbel_sample.launches == before + 1
    pidx, pprob = sampling_kernel.fused_topk_gumbel_sample_plain(*args, **kw)
    assert torch.equal(idx, pidx)
    # the row's logsumexp is summed in another order
    torch.testing.assert_close(prob, pprob, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("which_k", ["one", "tenth", "all"])
def test_sampler_tied_and_constant_rows(dev, dtype, which_k):
    # five distinct values a row (most columns tie at the threshold), one
    # constant row: the ids stay exact, ties to the lowest index
    g = torch.Generator(device=dev).manual_seed(11)
    rows, V = 40, 8192
    k = {"one": 1, "tenth": -(-V // 10), "all": V}[which_k]
    logits = (torch.randint(0, 5, (rows, V), generator=g, device=dev).float() * 0.75 - 1.0).to(dtype)
    logits[3] = 2.5
    noise = _gumbel((rows, V), g, dev)
    noise[5] = 0.0  # ties in the score too
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    idx, prob = sampling_kernel.fused_topk_gumbel_sample(logits, k, 0.8, seed, noise=noise)
    pidx, pprob = sampling_kernel.fused_topk_gumbel_sample_plain(logits, k, 0.8, seed, noise=noise)
    assert torch.equal(idx, pidx)
    torch.testing.assert_close(prob, pprob, rtol=1e-5, atol=0)


def test_sampler_nan_and_infinite_rows_do_not_fault(dev):
    # a row that holds a NaN or an infinity guesses no histogram bins; the
    # rows beside it stay exact and +inf wins its row
    g = torch.Generator(device=dev).manual_seed(5)
    rows, V = 40, 65536
    logits = (torch.randn(rows, V, generator=g, device=dev) * 3).to(torch.bfloat16)
    noise = _gumbel((rows, V), g, dev)
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    k = -(-V // 10)
    pidx, _ = sampling_kernel.fused_topk_gumbel_sample_plain(logits, k, 0.8, seed, noise=noise)
    broken = logits.clone()
    broken[3, 77] = float("nan")
    broken[5, 4099] = float("inf")
    broken[8, 12] = float("-inf")
    for x in (broken, broken.float()):
        idx, _ = sampling_kernel.fused_topk_gumbel_sample(x, k, 0.8, seed, noise=noise)
        torch.cuda.synchronize()
        sound = torch.ones(rows, dtype=torch.bool, device=dev)
        sound[[3, 5, 8]] = False
        assert torch.equal(idx[sound], pidx[sound])
        assert int(idx[5]) == 4099


def test_sampler_part_clocks(dev):
    logits = torch.randn(300, 65536, device=dev).to(torch.bfloat16)
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    parts = sampling_kernel.sample_part_clocks(logits, 6554, 1.0, seed)
    assert tuple(parts) == sampling_kernel.PARTS
    assert all(c >= 0 for c in parts.values()) and sum(parts.values()) > 0


def test_sampler_philox_stream_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn(64, 4096, generator=g, device=dev).to(torch.bfloat16)
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    idx, _ = sampling_kernel.fused_topk_gumbel_sample(logits, 410, 1.0, seed)
    pidx, _ = sampling_kernel.fused_topk_gumbel_sample_plain(logits, 410, 1.0, seed)
    # the same Philox bits; log may differ in the last place between the
    # kernel's logf and PyTorch's, which can flip a rare near-tie
    assert (idx == pidx).float().mean().item() >= 0.95


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sampler_reads_its_cfg_scale_from_device_memory(dev, dtype):
    # cfg_pair with the scale of a guidance ramp's step as a one-element f32
    # tensor on the card: ids exact, and the same as with that host float
    g = torch.Generator(device=dev).manual_seed(17)
    rows, V = 133, 65536
    k = -(-V // 10)
    logits = (torch.randn(2 * rows, V, generator=g, device=dev) * 3).to(dtype)
    noise = _gumbel((rows, V), g, dev)
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    ramp_step = 1.2352941  # not a bf16 value
    scale = torch.tensor([ramp_step], device=dev)
    kw = dict(noise=noise, cfg_pair=True)
    idx, prob = sampling_kernel.fused_topk_gumbel_sample(logits, k, 0.8, seed, cond_scale=scale, **kw)
    pidx, pprob = sampling_kernel.fused_topk_gumbel_sample_plain(logits, k, 0.8, seed, cond_scale=scale, **kw)
    assert torch.equal(idx, pidx)
    torch.testing.assert_close(prob, pprob, rtol=1e-5, atol=0)
    hidx, hprob = sampling_kernel.fused_topk_gumbel_sample(logits, k, 0.8, seed, cond_scale=ramp_step, **kw)
    assert torch.equal(hidx, idx) and torch.equal(hprob, prob)
    # replayed from a CUDA graph, the kernel reads the scale written since
    graph = torch.cuda.CUDAGraph()
    sampling_kernel.fused_topk_gumbel_sample(logits, k, 0.8, seed, cond_scale=scale, **kw)  # warm-up
    with torch.cuda.graph(graph):
        gidx, _ = sampling_kernel.fused_topk_gumbel_sample(logits, k, 0.8, seed, cond_scale=scale, **kw)
    scale.fill_(4.5)
    graph.replay()
    widx, _ = sampling_kernel.fused_topk_gumbel_sample_plain(logits, k, 0.8, seed, cond_scale=4.5, **kw)
    assert torch.equal(gidx, widx) and not torch.equal(widx, idx)
    for bad in (torch.tensor([2.0]), torch.tensor([2.0], device=dev, dtype=torch.float64), torch.ones(2, device=dev)):
        with pytest.raises(ValueError, match="cond_scale"):
            sampling_kernel.fused_topk_gumbel_sample(logits, k, 0.8, seed, cond_scale=bad, **kw)


# the sampling surfaces' K2 shapes: 400 queries (a 320px base stage, 3 x 128
# + 16), 384 (a 256 x 384 rectangle), and the negative-prompt cross mask,
# where both CFG halves attend real text padded to one length
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ["self_400", "self_384", "negative_cross"])
def test_qknorm_sampling_surface_shapes(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(len(shape))
    b, h, d = 4, 8, 64
    n, m = {"self_400": (400, 400), "self_384": (384, 384), "negative_cross": (400, 64)}[shape]
    q = torch.randn(b, n, h, d, generator=g, device=dev).to(dtype)
    kv = torch.randn(b, m, 2 * h * d, generator=g, device=dev).to(dtype)
    k, v = (t.reshape(b, m, h, d) for t in kv.chunk(2, dim=-1))
    nk, nv = (torch.randn(h, d, generator=g, device=dev).to(dtype) for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(d, generator=g, device=dev) for _ in range(2))
    mask = None
    if shape == "negative_cross":
        # positive rows: texts of up to 64 tokens; negative rows: 16, padded
        lengths = torch.tensor([64, 37, 16, 9], device=dev)[:, None]
        mask = torch.arange(m, device=dev)[None] < lengths
    args = (q, k, v, nk, nv, qs, ks)
    out = attention.qknorm_attend(*args, mask=mask)
    ref = attention.qknorm_attend_plain(*args, mask=mask)
    tol = 1e-4 if dtype == torch.float32 else K2_BF16_FROM_F32
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    if dtype == torch.bfloat16:
        rounded = attention.qknorm_attend_plain(*args, mask=mask, round_to=torch.bfloat16)
        torch.testing.assert_close(out.float(), rounded.float(), rtol=0, atol=BF16_VS_ROUNDED)


def _leaves_close(got, want, frac):
    """Each gradient within frac of its largest |entry| (f32 comparison)."""
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if b.numel():
            b = b.float()
            torch.testing.assert_close(a.float(), b, rtol=0, atol=frac * b.abs().max().item(), msg=f"leaf {i}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_qknorm_gradients_match_plain(dev, dtype):
    # inputs that need a gradient: K2 runs the forward (one launch) and K2's
    # backward kernel (one launch); against autograd through
    # `qknorm_attend_plain`, which computes in f32 on the same inputs: f32
    # within 1e-4 of each gradient's max (summation order), bf16 within
    # K2_BWD_BF16_FROM_F32 (the kernel's bf16 roundings)
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(3, 70, 2, 64, generator=g, device=dev).to(dtype) for _ in range(3))
    nk, nv = (torch.randn(2, 64, generator=g, device=dev).to(dtype) for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(64, generator=g, device=dev) for _ in range(2))
    mask = torch.rand(3, 70, generator=g, device=dev) > 0.3
    mask[0] = False  # a CFG-dropped row: the null position only
    cot = torch.randn(3, 70, 2, 64, generator=g, device=dev).to(dtype)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, nk, nv, qs, ks)]
        out = fn(*leaves, mask=mask)
        (out.float() * cot.float()).sum().backward()
        return out, [t.grad for t in leaves]

    before = attention.qknorm_attend.launches, attention.qknorm_attend_backward.launches
    out, got = grads(attention.qknorm_attend)
    assert (attention.qknorm_attend.launches, attention.qknorm_attend_backward.launches) == (before[0] + 1, before[1] + 1)
    ref, want = grads(attention.qknorm_attend_plain)
    tol = 1e-4 if dtype == torch.float32 else K2_BF16_FROM_F32
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    _leaves_close(got, want, 1e-4 if dtype == torch.float32 else K2_BWD_BF16_FROM_F32)
    # with the gradient off the kernel runs alone and saves nothing
    with torch.no_grad():
        assert attention.qknorm_attend(q.requires_grad_(), k, v, nk, nv, qs, ks, mask=mask).grad_fn is None


# K2's backward kernel against its plain version: ragged n and m with a
# partial mask and a dropped row, no keys, a cross-attention with a dropped
# row, and n = m = 1024 (the super-res self-attention's length); then the
# one-pass route's edges (bf16 takes it at n <= 256, any m, and the split
# route above): m = 256 and 257 (a full and a ragged last key tile), n = 1,
# n = 200 over 64 keys, a batch mixing a fully masked row with ragged and
# partial ones, and n = 256 / 257 on either side of the route's limit; then
# the f32 keys kernel's edges: m = 63, 64 and 65 (a partial, a full and an
# extra key tile), n = 65 (a second query tile of one row), and 640 blocks
# of (key tile, head, batch), more than four waves of 132; then the bf16
# split route's edges (n > 256: 128-row blocks, TMA rings): no keys, a
# ragged n = 1025 over m = 200 with a ragged text and a dropped row, m = 63
# and 65 (WG 1's 64 keys past m, or one key), the super-res cross shape
# (text keys then 256 conditioning keys, the null half's text keys off),
# and 576 key blocks of (128 keys, head, batch), more than four waves; then
# the base stage's train shapes at the 4 heads a rank of a two-way tensor
# split runs
BACKWARD_SHAPES = {
    "ragged": (3, 70, 200, 2, "partial"),
    "m0": (2, 70, 0, 2, None),
    "cross_dropped": (4, 256, 64, 8, "dropped"),
    "n1024": (1, 1024, 1024, 2, None),
    "m256": (2, 130, 256, 2, "partial"),
    "m257": (2, 130, 257, 2, "partial"),
    "n1": (3, 1, 70, 2, "partial"),
    "n200_m64": (2, 200, 64, 2, "dropped"),
    "mixed_rows": (4, 96, 150, 2, "mixed"),
    "n256": (2, 256, 100, 2, "partial"),
    "n257": (2, 257, 100, 2, "partial"),
    "m63": (2, 70, 63, 2, "partial"),
    "m64": (2, 70, 64, 2, "partial"),
    "m65": (2, 70, 65, 2, "partial"),
    "n65": (3, 65, 130, 2, "mixed"),
    "waves": (8, 65, 640, 8, "partial"),
    "n300_m0": (2, 300, 0, 2, None),
    "n1025_m200": (2, 1025, 200, 2, "mixed"),
    "n300_m63": (2, 300, 63, 2, "partial"),
    "n300_m65": (2, 300, 65, 2, "partial"),
    "sr_cross": (4, 1024, 320, 8, "superres"),
    "split_waves": (8, 300, 1100, 8, "partial"),
    "tp_self": (64, 256, 256, 4, None),
    "tp_cross": (64, 256, 64, 4, "dropped"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(BACKWARD_SHAPES))
def test_qknorm_backward_matches_plain(dev, dtype, shape):
    b, n, m, h, mask_kind = BACKWARD_SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(n + m)
    q = torch.randn(b, n, h, 64, generator=g, device=dev).to(dtype)
    kv = torch.randn(b, m, 2 * h * 64, generator=g, device=dev).to(dtype)
    k, v = (t.reshape(b, m, h, 64) for t in kv.chunk(2, dim=-1))  # strided views, as the model passes them
    nk, nv = (torch.randn(h, 64, generator=g, device=dev).to(dtype) for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(64, generator=g, device=dev) for _ in range(2))
    mask = None
    if mask_kind == "superres":
        mask = torch.ones(b, m, dtype=torch.bool, device=dev)
        mask[b // 2 :, : m - 256] = False  # the null half's text keys; the conditioning keys stay on
    elif mask_kind is not None:
        mask = torch.rand(b, m, generator=g, device=dev) > (-1.0 if mask_kind == "dropped" else 0.3)
        if mask_kind == "mixed":
            mask[0] = torch.arange(m, device=dev) < m // 3  # a ragged text: keys on up to its length
        mask[b - 1] = False  # a CFG-dropped row: the null position only
    cot = torch.randn(b, n, h, 64, generator=g, device=dev).to(dtype)
    args = [q, k, v, nk, nv, qs, ks]

    def kernel():
        leaves = [t.detach().requires_grad_() for t in args]
        return torch.autograd.grad(attention.qknorm_attend(*leaves, mask=mask), leaves, cot)

    before = attention.qknorm_attend_backward.launches
    got = kernel()
    assert attention.qknorm_attend_backward.launches == before + 1
    assert attention._backward_one_pass(n, dtype) == (dtype == torch.bfloat16 and n <= 256)
    again = kernel()
    assert all(torch.equal(a, c) for a, c in zip(got, again)), "two launches gave different gradients"
    # the public wrapper from the forward's output and logsumexp: the same kernel
    out, lse = attention.qknorm_attend_with_lse(*args, mask=mask)
    direct = attention.qknorm_attend_backward(cot, *args, out, lse, mask=mask)
    assert all(torch.equal(a, c) for a, c in zip(got, direct))
    want = attention.qknorm_attend_backward_plain(cot, *args, mask=mask)
    if m == 0:
        # no keys: P_0 = 1, so dq, d null_k and the scales' gradients are 0
        # up to rounding, and g reaches null_v whole
        for i in (0, 3, 5, 6):
            assert got[i].float().abs().max().item() <= 1e-4, i
        _leaves_close(got[4:5], [cot.float().sum(dim=(0, 1)).to(dtype)], 1e-4 if dtype == torch.float32 else K2_BWD_BF16_VS_ROUNDED)
        assert got[1].numel() == got[2].numel() == 0
        return
    if mask_kind not in (None, "superres"):
        assert got[0][b - 1].float().abs().max().item() <= 1e-4  # the dropped row's q sees no key
    if dtype == torch.float32:
        _leaves_close(got, want, 1e-4)
    else:
        _leaves_close(got, want, K2_BWD_BF16_FROM_F32)
        rounded = attention.qknorm_attend_backward_plain(cot, *args, mask=mask, round_to=torch.bfloat16)
        _leaves_close(got, rounded, K2_BWD_BF16_VS_ROUNDED)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mask_kind", [None, "dropped"], ids=["self", "cross"])
def test_qknorm_forward_on_a_tensor_ranks_heads(dev, dtype, mask_kind):
    # what a rank of a two-way tensor split runs at the base stage's train
    # shapes: heads 4..7 of 8. On views of the whole call's inputs (q, and k
    # and v of one [k | v] projection) the kernel gives the whole call's
    # heads bit for bit; at 4 heads it holds to the plain version as at 8
    b, n, h = 64, 256, 8
    m = 256 if mask_kind is None else 64
    part = slice(4, 8)
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn(b, n, h, 64, generator=g, device=dev).to(dtype)
    kv = torch.randn(b, m, 2 * h * 64, generator=g, device=dev).to(dtype)
    k, v = (t.reshape(b, m, h, 64) for t in kv.chunk(2, dim=-1))
    nk, nv = (torch.randn(h, 64, generator=g, device=dev).to(dtype) for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(64, generator=g, device=dev) for _ in range(2))
    mask = None
    if mask_kind == "dropped":
        mask = torch.ones(b, m, dtype=torch.bool, device=dev)
        mask[b - 1] = False
    whole = attention.qknorm_attend(q, k, v, nk, nv, qs, ks, mask=mask)
    before = attention.qknorm_attend.launches
    args = [q[:, :, part], k[:, :, part], v[:, :, part], nk[part], nv[part], qs, ks]
    half = attention.qknorm_attend(*args, mask=mask)
    assert attention.qknorm_attend.launches == before + 1
    assert torch.equal(half, whole[:, :, part])
    ref = attention.qknorm_attend_plain(*args, mask=mask)
    torch.testing.assert_close(half.float(), ref.float(), rtol=0, atol=1e-4 if dtype == torch.float32 else K2_BF16_FROM_F32)
    if dtype == torch.bfloat16:
        rounded = attention.qknorm_attend_plain(*args, mask=mask, round_to=torch.bfloat16)
        torch.testing.assert_close(half.float(), rounded.float(), rtol=0, atol=BF16_VS_ROUNDED)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_qknorm_backward_without_queries_launches_nothing(dev, dtype):
    # n = 0: every gradient is zero, and no kernel is launched or counted
    h = 2
    q = torch.randn(2, 0, h, 64, device=dev).to(dtype)
    k, v = (torch.randn(2, 5, h, 64, device=dev).to(dtype) for _ in range(2))
    nk, nv = (torch.randn(h, 64, device=dev).to(dtype) for _ in range(2))
    qs, ks = torch.ones(64, device=dev), torch.ones(64, device=dev)
    out, lse = torch.empty_like(q), torch.empty(2, h, 0, device=dev)
    before = attention.qknorm_attend_backward.launches
    grads = attention.qknorm_attend_backward(torch.empty_like(q), q, k, v, nk, nv, qs, ks, out, lse)
    assert attention.qknorm_attend_backward.launches == before
    for got, x in zip(grads, (q, k, v, nk, nv, qs, ks)):
        assert got.shape == x.shape and got.dtype == x.dtype and not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [70, 200])
def test_attention_matches_plain(dev, dtype, m):
    g = torch.Generator(device=dev).manual_seed(m)
    b, n, h, d = 3, 80, 2, 64  # n, m: not multiples of the kernels' tiles
    q = torch.randn(b, n, h, d, generator=g, device=dev).to(dtype)
    kv = torch.randn(b, m, 2 * h * d, generator=g, device=dev).to(dtype)
    k, v = (t.reshape(b, m, h, d) for t in kv.chunk(2, dim=-1))  # strided views
    nk, nv = (torch.randn(h, d, generator=g, device=dev).to(dtype) for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(d, generator=g, device=dev) for _ in range(2))
    mask = torch.rand(b, m, generator=g, device=dev) > 0.3
    mask[1] = False  # row 1 attends to the null position only
    args = (q, k, v, nk, nv, qs, ks)
    before = attention.qknorm_attend.launches
    out = attention.qknorm_attend(*args, mask=mask)
    assert attention.qknorm_attend.launches == before + 1
    ref = attention.qknorm_attend_plain(*args, mask=mask)
    # f32: summation order only; bf16: as far as the Pallas kernel keeps from f32
    tol = 1e-4 if dtype == torch.float32 else K2_BF16_FROM_F32
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(out[1].float(), nv.float().expand(n, h, d), rtol=0, atol=tol)
    if dtype == torch.bfloat16:
        rounded = attention.qknorm_attend_plain(*args, mask=mask, round_to=torch.bfloat16)
        torch.testing.assert_close(out.float(), rounded.float(), rtol=0, atol=BF16_VS_ROUNDED)


# the Hopper core behind both bf16 attentions: ragged kv (65 keys: one key
# past a tile), kv over more tiles than the 3-stage ring holds (257, 1025),
# queries not a multiple of the 128-query block
@pytest.mark.parametrize("m", [65, 257, 1025])
def test_qknorm_bf16_core(dev, m):
    g = torch.Generator(device=dev).manual_seed(m)
    b, n, h, d = 3, 200, 4, 64
    q = torch.randn(b, n, h, d, generator=g, device=dev).bfloat16()
    kv = torch.randn(b, m, 2 * h * d, generator=g, device=dev).bfloat16()
    k, v = (t.reshape(b, m, h, d) for t in kv.chunk(2, dim=-1))  # strided views
    nk, nv = (torch.randn(h, d, generator=g, device=dev).bfloat16() for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(d, generator=g, device=dev) for _ in range(2))
    mask = torch.rand(b, m, generator=g, device=dev) > 0.3
    mask[2] = False  # row 2 attends to the null position only
    args = (q, k, v, nk, nv, qs, ks)
    for mk in (None, mask):
        out = attention.qknorm_attend(*args, mask=mk)
        rounded = attention.qknorm_attend_plain(*args, mask=mk, round_to=torch.bfloat16)
        plain = attention.qknorm_attend_plain(*args, mask=mk)
        torch.testing.assert_close(out.float(), rounded.float(), rtol=0, atol=BF16_VS_ROUNDED)
        torch.testing.assert_close(out.float(), plain.float(), rtol=0, atol=K2_BF16_FROM_F32)
    torch.testing.assert_close(out[2].float(), nv.float().expand(n, h, d), rtol=0, atol=BF16_VS_ROUNDED)
    # the same tensors, contiguous: the TMA maps read the views by stride
    dense = attention.qknorm_attend(q, k.contiguous(), v.contiguous(), nk, nv, qs, ks, mask=mask)
    assert torch.equal(dense, out)


# the super-res cross-attention under CFG: text keys then 256 conditioning
# keys; the cond half sees its (ragged) text, the null half has every text
# key off, the conditioning keys are on for all. At 64 text keys a whole
# key tile is off for half the rows and on for the others; at 16 the tiles
# are ragged (272 keys)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("text", [64, 16, 8])
def test_qknorm_superres_cross_mask(dev, dtype, text):
    g = torch.Generator(device=dev).manual_seed(text)
    b, n, h, d, m = 6, 200, 2, 64, text + 256
    q = torch.randn(b, n, h, d, generator=g, device=dev).to(dtype)
    kv = torch.randn(b, m, 2 * h * d, generator=g, device=dev).to(dtype)
    k, v = (t.reshape(b, m, h, d) for t in kv.chunk(2, dim=-1))
    nk, nv = (torch.randn(h, d, generator=g, device=dev).to(dtype) for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(d, generator=g, device=dev) for _ in range(2))
    mask = torch.ones(b, m, dtype=torch.bool, device=dev)
    mask[b // 2 :, :text] = False
    lengths = torch.randint(1, text + 1, (b // 2, 1), generator=g, device=dev)
    mask[: b // 2, :text] = torch.arange(text, device=dev)[None] < lengths
    args = (q, k, v, nk, nv, qs, ks)
    out = attention.qknorm_attend(*args, mask=mask)
    ref = attention.qknorm_attend_plain(*args, mask=mask)
    tol = 1e-4 if dtype == torch.float32 else K2_BF16_FROM_F32
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    # the null half equals an attention over the conditioning keys alone
    cond_only = attention.qknorm_attend(q[b // 2 :], k[b // 2 :, text:], v[b // 2 :, text:], nk, nv, qs, ks)
    torch.testing.assert_close(out[b // 2 :].float(), cond_only.float(), rtol=0, atol=tol)
    if dtype == torch.bfloat16:
        rounded = attention.qknorm_attend_plain(*args, mask=mask, round_to=torch.bfloat16)
        torch.testing.assert_close(out.float(), rounded.float(), rtol=0, atol=BF16_VS_ROUNDED)


def test_xla_sampler_first_index_on_the_card(dev):
    # rows of heavy ties: the first maximal index, as on the CPU
    from muse_maskgit_pytorch_tpu_torch.utils.sampling import first_argmax, top_k

    g = torch.Generator().manual_seed(2)
    t = torch.randint(0, 3, (64, 5, 4096), generator=g).float()
    assert torch.equal(first_argmax(t.to(dev)).cpu(), first_argmax(t))
    assert torch.equal(first_argmax(t.to(dev)).cpu(), t.argmax(-1))
    logits = torch.randn(64, 4096, generator=g).bfloat16()
    assert torch.equal(top_k(logits.to(dev), 0.9).cpu(), top_k(logits, 0.9))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_qknorm_without_keys_returns_null_v(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(11)
    b, n, h, d = 2, 70, 2, 64
    q = torch.randn(b, n, h, d, generator=g, device=dev).to(dtype)
    k = v = torch.empty(b, 0, h, d, device=dev, dtype=dtype)
    nk, nv = (torch.randn(h, d, generator=g, device=dev).to(dtype) for _ in range(2))
    qs = ks = torch.ones(d, device=dev)
    out = attention.qknorm_attend(q, k, v, nk, nv, qs, ks)
    torch.testing.assert_close(out.float(), nv.float().expand(b, n, h, d), rtol=0, atol=1e-6)


def _plain_lse(q, k, nk, qs, ks, mask, scale=8.0):
    """Each row's logsumexp over the null position and the keys, in plain
    PyTorch (f32): what K2's forward writes for the backward."""

    def norm(t):
        return t * torch.rsqrt((t * t).sum(-1, keepdim=True) + 1e-12)

    qn, kn, nkn = norm(q) * qs * scale, norm(k) * ks, norm(nk) * ks
    s = torch.einsum("bnhd,bmhd->bhnm", qn, kn)
    if mask is not None:
        s = s + attention.key_mask_bias(mask, k.shape[0], k.shape[1], q.device)[:, None, None, :]
    s0 = torch.einsum("bnhd,hd->bhn", qn, nkn)
    return torch.logsumexp(torch.cat([s0[..., None], s], -1), -1)


# K2's f32 forward (`qknorm_fwd_f32`, 128 queries a block, 64-key tiles) at
# its edges: one query, a block less one, exactly one, one more; no key, one,
# a tile less one, exactly one, one more, five tiles; k and v strided views
# of one to_kv output; a partial mask, and the last row's keys all masked
# (null_v, its tiles skipped)
@pytest.mark.parametrize("m", [0, 1, 63, 64, 65, 320])
@pytest.mark.parametrize("n", [1, 127, 128, 129])
def test_qknorm_f32_forward_edges(dev, n, m):
    g = torch.Generator(device=dev).manual_seed(1000 * n + m)
    b, h = 3, 2
    q = torch.randn(b, n, h, 64, generator=g, device=dev)
    kv = torch.randn(b, m, 2 * h * 64, generator=g, device=dev)
    k, v = (t.reshape(b, m, h, 64) for t in kv.chunk(2, dim=-1))
    nk, nv = (torch.randn(h, 64, generator=g, device=dev) for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(64, generator=g, device=dev) for _ in range(2))
    mask = None
    if m > 0:
        mask = torch.rand(b, m, generator=g, device=dev) > 0.3
        mask[b - 1] = False
    args = (q, k, v, nk, nv, qs, ks)
    before = attention.qknorm_attend.launches
    out, lse = attention.qknorm_attend_with_lse(*args, mask=mask)
    assert attention.qknorm_attend.launches == before + 1
    again, lse_again = attention.qknorm_attend_with_lse(*args, mask=mask)
    assert torch.equal(out, again) and torch.equal(lse, lse_again), "two launches differ"
    assert torch.equal(attention.qknorm_attend(*args, mask=mask), out)  # the same kernel without the lse
    # f32 on both sides: summation order, base 2 and the folded norms only
    torch.testing.assert_close(out, attention.qknorm_attend_plain(*args, mask=mask), rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, _plain_lse(q, k, nk, qs, ks, mask), rtol=0, atol=1e-5)
    masked = [0, 1, 2] if m == 0 else [b - 1]
    torch.testing.assert_close(out[masked], nv.expand(len(masked), n, h, 64), rtol=0, atol=1e-4)


def test_attention_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 8, 2, 32, device=dev)  # head dim 32
    with pytest.raises(ValueError, match="head dim"):
        attention.qknorm_attend(q, q, q, q[0, 0], q[0, 0], q[0, 0, 0], q[0, 0, 0])


# -- K3: nearest-code search ----------------------------------------------------


def _unit(t):
    return t / t.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize(
    "n, k, d, cosine",
    [(300, 1000, 64, False), (77, 513, 32, True), (1000, 4099, 256, True)],
    ids=["euclidean", "cosine-ragged", "cosine-d256"],
)
def test_nearest_code_matches_plain(dev, n, k, d, cosine):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, d, generator=g, device=dev)
    cb = torch.randn(k, d, generator=g, device=dev)
    cb_sq = None
    if cosine:
        x, cb, cb_sq = _unit(x), _unit(cb), torch.zeros(k, device=dev)
    before = vq.nearest_code.launches
    ids = vq.nearest_code(x, cb, cb_sq)
    assert vq.nearest_code.launches == before + 1
    plain = vq.nearest_code_plain(x, cb, cb_sq)
    assert ids.dtype == torch.int32 and ids.shape == (n,)
    # near-tie rule (tests/test_torch_vq.py): each pick within tol of the f64 best
    scale = 1.0 if cosine else (x.double() ** 2).sum(-1) + (cb.double() ** 2).sum(-1).max()
    for side in (ids, plain):
        assert bool((vq.score_gap(x, cb, side, cb_sq) <= 1e-5 * scale).all())


def test_nearest_code_duplicates_exact(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    distinct = _unit(torch.randn(64, 256, generator=g, device=dev))
    cb = distinct[torch.randint(0, 64, (4097,), generator=g, device=dev)]
    x = _unit(distinct[torch.randint(0, 64, (333,), generator=g, device=dev)] + 0.05 * torch.randn(333, 256, generator=g, device=dev))
    zeros = torch.zeros(len(cb), device=dev)
    ids = vq.nearest_code(x, cb, zeros)
    assert torch.equal(ids, vq.nearest_code_plain(x, cb, zeros))


def test_nearest_code_at_the_gan_training_shape(dev):
    """EMA-VQ's search in the reference GAN step: (2048, 256) x (65536, 256),
    cosine. 16 row tiles on 132 SMs give 8 codebook splits; ties across the
    splits go to the lowest index (every code stored twice, half a codebook
    apart)."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = _unit(torch.randn(2048, 256, generator=g, device=dev))
    cb = _unit(torch.randn(65536, 256, generator=g, device=dev))
    zeros = torch.zeros(65536, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert vq._k_splits(2048, 65536, dev) == min(512, sms // 16)
    before = vq.nearest_code.launches
    ids = vq.nearest_code(x, cb, zeros)
    assert vq.nearest_code.launches == before + 1
    for side in (ids, vq.nearest_code_plain(x, cb, zeros)):
        assert bool((vq.score_gap(x, cb, side, zeros) <= 1e-5).all())
    twice = torch.cat([cb[:32768], cb[:32768]])
    ids = vq.nearest_code(x, twice, zeros)
    assert int(ids.max()) < 32768
    assert torch.equal(ids, vq.nearest_code_plain(x, twice, zeros))


def test_nearest_code_on_a_kmeans_codebook(dev):
    """k-means' first centres: 65536 rows drawn from 2048, so most codes are
    exact duplicates; its assignment (euclidean, the rows themselves) gives
    the plain version's ids exactly."""
    g = torch.Generator(device=dev).manual_seed(8)
    z = _unit(torch.randn(2048, 256, generator=g, device=dev))
    cb = z[torch.randint(0, 2048, (65536,), generator=g, device=dev)]
    ids = vq.nearest_code(z, cb)
    assert torch.equal(ids, vq.nearest_code_plain(z, cb))


def test_ema_vq_codebook_update_repeats_bit_identically(dev):
    """No float atomics in the codebook statistics: the same update from the
    same state twice gives the same bits, and the per-code sums match the
    one-hot product."""
    from muse_maskgit_pytorch_tpu_torch import VectorQuantizeEMA
    from muse_maskgit_pytorch_tpu_torch.models.quantizers import VQDraws, _code_sums

    g = torch.Generator(device=dev).manual_seed(9)
    z = torch.randn(16384, 256, generator=g, device=dev)
    codes = torch.randint(0, 4096, (16384,), generator=g, device=dev).int()
    counts, sums = _code_sums(z, codes, 4096)
    again = _code_sums(z, codes, 4096)
    assert torch.equal(counts, again[0]) and torch.equal(sums, again[1])
    onehot = torch.nn.functional.one_hot(codes.long(), 4096).float()
    torch.testing.assert_close(sums, onehot.T @ z, rtol=1e-5, atol=1e-4)
    results = []
    for _ in range(2):
        q = VectorQuantizeEMA(
            dim=64, codebook_size=4096, threshold_ema_dead_code=2.0, generator=torch.Generator().manual_seed(0)
        )
        x = torch.randn(8, 16, 16, 64, generator=torch.Generator(device=dev).manual_seed(10), device=dev)
        draws = VQDraws.draw(4096, 2048, torch.Generator().manual_seed(11))
        before = vq.nearest_code.launches
        q.update_from_input(x, rng=draws)
        q.update_from_input(x + 0.1, rng=draws)
        assert vq.nearest_code.launches == before + 10 + 2  # k-means, then one search an update
        results.append([b.clone() for b in q.buffers()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_sampler_row_offset(dev):
    """A data-parallel rank's rows: with `row_offset`, rows [off, off + n)
    sample bit for bit what they sample in the whole batch, in the kernel
    and in the plain version; kernel against plain as at offset 0."""
    g = torch.Generator(device=dev).manual_seed(4)
    off, n = 37, 96
    logits = torch.randn(off + n, 65536, generator=g, device=dev).to(torch.bfloat16)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    idx, prob = sampling_kernel.fused_topk_gumbel_sample(logits, 6554, 1.0, seed)
    idx_off, prob_off = sampling_kernel.fused_topk_gumbel_sample(logits[off:], 6554, 1.0, seed, row_offset=off)
    assert torch.equal(idx_off, idx[off:]) and torch.equal(prob_off, prob[off:])
    pidx, pprob = sampling_kernel.fused_topk_gumbel_sample_plain(logits, 6554, 1.0, seed)
    pidx_off, pprob_off = sampling_kernel.fused_topk_gumbel_sample_plain(logits[off:], 6554, 1.0, seed, row_offset=off)
    assert torch.equal(pidx_off, pidx[off:]) and torch.equal(pprob_off, pprob[off:])
    assert (idx_off == pidx_off).float().mean().item() >= 0.95


@pytest.fixture
def nccl_group(dev):
    """A process group of one NCCL rank on 127.0.0.1, destroyed after."""
    import socket

    import torch.distributed as dist

    from muse_maskgit_pytorch_tpu_torch.parallel import init_distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(backend="nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_tensor_collectives_on_cuda_tensors_under_gloo(dev):
    """`parallel.tensor`'s collectives in a gloo group on CUDA tensors (how
    two ranks share one card): the gather through an integer all-reduce
    keeps every bit, a -0.0 too; bf16 reduces in f32 and comes back bf16."""
    import socket

    import torch.distributed as dist

    from muse_maskgit_pytorch_tpu_torch.parallel import create_mesh, init_distributed
    from muse_maskgit_pytorch_tpu_torch.parallel.tensor import all_gather, all_reduce, tensor_split

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(backend="gloo", device="cuda", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        mesh = create_mesh({"tensor": 1})
        assert mesh.device_type == "cuda" and tensor_split(mesh) is None
        x = torch.randn(3, 5, device=dev)
        x[0, 0] = -0.0
        for t in (x, x.to(torch.bfloat16), torch.arange(7, device=dev), x > 0):
            (got,) = all_gather(t)
            assert got.device == t.device and got.dtype == t.dtype
            assert torch.equal(got.view(torch.uint8), t.view(torch.uint8)) if t.dtype != torch.bool else torch.equal(got, t)
        assert torch.signbit(all_gather(x)[0][0, 0])
        y = all_reduce(x.to(torch.bfloat16), None)
        assert y.dtype == torch.bfloat16 and torch.equal(y, x.to(torch.bfloat16))
    finally:
        dist.destroy_process_group()


def test_sharded_maskgit_step_matches_unwrapped(dev, nccl_group, tmp_path):
    """`MaskGitTrainer(mesh=create_mesh(), shard_state=True)` over an NCCL
    group of one against the unwrapped trainer, two f32 steps from one
    seed: losses within 1e-5 relative, weights within 1e-5, and K2's
    gradient launched inside the wrapped step (2 layers x self and cross)."""
    from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTrainer
    from muse_maskgit_pytorch_tpu_torch.parallel import TrivialMesh, create_mesh

    def trainer(name, mesh, shard):
        t = MaskGitTransformer(
            num_tokens=256, dim=128, seq_len=64, depth=2, dim_head=64, heads=2, text_embed_dim=32, self_cond=True,
            dtype=torch.float32, generator=torch.Generator().manual_seed(0),
        )
        return MaskGitTrainer(
            MaskGit(image_size=32, transformer=t), num_train_steps=10, batch_size=8, lr=1e-3,
            results_folder=str(tmp_path / name), mesh=mesh, shard_state=shard,
        )

    g = torch.Generator(device=dev).manual_seed(1)
    batch = (
        torch.randint(0, 256, (1, 8, 64), generator=g, device=dev),
        torch.randn(1, 8, 5, 32, generator=g, device=dev),
        torch.ones(1, 8, 5, dtype=torch.bool, device=dev),
    )
    plain, wrapped = trainer("plain", TrivialMesh(), False), trainer("wrapped", create_mesh(), True)
    assert wrapped.dp.active and not plain.dp.active
    for _ in range(2):
        want = plain.train_step_arrays(*batch)["loss"]
        before = attention.qknorm_attend_backward.launches
        got = wrapped.train_step_arrays(*batch)["loss"]
        assert attention.qknorm_attend_backward.launches - before == 2 * 2
        assert got == pytest.approx(want, rel=1e-5)
    for a, b in zip(plain.params, wrapped.dp.gather(wrapped.dp.masters)):
        assert (a - b).abs().max().item() <= 1e-5


def test_vqgan_trainer_step_on_the_card(dev, tmp_path):
    """A small GAN step with EMA-VQ on the card: K3 three times a step (ten
    more for k-means on the first), finite logs, no gradient left behind."""
    from muse_maskgit_pytorch_tpu_torch import VQGanVAETrainer

    vae = VQGanVAE(
        dim=32, layers=2, codebook_size=1024, lookup_free_quantization=False,
        generator=torch.Generator().manual_seed(0), vq_kwargs=dict(codebook_dim=64),
    )
    t = VQGanVAETrainer(
        vae, folder=None, dataset=[torch.zeros(32, 32, 3).numpy()], num_train_steps=3, batch_size=2, image_size=32,
        valid_frac=0.0, save_results_every=10**9, save_model_every=10**9, results_folder=str(tmp_path),
        apply_grad_penalty_every=2,
    )
    imgs = torch.rand(1, 2, 32, 32, 3, generator=torch.Generator(device=dev).manual_seed(12), device=dev)
    launches = []
    for _ in range(3):
        before = vq.nearest_code.launches
        logs = t.train_step_arrays(imgs)
        launches.append(vq.nearest_code.launches - before)
        assert all(torch.isfinite(torch.tensor(v)) for v in logs.values())
    assert launches == [13, 3, 3]
    assert all(p.grad is None for p in vae.parameters())


def test_nearest_code_rejects_what_the_kernel_does_not_take(dev):
    with pytest.raises(ValueError, match="multiple of 4"):
        vq.nearest_code(torch.randn(4, 6, device=dev), torch.randn(8, 6, device=dev))


# -- K4: plain flash attention ---------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d, m", [(64, 70), (32, 300)])
def test_flash_attend_matches_plain(dev, dtype, d, m):
    g = torch.Generator(device=dev).manual_seed(m + d)
    b, h, n = 3, 2, 80  # n, m: not multiples of the kernel's tiles
    q, k, v = (torch.randn(b, h, length, d, generator=g, device=dev).to(dtype) for length in (n, m, m))
    mask = torch.rand(b, m, generator=g, device=dev) > 0.3
    mask[1] = False  # row 1: every key masked, an average over the m keys
    before = attention.attend.launches
    out = attention.attend(q, k, v, mask=mask, scale=8.0, impl="flash")
    assert attention.attend.launches == before + 1 and out.dtype == dtype
    ref = attention.attend_plain(q, k, v, mask=mask, scale=8.0)
    tol = 1e-4 if dtype == torch.float32 else K4_BF16_FROM_F32
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand(h, n, d)
    torch.testing.assert_close(out[1].float(), mean_v, rtol=0, atol=tol)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("m", [65, 257, 1025])
def test_flash_bf16_core(dev, d, m):
    g = torch.Generator(device=dev).manual_seed(m + d)
    b, h, n = 2, 3, 200  # n: not a multiple of the 128-query block
    unit = lambda t: t / t.norm(dim=-1, keepdim=True)  # noqa: E731
    q = unit(torch.randn(b, h, n, d, generator=g, device=dev)).bfloat16()
    # k: a strided view (every other row of a longer buffer); the wrapper copies it
    k = unit(torch.randn(b, h, 2 * m, d, generator=g, device=dev)).bfloat16()[:, :, ::2]
    v = torch.randn(b, h, m, d, generator=g, device=dev).bfloat16()
    mask = torch.rand(b, m, generator=g, device=dev) > 0.3
    mask[1] = False  # row 1: every key masked, an average over the m keys
    for mk in (None, mask):
        out = attention.attend(q, k, v, mask=mk, scale=8.0, impl="flash")
        ref = attention.attend_plain(q, k, v, mask=mk, scale=8.0)
        rounded = attention.attend_plain(q, k, v, mask=mk, scale=8.0, round_to=torch.bfloat16)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=K4_BF16_FROM_F32)
        torch.testing.assert_close(out.float(), rounded.float(), rtol=0, atol=BF16_VS_ROUNDED)
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand(h, n, d)
    torch.testing.assert_close(out[1].float(), mean_v, rtol=0, atol=BF16_VS_ROUNDED)


def test_flash_attend_gradient_recomputes_plain(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(1, 2, 24, 32, generator=g, device=dev, requires_grad=True) for _ in range(3))
    mask = torch.ones(1, 24, dtype=torch.bool, device=dev)
    mask[:, -5:] = False
    attention.attend(q, k, v, mask=mask, scale=8.0, impl="flash").sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention.xla_attention(q, k, v, mask=mask, scale=8.0).sum().backward()
    for got, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(got, t.grad, rtol=5e-3, atol=5e-3)


def test_flash_attend_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 2, 8, 16, device=dev)  # head dim 16
    with pytest.raises(ValueError, match="head dim"):
        attention.attend(q, q, q)  # "auto" is the kernel for CUDA tensors


# -- the public modules live on the card unless asked otherwise --------------


def test_public_modules_default_to_the_card(dev):
    kw = dict(num_tokens=64, dim=16, seq_len=16, depth=1, dim_head=16, heads=1, text_embed_dim=8)
    for build in (
        lambda **d: MaskGitTransformer(generator=torch.Generator().manual_seed(0), **kw, **d),
        lambda **d: VQGanVAE(dim=16, layers=2, codebook_size=64, generator=torch.Generator().manual_seed(0), **d),
        lambda **d: LFQ(dim=8, codebook_size=64, generator=torch.Generator().manual_seed(0), **d),
    ):
        on_card, on_cpu = build(), build(device="cpu")
        assert all(t.device.type == "cuda" for t in on_card.state_dict().values())
        # weights are drawn from the CPU generator first, then placed
        for a, b in zip(on_card.state_dict().values(), on_cpu.state_dict().values()):
            assert torch.equal(a.cpu(), b)


@contextlib.contextmanager
def _cudnn_flags(allow_tf32):
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    # deterministic: both runs pick the same cuDNN algorithms, so any
    # difference is TF32's
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = allow_tf32, True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved


def test_f32_vae_decode_ignores_cudnn_tf32(dev):
    # PyTorch lets cuDNN run f32 convolutions in TF32 by default; the port's
    # f32 convolutions stay IEEE f32 (as JAX's do): the decode with the
    # default equals the decode with TF32 off, bit for bit
    vae = VQGanVAE(dim=64, layers=2, codebook_size=1024, generator=torch.Generator().manual_seed(0))
    ids = torch.randint(0, 1024, (2, 16, 16), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        with _cudnn_flags(True):
            default = vae.decode_from_ids(ids)
            assert torch.backends.cudnn.allow_tf32, "the caller's setting is restored"
        with _cudnn_flags(False):
            ieee = vae.decode_from_ids(ids)
    assert default.dtype == torch.float32 and torch.isfinite(ieee).all()
    assert torch.equal(default, ieee)


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "transposed"])
def test_f32_conv_gradients_ignore_cudnn_tf32(dev, transposed):
    from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d, ConvTranspose2d

    gen = torch.Generator().manual_seed(2)
    # shapes whose cuDNN algorithms all use TF32 when let (at 128 -> 64 over
    # 32 x 32 the plain conv's weight gradient takes an IEEE one either way)
    if transposed:
        conv, shape = ConvTranspose2d(128, 64, generator=gen), (4, 128, 32, 32)
    else:
        conv, shape = Conv2d(256, 256, 3, padding=1, generator=gen), (4, 256, 64, 64)
    conv = conv.to(dev)
    x = torch.randn(*shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev)

    def grads(allow_tf32, layer):
        conv.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        with _cudnn_flags(allow_tf32):
            y = layer(xi)
        # the backward runs later, outside the forward's call, as a trainer's does
        gy = torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
        with _cudnn_flags(allow_tf32):
            y.backward(gy)
        return y.detach(), xi.grad, conv.weight.grad, conv.bias.grad

    names = ("output", "input grad", "weight grad", "bias grad")
    # the check can see TF32: PyTorch's own convolution of the same weights
    # changes its output and both products' gradients with it
    native = lambda xi: (torch.nn.ConvTranspose2d if transposed else torch.nn.Conv2d).forward(conv, xi)  # noqa: E731
    seen = [not torch.equal(a, b) for a, b in zip(grads(True, native), grads(False, native))]
    assert seen[:3] == [True] * 3, dict(zip(names, seen))
    default, ieee = grads(True, conv), grads(False, conv)
    for name, a, b in zip(names, default, ieee):
        assert torch.equal(a, b), name


# -- the FID towers on the card ----------------------------------------------


@pytest.mark.parametrize("tower", ["inception", "vgg"])
def test_fid_towers_on_the_card_match_the_cpu(dev, tower):
    """The towers through their extractors, the same weights and 4 images on
    the card and on the CPU, at the CPU tests' limits (rtol 1e-4, atol 1e-4
    of the largest feature): f32 convolutions stay IEEE on the card. A
    repeat on the card is bit-identical."""
    from muse_maskgit_pytorch_tpu_torch.utils import eval as ev

    if tower == "inception":
        make, kw, px = ev.make_inception_extractor, {"resize_to": 96}, 128  # a shrinking resize
    else:
        make, kw, px = ev.make_vgg_extractor, {}, 64
    x = torch.rand(4, px, px, 3, generator=torch.Generator().manual_seed(2))
    on_cpu = make(device="cpu", seed=3, **kw)
    on_card = make(device=dev, seed=3, **kw)
    ref = on_cpu(x)
    got = on_card(x)
    assert got.device.type == "cuda" and got.shape == ref.shape
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(on_card(x.to(dev)), got)
