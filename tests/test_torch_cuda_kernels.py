"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small odd shapes that the main path does not reach.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode. On a machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest -o addopts=""

(`--noconftest` because the suite's conftest sets up JAX, which a GPU
machine need not have; `-o addopts=""` drops the suite's xdist options).
`chip_smoke.py` checks the same kernels at the main path's shapes.
"""

import pytest
import torch

from muse_maskgit_pytorch_tpu_torch.ops import attention, sampling_kernel

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


@pytest.mark.parametrize("cfg_pair", [False, True], ids=["single", "cfg_pair"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("V", [4096, 1000])  # 1000: not a multiple of 8
def test_sampler_matches_plain(dev, dtype, cfg_pair, V):
    g = torch.Generator(device=dev).manual_seed(V + 2 * cfg_pair)
    rows, k = 37, -(-V // 10)
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
    # f32: summation order only; bf16: one bf16 rounding of the output apart
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(out[1].float(), nv.float().expand(n, h, d), rtol=0, atol=tol)


def test_attention_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 8, 2, 32, device=dev)  # head dim 32
    with pytest.raises(ValueError, match="head dim"):
        attention.qknorm_attend(q, q, q, q[0, 0], q[0, 0], q[0, 0, 0], q[0, 0, 0])
