"""Port parity: K1's plain PyTorch version
(`muse_maskgit_pytorch_tpu_torch/ops/sampling_kernel.py`) against the JAX
package's fused sampler, `fused_topk_gumbel_sample(..., noise=g,
interpret=True)`, under the same injected gumbel noise.

The ids must be identical: the threshold comes from the same f32 bisection
operations and the argmax breaks ties at the lowest index on both sides.
The chosen probabilities agree to rtol 1e-5: the logsumexp of a row is
summed in a different order on each side.

The histogram form of the threshold (`topk_threshold_histogram_plain`, the
algorithm of the CUDA kernel) is held to exact equality, bit for bit, with
the ten-round bisection of the port and of the JAX kernel's body.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from muse_maskgit_pytorch_tpu.ops.sampling_kernel import (
    _BISECT_ITERS,
    fused_topk_gumbel_sample as jax_sample,
)
from muse_maskgit_pytorch_tpu_torch.ops import sampling_kernel as port

ROWS, V, K = 13, 512, 52  # odd row count


def _inputs(seed, rows, pair, bf16):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(2 * rows if pair else rows, V) * 3).astype(np.float32)
    if bf16:
        # round once; both sides then see the same bf16 values
        logits = np.array(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32))
    noise = -np.log(-np.log(rs.uniform(1e-9, 1 - 1e-9, (rows, V)))).astype(np.float32)
    return logits, noise


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("pair", [False, True], ids=["single", "cfg_pair"])
@pytest.mark.parametrize("temperature", [1.0, 0.37, 0.0])
def test_plain_matches_jax_kernel(bf16, pair, temperature):
    logits, noise = _inputs(int(temperature * 100) + 2 * pair + bf16, ROWS, pair, bf16)
    j_logits = jnp.asarray(logits, jnp.bfloat16 if bf16 else jnp.float32)
    t_logits = torch.from_numpy(logits).to(torch.bfloat16 if bf16 else torch.float32)
    j_idx, j_prob = jax_sample(
        j_logits, K, jnp.float32(temperature), jnp.int32(0), noise=jnp.asarray(noise),
        interpret=True, cfg_pair=pair, cond_scale=3.0,
    )
    idx, prob = port.fused_topk_gumbel_sample(
        t_logits, K, temperature, torch.zeros(1, dtype=torch.int32),
        noise=torch.from_numpy(noise), cfg_pair=pair, cond_scale=3.0,
    )
    assert idx.dtype == torch.int32 and idx.shape == (ROWS,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(prob.numpy(), np.asarray(j_prob), rtol=1e-5, atol=1e-7)


def test_cpu_wrapper_runs_plain_version_without_launching():
    logits, noise = _inputs(0, ROWS, False, False)
    before = port.fused_topk_gumbel_sample.launches
    a = port.fused_topk_gumbel_sample(
        torch.from_numpy(logits), K, 1.0, torch.zeros(1, dtype=torch.int32),
        noise=torch.from_numpy(noise),
    )
    b = port.fused_topk_gumbel_sample_plain(
        torch.from_numpy(logits), K, 1.0, torch.zeros(1, dtype=torch.int32),
        noise=torch.from_numpy(noise),
    )
    assert port.fused_topk_gumbel_sample.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_threshold_matches_jax_bisection():
    # the count of the kept set is >= k and within the 10-round slack
    logits, _ = _inputs(3, 64, False, False)
    thresh = port.topk_threshold_plain(torch.from_numpy(logits), K)
    kept = (torch.from_numpy(logits) >= thresh).sum(-1)
    assert bool((kept >= K).all())
    assert bool((kept <= K + V // 2**port.BISECT_ITERS + 8).all())


@pytest.mark.parametrize(
    "ctr, key, want",
    [
        # Random123 known-answer vectors for philox4x32-10
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (
            (0xFFFFFFFF,) * 4,
            (0xFFFFFFFF, 0xFFFFFFFF),
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
        ),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_philox_known_answers(ctr, key, want):
    words = port.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_philox_noise_is_gumbel_and_seeded():
    g = port.philox_gumbel(7, 64, 4096)
    assert g.shape == (64, 4096) and bool(torch.isfinite(g).all())
    # Gumbel(0, 1): mean = Euler's gamma, variance = pi^2 / 6 (262144 draws:
    # standard errors ~0.0025 and ~0.01)
    assert abs(g.mean().item() - 0.5772) < 0.015
    assert abs(g.var().item() - np.pi**2 / 6) < 0.05
    assert torch.equal(g, port.philox_gumbel(7, 64, 4096))
    assert not torch.equal(g, port.philox_gumbel(8, 64, 4096))
    # rows get their own keys
    assert not torch.equal(g[0], g[1])


def test_in_kernel_noise_frequencies_follow_softmax():
    # k = V (no filtering) at temperature 1: the draw frequencies of the
    # Philox stream approximate softmax(logits); 2^14 draws give a frequency
    # standard error <= 0.004, the bound is 0.02
    p = np.array([0.5, 0.2, 0.1, 0.05, 0.05, 0.04, 0.03, 0.03], np.float32)
    logits = torch.from_numpy(np.log(np.tile(p, (1 << 14, 1))))
    idx, prob = port.fused_topk_gumbel_sample(logits, 8, 1.0, torch.tensor([11], dtype=torch.int32))
    freq = np.bincount(idx.numpy(), minlength=8) / (1 << 14)
    np.testing.assert_allclose(freq, p, atol=0.02)
    np.testing.assert_allclose(prob.numpy(), p[idx.numpy()], rtol=1e-5)


def test_zero_temperature_is_first_argmax():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, -1.0, 5.0, 0.0]])
    idx, _ = port.fused_topk_gumbel_sample(logits, 2, 0.0, torch.tensor([3], dtype=torch.int32))
    assert idx.tolist() in ([1, 0], [2, 0], [1, 2], [2, 2])  # a row maximum
    assert bool((logits.gather(1, idx.long()[:, None])[:, 0] == logits.amax(-1)).all())


# ---------------------------------------------------------------------------
# the histogram form of the threshold: exact equality with the bisection
# ---------------------------------------------------------------------------


def _jax_bisection(l, k):
    """The threshold of the JAX kernel's body (`_sample_kernel`, step 1),
    the same operations on a (rows, V) f32 array."""
    l = jnp.asarray(l)
    lo = jnp.min(l, axis=-1, keepdims=True)
    hi = jnp.max(l, axis=-1, keepdims=True)

    def bisect(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum((l >= mid).astype(jnp.float32), axis=-1, keepdims=True)
        ge = cnt >= k
        return jnp.where(ge, mid, lo), jnp.where(ge, hi, mid)

    lo, hi = jax.lax.fori_loop(0, _BISECT_ITERS, bisect, (lo, hi))
    return np.asarray(lo)


def _threshold_rows(kind):
    rs = np.random.RandomState(sum(map(ord, kind)))
    if kind == "bf16":  # bf16-valued rows, as the bf16 trunk's head gives
        l = (rs.randn(6, 8192) * 3).astype(np.float32)
        return np.array(jnp.asarray(l, jnp.bfloat16).astype(jnp.float32))
    if kind == "f32_odd":  # V not a multiple of 8
        return (rs.randn(9, 4099) * 3).astype(np.float32)
    if kind == "few_values":  # heavy ties
        return rs.randint(0, 5, (7, 4099)).astype(np.float32) * 0.75 - 1.0
    if kind == "constant":
        return np.full((3, 1000), 2.5, np.float32)
    if kind == "tiny":  # denormal scale
        return ((rs.randn(5, 4099) * 3).astype(np.float32) * np.float32(1e-38)).astype(np.float32)
    if kind == "huge":
        return ((rs.randn(5, 4099) * 3).astype(np.float32) * np.float32(1e30)).astype(np.float32)
    if kind == "narrow":  # a range far below the magnitude: the tree's mids collide
        return (1000.0 + rs.rand(5, 2048) * 1e-3).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("which_k", ["one", "tenth", "all"])
@pytest.mark.parametrize(
    "kind", ["bf16", "f32_odd", "few_values", "constant", "tiny", "huge", "narrow"]
)
def test_histogram_threshold_equals_bisection(kind, which_k):
    l = _threshold_rows(kind)
    V = l.shape[1]
    k = {"one": 1, "tenth": math.ceil(0.1 * V), "all": V}[which_k]
    t = torch.from_numpy(l)
    want = port.topk_threshold_plain(t, k)
    got = port.topk_threshold_histogram_plain(t, k)
    assert got.shape == want.shape == (l.shape[0], 1)
    # exact equality, compared as bits (so -0.0 and 0.0 would differ too)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    if kind != "tiny":  # XLA's CPU backend flushes denormals to zero: not IEEE there
        np.testing.assert_array_equal(got.numpy().view(np.int32), _jax_bisection(l, k).view(np.int32))


@settings(max_examples=60, deadline=None, database=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    V=st.integers(1, 700),
    scale=st.sampled_from([1e-3, 1.0, 3.0, 1e4]),
    offset=st.sampled_from([0.0, -7.0, 300.0]),
    levels=st.sampled_from([0, 3, 40]),  # 0: continuous values, else that many distinct ones
    k_frac=st.floats(0.0, 1.0),
)
def test_histogram_threshold_equals_bisection_random(seed, V, scale, offset, levels, k_frac):
    rs = np.random.RandomState(seed)
    l = rs.randn(4, V)
    if levels:
        l = np.round(l * levels / 4) * 4 / levels
    t = torch.from_numpy((l * scale + offset).astype(np.float32))
    k = min(V, max(1, round(k_frac * V)))
    want = port.topk_threshold_plain(t, k)
    got = port.topk_threshold_histogram_plain(t, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))  # exact
