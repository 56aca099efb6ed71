"""Port parity: K1's plain PyTorch version
(`muse_maskgit_pytorch_tpu_torch/ops/sampling_kernel.py`) against the JAX
package's fused sampler, `fused_topk_gumbel_sample(..., noise=g,
interpret=True)`, under the same injected gumbel noise.

The ids must be identical: the threshold comes from the same f32 bisection
operations and the argmax breaks ties at the lowest index on both sides.
The chosen probabilities agree to rtol 1e-5: the logsumexp of a row is
summed in a different order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu.ops.sampling_kernel import (
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
