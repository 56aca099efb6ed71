"""Port parity: host-side decode schedule and remask ranking
(`muse_maskgit_pytorch_tpu_torch/utils/sampling.py`, `_compact_segments`)
against the JAX package.

The per-step mask counts must equal the ones the JAX decode computes inside
its jitted scan, bit for bit: `floor(cos(t * pi / 2) * seq)` flips to the
next integer where the f32 product lands next to one, and `torch.linspace`
differs from jitted `jnp.linspace` in the last bit for many step counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu.models import maskgit as jax_maskgit
from muse_maskgit_pytorch_tpu.utils import sampling as jax_sampling
from muse_maskgit_pytorch_tpu_torch.models import maskgit as port_maskgit
from muse_maskgit_pytorch_tpu_torch.utils import sampling as port_sampling

SEQS = (16, 64, 256, 1024)


def _jax_scan_schedule(timesteps: int, seqs, temperature: float):
    """Counts and temperatures exactly as `_generate_jit`'s scan body
    computes them (`models/maskgit.py` there: step times from jnp.linspace,
    count max(floor(schedule(t) * seq), 1), temp * steps_left / T)."""

    @jax.jit
    def run():
        ts = jnp.linspace(0.0, 1.0, timesteps)
        steps_left = jnp.arange(timesteps - 1, -1, -1)

        def body(c, xs):
            t, left = xs
            p = jax_sampling.cosine_schedule(t)
            counts = [jnp.maximum(jnp.floor(p * s), 1).astype(jnp.int32) for s in seqs]
            temp = temperature * (left.astype(jnp.float32) / timesteps)
            return c, (jnp.stack(counts), temp)

        return ts, jax.lax.scan(body, 0, (ts, steps_left))[1]

    ts, (counts, temps) = run()
    return np.asarray(ts), np.asarray(counts).T, np.asarray(temps)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_schedule_counts_match_jax_scan(temperature):
    for timesteps in range(2, 65):
        ts, counts, temps = _jax_scan_schedule(timesteps, SEQS, temperature)
        np.testing.assert_array_equal(
            port_sampling.step_times(timesteps).view(np.int32), ts.view(np.int32)
        )
        for s, c in zip(SEQS, counts):
            np.testing.assert_array_equal(
                port_sampling.mask_counts(port_sampling.cosine_schedule, s, timesteps), c,
                err_msg=f"T={timesteps} seq={s}",
            )
        np.testing.assert_array_equal(
            port_sampling.step_temperatures(temperature, timesteps).view(np.int32),
            temps.view(np.int32),
        )


def test_torch_linspace_is_not_the_jax_schedule():
    # the hazard the host schedule avoids: torch.linspace rounds differently
    differs = [
        T for T in range(2, 65)
        if not np.array_equal(
            torch.linspace(0, 1, T).numpy().view(np.int32),
            port_sampling.step_times(T).view(np.int32),
        )
    ]
    assert differs, "expected torch.linspace to differ from jnp.linspace for some T"


@pytest.mark.parametrize("seq", SEQS)
def test_compact_segments_match_jax(seq):
    for timesteps in range(2, 25):
        for jax_s, port_s in (
            (jax_sampling.cosine_schedule, port_sampling.cosine_schedule),
            (jax_sampling.linear_schedule, port_sampling.linear_schedule),
        ):
            assert port_maskgit._compact_segments(port_s, seq, timesteps) == (
                jax_maskgit._compact_segments(jax_s, seq, timesteps)
            ), (seq, timesteps)


@pytest.mark.parametrize("per_row", [False, True])
def test_mask_by_topk_scores_with_ties(per_row):
    rs = np.random.RandomState(0)
    # few distinct values: many ties, which must break at the lowest index
    scores = rs.choice(np.array([-1e5, 0.25, 0.5, 0.75], np.float32), size=(6, 40))
    counts = rs.randint(1, 40, size=6) if per_row else 17
    j_counts = jnp.asarray(counts) if per_row else jnp.full((6,), counts)
    want = np.asarray(jax_sampling.mask_by_topk_scores(jnp.asarray(scores), j_counts))
    got = port_sampling.mask_by_topk_scores(
        torch.from_numpy(scores), torch.from_numpy(counts) if per_row else counts
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_keeps_threshold_ties():
    logits = np.array([[3.0, 1.0, 2.0, 2.0, 0.0, 2.0]], np.float32)
    want = np.asarray(jax_sampling.top_k(jnp.asarray(logits), thres=0.6))
    got = port_sampling.top_k(torch.from_numpy(logits), thres=0.6).numpy()
    np.testing.assert_array_equal(got, want)


def test_log_and_gumbel_noise_follow_jax():
    t = np.array([0.0, 1e-30, 1e-20, 0.3, 1.0], np.float32)
    np.testing.assert_array_equal(
        port_sampling.log(torch.from_numpy(t)).numpy(), np.asarray(jax_sampling.log(jnp.asarray(t)))
    )
    gen = torch.Generator().manual_seed(0)
    g = port_sampling.gumbel_noise((4000, 16), gen)
    again = port_sampling.gumbel_noise((4000, 16), torch.Generator().manual_seed(0))
    assert torch.equal(g, again) and g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    # a standard gumbel: mean = Euler's constant, variance = pi^2 / 6
    assert abs(g.mean().item() - 0.5772) < 0.02 and abs(g.var().item() - np.pi ** 2 / 6) < 0.05


def test_first_argmax_breaks_ties_at_the_lowest_index():
    rs = np.random.RandomState(1)
    t = rs.choice(np.array([-np.inf, 0.5, 2.0], np.float32), size=(50, 3, 12))
    t[0] = -np.inf  # a row of nothing but -inf still has a first maximum
    want = np.asarray(jnp.argmax(jnp.asarray(t), axis=-1))
    got = port_sampling.first_argmax(torch.from_numpy(t))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_gumbel_sample(temperature):
    # temperature 0 is clamped to 1e-10: the noise cannot move the argmax;
    # at temperature 1 the draws follow softmax(logits)
    p = torch.tensor([0.5, 0.25, 0.125, 0.125])
    logits = p.log().expand(20000, 4)
    ids = port_sampling.gumbel_sample(logits, temperature, torch.Generator().manual_seed(0))
    assert ids.shape == (20000,) and ids.dtype == torch.int64
    freq = torch.bincount(ids, minlength=4).float() / 20000
    if temperature == 0.0:
        assert torch.equal(freq, torch.tensor([1.0, 0.0, 0.0, 0.0]))
        want = jax_sampling.gumbel_sample(jax.random.PRNGKey(0), jnp.asarray(logits.numpy()[:8]), temperature=0.0)
        np.testing.assert_array_equal(ids[:8].numpy(), np.asarray(want))
    else:
        assert (freq - p).abs().max().item() < 0.015  # > 4 sigma at 20000 draws
