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
