"""Port parity of the quantizers' training side
(`muse_maskgit_pytorch_tpu_torch/models/quantizers.py`) against the JAX
modules with bridged weights and injected draws: LFQ's entropy and
commitment losses and their gradient, its group-bits rule, and EMA-VQ's
k-means init, EMA update with Laplace smoothing and dead-code revival, in
`update_from_input` and in `forward(update_stats=True)`.

The JAX module draws k-means' first centres and the revived codes' rows
from one key with `jax.random.randint(key, (K,), 0, n)`; the port takes that
vector as a `VQDraws`, so both sides pick the same rows. Tolerances: LFQ's
aux loss 1e-6 relative, its input gradient 1e-4 of the largest entry (the
entropy's softmax at inverse temperature 100 puts each side's f32 gradient
about 3e-5 of it apart); the EMA-VQ buffers (codebook, cluster sizes,
averages) 1e-6 of each buffer's largest magnitude (at least 1: f32 sums of
up to n rows in another order); ids exact.

k-means draws its first centres with replacement, so two codes may start
from one row. One EMA update later such a pair differs by f32 rounding
only (1e-7), and which of the two a row picks depends on that rounding: on
either side, not on the port. The multi-update parity therefore draws 16
codes from 2048 rows with no row drawn twice (checked), and
`test_duplicated_picks_follow_the_near_tie_rule` holds the duplicated case
to the near-tie rule of `tests/test_torch_vq.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import quantizers as jq
from muse_maskgit_pytorch_tpu_torch.models import quantizers as pq
from muse_maskgit_pytorch_tpu_torch.models.quantizers import VQDraws, _code_sums
from muse_maskgit_pytorch_tpu_torch.ops.vq import score_gap
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state

BUF_REL = 1e-6
BUFFERS = ("codebook", "cluster_size", "embed_avg")


def jax_state(module):
    return jax.tree.map(np.asarray, nnx.state(module, (nnx.Param, nnx.BatchStat)).to_pure_dict())


def jax_draws(key, k: int, n: int) -> VQDraws:
    return VQDraws(torch.from_numpy(np.array(jax.random.randint(key, (k,), 0, n))))


def assert_buffers_match(jm, pm):
    for name in BUFFERS:
        want = np.asarray(getattr(jm, name)[...])
        err = np.abs(getattr(pm, name).numpy() - want).max()
        assert err <= BUF_REL * max(1.0, np.abs(want).max()), (name, err)
    assert bool(pm.initted) == bool(jm.initted[...])


# -- LFQ ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "codebook_size, group_bits, want",
    [(1024, 8, 5), (65536, 8, 8), (256, 8, 8), (4096, 5, 4), (64, 8, 6)],
)
def test_lfq_group_bits_match_jax(codebook_size, group_bits, want):
    # the largest group size <= entropy_group_bits that divides the code width
    jl = jq.LFQ(dim=8, codebook_size=codebook_size, entropy_group_bits=group_bits, rngs=nnx.Rngs(0))
    pl = pq.LFQ(dim=8, codebook_size=codebook_size, entropy_group_bits=group_bits, device="cpu")
    assert pl.entropy_group_bits == jl.entropy_group_bits == want


@pytest.mark.parametrize(
    "dim, codebook_size", [(8, 256), (24, 256), (12, 1024)], ids=["no_projection", "projection", "groups_of_5"]
)
def test_lfq_training_losses_match_jax(dim, codebook_size):
    jl = jq.LFQ(dim=dim, codebook_size=codebook_size, rngs=nnx.Rngs(3))
    pl = pq.LFQ(dim=dim, codebook_size=codebook_size, device="cpu")
    assert load_jax_state(pl, jax_state(jl)) == []
    x = np.random.RandomState(4).randn(2, 4, 4, dim).astype(np.float32)

    def jax_aux(x):
        return jl(x, train=True)[2]

    (jout, jids, jaux), jgrad = jl(jnp.asarray(x), train=True), jax.grad(jax_aux)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    out, ids, aux = pl(t, train=True)
    (grad,) = torch.autograd.grad(aux, t)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert abs(float(aux)) > 0.1  # the entropy terms are there
    jgrad = np.asarray(jgrad)
    assert np.abs(grad.numpy() - jgrad).max() <= 1e-4 * np.abs(jgrad).max()
    # and the two terms one at a time
    for weights in (dict(entropy_loss_weight=0.0), dict(commitment_loss_weight=0.0)):
        jw = jq.LFQ(dim=dim, codebook_size=codebook_size, rngs=nnx.Rngs(3), **weights)
        pw = pq.LFQ(dim=dim, codebook_size=codebook_size, device="cpu", **weights)
        load_jax_state(pw, jax_state(jw))
        with torch.no_grad():
            got = float(pw(torch.from_numpy(x), train=True)[2])
        np.testing.assert_allclose(got, float(jw(jnp.asarray(x), train=True)[2]), rtol=1e-6)


# -- EMA-VQ -------------------------------------------------------------------

EMA_CASES = {
    "cosine-revival": dict(use_cosine_sim=True, threshold_ema_dead_code=30.0),
    "cosine": dict(use_cosine_sim=True),
    "euclidean-revival-projection": dict(use_cosine_sim=False, threshold_ema_dead_code=30.0, dim=24),
    "no-kmeans-revival": dict(kmeans_init=False, threshold_ema_dead_code=30.0),
}
K = 16


def _ema_pair(case, seed=1, k=K):
    kw = dict(dim=8, codebook_size=k, codebook_dim=8) | EMA_CASES[case]
    jm = jq.VectorQuantizeEMA(**kw, rngs=nnx.Rngs(seed))
    pm = pq.VectorQuantizeEMA(device="cpu", **kw)
    assert load_jax_state(pm, jax_state(jm)) == []
    return jm, pm, kw["dim"]


@pytest.mark.parametrize("case", list(EMA_CASES))
def test_ema_vq_update_from_input_matches_jax(case):
    """Three updates: the first initialises (k-means from the drawn rows,
    then the EMA update and, with a threshold, the revival from the same
    rows), the next two update and revive; a fourth without a key updates
    only."""
    jm, pm, dim = _ema_pair(case)
    rs = np.random.RandomState(5)
    key = jax.random.PRNGKey(7)
    revived = 0
    for step in range(4):
        x = (rs.randn(2, 32, 32, dim) + 0.5 * step).astype(np.float32)
        n = x.size // dim
        if step < 3:
            key, sub = jax.random.split(key)
            draws = jax_draws(sub, K, n)
            assert draws.pick.unique().numel() == K  # no row drawn twice
            jm.update_from_input(jnp.asarray(x), rng=sub)
            pm.update_from_input(torch.from_numpy(x), rng=draws)
            revived += int((pm.cluster_size == pm.threshold_ema_dead_code).sum())
        else:
            jm.update_from_input(jnp.asarray(x), rng=None)
            pm.update_from_input(torch.from_numpy(x))
        assert_buffers_match(jm, pm)
        # the searches agree on the updated codebook
        with torch.no_grad():
            _, ids, _ = pm(torch.from_numpy(x))
        _, jids, _ = jm(jnp.asarray(x), train=False)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (revived > 0) == ("revival" in case)


@pytest.mark.parametrize("case", ["cosine-revival", "euclidean-revival-projection"])
def test_ema_vq_forward_with_update_stats_matches_jax(case):
    """`forward(train=True, rng=...)` updates the statistics inside the
    call, as the JAX module does, and returns what the pre-update codebook
    gives; the commitment loss's gradient reaches the input."""
    jm, pm, dim = _ema_pair(case, seed=2)
    rs = np.random.RandomState(6)
    key = jax.random.PRNGKey(8)
    for _ in range(2):
        x = rs.randn(2, 32, 32, dim).astype(np.float32)
        key, sub = jax.random.split(key)
        draws = jax_draws(sub, K, 2048)
        assert draws.pick.unique().numel() == K
        jout, jids, jaux = jm(jnp.asarray(x), train=True, rng=sub)
        t = torch.from_numpy(x).requires_grad_(True)
        out, ids, aux = pm(t, train=True, rng=draws)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        assert_buffers_match(jm, pm)
        (g,) = torch.autograd.grad(aux + out.sum(), t)
        assert torch.isfinite(g).all() and g.abs().max() > 0
    assert not any(b.requires_grad for b in pm.buffers())


def test_one_draw_for_kmeans_and_revival():
    """On the initialising update, k-means' first centres and the revived
    codes come from the same rows (JAX feeds both one key): a port drawing
    them apart would give other revived codes."""
    jm, pm, dim = _ema_pair("cosine-revival", seed=3, k=64)
    x = np.random.RandomState(9).randn(1, 4, 4, dim).astype(np.float32)  # 16 rows for 64 codes
    key = jax.random.PRNGKey(10)
    draws = jax_draws(key, 64, 16)
    jm.update_from_input(jnp.asarray(x), rng=key)
    pm.update_from_input(torch.from_numpy(x), rng=draws)
    assert_buffers_match(jm, pm)
    # every code k-means left empty is revived from its drawn row
    rows = pq.l2norm(torch.from_numpy(x).reshape(-1, dim))[draws.pick]
    dead = pm.cluster_size == pm.threshold_ema_dead_code
    assert dead.any()
    torch.testing.assert_close(pm.codebook[dead], rows[dead])
    other = VQDraws(torch.roll(draws.pick, 1))
    _, pm2, _ = _ema_pair("cosine-revival", seed=3, k=64)
    pm2.update_from_input(torch.from_numpy(x), rng=other)
    assert not torch.allclose(pm2.codebook, pm.codebook)


def test_draws_from_a_generator_are_seeded_and_in_range():
    a = VQDraws.draw(K, 50, torch.Generator().manual_seed(3))
    b = VQDraws.draw(K, 50, torch.Generator().manual_seed(3))
    assert torch.equal(a.pick, b.pick) and a.pick.shape == (K,)
    assert int(a.pick.min()) >= 0 and int(a.pick.max()) < 50
    _, pm, dim = _ema_pair("cosine-revival", seed=4)
    _, pm2, _ = _ema_pair("cosine-revival", seed=4)
    x = torch.from_numpy(np.random.RandomState(11).randn(50, dim).astype(np.float32))
    pm.update_from_input(x, rng=torch.Generator().manual_seed(3))
    pm2.update_from_input(x, rng=a)
    for name in BUFFERS:
        assert torch.equal(getattr(pm, name), getattr(pm2, name))
    with pytest.raises(ValueError, match="pick"):
        pm.update_from_input(x, rng=VQDraws(torch.zeros(3, dtype=torch.long)))


def test_duplicated_picks_follow_the_near_tie_rule():
    """64 codes drawn from 72 rows (many drawn twice): the first update
    matches JAX to 1e-6, and later searches on the near-duplicate codes pick
    the same code or one within 1e-5 of the best score in f64, on both
    sides."""
    jm, pm, dim = _ema_pair("cosine", k=64)
    rs = np.random.RandomState(5)
    key = jax.random.PRNGKey(7)
    for step in range(3):
        x = (rs.randn(2, 6, 6, dim) + 0.5 * step).astype(np.float32)
        key, sub = jax.random.split(key)
        jm.update_from_input(jnp.asarray(x), rng=sub)
        pm.update_from_input(torch.from_numpy(x), rng=jax_draws(sub, 64, 72))
        if step == 0:
            assert_buffers_match(jm, pm)
        z = pq.l2norm(torch.from_numpy(x).reshape(-1, dim))
        with torch.no_grad():
            _, ids, _ = pm(torch.from_numpy(x))
        _, jids, _ = jm(jnp.asarray(x), train=False)
        zeros = torch.zeros(64)
        assert (score_gap(z, pm.codebook, ids.reshape(-1), zeros) <= 1e-5).all()
        jcb = torch.from_numpy(np.asarray(jm.codebook[...]))
        assert (score_gap(z, jcb, torch.from_numpy(np.asarray(jids)).reshape(-1), zeros) <= 1e-5).all()


@pytest.mark.parametrize("n, k", [(50, 64), (1000, 16)])
def test_code_sums_match_the_one_hot_product(n, k):
    rs = np.random.RandomState(12)
    z = torch.from_numpy(rs.randn(n, 8).astype(np.float32))
    codes = torch.from_numpy(rs.randint(0, k, n)).int()
    counts, sums = _code_sums(z, codes, k)
    onehot = torch.nn.functional.one_hot(codes.long(), k).float()
    torch.testing.assert_close(counts, onehot.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(sums, onehot.T @ z, rtol=1e-6, atol=1e-5)
    serial = torch.zeros(k, 8)
    for i in range(n):
        serial[codes[i]] += z[i]
    assert torch.equal(sums, serial)  # each code's rows added in row order
