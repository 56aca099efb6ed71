"""Port parity: K3's plain version and the EMA-VQ quantizer
(`muse_maskgit_pytorch_tpu_torch/ops/vq.py`, `models/quantizers.py`) against
the JAX package -- `nearest_code_xla`, the Pallas kernel in interpret mode
and `VectorQuantizeEMA` with bridged state -- on the same f32 inputs.

Ids rule: two f32 searches that sum the d-term dot in different orders may
pick different codes only at a near-tie. So each side's pick must score,
in f64, within `tol` of the row's best code (`ops.vq.score_gap`); that
makes the ids equal on every row whose f64 top-1/top-2 margin exceeds
`tol`. For unit vectors (cosine) tol is 1e-5, which bounds the f32 error of
a 256-term dot; for euclidean scores it is 1e-5 times the row's score scale
|x|^2 + max |c|^2. Where the codebook holds exact duplicates, ids are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import quantizers as jq
from muse_maskgit_pytorch_tpu.ops.vq import nearest_code_pallas, nearest_code_xla
from muse_maskgit_pytorch_tpu_torch.models import quantizers as pq
from muse_maskgit_pytorch_tpu_torch.ops import vq
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state


def unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def assert_ids_by_rule(x, cb, cb_sq, *id_sets, cosine):
    x_t, cb_t = torch.from_numpy(x), torch.from_numpy(cb)
    sq_t = None if cb_sq is None else torch.from_numpy(cb_sq)
    if cosine:
        tol = np.full(x.shape[0], 1e-5)
    else:
        tol = 1e-5 * ((x.astype(np.float64) ** 2).sum(-1) + (cb.astype(np.float64) ** 2).sum(-1).max())
    for ids in id_sets:
        gap = vq.score_gap(x_t, cb_t, torch.from_numpy(np.array(ids)), sq_t).numpy()
        assert (gap >= 0).all() and (gap <= tol).all(), f"rows off the best code by {gap.max():.3g}"


@pytest.mark.parametrize(
    "n, k, d, cosine",
    [(100, 1000, 64, False), (64, 513, 32, True), (37, 129, 256, True)],
    ids=["euclidean", "cosine-ragged-513", "cosine-d256"],
)
def test_plain_matches_jax(n, k, d, cosine):
    rs = np.random.RandomState(n + k)
    x = rs.randn(n, d).astype(np.float32)
    cb = rs.randn(k, d).astype(np.float32)
    cb_sq = None
    if cosine:
        x, cb, cb_sq = unit(x), unit(cb), np.zeros(k, np.float32)
    jx, jcb = jnp.asarray(x), jnp.asarray(cb)
    jsq = None if cb_sq is None else jnp.asarray(cb_sq)
    want_xla = np.asarray(nearest_code_xla(jx, jcb, jsq))
    want_pallas = np.asarray(nearest_code_pallas(jx, jcb, jsq, interpret=True, block_n=32, block_k=256))
    got = vq.nearest_code(torch.from_numpy(x), torch.from_numpy(cb), None if cb_sq is None else torch.from_numpy(cb_sq))
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert_ids_by_rule(x, cb, cb_sq, got.numpy(), want_xla, want_pallas, cosine=cosine)


def test_duplicated_codes_ids_exact():
    # k-means init fills a codebook from a batch with replacement: exactly
    # duplicated rows tie exactly, and every search takes the lowest index
    rs = np.random.RandomState(0)
    distinct = unit(rs.randn(64, 32).astype(np.float32))
    cb = distinct[rs.randint(0, 64, size=515)]  # ragged K, every code repeated
    x = unit(distinct[rs.randint(0, 64, size=90)] + 0.05 * rs.randn(90, 32).astype(np.float32))
    zeros = np.zeros(len(cb), np.float32)
    got = vq.nearest_code(torch.from_numpy(x), torch.from_numpy(cb), torch.from_numpy(zeros)).numpy()
    want = np.asarray(nearest_code_xla(jnp.asarray(x), jnp.asarray(cb), jnp.asarray(zeros)))
    want_pallas = np.asarray(
        nearest_code_pallas(jnp.asarray(x), jnp.asarray(cb), jnp.asarray(zeros), interpret=True, block_k=128)
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_pallas)
    # the lowest index among the duplicates of the chosen code
    first = {}
    for i, row in enumerate(map(bytes, cb)):
        first.setdefault(row, i)
    assert all(first[bytes(cb[i])] == i for i in got)


def test_cpu_wrapper_does_not_launch():
    x = torch.randn(8, 16)
    before = vq.nearest_code.launches
    vq.nearest_code(x, torch.randn(32, 16))
    assert vq.nearest_code.launches == before


def test_score_gap_zero_at_the_argmax():
    rs = np.random.RandomState(3)
    x, cb = torch.from_numpy(rs.randn(20, 8)), torch.from_numpy(rs.randn(50, 8))
    best = (2 * x @ cb.T - (cb * cb).sum(-1)).argmax(-1)
    assert (vq.score_gap(x, cb, best) == 0).all()
    assert (vq.score_gap(x, cb, (best + 1) % 50) > 0).all()


def test_ema_vq_bridge_leaves_nothing():
    jm = jq.VectorQuantizeEMA(dim=24, codebook_size=64, codebook_dim=8, rngs=nnx.Rngs(0))
    pm = pq.VectorQuantizeEMA(dim=24, codebook_size=64, codebook_dim=8, device="cpu")
    state = nnx.state(jm, (nnx.Param, nnx.BatchStat)).to_pure_dict()
    assert load_jax_state(pm, state) == []
    np.testing.assert_array_equal(pm.codebook.numpy(), np.asarray(jm.codebook[...]))
    np.testing.assert_array_equal(pm.embed_avg.numpy(), np.asarray(jm.embed_avg[...]))
    assert pm.initted.dtype == torch.bool and not bool(pm.initted)  # kmeans_init: not initted yet
    assert pm.project_in.bias is not None and pm.project_out.bias is not None


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "euclidean"])
@pytest.mark.parametrize("dim", [8, 24], ids=["no_projection", "projection"])
def test_ema_vq_forward_matches_jax(cosine, dim):
    kw = dict(dim=dim, codebook_size=256, codebook_dim=8, use_cosine_sim=cosine)
    jm = jq.VectorQuantizeEMA(**kw, rngs=nnx.Rngs(1))
    pm = pq.VectorQuantizeEMA(device="cpu", **kw)
    assert load_jax_state(pm, nnx.state(jm, (nnx.Param, nnx.BatchStat)).to_pure_dict()) == []
    x = np.random.RandomState(2).randn(2, 5, 5, dim).astype(np.float32)
    jout, jids, jaux = jm(jnp.asarray(x), train=False)
    with torch.no_grad():
        out, ids, aux = pm(torch.from_numpy(x))
    assert ids.shape == (2, 5, 5) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_ema_vq_codes_from_indices_match_jax():
    kw = dict(dim=24, codebook_size=64, codebook_dim=8)
    jm = jq.VectorQuantizeEMA(**kw, rngs=nnx.Rngs(3))
    pm = pq.VectorQuantizeEMA(device="cpu", **kw)
    load_jax_state(pm, nnx.state(jm, (nnx.Param, nnx.BatchStat)).to_pure_dict())
    ids = np.random.RandomState(4).randint(0, 64, size=(2, 4, 4))
    want = np.asarray(jm.get_codes_from_indices(jnp.asarray(ids)))
    with torch.no_grad():
        got = pm.get_codes_from_indices(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_ema_vq_random_init_is_unit_norm_and_seeded():
    a = pq.VectorQuantizeEMA(dim=16, codebook_size=32, codebook_dim=8, generator=torch.Generator().manual_seed(5), device="cpu")
    b = pq.VectorQuantizeEMA(dim=16, codebook_size=32, codebook_dim=8, generator=torch.Generator().manual_seed(5), device="cpu")
    torch.testing.assert_close(a.codebook.norm(dim=-1), torch.ones(32))
    assert torch.equal(a.codebook, b.codebook) and torch.equal(a.embed_avg, a.codebook)


def test_ema_vq_training_raises_not_ported():
    """EMA-VQ training is ported (ROADMAP A10): the three calls that raised
    here, `forward(train=True)`, `forward(update_stats=True)` and
    `update_from_input`, now run k-means init and the EMA update as the JAX
    module does from the same key (its row draw handed over as a
    `VQDraws`): buffers within 1e-6 of their largest magnitude."""
    from muse_maskgit_pytorch_tpu_torch.models.quantizers import VQDraws

    kw = dict(dim=16, codebook_size=32, codebook_dim=8)
    x = np.random.RandomState(3).randn(256, 16).astype(np.float32)
    key = jax.random.PRNGKey(4)
    draws = VQDraws(torch.from_numpy(np.array(jax.random.randint(key, (32,), 0, 256))))
    for call in ("train", "update_stats", "update_from_input"):
        jm = jq.VectorQuantizeEMA(**kw, rngs=nnx.Rngs(5))
        pm = pq.VectorQuantizeEMA(device="cpu", **kw)
        load_jax_state(pm, nnx.state(jm, (nnx.Param, nnx.BatchStat)).to_pure_dict())
        if call == "update_from_input":
            jm.update_from_input(jnp.asarray(x), rng=key)
            pm.update_from_input(torch.from_numpy(x), rng=draws)
        else:
            jm(jnp.asarray(x), train=True, rng=key)
            pm(torch.from_numpy(x), rng=draws, **{call: True})
        assert bool(pm.initted) and bool(jm.initted[...])
        for name in ("codebook", "cluster_size", "embed_avg"):
            want = np.asarray(getattr(jm, name)[...])
            err = np.abs(getattr(pm, name).numpy() - want).max()
            assert err <= 1e-6 * max(1.0, np.abs(want).max()), (call, name, err)
