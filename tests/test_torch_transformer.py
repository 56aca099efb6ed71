"""Port parity: the transformer modules of
`muse_maskgit_pytorch_tpu_torch/models/transformer.py` against the JAX
modules, with the JAX weights copied across by `utils.from_jax`. All f32;
tolerance 1e-4 (a trunk of f32 matmuls summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import transformer as jt
from muse_maskgit_pytorch_tpu_torch.models import transformer as pt
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state
from muse_maskgit_pytorch_tpu_torch.utils.helpers import not_ported

DIM, TEXT_DIM, VOCAB, SEQ, B, L = 48, 24, 256, 16, 2, 6
KW = dict(num_tokens=VOCAB, dim=DIM, seq_len=SEQ, depth=2, dim_head=16, heads=2, text_embed_dim=TEXT_DIM)
TOL = dict(atol=1e-4, rtol=1e-4)


def jax_params(module):
    return jax.tree.map(np.asarray, nnx.state(module, nnx.Param).to_pure_dict())


def bridged(jax_module, port_module):
    unused = load_jax_state(port_module, jax_params(jax_module))
    assert unused == [], unused
    return port_module


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_layernorm_and_feedforward():
    jff = jt.FeedForward(DIM, rngs=nnx.Rngs(0))
    # non-trivial gammas so the bridge of every parameter matters
    jff.norm.gamma[...] = jnp.asarray(1 + 0.1 * _np(1, DIM))
    pff = bridged(jff, pt.FeedForward(DIM))
    x = _np(2, B, SEQ, DIM)
    np.testing.assert_allclose(
        pff(torch.from_numpy(x)).detach().numpy(), np.asarray(jff(jnp.asarray(x))), **TOL
    )


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_attention(cross):
    ja = jt.Attention(DIM, dim_head=16, heads=2, cross_attend=cross, rngs=nnx.Rngs(3))
    ja.q_scale[...] = jnp.asarray(1 + 0.1 * _np(4, 16))
    pa = bridged(ja, pt.Attention(DIM, dim_head=16, heads=2, cross_attend=cross))
    x = _np(5, B, SEQ, DIM)
    kw_j, kw_p = {}, {}
    if cross:
        ctx = _np(6, B, L, DIM)
        mask = np.ones((B, L), bool)
        mask[1, 3:] = False
        kw_j = dict(context=jnp.asarray(ctx), context_mask=jnp.asarray(mask))
        kw_p = dict(context=torch.from_numpy(ctx), context_mask=torch.from_numpy(mask))
    with torch.no_grad():
        got = pa(torch.from_numpy(x), **kw_p).numpy()
    np.testing.assert_allclose(got, np.asarray(ja(jnp.asarray(x), **kw_j)), **TOL)
    if cross:
        with torch.no_grad():
            np.testing.assert_allclose(
                pa.null_out().numpy(), np.asarray(ja.null_out()), **TOL
            )


@pytest.fixture(scope="module")
def models():
    jm = jt.MaskGitTransformer(rngs=nnx.Rngs(0), **KW)
    pm = bridged(jm, pt.MaskGitTransformer(device="cpu", **KW))
    rs = np.random.RandomState(7)
    ids = rs.randint(0, VOCAB + 1, size=(B, SEQ))
    te = rs.randn(B, L, TEXT_DIM).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[0, 4:] = False
    gather = np.stack([rs.permutation(SEQ)[:5] for _ in range(B)])
    return jm, pm, ids, te, mask, gather


def test_forward_logits_and_embed(models):
    jm, pm, ids, te, mask, _ = models
    jl, je = jm(jnp.asarray(ids), text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask), return_embed=True)
    with torch.no_grad():
        pl, pe = pm(torch.from_numpy(ids), text_embeds=torch.from_numpy(te),
                    text_mask=torch.from_numpy(mask), return_embed=True)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), **TOL)


@pytest.mark.parametrize("gather", [False, True], ids=["full", "gather"])
@pytest.mark.parametrize("null_fold", [False, True], ids=["nofold_null", "null_fold"])
@pytest.mark.parametrize("cfg_fold", [False, True], ids=["nofold_cfg", "cfg_fold"])
def test_forward_with_cond_scale(models, cfg_fold, null_fold, gather):
    jm, pm, ids, te, mask, gpos = models
    common = dict(cond_scale=3.0, return_embed=True, cfg_fold=cfg_fold, null_fold=null_fold)
    jl, je = jm.forward_with_cond_scale(
        jnp.asarray(ids), text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask),
        gather_positions=jnp.asarray(gpos) if gather else None, **common,
    )
    with torch.no_grad():
        pl, pe = pm.forward_with_cond_scale(
            torch.from_numpy(ids), text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask),
            gather_positions=torch.from_numpy(gpos) if gather else None, **common,
        )
    assert pl.shape == jl.shape
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), **TOL)


def test_cached_context_kv_and_raw_double(models):
    # the decode loop's form: K/V of the context precomputed once, doubled
    # for CFG, and the raw doubled logits for the in-sampler combine
    jm, pm, ids, te, mask, _ = models
    jkv = jm.precompute_context_kv(text_embeds=jnp.asarray(te))
    jkv = [(jnp.concatenate([k, k]), jnp.concatenate([v, v])) for k, v in jkv]
    jl, _ = jm.forward_with_cond_scale(
        jnp.asarray(ids), text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask),
        context_kv=jkv, return_raw_double=True, cfg_fold=False,
    )
    with torch.no_grad():
        pkv = pm.precompute_context_kv(text_embeds=torch.from_numpy(te))
        pkv = [(torch.cat([k, k]), torch.cat([v, v])) for k, v in pkv]
        pl, _ = pm.forward_with_cond_scale(
            torch.from_numpy(ids), text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask),
            context_kv=pkv, return_raw_double=True, cfg_fold=False,
        )
    assert pl.shape == (2 * B, SEQ, VOCAB)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


@pytest.fixture(scope="module")
def cond_ids():
    return np.random.RandomState(8).randint(0, VOCAB, size=(B, 2, 3))  # a (2, 3) grid of conditioning tokens


@pytest.mark.parametrize("cached", [False, True], ids=["context", "context_kv"])
def test_forward_with_conditioning_token_ids(models, cond_ids, cached):
    # the super-res stage's context: projected text, then the token
    # embeddings of the conditioning ids, which no text mask hides
    jm, pm, ids, te, mask, _ = models
    jkw = dict(text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask), conditioning_token_ids=jnp.asarray(cond_ids))
    pkw = dict(text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask),
               conditioning_token_ids=torch.from_numpy(cond_ids))
    if cached:
        jkw["context_kv"] = jm.precompute_context_kv(text_embeds=jnp.asarray(te), conditioning_token_ids=jnp.asarray(cond_ids))
        with torch.no_grad():
            pkw["context_kv"] = pm.precompute_context_kv(
                text_embeds=torch.from_numpy(te), conditioning_token_ids=torch.from_numpy(cond_ids)
            )
        assert pkw["context_kv"][0][0].shape[1] == L + 6
    jl, je = jm(jnp.asarray(ids), return_embed=True, **jkw)
    with torch.no_grad():
        pl, pe = pm(torch.from_numpy(ids), return_embed=True, **pkw)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), **TOL)


@pytest.mark.parametrize("gather", [False, True], ids=["full", "gather"])
@pytest.mark.parametrize("null_fold", [False, True], ids=["nofold_null", "null_fold"])
@pytest.mark.parametrize("cfg_fold", [False, True], ids=["nofold_cfg", "cfg_fold"])
def test_forward_with_cond_scale_and_conditioning_token_ids(models, cond_ids, cfg_fold, null_fold, gather):
    # the null half keeps the conditioning tokens, so `null_fold` folds nothing
    jm, pm, ids, te, mask, gpos = models
    common = dict(cond_scale=3.0, return_embed=True, cfg_fold=cfg_fold, null_fold=null_fold)
    jkv = jm.precompute_context_kv(text_embeds=jnp.asarray(te), conditioning_token_ids=jnp.asarray(cond_ids))
    jkv = [(jnp.concatenate([k, k]), jnp.concatenate([v, v])) for k, v in jkv]
    jl, je = jm.forward_with_cond_scale(
        jnp.asarray(ids), text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask),
        conditioning_token_ids=jnp.asarray(cond_ids), context_kv=jkv,
        gather_positions=jnp.asarray(gpos) if gather else None, **common,
    )
    with torch.no_grad():
        pkv = pm.precompute_context_kv(text_embeds=torch.from_numpy(te), conditioning_token_ids=torch.from_numpy(cond_ids))
        pkv = [(torch.cat([k, k]), torch.cat([v, v])) for k, v in pkv]
        pl, pe = pm.forward_with_cond_scale(
            torch.from_numpy(ids), text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask),
            conditioning_token_ids=torch.from_numpy(cond_ids), context_kv=pkv,
            gather_positions=torch.from_numpy(gpos) if gather else None, **common,
        )
        uncached = pm.forward_with_cond_scale(
            torch.from_numpy(ids), text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask),
            conditioning_token_ids=torch.from_numpy(cond_ids),
            gather_positions=torch.from_numpy(gpos) if gather else None, **common,
        )[0]
    assert pl.shape == jl.shape
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(uncached.numpy(), pl.numpy(), **TOL)


def test_cond_scale_one_is_single_pass(models):
    jm, pm, ids, te, mask, _ = models
    jl = jm.forward_with_cond_scale(jnp.asarray(ids), text_embeds=jnp.asarray(te), cond_scale=1.0)
    with torch.no_grad():
        pl = pm.forward_with_cond_scale(torch.from_numpy(ids), text_embeds=torch.from_numpy(te), cond_scale=1.0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


def test_bf16_compute_keeps_jax_dtypes():
    m = pt.MaskGitTransformer(dtype=torch.bfloat16, device="cpu", **KW)
    ids = torch.randint(0, VOCAB, (B, SEQ))
    with torch.no_grad():
        logits, embed = m(ids, text_embeds=torch.randn(B, L, TEXT_DIM), return_embed=True)
    assert logits.dtype == torch.bfloat16 and embed.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_random_init_scales_follow_jax():
    # flax initialisers: lecun-normal kernels, normal(1/sqrt(dim)) embeddings,
    # normal null_kv, ones for scales
    m = pt.MaskGitTransformer(generator=torch.Generator().manual_seed(0), device="cpu", **KW)
    assert abs(m.to_logits.weight.std().item() - DIM ** -0.5) < 0.1 * DIM ** -0.5
    assert abs(m.token_emb.weight.std().item() - DIM ** -0.5) < 0.1 * DIM ** -0.5
    attn = m.transformer_blocks.layers[0][0]
    assert abs(attn.null_kv.std().item() - 1.0) < 0.3
    assert torch.equal(attn.q_scale, torch.ones(16))


def test_missing_text_embed_dim_raises():
    # the width then comes from the named T5's config table; a name the
    # table does not hold raises (nothing asks a hub)
    kw = dict(KW, text_embed_dim=None, device="cpu")
    m = pt.MaskGitTransformer(**kw)
    assert m.t5_name == "google/t5-v1_1-base" and m.text_embed_dim == 768
    assert m.text_embed_proj.weight.shape == (DIM, 768)
    assert pt.MaskGitTransformer(**kw, t5_name="t5-small").text_embed_dim == 512
    with pytest.raises(ValueError, match="unknown t5 config"):
        pt.MaskGitTransformer(**kw, t5_name="no/such-model")
    with pytest.raises(ValueError, match="exactly one of texts and text_embeds"):
        m(torch.zeros(B, SEQ, dtype=torch.long))
    assert "A6" in str(not_ported("x", "A6"))
