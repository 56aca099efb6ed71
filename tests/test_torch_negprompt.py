"""Port parity for negative prompts: `forward_with_neg_prompt`, its padded
K/V cache `precompute_context_kv_neg` and `generate(neg_text_embeds=...)`
against the JAX package with bridged weights and injected noise (f32, toy
size), the negative text shorter than the positive one: token grids must be
identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu_torch.models.transformer import _pad_text_to
from tests.torch_surface_pairs import B, T, TEXT_DIM, build_pair, generate_both, gumbel, text_inputs

NEG_L = 3


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def inputs():
    rs, te, mask = text_inputs(1)
    neg = rs.randn(B, NEG_L, TEXT_DIM).astype(np.float32)
    neg[0, -1] = 0.0  # a padded negative position
    return te, mask, neg, gumbel(rs, 16)


def test_pad_text_to():
    t, m = torch.ones(2, 3, 4), torch.ones(2, 3, dtype=torch.bool)
    pt, pm = _pad_text_to(t, m, 5)
    assert pt.shape == (2, 5, 4) and bool((pt[:, 3:] == 0).all()) and pm.tolist() == [[True] * 3 + [False] * 2] * 2
    assert _pad_text_to(t, m, 3)[0] is t


@functools.partial(jax.jit, static_argnames=("graphdef", "cfg_fold", "cached"))
def _jax_forward(graphdef, state, x, te, mask, neg, *, cfg_fold, cached):
    # one compiled program: eager JAX compiles every op of the forward apart
    tr = nnx.merge(graphdef, state)
    kw = dict(text_embeds=te, text_mask=mask, neg_text_embeds=neg)
    if cached:
        kv, (t, tm), (n, nm) = tr.precompute_context_kv_neg(**kw)
        kw = dict(text_embeds=t, text_mask=tm, neg_text_embeds=n, neg_text_mask=nm, context_kv=kv)
    return tr.forward_with_neg_prompt(x, cond_scale=2.5, cfg_fold=cfg_fold, return_embed=True, **kw)


@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
@pytest.mark.parametrize("cfg_fold", [True, False], ids=["fold", "logits"])
def test_forward_with_neg_prompt_matches_jax(pair, inputs, cfg_fold, cached):
    jm, pm = pair
    te, mask, neg, _ = inputs
    x = np.random.RandomState(2).randint(0, 65, (B, 16)).astype(np.int32)
    pt = pm.transformer
    pkw = dict(text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), neg_text_embeds=torch.from_numpy(neg))
    if cached:
        with torch.no_grad():
            kv, (t, tm), (n, nm) = pt.precompute_context_kv_neg(**pkw)
        assert t.shape[1] == n.shape[1] == te.shape[1] and not bool(nm[:, NEG_L:].any())
        pkw = dict(text_embeds=t, text_mask=tm, neg_text_embeds=n, neg_text_mask=nm, context_kv=kv)
    graphdef, state = nnx.split(jm.transformer)
    want, want_embed = _jax_forward(
        graphdef, state, *(jnp.asarray(a) for a in (x, te, mask, neg)), cfg_fold=cfg_fold, cached=cached
    )
    with torch.no_grad():
        got, got_embed = pt.forward_with_neg_prompt(
            torch.from_numpy(x).long(), cond_scale=2.5, cfg_fold=cfg_fold, return_embed=True, **pkw
        )
        # null_fold is accepted and does nothing: the negative half attends a real text
        again = pt.forward_with_neg_prompt(
            torch.from_numpy(x).long(), cond_scale=2.5, cfg_fold=cfg_fold, null_fold=False, **pkw
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_embed.numpy(), np.asarray(want_embed), atol=1e-5, rtol=1e-5)
    assert torch.equal(again, got)


CASES = {
    # (sampler, cfg_fold, cond_scale, compact)
    "fused-cfg_pair": ("fused", False, 3.0, False),
    "xla-fold-compact": ("xla", True, 3.0, "auto"),
    "fused-fold-ramp": ("fused", True, (1.0, 4.0), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_negative_prompt_token_grids_match_jax(pair, inputs, case):
    sampler, cfg_fold, cond_scale, compact = CASES[case]
    te, mask, neg, noise = inputs
    want, got = generate_both(
        *pair, te, mask, noise, neg_text_embeds=neg, sampler=sampler, cfg_fold=cfg_fold, cond_scale=cond_scale,
        compact=compact,
    )
    np.testing.assert_array_equal(got, want)


def test_negative_prompt_changes_the_decode_and_texts_encode(pair, inputs, monkeypatch):
    _, pm = pair
    te, mask, neg, noise = inputs
    kw = dict(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=T, return_ids=True,
        injected_gumbel_noise=torch.from_numpy(noise),
    )
    plain = pm.generate(**kw)
    with_neg = pm.generate(neg_text_embeds=torch.from_numpy(neg), **kw)
    assert not torch.equal(plain, with_neg)
    # negative_texts go through the transformer's text encoder, one a row
    encoded = []

    def encode(texts):
        encoded.append(list(texts))
        return torch.from_numpy(neg)

    monkeypatch.setattr(pm.transformer, "encode_text", encode)
    by_text = pm.generate(negative_texts=["blurry", "dark"], **kw)
    assert encoded == [["blurry", "dark"]] and torch.equal(by_text, with_neg)
    with pytest.raises(ValueError, match="negative texts"):
        pm.generate(negative_texts=["blurry"], **kw)
