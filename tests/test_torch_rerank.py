"""Port parity for re-ranking: `score_samples` ("logprob" and "critic", on
square and rectangular grids) within 1e-5 of the JAX package, and the
selection of `generate_reranked` (`MaskGit.rerank_select`) against JAX's
`_rerank_select_jit` on the same candidates. `generate_reranked` takes no
injected noise in either package, so its tiling (prompt-major, as
`jnp.repeat`) is pinned on its own, and `Muse(rerank_candidates=,
image_size=)` is held against the chain it stands for. Last, every public
sampling surface accepts every parameter of its JAX counterpart.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import maskgit as jmg
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, Muse, VQGanVAE
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.models.maskgit import child_generators
from tests.torch_surface_pairs import B, T, TEXT_DIM, VOCAB, build_pair, text_inputs, transformer_kw

K = 3
PAIRS = {"logprob": dict(), "critic-token": dict(critic="token"), "critic-self": dict(critic="self")}


@pytest.fixture(scope="module")
def pairs():
    return {name: build_pair(**kw) for name, kw in PAIRS.items()}


def _candidates(seed, grid):
    rs, te, mask = text_inputs(seed)
    ids = rs.randint(0, VOCAB, (B * K, *grid)).astype(np.int32)
    return np.repeat(te, K, axis=0), np.repeat(mask, K, axis=0), ids


@functools.partial(jax.jit, static_argnames=("graphdef", "method"))
def _jax_scores(graphdef, state, ids, te, tm, method):
    # one compiled program: eager JAX compiles every op of the forward apart
    return nnx.merge(graphdef, state).score_samples(ids, text_embeds=te, text_mask=tm, method=method)


@pytest.mark.parametrize(
    "name, grid",
    [("logprob", (4, 4)), ("logprob", (4, 6)), ("critic-token", (4, 4)), ("critic-self", (4, 6))],
    ids=["logprob-square", "logprob-rect", "critic_token-square", "critic_self-rect"],
)
def test_score_samples_match_jax(pairs, name, grid):
    jm, pm = pairs[name]
    te, mask, ids = _candidates(12, grid)
    method = name.split("-")[0]
    graphdef, state = nnx.split(jm)
    want = _jax_scores(graphdef, state, jnp.asarray(ids), jnp.asarray(te), jnp.asarray(mask), method=method)
    got = pm.score_samples(torch.from_numpy(ids), text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask))
    assert got.shape == (B * K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["logprob", "critic-self"])
def test_rerank_select_matches_jax(pairs, name):
    jm, pm = pairs[name]
    te, mask, ids = _candidates(13, (4, 4))
    ids[K] = ids[K + 1]  # a tie within the second prompt: the first candidate wins
    method = name.split("-")[0]
    graphdef, state = nnx.split(jm)
    w_ids, w_scores, w_images = jmg._rerank_select_jit(
        graphdef, state, jnp.asarray(ids), jnp.asarray(te), jnp.asarray(mask), b=B, k=K, method=method,
        attn_impl="auto", decode=True,
    )
    g_ids, g_scores, g_images = pm.rerank_select(
        torch.from_numpy(ids), torch.from_numpy(te), torch.from_numpy(mask), b=B, k=K, method=method, decode=True
    )
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
    np.testing.assert_allclose(g_scores.numpy(), np.asarray(w_scores), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_images.numpy(), np.asarray(w_images), atol=1e-4, rtol=1e-4)
    assert float(g_images.min()) >= 0 and float(g_images.max()) <= 1


def test_generate_reranked_tiles_prompt_major(pairs, monkeypatch):
    _, pm = pairs["logprob"]
    _, te, mask = text_inputs(14)
    per_row = np.array([[2.0, 5.0]], np.float32)
    neg = np.random.RandomState(1).randn(B, 3, TEXT_DIM).astype(np.float32)
    seen = {}
    generate = pm.generate

    def spy(**kw):
        seen.update(kw, candidates=generate(**kw))
        return seen["candidates"]

    monkeypatch.setattr(pm, "generate", spy)
    out, scores = pm.generate_reranked(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), num_candidates=K, timesteps=T,
        cond_scale=per_row, neg_text_embeds=torch.from_numpy(neg), return_ids=True, return_scores=True,
        generator=torch.Generator().manual_seed(3),
    )
    # jnp.repeat's order: a prompt's K candidates are neighbours
    np.testing.assert_array_equal(seen["text_embeds"].numpy(), np.asarray(jnp.repeat(jnp.asarray(te), K, axis=0)))
    np.testing.assert_array_equal(seen["text_mask"].numpy(), np.repeat(mask, K, axis=0))
    np.testing.assert_array_equal(seen["neg_text_embeds"].numpy(), np.repeat(neg, K, axis=0))
    np.testing.assert_array_equal(seen["cond_scale"].numpy(), np.repeat(per_row, K, axis=1))
    # the winners are the best-scored candidates of each prompt
    cands = seen["candidates"]
    cand_scores = pm.score_samples(cands, text_embeds=seen["text_embeds"], text_mask=seen["text_mask"]).reshape(B, K)
    best = cand_scores.argmax(dim=1)
    assert torch.equal(out, cands.reshape(B, K, 4, 4)[torch.arange(B), best])
    torch.testing.assert_close(scores, cand_scores.max(dim=1).values)
    images = pm.generate_reranked(
        text_embeds=torch.from_numpy(te), num_candidates=2, timesteps=2, generator=torch.Generator().manual_seed(3)
    )
    assert images.shape == (B, 16, 16, 3) and 0 <= images.min() and images.max() <= 1
    for bad in ("known_token_ids", "known_mask", "injected_gumbel_noise"):
        with pytest.raises(ValueError, match="per-sample"):
            pm.generate_reranked(text_embeds=torch.from_numpy(te), **{bad: torch.zeros(1)})


TINY_T5 = "test/torch-rerank-t5"
pt5.T5_CONFIGS.setdefault(TINY_T5, pt5.T5Config(d_model=TEXT_DIM, d_ff=48, num_heads=2, d_kv=16, num_layers=1, gated=True))


def test_muse_reranks_at_any_resolution_as_its_chain():
    pt5.set_model(TINY_T5, pt5.T5Encoder(pt5.get_config(TINY_T5), device="cpu"))
    vae = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=VOCAB, device="cpu")
    base = MaskGit(
        image_size=16, vae=vae, device="cpu",
        transformer=MaskGitTransformer(device="cpu", t5_name=TINY_T5, **transformer_kw(16)),
    )
    sr = MaskGit(
        image_size=32, cond_image_size=16, vae=vae, cond_vae=vae, device="cpu",
        transformer=MaskGitTransformer(device="cpu", t5_name=TINY_T5, **transformer_kw(64)),
    )
    muse = Muse(base, sr, device="cpu")
    prompts = ["a cat", "a dog on a hill"]
    gen = torch.Generator().manual_seed(21)
    out = muse(
        prompts, generator=gen, timesteps=2, rerank_candidates=2, image_size=(16, 24), cond_via="ids",
        return_pil_images=False, attn_impl="xla",
    )
    assert out.shape == (B, 32, 48, 3) and 0 <= out.min() and out.max() <= 1
    g_base, g_sr = child_generators(gen, "cpu")
    winners = base.generate_reranked(
        texts=prompts, generator=g_base, num_candidates=2, timesteps=2, image_size=(16, 24), return_ids=True
    )
    assert winners.shape == (B, 4, 6)
    chain = sr.generate(texts=prompts, generator=g_sr, timesteps=2, image_size=(32, 48), cond_token_ids=winners)
    assert torch.equal(out, chain.clamp(0, 1))
    pixels = muse(prompts, generator=gen, timesteps=2, image_size=20, return_pil_images=False)
    assert pixels.shape == (B, 40, 40, 3)


SURFACES = [
    (jmg.MaskGit.generate, MaskGit.generate),
    (jmg.MaskGit.edit, MaskGit.edit),
    (jmg.MaskGit.score_samples, MaskGit.score_samples),
    (jmg.MaskGit.generate_reranked, MaskGit.generate_reranked),
    (jmg.Muse.__call__, Muse.forward),
    (jmg.Muse.edit, Muse.edit),
]


@pytest.mark.parametrize("jax_fn, port_fn", SURFACES, ids=[j.__qualname__ for j, _ in SURFACES])
def test_signatures_accept_every_jax_parameter(jax_fn, port_fn):
    rename = {"rng": "generator"}
    want = [rename.get(n, n) for n in inspect.signature(jax_fn).parameters]
    got = list(inspect.signature(port_fn).parameters)
    assert want == got
    for n, p in inspect.signature(jax_fn).parameters.items():
        assert inspect.signature(port_fn).parameters[rename.get(n, n)].kind == p.kind, n
