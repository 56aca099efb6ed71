"""Port parity for the cascade: the super-res stage of `MaskGit.generate`
(conditioning tokens, given as ids or encoded from images), the two-stage
chain in both hand-offs, `Muse` and `vaes_share_weights`, against the JAX
package with bridged weights and injected noise. f32 on the CPU at the toy
sizes of `tests/test_maskgit.py`: token grids must be identical, images
agree to 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import t5 as jt5
from muse_maskgit_pytorch_tpu.models.maskgit import MaskGit as JMaskGit
from muse_maskgit_pytorch_tpu.models.transformer import MaskGitTransformer as JTransformer
from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu_torch import (
    MaskGit,
    MaskGitTransformer,
    Muse,
    VQGanVAE,
    load_jax_state,
    vaes_share_weights,
)
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.models.maskgit import child_generators

CODEBOOK, TEXT_DIM, B, L, T = 32, 24, 2, 6, 4
TINY_T5 = "test/torch-cascade-t5"
_T5 = dict(d_model=TEXT_DIM, d_ff=48, num_heads=2, d_kv=16, num_layers=2, gated=True)
jt5.T5_CONFIGS.setdefault(TINY_T5, jt5.T5Config(**_T5))
pt5.T5_CONFIGS.setdefault(TINY_T5, pt5.T5Config(**_T5))
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPTS = ["a cat", "a dog on a hill"]


def jax_params(module):
    return jax.tree.map(np.asarray, nnx.state(module, nnx.Param).to_pure_dict())


def jax_vae(seed=0):
    return JVAE(dim=16, layers=2, codebook_size=CODEBOOK, use_vgg_and_gan=False, rngs=nnx.Rngs(seed))


def port_vae(jvae=None):
    pvae = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=CODEBOOK, device="cpu")
    if jvae is not None:
        load_jax_state(pvae, jax_params(jvae))
    return pvae


def _transformer_kw(seq_len):
    return dict(num_tokens=CODEBOOK, dim=32, seq_len=seq_len, depth=1, dim_head=16, heads=2, t5_name=TINY_T5)


def stages(shared_vae=True):
    """(JAX base, JAX super-res, port base, port super-res) with the same
    weights: 16px base on a 4x4 grid, 32px super-res on an 8x8 grid
    conditioned on the base stage's VAE (`shared_vae`) or on its own."""
    jv = jax_vae(0)
    jbase = JMaskGit(image_size=16, transformer=JTransformer(rngs=nnx.Rngs(0), **_transformer_kw(16)), vae=jv)
    jsr_vae = jv if shared_vae else jax_vae(2)
    jsr = JMaskGit(
        image_size=32, cond_image_size=16, vae=jsr_vae, cond_vae=jv if shared_vae else jax_vae(3),
        transformer=JTransformer(rngs=nnx.Rngs(1), **_transformer_kw(64)),
    )
    pv = port_vae()
    pbase = MaskGit(
        image_size=16, transformer=MaskGitTransformer(device="cpu", **_transformer_kw(16)), vae=pv, device="cpu"
    )
    psr = MaskGit(
        image_size=32, cond_image_size=16, vae=pv if shared_vae else port_vae(),
        cond_vae=pv if shared_vae else port_vae(),
        transformer=MaskGitTransformer(device="cpu", **_transformer_kw(64)), device="cpu",
    )
    # whole stages at once: the JAX state holds a `vae` and a `cond_vae`
    # subtree where the port may hold one shared module
    assert load_jax_state(pbase, jax_params(jbase)) == []
    assert load_jax_state(psr, jax_params(jsr)) == []
    return jbase, jsr, pbase, psr


@pytest.fixture(scope="module")
def shared():
    return stages(shared_vae=True)


@pytest.fixture(scope="module")
def separate():
    return stages(shared_vae=False)


@pytest.fixture(scope="module")
def tiny_t5():
    """One toy T5 with the same weights in both packages' caches."""
    jm = jt5.T5Encoder(jt5.get_config(TINY_T5), rngs=nnx.Rngs(7))
    pm = pt5.T5Encoder(pt5.get_config(TINY_T5), device="cpu")
    assert load_jax_state(pm, jax_params(jm)) == []
    jt5.set_model(TINY_T5, jm)
    pt5.set_model(TINY_T5, pm)


def _gumbel(rs, seq):
    return -np.log(-np.log(rs.uniform(1e-9, 1 - 1e-9, (T, B, seq, CODEBOOK)))).astype(np.float32)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    te = rs.randn(B, L, TEXT_DIM).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, 4:] = False
    cond_ids = rs.randint(0, CODEBOOK, (B, 4, 4)).astype(np.int32)
    cond_img = rs.uniform(0, 1, (B, 16, 16, 3)).astype(np.float32)
    return te, mask, cond_ids, cond_img, _gumbel(rs, 16), _gumbel(rs, 64)


def _both(jm, pm, te, mask, noise, jkw=None, pkw=None, **kw):
    want = jm.generate(
        text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask), timesteps=T,
        injected_gumbel_noise=jnp.asarray(noise), **(jkw or {}), **kw,
    )
    got = pm.generate(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=T,
        injected_gumbel_noise=torch.from_numpy(noise), **(pkw or {}), **kw,
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("cfg_fold", [True, False], ids=["cfg_fold", "cfg_nofold"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("sampler", ["xla", "fused"])
def test_superres_token_grids_identical_with_cond_token_ids(shared, sampler, compact, cfg_fold):
    _, jsr, _, psr = shared
    te, mask, cond_ids, _, _, noise = _inputs()
    want, got = _both(
        jsr, psr, te, mask, noise,
        jkw=dict(cond_token_ids=jnp.asarray(cond_ids)), pkw=dict(cond_token_ids=torch.from_numpy(cond_ids)),
        sampler=sampler, compact=compact, cfg_fold=cfg_fold, cond_scale=3.0, return_ids=True,
    )
    assert got.shape == want.shape == (B, 8, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampler", ["xla", "fused"])
@pytest.mark.parametrize("which", ["shared", "separate"])
def test_superres_token_grids_identical_with_cond_images(request, which, sampler):
    # the images go through cond_vae.encode on both sides
    _, jsr, _, psr = request.getfixturevalue(which)
    te, mask, _, cond_img, _, noise = _inputs(1)
    want, got = _both(
        jsr, psr, te, mask, noise,
        jkw=dict(cond_images=jnp.asarray(cond_img)), pkw=dict(cond_images=torch.from_numpy(cond_img)),
        sampler=sampler, return_ids=True,
    )
    np.testing.assert_array_equal(got, want)


def test_superres_images_match(shared):
    _, jsr, _, psr = shared
    te, mask, cond_ids, _, _, noise = _inputs(2)
    want, got = _both(
        jsr, psr, te, mask, noise,
        jkw=dict(cond_token_ids=jnp.asarray(cond_ids)), pkw=dict(cond_token_ids=torch.from_numpy(cond_ids)),
    )
    assert got.shape == want.shape == (B, 32, 32, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sampler", ["xla", "fused"])
def test_null_fold_is_a_no_op_in_superres(shared, sampler):
    # conditioning tokens stay attendable in the CFG null half, so its
    # cross-attention is no constant: both settings run the same forward
    _, _, _, psr = shared
    te, mask, cond_ids, _, _, noise = _inputs(3)
    kw = dict(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=T, sampler=sampler,
        cond_token_ids=torch.from_numpy(cond_ids), injected_gumbel_noise=torch.from_numpy(noise), return_ids=True,
    )
    assert torch.equal(psr.generate(null_fold=True, **kw), psr.generate(null_fold=False, **kw))


def test_null_half_attends_the_conditioning_tokens(shared):
    # the fault the `null_rows` condition guards against: folding the null
    # half to a constant would drop its attention over the conditioning tokens
    _, _, _, psr = shared
    te, mask, cond_ids, _, _, _ = _inputs(4)
    tr = psr.transformer
    x = torch.full((B, 64), tr.mask_id)
    te, cond = torch.from_numpy(te), torch.from_numpy(cond_ids)
    other = (cond + 1) % CODEBOOK
    with torch.no_grad():
        folded = tr.forward_with_cond_scale(x, text_embeds=te, conditioning_token_ids=cond, null_fold=True)
        unfolded = tr.forward_with_cond_scale(x, text_embeds=te, conditioning_token_ids=cond, null_fold=False)
        # with the text all masked, the cond and null halves see the same
        # context, so CFG returns the null half: it must follow the tokens
        no_text = torch.zeros(B, L, TEXT_DIM)
        null_a = tr.forward_with_cond_scale(x, text_embeds=no_text, conditioning_token_ids=cond)
        null_b = tr.forward_with_cond_scale(x, text_embeds=no_text, conditioning_token_ids=other)
        with pytest.raises(ValueError, match="null_rows"):
            tr(x, text_embeds=te, conditioning_token_ids=cond, null_rows=1)
    assert torch.equal(folded, unfolded)
    assert (null_a - null_b).abs().max() > 1e-3


@pytest.mark.parametrize("sampler", ["xla", "fused"])
@pytest.mark.parametrize("cond_via", ["ids", "pixels"])
def test_two_stage_chain_matches_jax(shared, cond_via, sampler):
    jbase, jsr, pbase, psr = shared
    te, mask, _, _, noise_base, noise_sr = _inputs(5)
    via_ids = cond_via == "ids"
    j_low, p_low = _both(jbase, pbase, te, mask, noise_base, sampler=sampler, return_ids=via_ids)
    if via_ids:
        np.testing.assert_array_equal(p_low, j_low)
        jkw, pkw = dict(cond_token_ids=jnp.asarray(j_low)), dict(cond_token_ids=torch.from_numpy(p_low))
    else:
        np.testing.assert_allclose(p_low, j_low, **TOL)
        # the clamp between the stages
        jkw = dict(cond_images=jnp.clip(jnp.asarray(j_low), 0.0, 1.0))
        pkw = dict(cond_images=torch.from_numpy(p_low).clamp(0.0, 1.0))
    want_ids, got_ids = _both(jsr, psr, te, mask, noise_sr, jkw=jkw, pkw=pkw, sampler=sampler, return_ids=True)
    np.testing.assert_array_equal(got_ids, want_ids)
    want, got = _both(jsr, psr, te, mask, noise_sr, jkw=jkw, pkw=pkw, sampler=sampler)
    np.testing.assert_allclose(np.clip(got, 0, 1), np.clip(want, 0, 1), **TOL)


@pytest.mark.parametrize("sampler", ["xla", "fused"])
def test_texts_end_to_end_match_jax(shared, tiny_t5, sampler):
    # prompts -> bridged toy T5 -> base stage, on both sides
    jbase, _, pbase, _ = shared
    noise = _gumbel(np.random.RandomState(6), 16)
    want = jbase.generate(
        texts=PROMPTS, timesteps=T, injected_gumbel_noise=jnp.asarray(noise), sampler=sampler, return_ids=True
    )
    got = pbase.generate(
        texts=PROMPTS, timesteps=T, injected_gumbel_noise=torch.from_numpy(noise), sampler=sampler, return_ids=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = pbase.generate(texts=PROMPTS[0], timesteps=2, return_ids=True)  # a bare string is one prompt
    assert one.shape == (1, 4, 4)


@pytest.mark.parametrize("cond_via", ["ids", "pixels"])
def test_muse_equals_the_manual_chain(shared, tiny_t5, cond_via):
    _, _, pbase, psr = shared
    muse = Muse(pbase, psr, device="cpu")
    gen = torch.Generator().manual_seed(11)
    sr_img, lr_img = muse(
        PROMPTS, generator=gen, timesteps=2, cond_via=cond_via, return_lowres=True, return_pil_images=False
    )
    assert sr_img.shape == (B, 32, 32, 3) and lr_img.shape == (B, 16, 16, 3)
    for img in (sr_img, lr_img):
        assert 0 <= img.min() and img.max() <= 1
    only = muse(PROMPTS, generator=gen, timesteps=2, cond_via=cond_via, return_pil_images=False)
    assert torch.equal(only, sr_img)  # the generator is read by its seed, as a JAX key is

    g_base, g_sr = child_generators(torch.Generator().manual_seed(11), "cpu")
    if cond_via == "ids":
        ids = pbase.generate(texts=PROMPTS, generator=g_base, timesteps=2, return_ids=True)
        manual = psr.generate(texts=PROMPTS, generator=g_sr, timesteps=2, cond_token_ids=ids)
        low = pbase.vae.decode_from_ids(ids).clamp(0, 1)
    else:
        low = pbase.generate(texts=PROMPTS, generator=g_base, timesteps=2).clamp(0, 1)
        manual = psr.generate(texts=PROMPTS, generator=g_sr, timesteps=2, cond_images=low)
    assert torch.equal(sr_img, manual.clamp(0, 1))
    assert torch.equal(lr_img, low)
    other = muse(PROMPTS, generator=torch.Generator().manual_seed(12), timesteps=2, cond_via=cond_via, return_pil_images=False)
    assert not torch.equal(other, sr_img)


def test_muse_superres_timesteps_and_pil_output(shared, tiny_t5):
    from PIL import Image

    _, _, pbase, psr = shared
    muse = Muse(pbase, psr, device="cpu")
    out = muse(PROMPTS[:1], timesteps=2, superres_timesteps=3)
    assert isinstance(out[0], Image.Image) and out[0].size == (32, 32)
    sr, low = muse(PROMPTS[:1], timesteps=2, return_lowres=True, cond_via="ids")
    assert sr[0].size == (32, 32) and low[0].size == (16, 16)


def test_muse_rejects_what_it_cannot_run(shared, separate, tiny_t5):
    _, _, pbase, psr = shared
    _, _, _, psr_own = separate
    with pytest.raises(ValueError, match="cond_image_size"):
        Muse(pbase, pbase, device="cpu")
    odd = copy.copy(psr)
    odd.image_size = 24
    with pytest.raises(ValueError, match="exact multiple"):
        Muse(pbase, odd, device="cpu")
    muse = Muse(pbase, psr, device="cpu")
    with pytest.raises(ValueError, match="cond_via must be"):
        muse(PROMPTS, timesteps=2, cond_via="tokens")
    with pytest.raises(ValueError, match="share one VAE"):
        Muse(pbase, psr_own, device="cpu")(PROMPTS, timesteps=2, cond_via="ids", return_pil_images=False)
    # a base-stage size the VAE's factor does not divide, and an edit
    # source the cascade's ratio does not divide
    with pytest.raises(ValueError, match="divisible by the VAE"):
        muse(PROMPTS, timesteps=2, image_size=18, rerank_candidates=2)
    with pytest.raises(ValueError, match="cascade ratio"):
        muse.edit(torch.rand(B, 31, 31, 3), torch.zeros(B, 31, 31, dtype=torch.bool), PROMPTS)


def test_superres_needs_its_conditioning(shared):
    _, _, _, psr = shared
    with pytest.raises(ValueError, match="conditioning image"):
        psr.generate(text_embeds=torch.zeros(B, L, TEXT_DIM), timesteps=2)
    with pytest.raises(ValueError, match="cond_image_size must be specified"):
        MaskGit(image_size=32, transformer=psr.transformer, vae=psr.vae, cond_vae=psr.vae, device="cpu")
    with pytest.raises(ValueError, match="codebook size"):
        other = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=64, device="cpu")
        MaskGit(image_size=32, cond_image_size=16, transformer=psr.transformer, vae=psr.vae, cond_vae=other, device="cpu")
    assert psr.resize_image_for_cond_image and psr.has_separate_cond_vae and psr.cond_vae is psr.vae


def test_vaes_share_weights_three_tiers():
    a = port_vae(jax_vae(0))
    assert vaes_share_weights(a, a)  # one object
    view = copy.copy(a)  # another module around the same tensors
    view._modules = dict(a._modules)
    assert view is not a and vaes_share_weights(a, view)
    assert vaes_share_weights(a, port_vae(jax_vae(0)))  # restored twice from one source: equal values
    assert not vaes_share_weights(a, port_vae(jax_vae(3)))
    wider = VQGanVAE(use_vgg_and_gan=False, dim=32, layers=2, codebook_size=CODEBOOK, device="cpu")
    assert not vaes_share_weights(a, wider)  # shapes differ: no values read
    assert not vaes_share_weights(a, None) and vaes_share_weights(None, None)


def test_bridge_refuses_two_subtrees_for_one_shared_module(shared, separate):
    _, jsr_own, _, _ = separate
    _, _, _, psr = shared
    tree = jax_params(jsr_own)  # vae and cond_vae differ there
    with pytest.raises(ValueError, match="one shared"):
        load_jax_state(copy.deepcopy(psr), tree)
    # a tree that stores an aliased module once still loads
    jsr = shared[1]
    once = {k: v for k, v in jax_params(jsr).items() if k != "cond_vae"}
    assert load_jax_state(copy.deepcopy(psr), once) == []
    with pytest.raises(KeyError, match="vae"):
        load_jax_state(copy.deepcopy(psr), {k: v for k, v in once.items() if k != "vae"})


def test_cascade_modules_build_on_the_gpu_by_default(shared, monkeypatch):
    _, _, pbase, psr = shared
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Muse(pbase, psr)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskGit(image_size=32, cond_image_size=16, transformer=psr.transformer, vae=psr.vae, cond_vae=psr.vae)
