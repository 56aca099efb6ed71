"""Port parity for editing: `generate(known_token_ids=, known_mask=)`,
`MaskGit.edit` with pixel- and token-level masks (a super-res stage
included) and `Muse.edit`, against the JAX package with bridged weights
(f32, toy size): token grids must be identical under injected noise, and
`Muse.edit`, which takes no injected noise, is compared at temperature 0.
Also the frozen VAE clones `MaskGit` stores (F3).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu.models.maskgit import Muse as JMuse
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, Muse, VQGanVAE, load_jax_state
from muse_maskgit_pytorch_tpu_torch.models.maskgit import _resize_nearest
from muse_maskgit_pytorch_tpu_torch.utils.sampling import linear_schedule
from tests.torch_surface_pairs import B, T, TEXT_DIM, VOCAB, build_pair, gumbel, jax_params, text_inputs, transformer_kw


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def superres():
    return build_pair(seq_len=64, image_size=32, cond_image_size=16, seed=10)


def centre_half(b, h, w):
    mask = np.zeros((b, h, w), bool)
    mask[:, h // 4 : h - h // 4, w // 4 : w - w // 4] = True
    return mask


def edit_both(jm, pm, images, edit_mask, noise, **kw):
    _, te, tmask = text_inputs(5)
    want = jm.edit(
        jnp.asarray(images), jnp.asarray(edit_mask), text_embeds=jnp.asarray(te), text_mask=jnp.asarray(tmask),
        timesteps=T, injected_gumbel_noise=jnp.asarray(noise), return_ids=True, **kw,
    )
    got = pm.edit(
        torch.from_numpy(images), torch.from_numpy(edit_mask), text_embeds=torch.from_numpy(te),
        text_mask=torch.from_numpy(tmask), timesteps=T, injected_gumbel_noise=torch.from_numpy(noise),
        return_ids=True, **kw,
    )
    return np.asarray(want), got.numpy()


CASES = {
    # (source h, w, mask level, mask dtype, sampler, extra)
    "pixel-bool-xla": (16, 16, "pixel", bool, "xla", {}),
    "pixel-float-fused-cfg_pair": (16, 16, "pixel", np.float32, "fused", dict(cfg_fold=False)),
    "token-int-fused": (16, 16, "token", np.int32, "fused", {}),
    "pixel-rect-xla": (16, 24, "pixel", bool, "xla", dict(cond_scale=(1.0, 4.0))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_maskgit_edit_matches_jax(pair, case):
    h, w, level, dtype, sampler, kw = CASES[case]
    rs = np.random.RandomState(6)
    images = rs.uniform(0, 1, (B, h, w, 3)).astype(np.float32)
    mask = centre_half(B, h, w) if level == "pixel" else centre_half(B, h // 4, w // 4)
    noise = gumbel(rs, (h // 4) * (w // 4))
    want, got = edit_both(*pair, images, mask.astype(dtype), noise, sampler=sampler, **kw)
    np.testing.assert_array_equal(got, want)
    # every known token is the source's, exactly
    _, pm = pair
    _, src, _ = pm.vae.encode(torch.from_numpy(images))
    known = ~torch.from_numpy(mask if level == "token" else mask.reshape(B, h // 4, 4, w // 4, 4).any(axis=(2, 4)))
    assert torch.equal(torch.from_numpy(got)[known], src.long()[known])


def test_superres_edit_resizes_its_source_as_jax_does(superres):
    rs = np.random.RandomState(7)
    images = rs.uniform(0, 1, (B, 32, 32, 3)).astype(np.float32)
    want, got = edit_both(*superres, images, centre_half(B, 32, 32), gumbel(rs, 64), sampler="xla")
    np.testing.assert_array_equal(got, want)


def test_nearest_resize_is_jax_nearest():
    x = np.random.RandomState(8).uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    for h, w in ((32, 24), (16, 12), (20, 15)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, h, w, 3), method="nearest"))
        np.testing.assert_array_equal(_resize_nearest(torch.from_numpy(x), h, w).numpy(), want)


def test_muse_edit_matches_jax(pair, superres, monkeypatch):
    # Muse.edit takes no injected noise; at temperature 0 the sample is
    # each row's first maximal logit on both sides, whatever the noise
    jbase, pbase = pair
    jsr, psr = superres
    for pm in (pbase, psr):
        monkeypatch.setattr(pm, "generate", functools.partial(MaskGit.generate, pm, sampler="xla"))
    rs = np.random.RandomState(9)
    images = rs.uniform(0, 1, (B, 32, 32, 3)).astype(np.float32)
    mask = centre_half(B, 32, 32)
    _, te, tmask = text_inputs(11)
    neg = rs.randn(B, 3, TEXT_DIM).astype(np.float32)
    kw = dict(timesteps=T, temperature=0.0, return_pil_images=False)
    want = JMuse(jbase, jsr).edit(
        jnp.asarray(images), jnp.asarray(mask), text_embeds=jnp.asarray(te), text_mask=jnp.asarray(tmask),
        neg_text_embeds=jnp.asarray(neg), rng=jax.random.PRNGKey(0), **kw,
    )
    got = Muse(pbase, psr, device="cpu").edit(
        torch.from_numpy(images), torch.from_numpy(mask), text_embeds=torch.from_numpy(te),
        text_mask=torch.from_numpy(tmask), neg_text_embeds=torch.from_numpy(neg),
        generator=torch.Generator().manual_seed(0), **kw,
    )
    assert got.shape == (B, 32, 32, 3) and 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_edit_rejects_what_jax_rejects(pair, superres):
    _, pm = pair
    _, psr = superres
    te = torch.zeros(B, 4, TEXT_DIM)
    img = torch.rand(B, 16, 16, 3)
    with pytest.raises(ValueError, match="divisible by the VAE"):
        pm.edit(torch.rand(B, 18, 16, 3), torch.zeros(B, 18, 16, dtype=torch.bool), text_embeds=te, timesteps=2)
    with pytest.raises(ValueError, match="pixel-level or"):
        pm.edit(img, torch.zeros(B, 8, 8, dtype=torch.bool), text_embeds=te, timesteps=2)
    for image_size, side, match in ((48, 28, "conditioning ratio"), (40, 32, "integral")):
        odd = copy.copy(psr)  # a super-res stage of ratio 3, then of ratio 2.5
        odd.image_size = image_size
        with pytest.raises(ValueError, match=match):
            odd.edit(torch.rand(B, side, side, 3), torch.zeros(B, side, side, dtype=torch.bool), text_embeds=te)
    with pytest.raises(ValueError, match="both known_token_ids and known_mask"):
        pm.generate(text_embeds=te, known_mask=torch.ones(B, 4, 4, dtype=torch.bool), timesteps=2)
    late = MaskGit(
        image_size=16, transformer=pm.transformer, vae=pm.vae, noise_schedule=lambda t: 0.5 * linear_schedule(t),
        device="cpu",
    )
    with pytest.raises(ValueError, match="noise_schedule"):
        late.edit(img, torch.ones(B, 16, 16, dtype=torch.bool), text_embeds=te, timesteps=2)
    muse = Muse(pm, psr, device="cpu")
    with pytest.raises(ValueError, match="cascade ratio"):
        muse.edit(torch.rand(B, 33, 33, 3), torch.zeros(B, 33, 33, dtype=torch.bool), text_embeds=te)
    with pytest.raises(ValueError, match="source images' resolution"):
        muse.edit(torch.rand(B, 32, 32, 3), torch.zeros(B, 16, 16, dtype=torch.bool), text_embeds=te)


def test_maskgit_stores_frozen_vae_clones():
    # F3: the caller's VAE objects stay trainable and untouched; the model
    # holds eval clones, one object where one was passed twice
    vae, other = (VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=VOCAB, device="cpu") for _ in range(2))
    tr = MaskGitTransformer(device="cpu", **transformer_kw(64))
    shared = MaskGit(image_size=32, cond_image_size=16, transformer=tr, vae=vae, cond_vae=vae, device="cpu")
    separate = MaskGit(image_size=32, cond_image_size=16, transformer=tr, vae=vae, cond_vae=other, device="cpu")
    for v in (vae, other):
        assert v.training and all(p.requires_grad for p in v.parameters())
    assert shared.vae is not vae and shared.cond_vae is shared.vae
    assert separate.vae is not separate.cond_vae and separate.cond_vae is not other
    for m in (shared, separate):
        for v in (m.vae, m.cond_vae):
            assert not v.training and not any(p.requires_grad for p in v.parameters())
    for a, b in zip(vae.state_dict().values(), shared.vae.state_dict().values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_bridge_consumes_both_vae_subtrees_into_one_clone(superres):
    jsr, psr = superres
    tree = jax_params(jsr)
    assert {"vae", "cond_vae"} <= set(tree)
    fresh = MaskGit(
        image_size=32, cond_image_size=16, transformer=MaskGitTransformer(device="cpu", **transformer_kw(64)),
        vae=psr.vae, cond_vae=psr.vae, device="cpu",
    )
    with torch.no_grad():
        for p in fresh.vae.parameters():
            p.zero_()
    assert load_jax_state(fresh, tree) == []
    for a, b in zip(fresh.vae.state_dict().values(), psr.vae.state_dict().values()):
        assert torch.equal(a, b)
