"""Port parity for generation off the trained grid: `Transformer._positions`
(the bilinear resize of the learned positions, antialiased when it shrinks)
and `generate(image_size=..., fmap_size=...)` at square and rectangular
grids, against the JAX package with bridged weights and injected noise
(f32, toy size): token grids must be identical. Also the size checks that
raise instead of flooring (F1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models.transformer import Transformer as JTransformer
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, Transformer, VQGanVAE, load_jax_state
from tests.torch_surface_pairs import B, T, VOCAB, build_pair, generate_both, gumbel, jax_params, text_inputs, transformer_kw


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def trained_16x16():
    jt = JTransformer(rngs=nnx.Rngs(0), **transformer_kw(256))
    pt = Transformer(device="cpu", **transformer_kw(256))
    load_jax_state(pt, jax_params(jt))
    return jt, pt


@pytest.mark.parametrize(
    "n, grid",
    [(400, (20, 20)), (144, (12, 12)), (240, (12, 20)), (256, (16, 16)), (400, None), (64, None), (100, None)],
    ids=["20x20", "12x12", "12x20", "native", "flat_400", "flat_64", "flat_prefix_100"],
)
def test_positions_match_jax(trained_16x16, n, grid):
    jt, pt = trained_16x16
    want = np.asarray(jt._positions(n, grid=grid))
    with torch.no_grad():
        got = pt._positions(n, grid=grid).numpy()
    assert got.shape == want.shape == (n, 32)
    # F.interpolate's weights and jax.image.resize's round apart by ulps
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_positions_errors_of_a_non_square_table():
    jt = JTransformer(rngs=nnx.Rngs(0), **transformer_kw(12, seq_hw=(3, 4)))
    pt = Transformer(device="cpu", **transformer_kw(12, seq_hw=(3, 4)))
    load_jax_state(pt, jax_params(jt))
    with torch.no_grad():
        # the trained grid and a prefix of the table are what JAX gives
        np.testing.assert_array_equal(pt._positions(12, grid=(3, 4)).numpy(), np.asarray(jt._positions(12, grid=(3, 4))))
        np.testing.assert_array_equal(pt._positions(8).numpy(), np.asarray(jt._positions(8)))
        for n, grid, match in [
            (12, (4, 3), "does not match the trained grid"),
            (16, (4, 4), "square trained table"),
            (12, (2, 5), "does not tile"),
            (16, None, "exceeds the trained"),
        ]:
            with pytest.raises(ValueError, match=match):
                pt._positions(n, grid=grid)
            with pytest.raises(AssertionError):
                jt._positions(n, grid=grid)


SIZES = {
    # (size keyword, value, token grid, compact)
    "image_rect_16x24": ("image_size", (16, 24), (4, 6), "auto"),
    "image_20": ("image_size", 20, (5, 5), False),
    "fmap_portrait_6x4": ("fmap_size", (6, 4), (6, 4), False),
}


@pytest.mark.parametrize("case", list(SIZES))
def test_variable_and_rectangular_generate_match_jax(pair, case):
    key, value, grid, compact = SIZES[case]
    rs, te, mask = text_inputs(2)
    noise = gumbel(rs, grid[0] * grid[1])
    want, got = generate_both(*pair, te, mask, noise, compact=compact, **{key: value})
    assert got.shape == (B, *grid)
    np.testing.assert_array_equal(got, want)


def test_rectangular_images_match_jax(pair):
    jm, pm = pair
    rs, te, mask = text_inputs(3)
    noise = gumbel(rs, 24)
    kw = dict(timesteps=T, image_size=(24, 16), sampler="xla")
    want = jm.generate(text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask), injected_gumbel_noise=jnp.asarray(noise), **kw)
    got = pm.generate(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), injected_gumbel_noise=torch.from_numpy(noise), **kw
    )
    assert got.shape == (B, 24, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_sizes_the_vae_does_not_divide_raise():
    # F1: a size off the VAE's factor raises, as the JAX package asserts,
    # instead of flooring onto the trained grid
    vae = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=4, codebook_size=VOCAB, device="cpu")  # factor 16
    tr = MaskGitTransformer(device="cpu", **transformer_kw(256))
    mg = MaskGit(image_size=256, transformer=tr, vae=vae, device="cpu")
    te = torch.zeros(1, 4, 24)
    for size in (260, (256, 264)):
        with pytest.raises(ValueError, match="divisible by the VAE's downsampling factor 16"):
            mg.generate(text_embeds=te, image_size=size, timesteps=2)
    with pytest.raises(ValueError, match="not both"):
        mg.generate(text_embeds=te, image_size=256, fmap_size=16, timesteps=2)
    no_vae = MaskGit(image_size=256, transformer=tr, device="cpu")
    with pytest.raises(ValueError, match="fmap_size"):
        no_vae.generate(text_embeds=te, image_size=256, timesteps=2)
