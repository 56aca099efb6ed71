"""Port parity for the whole slice: JAX `MaskGit.generate(text_embeds,
text_mask, injected_gumbel_noise=g, sampler="fused")` against the port's
`MaskGit.generate` with the same weights (bridged) and the same noise. The
token grids must be identical; the decoded images agree to 1e-4 (f32).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models.maskgit import MaskGit as JMaskGit
from muse_maskgit_pytorch_tpu.models.transformer import MaskGitTransformer as JTransformer
from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, VQGanVAE, load_jax_state

VOCAB, SEQ, B, L, TEXT_DIM = 256, 16, 2, 5, 24
KW = dict(num_tokens=VOCAB, dim=32, seq_len=SEQ, depth=2, dim_head=16, heads=2, text_embed_dim=TEXT_DIM)


def jax_params(module):
    return jax.tree.map(np.asarray, nnx.state(module, nnx.Param).to_pure_dict())


def _pair(self_cond=False):
    jt = JTransformer(self_cond=self_cond, rngs=nnx.Rngs(0), **KW)
    jvae = JVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=False, rngs=nnx.Rngs(1))
    pt = MaskGitTransformer(self_cond=self_cond, **KW)
    pvae = VQGanVAE(dim=16, layers=2, codebook_size=VOCAB)
    assert load_jax_state(pt, jax_params(jt)) == []
    load_jax_state(pvae, jax_params(jvae))
    return (
        JMaskGit(image_size=16, transformer=jt, vae=jvae),
        MaskGit(image_size=16, transformer=pt, vae=pvae),
    )


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _inputs(timesteps, seed=0):
    rs = np.random.RandomState(seed)
    te = rs.randn(B, L, TEXT_DIM).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, 3:] = False
    g = -np.log(-np.log(rs.uniform(1e-9, 1 - 1e-9, (timesteps, B, SEQ, VOCAB)))).astype(np.float32)
    return te, mask, g


def _generate_both(jm, pm, timesteps, **kw):
    te, mask, g = _inputs(timesteps)
    want = jm.generate(
        text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask), timesteps=timesteps,
        injected_gumbel_noise=jnp.asarray(g), sampler="fused", **kw,
    )
    got = pm.generate(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=timesteps,
        injected_gumbel_noise=torch.from_numpy(g), **kw,
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("cfg_fold", [True, False], ids=["cfg_fold", "cfg_pair"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_token_grids_identical(pair, compact, cfg_fold):
    want, got = _generate_both(
        *pair, 6, cond_scale=3.0, compact=compact, cfg_fold=cfg_fold, return_ids=True
    )
    assert got.shape == want.shape == (B, 4, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("timesteps", [7, 12])
def test_token_grids_identical_other_step_counts(pair, timesteps):
    # step counts whose schedules round differently under torch.linspace
    want, got = _generate_both(*pair, timesteps, cond_scale=2.5, temperature=0.8, return_ids=True)
    np.testing.assert_array_equal(got, want)


def test_token_grids_identical_self_cond_no_null_fold():
    want, got = _generate_both(*_pair(self_cond=True), 6, null_fold=False, return_ids=True)
    np.testing.assert_array_equal(got, want)


def test_images_match(pair):
    want, got = _generate_both(*pair, 6)
    assert got.shape == want.shape == (B, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_generator_drives_the_sampler_noise(pair):
    _, pm = pair
    te = torch.from_numpy(_inputs(4)[0])

    def run(seed):
        gen = torch.Generator().manual_seed(seed) if seed is not None else None
        return pm.generate(generator=gen, text_embeds=te, timesteps=4, return_ids=True)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(None), run(0))
    assert int(a.max()) < VOCAB  # no mask id reaches the output


@pytest.mark.parametrize(
    "kwargs, item",
    [
        (dict(texts=["a photo"]), "A6"),
        (dict(neg_text_embeds=torch.zeros(B, L, TEXT_DIM)), "A8"),
        (dict(cond_token_ids=torch.zeros(B, 4, 4, dtype=torch.long)), "A7"),
        (dict(cond_scale=(1.0, 3.0)), "A8"),
        (dict(fmap_size=8), "A8"),
    ],
)
def test_unported_options_raise(pair, kwargs, item):
    _, pm = pair
    kw = dict(text_embeds=torch.zeros(B, L, TEXT_DIM), timesteps=2) | kwargs
    with pytest.raises(NotImplementedError, match=item):
        pm.generate(**kw)


def test_port_imports_no_jax():
    code = (
        "import sys, muse_maskgit_pytorch_tpu_torch; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'muse_maskgit_pytorch_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, timeout=120, cwd=Path(__file__).resolve().parents[1]
    )
