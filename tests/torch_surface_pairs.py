"""Shared model pairs for the port's parity tests
(`tests/test_torch_{guidance,negprompt,resolution,critic,edit,rerank}.py`
and the training tests): a JAX `MaskGit` and the port's, with the same
weights (bridged), at a toy size, a runner that drives both `generate`s
with the same inputs and the same injected gumbel noise (f32 on the CPU;
token grids must be identical), and `jax_draws`, the training draws of one
JAX key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models.maskgit import MaskGit as JMaskGit
from muse_maskgit_pytorch_tpu.models.transformer import MaskGitTransformer as JTransformer
from muse_maskgit_pytorch_tpu.models.transformer import TokenCritic as JTokenCritic
from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu.utils import sampling as jsamp
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, TokenCritic, TrainDraws, VQGanVAE, load_jax_state

VOCAB, TEXT_DIM, B, L, T = 64, 24, 2, 6, 4
IMAGE = 16  # 4 x 4 tokens through a VAE of two layers (factor 4)


def jax_params(module):
    return jax.tree.map(np.asarray, nnx.state(module, nnx.Param).to_pure_dict())


def transformer_kw(seq_len=16, **kw):
    return dict(num_tokens=VOCAB, dim=32, seq_len=seq_len, depth=1, dim_head=16, heads=2, text_embed_dim=TEXT_DIM) | kw


def build_pair(
    critic=None, seq_len=16, image_size=IMAGE, cond_image_size=None, vae=True, seed=0, self_cond=False,
    t5_name=None, **maskgit_kw,
):
    """(JAX MaskGit, port MaskGit) with the same weights. `critic`: None,
    "token" (a TokenCritic of depth 1) or "self" (a SelfCritic);
    `self_cond` and `t5_name` go to the generator's transformer."""
    extra = dict(self_cond=self_cond) | (dict(t5_name=t5_name) if t5_name else {})
    jt = JTransformer(rngs=nnx.Rngs(seed), **transformer_kw(seq_len, **extra))
    jvae = JVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=False, rngs=nnx.Rngs(seed + 1)) if vae else None
    jcritic = JTokenCritic(rngs=nnx.Rngs(seed + 2), **transformer_kw(seq_len)) if critic == "token" else None
    cond = dict(cond_image_size=cond_image_size, cond_vae=jvae) if cond_image_size else {}
    jm = JMaskGit(
        image_size=image_size, transformer=jt, vae=jvae, token_critic=jcritic, self_token_critic=critic == "self",
        rngs=nnx.Rngs(seed + 3), **cond, **maskgit_kw,
    )
    pvae = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=VOCAB, device="cpu") if vae else None
    pcritic = TokenCritic(device="cpu", **transformer_kw(seq_len)) if critic == "token" else None
    pcond = dict(cond_image_size=cond_image_size, cond_vae=pvae) if cond_image_size else {}
    pm = MaskGit(
        image_size=image_size, transformer=MaskGitTransformer(device="cpu", **transformer_kw(seq_len, **extra)), vae=pvae,
        token_critic=pcritic, self_token_critic=critic == "self", device="cpu", **pcond, **maskgit_kw,
    )
    assert load_jax_state(pm, jax_params(jm)) == []
    return jm, pm


def gumbel(rs, seq, timesteps=T, b=B):
    u = rs.uniform(1e-9, 1 - 1e-9, (timesteps, b, seq, VOCAB))
    return -np.log(-np.log(u)).astype(np.float32)


def text_inputs(seed=0, b=B, length=L):
    rs = np.random.RandomState(seed)
    te = rs.randn(b, length, TEXT_DIM).astype(np.float32)
    mask = np.ones((b, length), bool)
    mask[-1, length - 2 :] = False
    te[~mask] = 0.0
    return rs, te, mask


def _side(value, jax_side):
    """numpy arrays become a jnp array or a torch tensor; the rest passes."""
    if isinstance(value, np.ndarray):
        return jnp.asarray(value) if jax_side else torch.from_numpy(value)
    return value


def generate_both(jm, pm, te, mask, noise, timesteps=T, **kw):
    """(JAX ids, port ids) as numpy, from the same inputs and noise; numpy
    arrays among `kw` are handed to each side in its own type."""
    want = jm.generate(
        text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask), timesteps=timesteps,
        injected_gumbel_noise=jnp.asarray(noise), return_ids=True, **{k: _side(v, True) for k, v in kw.items()},
    )
    got = pm.generate(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=timesteps,
        injected_gumbel_noise=torch.from_numpy(noise), return_ids=True,
        **{k: _side(v, False) for k, v in kw.items()},
    )
    return np.asarray(want), got.numpy()


def jax_draws(key, b, n, vocab=VOCAB, dtype=jnp.float32) -> TrainDraws:
    """The draws `MaskGit.__call__(rng=key)` takes, in its order."""
    ks = jax.random.split(key, 8)

    def u(k, shape):
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))

    gumbel = np.asarray(jsamp.gumbel_noise(ks[6], (b, n, vocab), dtype), np.float32)
    return TrainDraws(
        rand_time=u(ks[0], (b,)), mask_scores=u(ks[1], (b, n)), nomask_scores=u(ks[2], (b, n)),
        keep_u=u(ks[3], (b, 1)), self_cond_u=u(ks[4], ()), sample_temperature=u(ks[5], ()),
        gumbel=torch.from_numpy(gumbel.copy()).to(torch.float32 if dtype == jnp.float32 else torch.bfloat16),
        critic_keep_u=u(ks[7], (b, 1)),
    )
