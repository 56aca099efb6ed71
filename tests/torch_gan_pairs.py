"""Toy GAN VAE pairs for the port's VQ-GAN training tests: a JAX
`VQGanVAE` and the port's with the same weights (bridged), and a small
perceptual stand-in tower with the same weights on both sides, since the
two packages' lazy random VGG16s cannot match (flax's `Rngs(0)` is not
torch's generator). CPU, f32, dim 32, 2 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F
from flax import nnx
from torch import nn

from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d, Linear
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import VQGanVAE
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state

DIM, LAYERS = 32, 2


class JTower(nnx.Module):
    """A perceptual stand-in: 3x3 conv, ReLU, spatial mean, linear, ReLU."""

    def __init__(self, rngs: nnx.Rngs):
        self.conv = nnx.Conv(3, 8, (3, 3), padding=1, rngs=rngs)
        self.fc = nnx.Linear(8, 16, rngs=rngs)

    def __call__(self, x):
        h = jax.nn.relu(self.conv(x)).mean(axis=(1, 2))
        return jax.nn.relu(self.fc(h))


class PTower(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        self.conv = Conv2d(3, 8, 3, padding=1, generator=generator)
        self.fc = Linear(8, 16, bias=True, generator=generator)

    def forward(self, x):
        h = F.relu(self.conv(x.permute(0, 3, 1, 2))).mean(dim=(2, 3))
        return F.relu(self.fc(h))


def jax_state(module) -> dict:
    return jax.tree.map(np.asarray, nnx.state(module, (nnx.Param, nnx.BatchStat)).to_pure_dict())


def perturb(module, seed: int = 0) -> None:
    """Non-trivial GroupNorm scales and biases and conv biases, so their
    bridge and gradients are tested."""
    rs = np.random.RandomState(seed)
    for _, node in nnx.iter_graph(module):
        if isinstance(node, nnx.GroupNorm):
            n = node.scale[...].shape[0]
            node.scale[...] = jnp.asarray(1 + 0.1 * rs.randn(n).astype(np.float32))
            node.bias[...] = jnp.asarray(0.1 * rs.randn(n).astype(np.float32))
        elif isinstance(node, (nnx.Conv, nnx.ConvTranspose)) and node.bias is not None:
            n = node.bias[...].shape[0]
            node.bias[...] = jnp.asarray(0.05 * rs.randn(n).astype(np.float32))


def build_pair(seed: int = 0, gan: bool = True, tower: bool = True, codebook_size: int = 256, **kw):
    """(JAX VAE, port VAE) with the same weights; with `gan`, the
    discriminator too and (with `tower`) the stand-in perceptual tower."""
    jkw = dict(kw)
    if gan and tower:
        jkw["vgg"] = JTower(nnx.Rngs(seed + 100))
    jv = JVAE(dim=DIM, layers=LAYERS, codebook_size=codebook_size, use_vgg_and_gan=gan, rngs=nnx.Rngs(seed), **jkw)
    perturb(jv, seed)
    pv = VQGanVAE(dim=DIM, layers=LAYERS, codebook_size=codebook_size, use_vgg_and_gan=gan, device="cpu", **kw)
    state = jax_state(jv)
    vgg_state = state.pop("_vgg", None)
    assert load_jax_state(pv, state) == []
    if vgg_state is not None:
        tower_module = PTower()
        assert load_jax_state(tower_module, vgg_state) == []
        pv.set_vgg(tower_module)
    return jv, pv


def images(seed: int, *shape) -> np.ndarray:
    return np.random.RandomState(seed).uniform(size=shape).astype(np.float32)


def leaf_close(got: np.ndarray, want: np.ndarray, rel: float = 1e-4, what: str = "") -> None:
    """Within `rel` of the leaf's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def torch_grads_by_jax_path(module: nn.Module, names, grads) -> dict:
    """Port gradients (by parameter name) as a {jax dotted path: array} map,
    in the JAX layout, through the bridge's inverse on a zero-filled copy."""
    import copy

    from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, to_jax_state

    holder = copy.deepcopy(module)
    live = dict(holder.named_parameters())
    with torch.no_grad():
        for p in holder.parameters():
            p.zero_()
        for name, g in zip(names, grads):
            live[name].copy_(g)
    return flatten_tree(to_jax_state(holder))
