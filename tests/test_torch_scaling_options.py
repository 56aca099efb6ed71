"""Port parity of the transformer's scaling options that the JAX package
takes: `remat` (rematerialise each block in the backward) and `flash`
(JAX's choice of attention kernel) on `TransformerBlocks` and so on every
`Transformer`, and `attn_impl` on `MaskGit.forward`. Toy size, f32 on the
CPU, the same weights on both sides (bridged) and inputs from numpy seeds.

Tolerances: the port's remat run against its plain run 1e-5 (the JAX
package's own remat test); against JAX's remat run, the loss to 1e-5
relative and each gradient leaf to 1e-4 of its largest |g|, as the port's
training-loss parity holds them (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models.transformer import MaskGitTransformer as JTransformer
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, TokenCritic
from muse_maskgit_pytorch_tpu_torch.models import transformer as pt
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, load_jax_state, to_jax_state

KW = dict(num_tokens=32, dim=64, seq_len=16, depth=2, dim_head=16, heads=4, text_embed_dim=32)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 32, (2, 16)).astype(np.int64)
    te = rs.randn(2, 5, 32).astype(np.float32)
    mask = np.ones((2, 5), bool)
    mask[1, 3:] = False
    labels = rs.randint(0, 32, (2, 16)).astype(np.int64)
    return ids, te, mask, labels


def _port_grads(pm):
    params = list(pm.parameters())
    saved = [p.data for p in params]
    try:
        for p in params:
            p.data = p.grad if p.grad is not None else torch.zeros_like(p)
        return flatten_tree(to_jax_state(pm))
    finally:
        for p, d in zip(params, saved):
            p.data = d


@pytest.fixture(scope="module")
def jax_remat():
    """JAX's remat=True transformer, its loss and gradients on `_inputs()`."""
    jm = JTransformer(rngs=nnx.Rngs(0), remat=True, **KW)
    ids, te, mask, labels = _inputs()
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def f(p):
        return nnx.merge(graphdef, p, rest)(
            jnp.asarray(ids), text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask), labels=jnp.asarray(labels)
        )

    loss, grads = jax.jit(jax.value_and_grad(f))(params)
    weights = jax.tree.map(np.asarray, nnx.state(jm, nnx.Param).to_pure_dict())
    return weights, float(loss), flatten_tree(grads.to_pure_dict())


def _port_run(weights, remat, monkeypatch):
    """(logits, loss, gradients, blocks run) of the port's transformer with
    JAX's weights; `blocks run` counts `TransformerBlocks._block` calls, so a
    remat run shows its recompute."""
    pm = MaskGitTransformer(device="cpu", remat=remat, **KW)
    assert load_jax_state(pm, weights) == []
    calls = []
    block = pt.TransformerBlocks._block

    def counted(*args):
        calls.append(1)
        return block(*args)

    monkeypatch.setattr(pt.TransformerBlocks, "_block", staticmethod(counted))
    ids, te, mask, labels = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        logits = pm(ids, text_embeds=te, text_mask=mask)
    calls.clear()
    loss = pm(ids, text_embeds=te, text_mask=mask, labels=labels)
    loss.backward()
    return logits, loss.item(), _port_grads(pm), len(calls)


def test_remat_matches_plain_and_jax(jax_remat, monkeypatch):
    weights, jax_loss, jax_grads = jax_remat
    logits, loss, grads, blocks = _port_run(weights, True, monkeypatch)
    p_logits, p_loss, p_grads, p_blocks = _port_run(weights, False, monkeypatch)
    depth = KW["depth"]
    assert (blocks, p_blocks) == (2 * depth, depth), "remat recomputes each block once in the backward"
    np.testing.assert_allclose(logits.numpy(), p_logits.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss, p_loss, rtol=0, atol=1e-5)
    assert grads.keys() == p_grads.keys() == jax_grads.keys()
    for key, g in p_grads.items():
        np.testing.assert_allclose(grads[key], g, rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    for key, g in jax_grads.items():
        np.testing.assert_allclose(grads[key], g, rtol=0, atol=1e-4 * float(np.abs(g).max()), err_msg=key)


@pytest.mark.parametrize("cls", [MaskGitTransformer, TokenCritic], ids=["maskgit", "critic"])
def test_flash_is_accepted_and_changes_nothing(cls):
    ids, te, mask, _ = (torch.from_numpy(a) for a in _inputs(1))
    outs = []
    for kw in ({}, dict(flash=False), dict(flash=False, remat=True)):
        m = cls(device="cpu", generator=torch.Generator().manual_seed(3), **KW, **kw)
        with torch.no_grad():
            outs.append(m(ids, text_embeds=te, text_mask=mask))
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_maskgit_forward_takes_attn_impl():
    pm = MaskGit(
        image_size=16, transformer=MaskGitTransformer(device="cpu", **KW), vae=None, device="cpu",
    )
    ids, te, mask, _ = (torch.from_numpy(a) for a in _inputs(2))
    losses = []
    for kw in ({}, dict(attn_impl="xla"), dict(attn_impl="flash")):
        losses.append(pm(ids, text_embeds=te, text_mask=mask, generator=torch.Generator().manual_seed(5), **kw))
    assert all(torch.equal(losses[0], x) for x in losses[1:])
    assert torch.isfinite(losses[0])
