"""Plain reference of the MaskGit transformer trunk (f32, no kernels, no
cache): token and position embeddings, self-conditioning, depth x
(qk-l2norm self-attention with a learned null key / value, cross-attention
over the projected text and the conditioning tokens, GEGLU feed-forward),
the final LayerNorm and the bias-free vocabulary head, with classifier-free
guidance as `null + (cond - null) * scale` over a doubled batch whose null
half has its text masked.

Weights are a dict under the port's parameter names; the reference reads
nothing else of the program. `mm` sets the matmul precision: "f32" (IEEE),
or a control's lower one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import linear

NEG = -1e30


def layer_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + 1e-5) * gamma


def _l2norm(t: torch.Tensor) -> torch.Tensor:
    return t * torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + 1e-12)


def attention(w: dict, p: str, x, kv_input, key_mask, *, heads: int, dim_head: int, mode: str, scale: float = 8.0):
    """One Attention block's output (pre-residual). `kv_input` None for
    self-attention; `key_mask` (B, m) bool or None."""
    b, n, _ = x.shape
    xn = layer_norm(x, w[p + "norm.gamma"])
    src = xn if kv_input is None else kv_input
    q = linear(xn, w[p + "to_q.weight"], mode).reshape(b, n, heads, dim_head)
    k, v = linear(src, w[p + "to_kv.weight"], mode).chunk(2, dim=-1)
    m = k.shape[1]
    k, v = k.reshape(b, m, heads, dim_head), v.reshape(b, m, heads, dim_head)
    null_k, null_v = w[p + "null_kv"][0, :, 0, :], w[p + "null_kv"][1, :, 0, :]
    qn = _l2norm(q) * (w[p + "q_scale"] * scale)
    kn = _l2norm(k) * w[p + "k_scale"]
    nk = _l2norm(null_k) * w[p + "k_scale"]
    sim = torch.einsum("bnhd,bmhd->bhnm", qn, kn)
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], NEG)
    s0 = torch.einsum("bnhd,hd->bhn", qn, nk)[..., None]
    attn = torch.cat([s0, sim], dim=-1).softmax(dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn[..., 1:], v) + attn[..., :1].transpose(1, 2) * null_v[None, None]
    return linear(out.reshape(b, n, heads * dim_head), w[p + "to_out.weight"], mode)


def feed_forward(w: dict, p: str, x, mode: str):
    h = linear(layer_norm(x, w[p + "norm.gamma"]), w[p + "proj_in.weight"], mode)
    a, gate = h.chunk(2, dim=-1)
    h = gate * F.gelu(a)
    return linear(layer_norm(h, w[p + "norm_inner.gamma"]), w[p + "proj_out.weight"], mode)


def context(w: dict, text_embeds, cond_ids, mode: str):
    """The cross-attention context: projected text, then the conditioning
    tokens' embeddings."""
    ctx = linear(text_embeds, w["text_embed_proj.weight"], mode)
    if cond_ids is not None:
        ctx = torch.cat([ctx, w["token_emb.weight"][cond_ids.reshape(ctx.shape[0], -1)]], dim=1)
    return ctx


def trunk(w: dict, t: dict, x, ctx, ctx_mask, self_cond_embed, mode: str):
    """Final-normed embeddings (B, n, dim) of ids `x` (B, n)."""
    h = w["token_emb.weight"][x] + w["pos_emb.weight"][: x.shape[1]]
    if t["self_cond"]:
        h = h + feed_forward(w, "self_cond_to_init_embed.", self_cond_embed, mode)
    kw = dict(heads=t["heads"], dim_head=t["dim_head"], mode=mode)
    for i in range(t["depth"]):
        p = f"transformer_blocks.layers.{i}."
        h = h + attention(w, p + "0.", h, None, None, **kw)
        h = h + attention(w, p + "1.", h, ctx, ctx_mask, **kw)
        h = h + feed_forward(w, p + "2.", h, mode)
    return layer_norm(h, w["transformer_blocks.norm.gamma"])


def guided_step(w: dict, t: dict, x, text_embeds, text_mask, cond_ids, self_cond_embed, cond_scale: float,
                positions, mode: str = "f32"):
    """One CFG decode step: (guided logits (B, k, vocab) at `positions`
    (B, k), the cond half's embeddings (B, n, dim))."""
    b = x.shape[0]
    ctx = context(w, text_embeds, cond_ids, mode)
    mask = text_mask
    if cond_ids is not None:
        mask = F.pad(mask, (0, cond_ids.reshape(b, -1).shape[1]), value=True)
    null_mask = mask.clone()
    null_mask[:, : text_mask.shape[1]] = False
    emb = trunk(
        w, t, torch.cat([x, x]), torch.cat([ctx, ctx]), torch.cat([mask, null_mask]),
        torch.cat([self_cond_embed, self_cond_embed]), mode,
    )
    cond, null = emb[:b], emb[b:]
    e = null + (cond - null) * cond_scale
    e = torch.take_along_dim(e, positions[..., None], dim=1)
    return linear(e, w["to_logits.weight"], mode), cond
