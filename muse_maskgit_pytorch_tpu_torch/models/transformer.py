"""MaskGit transformer backbone, inference side (counterpart of
`muse_maskgit_pytorch_tpu/models/transformer.py`).

Same structure and dtype flow as the JAX modules: parameters in f32,
`Linear(dtype=bf16)` casts input and weight to bf16, LayerNorm computes in
f32 and returns the input's dtype, the residual stream stays in the compute
dtype, logits stay in the compute dtype. Every attention goes through K2
(`ops.attention.qknorm_attend`); classifier-free guidance runs as one
doubled-batch forward with the `cfg_fold` (combine before the bias-free
vocab head) and `null_fold` (the null half's cross-attention is the constant
`Attention.null_out`) optimisations.

Parameter names mirror the JAX module tree, so `utils.from_jax` maps
weights by path.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Embedding, Linear
from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, exists, not_ported

KV = Tuple[torch.Tensor, torch.Tensor]


class LayerNorm(nn.Module):
    """Gamma-only LayerNorm, f32 statistics, eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        normed = (x32 - mean) * torch.rsqrt(var + 1e-5)
        return (normed * self.gamma).to(x.dtype)


class FeedForward(nn.Module):
    """LN -> Linear -> GEGLU (erf GELU) -> LN -> Linear."""

    def __init__(self, dim: int, mult: float = 4, dtype=torch.float32, *, generator=None):
        super().__init__()
        inner_dim = int(dim * mult * 2 / 3)
        self.norm = LayerNorm(dim)
        self.proj_in = Linear(dim, inner_dim * 2, dtype=dtype, generator=generator)
        self.norm_inner = LayerNorm(inner_dim)
        self.proj_out = Linear(inner_dim, dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj_in(self.norm(x)).chunk(2, dim=-1)
        x = gate * F.gelu(x)
        return self.proj_out(self.norm_inner(x))


class Attention(nn.Module):
    """qk-l2norm attention with one learned null key/value per head."""

    def __init__(
        self,
        dim: int,
        dim_head: int = 64,
        heads: int = 8,
        cross_attend: bool = False,
        scale: float = 8.0,
        dtype=torch.float32,
        *,
        generator=None,
    ):
        super().__init__()
        self.scale = scale
        self.heads = heads
        self.dim_head = dim_head
        self.cross_attend = cross_attend
        self.dtype = dtype
        inner_dim = dim_head * heads

        self.norm = LayerNorm(dim)
        self.null_kv = nn.Parameter(torch.randn(2, heads, 1, dim_head, generator=generator))
        self.to_q = Linear(dim, inner_dim, dtype=dtype, generator=generator)
        self.to_kv = Linear(dim, inner_dim * 2, dtype=dtype, generator=generator)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.to_out = Linear(inner_dim, dim, dtype=dtype, generator=generator)

    def null_out(self) -> torch.Tensor:
        """(1, 1, dim) output for a query whose whole context is masked: the
        softmax is one-hot on the null position, so this is `to_out(null_v)`."""
        v = self.null_kv[1].reshape(1, 1, self.heads * self.dim_head)
        return self.to_out(v.to(self.dtype))

    def compute_kv(self, kv_input: torch.Tensor) -> KV:
        """Raw K/V projections (views into one to_kv output)."""
        k, v = self.to_kv(kv_input).chunk(2, dim=-1)
        return k, v

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        context_mask: Optional[torch.Tensor] = None,
        cached_kv: Optional[KV] = None,
    ) -> torch.Tensor:
        if (exists(context) or exists(cached_kv)) != self.cross_attend:
            raise ValueError("context (or cached_kv) is given exactly for cross-attention")
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        x = self.norm(x)
        if exists(cached_kv):
            k_raw, v_raw = cached_kv
        else:
            k_raw, v_raw = self.compute_kv(context if self.cross_attend else x)
        m = k_raw.shape[1]
        q = self.to_q(x).reshape(b, n, h, d)
        out = qknorm_attend(
            q,
            k_raw.reshape(b, m, h, d),
            v_raw.reshape(b, m, h, d),
            null_k=self.null_kv[0, :, 0, :].to(k_raw.dtype),
            null_v=self.null_kv[1, :, 0, :].to(v_raw.dtype),
            q_scale=self.q_scale,
            k_scale=self.k_scale,
            mask=context_mask,
            scale=self.scale,
        )
        return self.to_out(out.reshape(b, n, h * d))


class TransformerBlocks(nn.Module):
    """depth x (self-attn -> cross-attn -> FF), final LayerNorm."""

    def __init__(
        self,
        *,
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: float = 4,
        dtype=torch.float32,
        generator=None,
    ):
        super().__init__()
        kw = dict(dim_head=dim_head, heads=heads, dtype=dtype, generator=generator)
        self.layers = nn.ModuleList(
            nn.ModuleList(
                [
                    Attention(dim, **kw),
                    Attention(dim, cross_attend=True, **kw),
                    FeedForward(dim, mult=ff_mult, dtype=dtype, generator=generator),
                ]
            )
            for _ in range(depth)
        )
        self.norm = LayerNorm(dim)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        context_mask: Optional[torch.Tensor] = None,
        context_kv: Optional[List[KV]] = None,
        null_rows: int = 0,
    ) -> torch.Tensor:
        """The LAST `null_rows` batch rows have a fully masked context (the
        CFG null half): their cross-attention is the constant
        `Attention.null_out`, so cross-attention runs on the leading rows only."""
        nr = int(null_rows)
        for i, (attn, cross_attn, ff) in enumerate(self.layers):
            kv_i = context_kv[i] if context_kv is not None else None
            x = attn(x) + x
            if nr:
                b = x.shape[0] - nr
                xc = cross_attn(
                    x[:b],
                    context=context[:b] if context is not None else None,
                    context_mask=context_mask[:b] if context_mask is not None else None,
                    cached_kv=(kv_i[0][:b], kv_i[1][:b]) if kv_i is not None else None,
                ) + x[:b]
                xn = x[b:] + cross_attn.null_out().to(x.dtype)
                x = torch.cat([xc, xn], dim=0)
            else:
                x = cross_attn(
                    x, context=context, context_mask=context_mask, cached_kv=kv_i
                ) + x
            x = ff(x) + x
        return self.norm(x)

    def compute_context_kv(self, context: torch.Tensor) -> List[KV]:
        return [layer[1].compute_kv(context) for layer in self.layers]


class Transformer(nn.Module):
    """Token transformer conditioned on text embeddings."""

    def __init__(
        self,
        *,
        num_tokens: int,
        dim: int,
        seq_len: int,
        seq_hw: Optional[tuple] = None,
        dim_out: Optional[int] = None,
        text_embed_dim: Optional[int] = None,
        self_cond: bool = False,
        add_mask_id: bool = False,
        dtype=torch.float32,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        super().__init__()
        if text_embed_dim is None:
            raise not_ported("T5 text encoding (text_embed_dim=None)", "A6")
        self.dim = dim
        self.mask_id = num_tokens if add_mask_id else None
        self.num_tokens = num_tokens
        self.seq_len = seq_len
        if seq_hw is not None:
            if seq_hw[0] * seq_hw[1] != seq_len:
                raise ValueError(f"seq_hw {seq_hw} does not tile seq_len {seq_len}")
            self.seq_hw = (int(seq_hw[0]), int(seq_hw[1]))
        else:
            f = math.isqrt(seq_len)
            self.seq_hw = (f, f) if f * f == seq_len else None
        self.dtype = dtype

        self.token_emb = Embedding(num_tokens + int(add_mask_id), dim, generator=generator)
        self.pos_emb = Embedding(seq_len, dim, generator=generator)
        self.transformer_blocks = TransformerBlocks(
            dim=dim, dtype=dtype, generator=generator, **kwargs
        )
        # present (and unused by the forward) in the JAX module as well; kept
        # so the two parameter trees match one to one
        self.norm = LayerNorm(dim)
        self.dim_out = default(dim_out, num_tokens)
        self.to_logits = Linear(dim, self.dim_out, dtype=dtype, generator=generator)
        self.text_embed_dim = text_embed_dim
        self.text_embed_proj = (
            Linear(text_embed_dim, dim, dtype=dtype, generator=generator)
            if text_embed_dim != dim
            else None
        )
        self.self_cond = self_cond
        self.self_cond_to_init_embed = FeedForward(dim, dtype=dtype, generator=generator)

    def _positions(self, n: int) -> torch.Tensor:
        """(n, dim) learned positional embeddings at the trained grid."""
        if n != self.seq_len:
            raise not_ported("positions off the trained grid (variable resolution)", "A8")
        return self.pos_emb.weight

    def _context(self, text_embeds: torch.Tensor) -> torch.Tensor:
        if exists(self.text_embed_proj):
            text_embeds = self.text_embed_proj(text_embeds)
        return text_embeds.to(self.dtype)

    def precompute_context_kv(
        self, *, text_embeds: torch.Tensor, conditioning_token_ids=None
    ) -> List[KV]:
        """Per-layer cross-attention K/V of the static context, projected once
        per generate instead of once per step per layer."""
        if exists(conditioning_token_ids):
            raise not_ported("conditioning token ids (super-res stage)", "A7")
        return self.transformer_blocks.compute_context_kv(self._context(text_embeds))

    def _cfg_combine(self, out2: torch.Tensor, b: int, cond_scale: float, fold: bool):
        """`null + (cond - null) * s` over a doubled batch: on the pre-head
        embeddings then one head matmul on b rows (`fold`), or on logits."""
        cond, null = out2[:b], out2[b:]
        if fold:
            e = null.float()
            e = e + (cond.float() - e) * cond_scale
            return self.to_logits(e.to(self.dtype))
        return null + (cond - null) * cond_scale

    def forward_with_cond_scale(
        self,
        x: torch.Tensor,
        *,
        text_embeds: torch.Tensor,
        cond_scale: float = 3.0,
        return_embed: bool = False,
        text_mask: Optional[torch.Tensor] = None,
        conditioning_token_ids=None,
        self_cond_embed: Optional[torch.Tensor] = None,
        return_raw_double: bool = False,
        gather_positions: Optional[torch.Tensor] = None,
        context_kv: Optional[List[KV]] = None,
        cfg_fold: bool = True,
        null_fold: bool = True,
    ):
        """CFG as ONE doubled-batch forward (cond rows then null rows, the
        null half with its text mask zeroed). Semantics of every flag as in
        the JAX module."""
        if not isinstance(cond_scale, (int, float)):
            raise not_ported("tensor-valued or scheduled cond_scale", "A8")
        if exists(conditioning_token_ids):
            raise not_ported("conditioning token ids (super-res stage)", "A7")
        if cond_scale == 1:
            return self(
                x, text_embeds=text_embeds, text_mask=text_mask, self_cond_embed=self_cond_embed,
                context_kv=context_kv, return_embed=return_embed, gather_positions=gather_positions,
            )

        b = x.shape[0]
        if text_mask is None:
            text_mask = (text_embeds != 0).any(dim=-1)

        def dup(t):
            return None if t is None else torch.cat([t, t], dim=0)

        fold = cfg_fold and not return_raw_double
        out2, embed2 = self(
            dup(x),
            text_embeds=dup(text_embeds),
            text_mask=torch.cat([text_mask, torch.zeros_like(text_mask)], dim=0),
            self_cond_embed=dup(self_cond_embed),
            return_embed=True,
            gather_positions=dup(gather_positions),
            context_kv=context_kv,
            skip_head=fold,
            null_rows=b if null_fold else 0,
        )
        if return_raw_double:
            return out2, embed2[:b]
        scaled = self._cfg_combine(out2, b, cond_scale, fold)
        if return_embed:
            return scaled, embed2[:b]
        return scaled

    def forward(
        self,
        x: torch.Tensor,
        *,
        text_embeds: torch.Tensor,
        text_mask: Optional[torch.Tensor] = None,
        return_embed: bool = False,
        self_cond_embed: Optional[torch.Tensor] = None,
        conditioning_token_ids=None,
        gather_positions: Optional[torch.Tensor] = None,
        context_kv: Optional[List[KV]] = None,
        skip_head: bool = False,
        null_rows: int = 0,
    ):
        """Logits (b, n|k, dim_out) for token ids x (b, n).

        `gather_positions` (b, k) restricts the vocab head to those
        positions; `skip_head` returns (gathered pre-head embeddings, full
        embeddings); `null_rows` see `TransformerBlocks.forward`."""
        if exists(conditioning_token_ids):
            raise not_ported("conditioning token ids (super-res stage)", "A7")
        b, n = x.shape
        context = self._context(text_embeds) if context_kv is None else None
        if text_mask is None:
            context_mask = (text_embeds != 0).any(dim=-1)
        else:
            context_mask = text_mask

        h = (self.token_emb(x) + self._positions(n)).to(self.dtype)
        if self.self_cond:
            if not exists(self_cond_embed):
                self_cond_embed = torch.zeros_like(h)
            h = h + self.self_cond_to_init_embed(self_cond_embed.to(self.dtype))

        embed = self.transformer_blocks(
            h, context=context, context_mask=context_mask, context_kv=context_kv,
            null_rows=null_rows,
        )
        if gather_positions is not None:
            head_in = torch.take_along_dim(embed, gather_positions[..., None], dim=1)
        else:
            head_in = embed
        if skip_head:
            return head_in, embed
        logits = self.to_logits(head_in)
        if return_embed:
            return logits, embed
        return logits


class MaskGitTransformer(Transformer):
    """Transformer with a [mask] token id (= num_tokens)."""

    def __init__(self, **kwargs):
        if "add_mask_id" in kwargs:
            raise TypeError("MaskGitTransformer always adds the mask id")
        super().__init__(add_mask_id=True, **kwargs)
