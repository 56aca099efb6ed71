"""MaskGit transformer backbone (counterpart of
`muse_maskgit_pytorch_tpu/models/transformer.py`).

Same structure and dtype flow as the JAX modules: parameters in f32,
`Linear(dtype=bf16)` casts input and weight to bf16, LayerNorm computes in
f32 and returns the input's dtype, the residual stream stays in the compute
dtype, logits stay in the compute dtype. Every attention goes through K2
(`ops.attention.qknorm_attend`); classifier-free guidance runs as one
doubled-batch forward with the `cfg_fold` (combine before the bias-free
vocab head) and `null_fold` (the null half's cross-attention is the constant
`Attention.null_out`) optimisations; the guidance scale is a python number,
a 0-d tensor or a per-row (b,) tensor, and `forward_with_neg_prompt` puts a
negative text in the null half's place. Texts are encoded by the frozen T5 of
`models.t5` (`encode_text`); a super-res stage's conditioning token ids join
the cross-attention context after the text and stay attendable in the CFG
null half, where `null_fold` then folds nothing. Off the trained grid the
learned positions are resized bilinearly (`Transformer._positions`).
`TokenCritic` and `SelfCritic` score how real each token of a grid looks.
Given `labels`, `forward` returns the training loss: the masked-token cross
entropy (`cross_entropy_ignore_index`), or a critic's binary cross entropy
(`sigmoid_bce`), with classifier-free-guidance dropout of the text from
given uniforms (`keep_u`).

Tensor parallelism (`parallel.tensor.plan`, under `shard_state_rules=` or
`parallel.tensor.shard_module`): a module whose `tensor_split` is set holds
its rank's slice of the leaves it names and computes its share. `Attention`
runs K2 on its rank's heads (`to_q`'s rows, `to_out`'s columns; the whole
`to_kv` is held and sliced, since its rows are `[k | v]` and a contiguous
split would give one rank all of k); `FeedForward` its slice of the inner
dim (the whole `proj_in` sliced for `[x | gate]`, `norm_inner`'s statistics
summed over the ranks); `Transformer` its slice of the vocab in `to_logits`
(a vocab-parallel cross entropy, the logits gathered for a sampler) and in
`token_emb`'s lookup. The replicated leaves a rank uses a slice of
(`null_kv`, `q_scale`, `k_scale`, `norm_inner.gamma`) and the gathered ones
get whole gradients on every rank.

Parameter names mirror the JAX module tree, so `utils.from_jax` maps
weights by path.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Embedding, Linear
from muse_maskgit_pytorch_tpu_torch.models.t5 import DEFAULT_T5_NAME, get_encoded_dim, t5_encode_text
from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend
from muse_maskgit_pytorch_tpu_torch.parallel.tensor import copy_in, gather_last, max_over, reduce_out
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, exists, resolve_device

KV = Tuple[torch.Tensor, torch.Tensor]
Scale = Union[float, torch.Tensor]


def _pad_text_to(t: torch.Tensor, mask: torch.Tensor, length: int):
    """Right-pad (b, n, d) embeddings and their (b, n) mask to text length
    `length`; the padding is masked out."""
    pad = length - t.shape[1]
    if pad == 0:
        return t, mask
    return F.pad(t, (0, 0, 0, pad)), F.pad(mask, (0, pad), value=False)


def _text_mask(text_embeds: torch.Tensor, text_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The given mask, or the one the embeddings carry (padding is zero)."""
    return (text_embeds != 0).any(dim=-1) if text_mask is None else text_mask


def _linear(layer: Linear, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """`layer` applied with `weight` in place of its own (rows of it)."""
    dt = layer.compute_dtype
    return F.linear(x.to(dt), weight.to(dt))


def _pair_rows(weight: torch.Tensor, half: int, part: slice) -> torch.Tensor:
    """Rows `part` of each half of a `[a | b]` weight of 2 * `half` rows."""
    return torch.cat([weight[part], weight[half + part.start : half + part.stop]])


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
        self.inner_dim = inner_dim
        self.norm = LayerNorm(dim)
        self.proj_in = Linear(dim, inner_dim * 2, dtype=dtype, generator=generator)
        self.norm_inner = LayerNorm(inner_dim)
        self.proj_out = Linear(inner_dim, dim, dtype=dtype, generator=generator)
        self.tensor_split = None

    def tensor_local_leaves(self, size: int):
        """`parallel.tensor.plan`: split `size` ways, a rank holds its
        columns of `proj_out` (its slice of the inner dim) where the split
        stores them; an inner dim that does not divide (1365 at dim 512)
        leaves `proj_out` whole and the block runs whole."""
        return [{"proj_out.weight": 1}]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tensor_split
        if tp is None:
            x, gate = self.proj_in(self.norm(x)).chunk(2, dim=-1)
            x = gate * F.gelu(x)
            return self.proj_out(self.norm_inner(x))
        part = tp.part(self.inner_dim)
        weight = _pair_rows(copy_in(self.proj_in.weight, tp), self.inner_dim, part)
        x, gate = _linear(self.proj_in, copy_in(self.norm(x), tp), weight).chunk(2, dim=-1)
        x = gate * F.gelu(x)
        # norm_inner over the whole inner dim: its statistics summed over the ranks
        x32 = x.float()
        mean = copy_in(reduce_out(x32.sum(dim=-1, keepdim=True), tp), tp) / self.inner_dim
        centred = x32 - mean
        var = copy_in(reduce_out(centred.square().sum(dim=-1, keepdim=True), tp), tp) / self.inner_dim
        gamma = copy_in(self.norm_inner.gamma, tp)[part]
        x = (centred * torch.rsqrt(var + 1e-5) * gamma).to(x.dtype)
        return reduce_out(self.proj_out(x), tp)


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
        self.tensor_split = None

    def tensor_local_leaves(self, size: int):
        """`parallel.tensor.plan`: split `size` ways, a rank holds its heads'
        rows of `to_q` and columns of `to_out` where the heads divide."""
        return [{"to_q.weight": 0, "to_out.weight": 1}] if self.heads % size == 0 else []

    def _null_kv(self) -> torch.Tensor:
        """(2, heads, 1, d): this rank's heads under a tensor split."""
        tp = self.tensor_split
        return self.null_kv if tp is None else copy_in(self.null_kv, tp)[:, tp.part(self.heads)]

    def null_out(self) -> torch.Tensor:
        """(1, 1, dim) output for a query whose whole context is masked: the
        softmax is one-hot on the null position, so this is `to_out(null_v)`
        (under a tensor split, the sum of each rank's heads' part)."""
        v = self._null_kv()[1]
        out = self.to_out(v.reshape(1, 1, v.shape[0] * self.dim_head).to(self.dtype))
        return out if self.tensor_split is None else reduce_out(out, self.tensor_split)

    def compute_kv(self, kv_input: torch.Tensor) -> KV:
        """Raw K/V projections (views into one to_kv output); under a tensor
        split, of this rank's heads."""
        tp = self.tensor_split
        return self._kv(kv_input if tp is None else copy_in(kv_input, tp))

    def _kv(self, kv_input: torch.Tensor) -> KV:
        tp = self.tensor_split
        if tp is None:
            out = self.to_kv(kv_input)
        else:
            heads = tp.part(self.heads)
            rows = slice(heads.start * self.dim_head, heads.stop * self.dim_head)
            out = _linear(self.to_kv, kv_input, _pair_rows(copy_in(self.to_kv.weight, tp), self.heads * self.dim_head, rows))
        k, v = out.chunk(2, dim=-1)
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
        tp = self.tensor_split
        d = self.dim_head
        h = self.heads if tp is None else self.heads // tp.size  # this rank's heads
        x = self.norm(x)
        q_scale, k_scale = self.q_scale, self.k_scale
        if tp is not None:
            x = copy_in(x, tp)
            q_scale, k_scale = copy_in(q_scale, tp), copy_in(k_scale, tp)
        if exists(cached_kv):
            k_raw, v_raw = cached_kv
        elif self.cross_attend:
            k_raw, v_raw = self.compute_kv(context)
        else:
            k_raw, v_raw = self._kv(x)
        m = k_raw.shape[1]
        null_kv = self._null_kv()
        q = self.to_q(x).reshape(b, n, h, d)
        out = qknorm_attend(
            q,
            k_raw.reshape(b, m, h, d),
            v_raw.reshape(b, m, h, d),
            null_k=null_kv[0, :, 0, :].to(k_raw.dtype),
            null_v=null_kv[1, :, 0, :].to(v_raw.dtype),
            q_scale=q_scale,
            k_scale=k_scale,
            mask=context_mask,
            scale=self.scale,
        )
        out = self.to_out(out.reshape(b, n, h * d))
        return out if tp is None else reduce_out(out, tp)


class TransformerBlocks(nn.Module):
    """depth x (self-attn -> cross-attn -> FF), final LayerNorm.

    `remat` recomputes each block's activations in the backward
    (`torch.utils.checkpoint`, as JAX's `jax.checkpoint` a block) when
    gradients are on. `flash` is JAX's choice of attention kernel: accepted
    and ignored, since every attention here is K2."""

    def __init__(
        self,
        *,
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: float = 4,
        flash: bool = True,
        dtype=torch.float32,
        remat: bool = False,
        generator=None,
    ):
        super().__init__()
        del flash
        self.remat = remat
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
        remat = self.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            kv_i = context_kv[i] if context_kv is not None else None
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._block, layer, x, context, context_mask, kv_i, nr, use_reentrant=False
                )
            else:
                x = self._block(layer, x, context, context_mask, kv_i, nr)
        return self.norm(x)

    @staticmethod
    def _block(layer, x, context, context_mask, kv_i, nr: int) -> torch.Tensor:
        attn, cross_attn, ff = layer
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
            x = cross_attn(x, context=context, context_mask=context_mask, cached_kv=kv_i) + x
        return ff(x) + x

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
        t5_name: Optional[str] = None,
        text_embed_dim: Optional[int] = None,
        self_cond: bool = False,
        add_mask_id: bool = False,
        dtype=torch.float32,
        generator: Optional[torch.Generator] = None,
        device="cuda",
        **kwargs,
    ):
        super().__init__()
        device = resolve_device(device)
        self.t5_name = default(t5_name, DEFAULT_T5_NAME)
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
        text_embed_dim = default(text_embed_dim, lambda: get_encoded_dim(self.t5_name))
        self.text_embed_dim = text_embed_dim
        self.text_embed_proj = (
            Linear(text_embed_dim, dim, dtype=dtype, generator=generator)
            if text_embed_dim != dim
            else None
        )
        self.self_cond = self_cond
        self.self_cond_to_init_embed = FeedForward(dim, dtype=dtype, generator=generator)
        self.tensor_split = None
        self.to(device)

    def tensor_local_leaves(self, size: int):
        """`parallel.tensor.plan`: split `size` ways, a rank holds its slice
        of the vocab head's rows and, apart, of the token embedding's rows,
        where the split stores them (65536 head rows divide; 65537 embedding
        rows, the mask id's among them, do not)."""
        return [{"to_logits.weight": 0}, {"token_emb.weight": 0}]

    def _split_of(self, leaf: str):
        tp = self.tensor_split
        return tp if tp is not None and tp.splits(leaf) else None

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings; under a split table, each rank looks up the ids
        in its rows (zeros elsewhere) and the ranks' parts are summed."""
        tp = self._split_of("token_emb.weight")
        if tp is None:
            return self.token_emb(ids)
        table = self.token_emb.weight
        local = ids - tp.rank * table.shape[0]
        inside = (local >= 0) & (local < table.shape[0])
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), table)
        return reduce_out(torch.where(inside[..., None], rows, torch.zeros_like(rows)), tp)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """Vocab logits of pre-head embeddings, whole rows on every rank."""
        tp = self._split_of("to_logits.weight")
        if tp is None:
            return self.to_logits(h)
        return gather_last(self.to_logits(copy_in(h, tp)), tp)

    def _positions(self, n: int, grid: Optional[tuple] = None) -> torch.Tensor:
        """(n, dim) positional embeddings for a sequence of n tokens.

        At the trained length this is the learned table. For another square
        grid (a model trained at f x f generating g x g), or an explicit
        `grid=(gh, gw)`, which may be rectangular, the trained f x f table is
        resized bilinearly to the new grid, as `jax.image.resize(...,
        "bilinear")` does: in f32, antialiased when it shrinks. A flat n that
        is no square keeps the prefix of the table (n <= seq_len)."""
        table = self.pos_emb.weight
        f = math.isqrt(self.seq_len)
        if grid is not None:
            gh, gw = int(grid[0]), int(grid[1])
            if gh * gw != n:
                raise ValueError(f"pos grid {grid} does not tile length {n}")
            if n == self.seq_len and f * f != self.seq_len:
                # a natively non-square table has one valid grid: its own
                if self.seq_hw is None or (gh, gw) != self.seq_hw:
                    raise ValueError(
                        f"pos grid {grid} does not match the trained grid {self.seq_hw} of this "
                        "non-square model (set seq_hw at construction to name the trained orientation)"
                    )
                return table
            if n == self.seq_len and (gh, gw) == (f, f):
                return table
            if f * f != self.seq_len:
                raise ValueError(
                    f"explicit pos_grid transfer needs a square trained table, got seq_len {self.seq_len}"
                )
            return self._resized_positions(f, gh, gw)
        if n == self.seq_len:
            return table
        g = math.isqrt(n)
        if f * f == self.seq_len and g * g == n:
            return self._resized_positions(f, g, g)
        if n > self.seq_len:
            raise ValueError(
                f"sequence length {n} exceeds the trained {self.seq_len} and is not a square grid "
                "(only square grids support resolution transfer)"
            )
        return table[:n]

    def _resized_positions(self, f: int, gh: int, gw: int) -> torch.Tensor:
        table = self.pos_emb.weight
        sq = table.reshape(f, f, self.dim).float().permute(2, 0, 1)[None]
        out = F.interpolate(sq, size=(gh, gw), mode="bilinear", align_corners=False, antialias=True)
        return out[0].permute(1, 2, 0).reshape(gh * gw, self.dim).to(table.dtype)

    def encode_text(self, texts) -> torch.Tensor:
        """Texts -> (b, n, text_embed_dim) T5 embeddings, padding zeroed, on
        this module's device (the frozen encoder named `t5_name`)."""
        return t5_encode_text(texts, name=self.t5_name, device=self.token_emb.weight.device)

    def _context(
        self, text_embeds: torch.Tensor, conditioning_token_ids: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The cross-attention context: the projected text, then the token
        embeddings of the flattened conditioning ids (super-res stage)."""
        if exists(self.text_embed_proj):
            text_embeds = self.text_embed_proj(text_embeds)
        context = text_embeds.to(self.dtype)
        if exists(conditioning_token_ids):
            cond_ids = conditioning_token_ids.reshape(context.shape[0], -1)
            context = torch.cat([context, self._embed(cond_ids).to(self.dtype)], dim=-2)
        return context

    def precompute_context_kv(
        self, *, text_embeds: torch.Tensor, conditioning_token_ids: Optional[torch.Tensor] = None
    ) -> List[KV]:
        """Per-layer cross-attention K/V of the static context (projected
        text, then conditioning-token embeddings), projected once per
        generate instead of once per step per layer."""
        return self.transformer_blocks.compute_context_kv(
            self._context(text_embeds, conditioning_token_ids)
        )

    def precompute_context_kv_neg(
        self,
        *,
        text_embeds: torch.Tensor,
        neg_text_embeds: torch.Tensor,
        text_mask: Optional[torch.Tensor] = None,
        neg_text_mask: Optional[torch.Tensor] = None,
        conditioning_token_ids: Optional[torch.Tensor] = None,
    ):
        """Per-layer cross-attention K/V for `forward_with_neg_prompt`'s
        doubled batch: the positive rows, then the negative rows, both texts
        padded to one length. Returns `(context_kv, (text_embeds, text_mask),
        (neg_text_embeds, neg_text_mask))` with the padded tensors, which the
        forward must be given so the masks match the cache."""
        text_mask = _text_mask(text_embeds, text_mask)
        neg_text_mask = _text_mask(neg_text_embeds, neg_text_mask)
        length = max(text_embeds.shape[1], neg_text_embeds.shape[1])
        text_embeds, text_mask = _pad_text_to(text_embeds, text_mask, length)
        neg_text_embeds, neg_text_mask = _pad_text_to(neg_text_embeds, neg_text_mask, length)
        cond2 = (
            torch.cat([conditioning_token_ids, conditioning_token_ids], dim=0)
            if exists(conditioning_token_ids)
            else None
        )
        ctx_kv = self.precompute_context_kv(
            text_embeds=torch.cat([text_embeds, neg_text_embeds], dim=0), conditioning_token_ids=cond2
        )
        return ctx_kv, (text_embeds, text_mask), (neg_text_embeds, neg_text_mask)

    def _cfg_combine(self, out2: torch.Tensor, b: int, cond_scale: Scale, fold: bool):
        """`null + (cond - null) * s` over a doubled batch: on the pre-head
        embeddings then one head matmul on b rows (`fold`), or on logits.

        `cond_scale` is a python number, a 0-d tensor or a per-row (b,)
        tensor. A tensor is an f32 value, as JAX's traced scale is: on logits
        in a lower precision it makes the combine's product and sum f32."""
        s = cond_scale
        if isinstance(s, torch.Tensor):
            s = s.float()
            if s.dim() == 1:
                s = s[:, None, None]
        cond, null = out2[:b], out2[b:]
        if fold:
            e = null.float()
            e = e + (cond.float() - e) * s
            return self._head(e.to(self.dtype))
        if isinstance(s, torch.Tensor):
            return null.float() + (cond - null).float() * s
        return null + (cond - null) * s

    def forward_with_cond_scale(
        self,
        x: torch.Tensor,
        *,
        text_embeds: torch.Tensor,
        cond_scale: Scale = 3.0,
        return_embed: bool = False,
        text_mask: Optional[torch.Tensor] = None,
        conditioning_token_ids: Optional[torch.Tensor] = None,
        self_cond_embed: Optional[torch.Tensor] = None,
        return_raw_double: bool = False,
        gather_positions: Optional[torch.Tensor] = None,
        context_kv: Optional[List[KV]] = None,
        pos_grid: Optional[tuple] = None,
        cfg_fold: bool = True,
        return_embed_only: bool = False,
        null_fold: bool = True,
    ):
        """CFG as ONE doubled-batch forward (cond rows then null rows, the
        null half with its TEXT mask zeroed; conditioning image tokens stay
        attendable there). Semantics of every flag as in the JAX module;
        `null_fold` is a no-op when conditioning tokens are given, because
        the null half's cross-attention is then no constant.

        `cond_scale`: a python number (1 runs a single pass), a 0-d tensor
        or a per-row (b,) tensor (the per-row form needs `cfg_fold`); a
        tensor always runs the doubled batch and is never read on the host.
        `return_embed_only` returns the cond half's embeddings and runs no
        vocab head."""
        if not isinstance(cond_scale, torch.Tensor) and cond_scale == 1:
            out = self(
                x, text_embeds=text_embeds, text_mask=text_mask, self_cond_embed=self_cond_embed,
                conditioning_token_ids=conditioning_token_ids, context_kv=context_kv, pos_grid=pos_grid,
                return_embed=return_embed, gather_positions=None if return_embed_only else gather_positions,
                skip_head=return_embed_only,
            )
            return out[1] if return_embed_only else out

        b = x.shape[0]
        text_mask = _text_mask(text_embeds, text_mask)
        return self._doubled(
            x, b, cond_scale, text_embeds=_dup(text_embeds),
            text_mask=torch.cat([text_mask, torch.zeros_like(text_mask)], dim=0),
            conditioning_token_ids=conditioning_token_ids, self_cond_embed=self_cond_embed,
            return_embed=return_embed, return_raw_double=return_raw_double, gather_positions=gather_positions,
            context_kv=context_kv, pos_grid=pos_grid, cfg_fold=cfg_fold, return_embed_only=return_embed_only,
            null_rows=b if (null_fold and not exists(conditioning_token_ids)) else 0,
        )

    def forward_with_neg_prompt(
        self,
        x: torch.Tensor,
        *,
        text_embeds: torch.Tensor,
        neg_text_embeds: torch.Tensor,
        cond_scale: Scale = 3.0,
        return_embed: bool = False,
        text_mask: Optional[torch.Tensor] = None,
        neg_text_mask: Optional[torch.Tensor] = None,
        conditioning_token_ids: Optional[torch.Tensor] = None,
        self_cond_embed: Optional[torch.Tensor] = None,
        return_raw_double: bool = False,
        gather_positions: Optional[torch.Tensor] = None,
        context_kv: Optional[List[KV]] = None,
        pos_grid: Optional[tuple] = None,
        cfg_fold: bool = True,
        return_embed_only: bool = False,
        null_fold: bool = True,
    ):
        """Negative prompting: `neg + (pos - neg) * cond_scale`, the
        negative text in the null half's place (both texts padded to one
        length). `context_kv` is `precompute_context_kv_neg`'s cache, which
        holds both halves. `null_fold` is accepted for symmetry with
        `forward_with_cond_scale` and does nothing: the negative half
        attends a real context."""
        del null_fold
        b = x.shape[0]
        text_mask = _text_mask(text_embeds, text_mask)
        neg_text_mask = _text_mask(neg_text_embeds, neg_text_mask)
        length = max(text_embeds.shape[1], neg_text_embeds.shape[1])
        text_embeds, text_mask = _pad_text_to(text_embeds, text_mask, length)
        neg_text_embeds, neg_text_mask = _pad_text_to(neg_text_embeds, neg_text_mask, length)
        return self._doubled(
            x, b, cond_scale, text_embeds=torch.cat([text_embeds, neg_text_embeds], dim=0),
            text_mask=torch.cat([text_mask, neg_text_mask], dim=0),
            conditioning_token_ids=conditioning_token_ids, self_cond_embed=self_cond_embed,
            return_embed=return_embed, return_raw_double=return_raw_double, gather_positions=gather_positions,
            context_kv=context_kv, pos_grid=pos_grid, cfg_fold=cfg_fold, return_embed_only=return_embed_only,
            null_rows=0,
        )

    def _doubled(
        self, x, b, cond_scale, *, text_embeds, text_mask, conditioning_token_ids, self_cond_embed,
        return_embed, return_raw_double, gather_positions, context_kv, pos_grid, cfg_fold,
        return_embed_only, null_rows,
    ):
        """The doubled-batch forward of both CFG wrappers (`text_embeds` and
        `text_mask` already hold both halves), then the combine."""
        fold = (cfg_fold or return_embed_only) and not return_raw_double
        out2, embed2 = self(
            _dup(x),
            text_embeds=text_embeds,
            text_mask=text_mask,
            conditioning_token_ids=_dup(conditioning_token_ids),
            self_cond_embed=_dup(self_cond_embed),
            return_embed=True,
            gather_positions=_dup(gather_positions),
            context_kv=context_kv,
            pos_grid=pos_grid,
            skip_head=fold,
            null_rows=null_rows,
        )
        if return_embed_only:
            return embed2[:b]
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
        texts=None,
        text_embeds: Optional[torch.Tensor] = None,
        text_mask: Optional[torch.Tensor] = None,
        return_embed: bool = False,
        return_logits: bool = False,
        labels: Optional[torch.Tensor] = None,
        ignore_index: int = 0,
        self_cond_embed: Optional[torch.Tensor] = None,
        cond_drop_prob: float = 0.0,
        keep_u: Optional[torch.Tensor] = None,
        conditioning_token_ids: Optional[torch.Tensor] = None,
        gather_positions: Optional[torch.Tensor] = None,
        context_kv: Optional[List[KV]] = None,
        pos_grid: Optional[tuple] = None,
        skip_head: bool = False,
        null_rows: int = 0,
        loss_denominator: Optional[float] = None,
    ):
        """Logits (b, n|k, dim_out) for token ids x (b, n).

        `gather_positions` (b, k) restricts the vocab head to those
        positions; `skip_head` returns (gathered pre-head embeddings, full
        embeddings); `null_rows` see `TransformerBlocks.forward`; `pos_grid`
        (h, w) names the token grid that x flattens (see `_positions`).
        `conditioning_token_ids` (b, ...) join the context after the text,
        always attendable; with `context_kv` given they only extend the mask
        (the cache already holds their K/V).

        Training: with `labels` (b, n) the loss is returned (with the logits
        after it under `return_logits`): the mean cross entropy over the
        labels that are not `ignore_index` (the sum over
        `loss_denominator` where given), or for a `dim_out == 1` critic
        the binary cross entropy against float labels. `cond_drop_prob` > 0
        drops a row's text (not its conditioning tokens) where its uniform
        `keep_u` (b, 1) is below it."""
        if null_rows and exists(conditioning_token_ids):
            # conditioning tokens stay attendable in the CFG null half, so
            # its cross-attention is no constant
            raise ValueError("null_rows needs a context without conditioning_token_ids")
        if exists(labels) and (gather_positions is not None or skip_head):
            raise ValueError("gather_positions and skip_head are sampling-path features: no labels with them")
        if exists(texts) == exists(text_embeds):
            raise ValueError("pass exactly one of texts and text_embeds")
        if exists(texts):
            text_embeds = self.encode_text(texts)
        b, n = x.shape
        context = (
            self._context(text_embeds, conditioning_token_ids) if context_kv is None else None
        )
        context_mask = _text_mask(text_embeds, text_mask)
        if cond_drop_prob > 0:
            # classifier-free guidance dropout: a row keeps its text where
            # its uniform is at least the drop probability
            if keep_u is None:
                raise ValueError("cond_drop_prob > 0 needs the uniforms keep_u")
            context_mask = context_mask & (keep_u.reshape(b, 1) >= cond_drop_prob)
        if exists(conditioning_token_ids):
            n_cond = conditioning_token_ids.reshape(b, -1).shape[-1]
            context_mask = F.pad(context_mask, (0, n_cond), value=True)

        h = (self._embed(x) + self._positions(n, grid=pos_grid)).to(self.dtype)
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
        vocab_split = self._split_of("to_logits.weight")
        if exists(labels) and vocab_split is not None and not return_embed:
            # a vocab-parallel cross entropy on this rank's logits; the whole
            # rows only where they are returned
            local = self.to_logits(copy_in(head_in, vocab_split))
            loss = cross_entropy_ignore_index(local, labels, ignore_index, loss_denominator, vocab_split)
            return (loss, gather_last(local, vocab_split)) if return_logits else loss
        logits = self._head(head_in)
        if return_embed:
            return logits, embed
        if not exists(labels):
            return logits
        if self.dim_out == 1:
            loss = sigmoid_bce(logits[..., 0], labels)
        else:
            loss = cross_entropy_ignore_index(logits, labels, ignore_index, loss_denominator)
        return (loss, logits) if return_logits else loss


def cross_entropy_ignore_index(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int, denominator: Optional[float] = None, split=None
) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not
    `ignore_index` (0 when there are none), as `picked logit - logsumexp`
    in f32 over logits of any dtype: no (b, n, vocab) log-softmax is
    written, only the picked logit is gathered. `denominator` replaces the
    count of those positions (a data-parallel rank divides its sum by its
    share of the global batch's count). `split` (a `TensorSplit`): the
    logits are this tensor rank's slice of the vocab, and the row max, the
    sum of exponentials and the picked logit reduce over the tensor group."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    if split is None:
        lse = torch.logsumexp(logits.float(), dim=-1)
        picked = logits.gather(-1, safe[..., None].long())[..., 0]
    else:
        x = logits.float()
        top = max_over(x.detach().amax(dim=-1, keepdim=True), split)
        lse = torch.log(reduce_out(torch.exp(x - top).sum(dim=-1), split)) + top[..., 0]
        local = safe.long() - split.rank * logits.shape[-1]
        inside = (local >= 0) & (local < logits.shape[-1])
        mine = logits.gather(-1, torch.where(inside, local, torch.zeros_like(local))[..., None])[..., 0].float()
        picked = reduce_out(torch.where(inside, mine, torch.zeros_like(mine)), split)
    ll = picked.float() - lse
    count = valid.sum().clamp(min=1) if denominator is None else denominator
    return -(ll * valid).sum() / count


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy with logits, through log-sigmoid in f32."""
    logits = logits.float()
    return -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits)).mean()


def _dup(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else torch.cat([t, t], dim=0)


class MaskGitTransformer(Transformer):
    """Transformer with a [mask] token id (= num_tokens)."""

    def __init__(self, **kwargs):
        if "add_mask_id" in kwargs:
            raise TypeError("MaskGitTransformer always adds the mask id")
        super().__init__(add_mask_id=True, **kwargs)


class TokenCritic(Transformer):
    """A transformer of its own that scores each token of a grid: one logit
    a token, the odds that it is fake (`dim_out=1`)."""

    def __init__(self, **kwargs):
        if "dim_out" in kwargs:
            raise TypeError("TokenCritic always has dim_out 1")
        super().__init__(dim_out=1, **kwargs)


class SelfCritic(nn.Module):
    """A linear critic head (f32, with a bias) over the generator's own
    embeddings (`net` is the generator's transformer, shared).

    It reads the cond half's embeddings only, so its CFG wrappers run one
    single-batch forward without the vocab head: the guidance scale never
    reaches its score."""

    def __init__(self, net: Transformer, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = net
        self.to_pred = Linear(net.dim, 1, bias=True, generator=generator)

    @staticmethod
    def _cond_half_ctx_kv(ctx_kv: Optional[List[KV]], b: int) -> Optional[List[KV]]:
        """A (possibly CFG-doubled) per-layer K/V cache cut to the cond rows."""
        if ctx_kv is None:
            return None
        return [(k[:b], v[:b]) for k, v in ctx_kv]

    def forward_with_cond_scale(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        for drop in ("return_embed", "return_embed_only", "return_raw_double", "cond_scale", "cfg_fold", "null_fold"):
            kwargs.pop(drop, None)
        kwargs["context_kv"] = self._cond_half_ctx_kv(kwargs.get("context_kv"), x.shape[0])
        _, embeds = self.net(x, skip_head=True, **kwargs)
        return self.to_pred(embeds)

    def forward_with_neg_prompt(
        self, x, *, text_embeds, neg_text_embeds, text_mask=None, neg_text_mask=None, **kwargs
    ) -> torch.Tensor:
        # the positive half only, its text padded to the length the doubled
        # positive + negative cache was built over
        del neg_text_mask
        text_mask = _text_mask(text_embeds, text_mask)
        length = max(text_embeds.shape[1], neg_text_embeds.shape[1])
        text_embeds, text_mask = _pad_text_to(text_embeds, text_mask, length)
        return self.forward_with_cond_scale(x, text_embeds=text_embeds, text_mask=text_mask, **kwargs)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
        """Fake-odds logits (b, n, 1); with float `labels` (b, n), their
        binary cross entropy."""
        kwargs.pop("return_embed", None)
        _, embeds = self.net(x, skip_head=True, **kwargs)
        logits = self.to_pred(embeds)
        if not exists(labels):
            return logits
        return sigmoid_bce(logits[..., 0], labels)
