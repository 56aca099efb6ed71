"""Frozen T5 text conditioning (counterpart of
`muse_maskgit_pytorch_tpu/models/t5.py`).

The encoder-only T5 (RMSNorm, relative-position-bias attention, gated tanh
GELU feed-forward for the v1.1 configs, ReLU for the legacy ones) in plain
PyTorch, f32. Its attention is plain `matmul` / `softmax`, as the JAX
package leaves it to XLA: a per-head (n, n) position bias joins the scores,
which neither attention kernel of `ops.attention` takes.

Same contract as the JAX module:

  * `t5_encode_text(texts, name) -> (b, n, d)` embeddings with the padding
    positions ZEROED, so that downstream code recovers the mask as
    `(embeds != 0).any(-1)`; an empty prompt still holds its EOS token;
  * lengths rounded up to a multiple of 8 and cut at `MAX_LENGTH`;
  * `get_encoded_dim(name)` from a static table, without building a model;
  * one cached encoder per (name, device): `get_model_and_tokenizer`,
    `set_model`.

Weights: random init from seed 0, or a JAX `T5Encoder`'s state carried over
by `utils.from_jax.load_jax_state` and injected with `set_model`. The
tokenizer is the byte-level one. Pretrained Hugging Face weights and the
SentencePiece vocabulary need files that are not in the repository:
`HFTokenizer` and `load_hf_t5_weights` raise until they are.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Embedding, Linear
from muse_maskgit_pytorch_tpu_torch.utils.helpers import not_ported, resolve_device

MAX_LENGTH = 256
DEFAULT_T5_NAME = "google/t5-v1_1-base"
T5_VOCAB_SIZE = 32128


@dataclasses.dataclass(frozen=True)
class T5Config:
    d_model: int
    d_ff: int
    num_heads: int
    d_kv: int
    num_layers: int
    gated: bool  # v1.1 = gated-gelu, legacy = relu
    vocab_size: int = T5_VOCAB_SIZE
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    layer_norm_eps: float = 1e-6


# a config may be registered here at run time (tiny offline configs in tests)
T5_CONFIGS: Dict[str, T5Config] = {
    "google/t5-v1_1-small": T5Config(512, 1024, 6, 64, 8, True),
    "google/t5-v1_1-base": T5Config(768, 2048, 12, 64, 12, True),
    "google/t5-v1_1-large": T5Config(1024, 2816, 16, 64, 24, True),
    "google/t5-v1_1-xl": T5Config(2048, 5120, 32, 64, 24, True),
    "google/t5-v1_1-xxl": T5Config(4096, 10240, 64, 64, 24, True),
    "t5-small": T5Config(512, 2048, 8, 64, 6, False),
    "t5-base": T5Config(768, 3072, 12, 64, 12, False),
    "t5-large": T5Config(1024, 4096, 16, 64, 24, False),
}


def get_config(name: str) -> T5Config:
    """Known names only: nothing here asks a hub or `transformers`."""
    if name not in T5_CONFIGS:
        raise ValueError(f"unknown t5 config {name!r}; known: {sorted(T5_CONFIGS)}")
    return T5_CONFIGS[name]


def get_encoded_dim(name: str) -> int:
    """Embedding dim without building a model."""
    return get_config(name).d_model


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """T5 layer norm: no mean, no bias; the variance in f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return x * self.weight.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _relative_position_bucket(n: int, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """(n, n) int64 bidirectional T5 buckets of `key - query`, on the host.

    The bucket of a large distance truncates an f32 `log` quotient to an
    integer, and a quotient that sits on an integer (distance 16: exactly 2
    but for the 1e-6) moves with the last bit of `log`; numpy's f32 `log`
    gives the JAX package's table for every n up to `MAX_LENGTH` (pinned by
    the tests), so the table is computed here and not on the device."""
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    num_buckets //= 2
    ret = (rel > 0).astype(np.int64) * num_buckets
    dist = np.abs(rel)
    max_exact = num_buckets // 2
    quotient = np.log(dist.astype(np.float32) / np.float32(max_exact) + np.float32(1e-6))
    scaled = quotient / np.float32(np.log(max_distance / max_exact)) * np.float32(num_buckets - max_exact)
    val_if_large = max_exact + scaled.astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(dist < max_exact, dist, val_if_large)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool, *, generator=None):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = Linear(cfg.d_model, inner, generator=generator)
        self.k = Linear(cfg.d_model, inner, generator=generator)
        self.v = Linear(cfg.d_model, inner, generator=generator)
        self.o = Linear(inner, cfg.d_model, generator=generator)
        self.rel_bias = (
            Embedding(cfg.rel_pos_buckets, cfg.num_heads, generator=generator) if has_rel_bias else None
        )

    def compute_bias(self, n: int) -> torch.Tensor:
        """(1, heads, n, n) position bias; only the first block owns one."""
        buckets = _relative_position_bucket(n, self.cfg.rel_pos_buckets, self.cfg.rel_pos_max_distance)
        buckets = torch.from_numpy(buckets).to(self.rel_bias.weight.device)
        return self.rel_bias(buckets).permute(2, 0, 1)[None]

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor, position_bias: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, _ = x.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv
        q = self.q(x).reshape(b, n, h, d).transpose(1, 2)
        k = self.k(x).reshape(b, n, h, d).transpose(1, 2)
        v = self.v(x).reshape(b, n, h, d).transpose(1, 2)
        if position_bias is None:
            position_bias = self.compute_bias(n)
        # T5 does NOT scale by 1/sqrt(d); masked keys are filled with -1e9,
        # not -inf: a row of padding attends evenly instead of giving NaN
        scores = torch.matmul(q, k.transpose(-1, -2)) + position_bias
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
        attn = scores.float().softmax(dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, h * d)
        return self.o(out), position_bias


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, *, generator=None):
        super().__init__()
        self.gated = cfg.gated
        if cfg.gated:
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, generator=generator)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, generator=generator)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, generator=generator)
        self.wo = Linear(cfg.d_ff, cfg.d_model, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            # the tanh form of GELU (the trunk's FeedForward uses the erf form)
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool, *, generator=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.attn = T5SelfAttention(cfg, has_rel_bias, generator=generator)
        self.ln2 = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ff = T5FF(cfg, generator=generator)

    def forward(self, x, mask, position_bias):
        h, position_bias = self.attn(self.ln1(x), mask, position_bias)
        x = x + h
        x = x + self.ff(self.ln2(x))
        return x, position_bias


class T5Encoder(nn.Module):
    """Encoder-only T5. Parameter names mirror the JAX module tree, so
    `utils.from_jax.load_jax_state` maps a JAX `T5Encoder`'s state by path."""

    def __init__(self, cfg: T5Config, *, generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.token_emb = Embedding(cfg.vocab_size, cfg.d_model, generator=generator)
        # the first block's position bias is shared down the stack
        self.blocks = nn.ModuleList(
            T5Block(cfg, has_rel_bias=(i == 0), generator=generator) for i in range(cfg.num_layers)
        )
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.eval().requires_grad_(False)
        self.to(device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.token_emb(input_ids)
        position_bias = None
        for block in self.blocks:
            x, position_bias = block(x, attention_mask, position_bias)
        return self.final_norm(x)


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


class ByteFallbackTokenizer:
    """Deterministic byte-level tokenizer with T5's special ids (pad 0,
    eos 1): byte b is id b + 3; a text is cut at `max_length - 1` bytes and
    closed with eos."""

    def __call__(self, texts: List[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        seqs = []
        for t in texts:
            ids = [min(b + 3, T5_VOCAB_SIZE - 1) for b in t.encode("utf-8")][: max_length - 1]
            ids.append(1)  # eos
            seqs.append(ids)
        n = max(len(s) for s in seqs)
        input_ids = np.zeros((len(seqs), n), np.int32)
        mask = np.zeros((len(seqs), n), bool)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = True
        return input_ids, mask


class HFTokenizer:
    """The SentencePiece tokenizer of a Hugging Face T5: needs its vocabulary
    file, which is not in the repository."""

    def __init__(self, name: str):
        raise not_ported(f"the Hugging Face tokenizer of {name!r} (no vocabulary file here)", "A13")


def load_hf_t5_weights(model: T5Encoder, name: str):
    """Pretrained Hugging Face weights: need files that are not in the
    repository."""
    raise not_ported(f"loading Hugging Face weights of {name!r} (no weight files here)", "A13")


# ---------------------------------------------------------------------------
# one cached encoder per (name, device), and the public encode API
# ---------------------------------------------------------------------------

_T5_CACHE: dict = {}


def _key(name: str, device) -> Tuple[str, str]:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return name, str(device)


def get_model_and_tokenizer(name: str, device="cuda"):
    """The cached (encoder, tokenizer) of `name` on `device`; built at random
    init from seed 0 with the byte tokenizer the first time (inject real
    weights with `set_model`)."""
    device = resolve_device(device)
    key = _key(name, device)
    if key not in _T5_CACHE:
        model = T5Encoder(get_config(name), generator=torch.Generator().manual_seed(0), device=device)
        _T5_CACHE[key] = dict(model=model, tokenizer=ByteFallbackTokenizer(), pretrained=False)
    entry = _T5_CACHE[key]
    return entry["model"], entry["tokenizer"]


def set_model(name: str, model: T5Encoder, tokenizer=None):
    """Inject an encoder (bridged or trained weights) into the cache, under
    `name` and the device its parameters lie on."""
    entry = _T5_CACHE.setdefault(_key(name, next(model.parameters()).device), {})
    entry["model"] = model
    entry["pretrained"] = True
    if tokenizer is not None:
        entry["tokenizer"] = tokenizer
    elif "tokenizer" not in entry:
        entry["tokenizer"] = ByteFallbackTokenizer()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@torch.no_grad()
def t5_encode_text_with_mask(
    texts: Union[str, List[str]],
    name: str = DEFAULT_T5_NAME,
    max_length: int = MAX_LENGTH,
    pad_to_multiple: int = 8,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(embeds (b, n, d) with the padding zeroed, mask (b, n) bool), on
    `device`. n is the longest text's length rounded up to
    `pad_to_multiple` and cut at `max_length`, as in the JAX package (a few
    length buckets instead of one shape per length)."""
    if isinstance(texts, str):
        texts = [texts]
    model, tokenizer = get_model_and_tokenizer(name, device)
    input_ids, mask = tokenizer(texts, max_length)

    n = min(_round_up(input_ids.shape[1], pad_to_multiple), max_length)
    if input_ids.shape[1] < n:
        pad = n - input_ids.shape[1]
        input_ids = np.pad(input_ids, ((0, 0), (0, pad)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
    else:
        input_ids, mask = input_ids[:, :n], mask[:, :n]

    where = next(model.parameters()).device
    ids_t = torch.from_numpy(np.ascontiguousarray(input_ids)).to(where)
    mask_t = torch.from_numpy(np.ascontiguousarray(mask)).to(where)
    embeds = model(ids_t, mask_t)
    return embeds.masked_fill(~mask_t[..., None], 0.0), mask_t


def t5_encode_text(
    texts: Union[str, List[str]],
    name: str = DEFAULT_T5_NAME,
    max_length: int = MAX_LENGTH,
    device="cuda",
) -> torch.Tensor:
    """Embeddings only, padding zeroed."""
    return t5_encode_text_with_mask(texts, name=name, max_length=max_length, device=device)[0]
