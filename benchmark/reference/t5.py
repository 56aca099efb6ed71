"""Plain reference of the T5 v1.1 encoder (f32, no cache) and of the byte
tokenizer: byte b is id b + 3 (capped at the vocabulary), pad 0, end 1, a
text cut at `length - 1` bytes and padded to `length`.

Encoder: token embedding; per block RMSNorm (eps 1e-6), self-attention
without 1/sqrt(d) over the bidirectional relative-position buckets of the
first block (masked keys at -1e9), residual, RMSNorm, gated-GELU (tanh form)
feed-forward, residual; a final RMSNorm; padding rows zeroed.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import linear


def byte_tokens(texts: Sequence[str], length: int, vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.zeros((len(texts), length), np.int64)
    mask = np.zeros((len(texts), length), bool)
    for i, t in enumerate(texts):
        seq = [min(b + 3, vocab - 1) for b in t.encode("utf-8")][: length - 1] + [1]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = True
    return ids, mask


def buckets(n: int, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """(n, n) bucket of `key - query`, T5's bidirectional rule, with the
    large-distance logarithm in float32."""
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    half = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * half
    dist = np.abs(rel)
    exact = half // 2
    q = np.log(dist.astype(np.float32) / np.float32(exact) + np.float32(1e-6))
    large = exact + (q / np.float32(math.log(max_distance / exact)) * np.float32(half - exact)).astype(np.int64)
    return ret + np.where(dist < exact, dist, np.minimum(large, half - 1))


def _rms(x, weight, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * weight


def encode(w: dict, t: dict, ids: torch.Tensor, mask: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """(B, n, d_model) embeddings, padding zeroed."""
    b, n = ids.shape
    h, d = t["num_heads"], t["d_kv"]
    x = w["token_emb.weight"][ids]
    bias = w["blocks.0.attn.rel_bias.weight"][torch.from_numpy(buckets(n)).to(ids.device)].permute(2, 0, 1)[None]
    for i in range(t["num_layers"]):
        p = f"blocks.{i}."
        y = _rms(x, w[p + "ln1.weight"])
        q, k, v = (linear(y, w[p + f"attn.{c}.weight"], mode).reshape(b, n, h, d).transpose(1, 2) for c in "qkv")
        scores = torch.matmul(q, k.transpose(-1, -2)) if mode != "tf32" else _tf32_matmul(q, k.transpose(-1, -2))
        scores = (scores + bias).masked_fill(~mask[:, None, None, :], -1e9)
        out = torch.matmul(scores.softmax(dim=-1), v).transpose(1, 2).reshape(b, n, h * d)
        x = x + linear(out, w[p + "attn.o.weight"], mode)
        y = _rms(x, w[p + "ln2.weight"])
        ff = F.gelu(linear(y, w[p + "ff.wi_0.weight"], mode), approximate="tanh") * linear(y, w[p + "ff.wi_1.weight"], mode)
        x = x + linear(ff, w[p + "ff.wo.weight"], mode)
    return _rms(x, w["final_norm.weight"]).masked_fill(~mask[..., None], 0.0)


def _tf32_matmul(a, b):
    from benchmark.reference.precision import tf32

    with tf32(True):
        return torch.matmul(a, b)


def encode_texts(w: dict, t: dict, texts: List[str], length: int, device, mode: str = "f32"):
    ids, mask = byte_tokens(texts, length, t["vocab_size"])
    mask_t = torch.from_numpy(mask).to(device)
    return encode(w, t, torch.from_numpy(ids).to(device), mask_t, mode), mask_t
