"""Quantizers, inference side (counterpart of
`muse_maskgit_pytorch_tpu/models/quantizers.py`).

  * `LFQ`: a token id is the MSB-first binary code of the sign bits of a
    `codebook_dim = log2(codebook_size)` wide latent.
  * `FSQ`: each latent channel is bounded with tanh and rounded to one of
    `levels[i]` values; the id is the mixed-radix code over channels.
  * `VectorQuantizeEMA`: nearest-code search over a (K, codebook_dim)
    codebook, cosine by default, through `ops.vq.nearest_code` (K3 on the
    GPU).

All take (..., dim) latents and return `(quantized, indices, aux_loss)`,
with int32 indices and the JAX package's straight-through expressions, so
the values agree with it to the last rounding. Training (LFQ's entropy and
commitment losses, EMA-VQ's k-means init and EMA codebook updates) is not
ported yet (ROADMAP A10).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Linear
from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code
from muse_maskgit_pytorch_tpu_torch.utils.helpers import not_ported, resolve_device

QuantizerOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t * torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + eps)


class LFQ(nn.Module):
    def __init__(
        self,
        *,
        dim: int,
        codebook_size: int,
        diversity_gamma: float = 4.0,
        entropy_loss_weight: float = 0.1,
        commitment_loss_weight: float = 0.25,
        inv_temperature: float = 100.0,
        entropy_group_bits: int = 8,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        codebook_dim = int(math.log2(codebook_size))
        if 2**codebook_dim != codebook_size:
            raise ValueError("codebook_size must be a power of 2")
        self.dim = dim
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        # loss settings, read by the (not yet ported) training side
        self.diversity_gamma = diversity_gamma
        self.entropy_loss_weight = entropy_loss_weight
        self.commitment_loss_weight = commitment_loss_weight
        self.inv_temperature = inv_temperature
        self.entropy_group_bits = entropy_group_bits
        self.has_projections = dim != codebook_dim
        if self.has_projections:
            self.project_in = Linear(dim, codebook_dim, generator=generator)
            self.project_out = Linear(codebook_dim, dim, generator=generator)
        self.to(device)

    def bits_to_indices(self, bits: torch.Tensor) -> torch.Tensor:
        """(..., codebook_dim) bool -> int32 ids, MSB first."""
        shifts = torch.arange(self.codebook_dim - 1, -1, -1, device=bits.device)
        return (bits.long() << shifts).sum(dim=-1).int()

    def indices_to_bits(self, indices: torch.Tensor) -> torch.Tensor:
        """int ids -> (..., codebook_dim) +-1 f32 codes, MSB first."""
        shifts = torch.arange(self.codebook_dim - 1, -1, -1, device=indices.device)
        bits = (indices[..., None].long() >> shifts) & 1
        return bits.float() * 2.0 - 1.0

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """ids -> (..., dim) latent vectors."""
        codes = self.indices_to_bits(indices)
        if self.has_projections:
            codes = self.project_out(codes)
        return codes

    def forward(self, x: torch.Tensor, train: bool = False) -> QuantizerOutput:
        """x (..., dim) -> (quantized (..., dim), int32 ids (...,), aux 0)."""
        if train:
            raise not_ported("LFQ's entropy and commitment losses (train=True)", "A10")
        z = self.project_in(x) if self.has_projections else x
        z = z.float()
        codes = torch.where(z > 0, 1.0, -1.0)
        quantized = z + (codes - z).detach()  # straight-through, as in JAX
        indices = self.bits_to_indices(z > 0)
        out = quantized.to(x.dtype)
        if self.has_projections:
            out = self.project_out(out)
        return out, indices, torch.zeros((), device=x.device)


class FSQ(nn.Module):
    """Finite scalar quantization; codebook_size == prod(levels)."""

    def __init__(
        self, *, dim: int, levels: Tuple[int, ...], generator: Optional[torch.Generator] = None, device="cuda"
    ):
        super().__init__()
        device = resolve_device(device)
        levels = tuple(int(n) for n in levels)
        if not levels or min(levels) < 2:
            raise ValueError("FSQ needs at least one level count, each >= 2")
        self.dim = dim
        self.levels = levels
        self.codebook_dim = len(levels)
        self.codebook_size = math.prod(levels)
        self.has_projections = dim != self.codebook_dim
        if self.has_projections:
            self.project_in = Linear(dim, self.codebook_dim, generator=generator)
            self.project_out = Linear(self.codebook_dim, dim, generator=generator)
        self.to(device)

    def _levels(self, device) -> torch.Tensor:
        return torch.tensor(self.levels, dtype=torch.float32, device=device)

    def _basis(self, device) -> torch.Tensor:
        """Mixed-radix digit weights: id = sum_i digit_i * basis_i."""
        return torch.tensor(
            [math.prod(self.levels[:i]) for i in range(len(self.levels))], dtype=torch.int32, device=device
        )

    def _half_width(self, device) -> torch.Tensor:
        return torch.floor(self._levels(device) / 2.0)

    def _bound(self, z: torch.Tensor) -> torch.Tensor:
        """tanh squash so rounding lands on `levels[i]` integers; even level
        counts sit on a grid offset by 0.5 (see the JAX module)."""
        levels = self._levels(z.device)
        half_l = (levels - 1.0) * (1.0 + 1e-3) / 2.0
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def _digits_to_values(self, digits: torch.Tensor) -> torch.Tensor:
        half_width = self._half_width(digits.device)
        return (digits.float() - half_width) / half_width

    def digits_to_indices(self, digits: torch.Tensor) -> torch.Tensor:
        return (digits * self._basis(digits.device)).sum(dim=-1, dtype=torch.int32)

    def indices_to_digits(self, indices: torch.Tensor) -> torch.Tensor:
        levels = torch.tensor(self.levels, dtype=torch.int32, device=indices.device)
        return torch.div(indices[..., None].int(), self._basis(indices.device), rounding_mode="floor") % levels

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """ids -> (..., dim) latent vectors."""
        codes = self._digits_to_values(self.indices_to_digits(indices))
        if self.has_projections:
            codes = self.project_out(codes)
        return codes

    def forward(self, x: torch.Tensor, train: bool = False) -> QuantizerOutput:
        """x (..., dim) -> (quantized (..., dim), int32 ids (...,), aux 0).
        FSQ has no training-only state or loss, so `train` changes nothing."""
        z = self.project_in(x) if self.has_projections else x
        z = z.float()
        half_width = self._half_width(z.device)
        bounded = self._bound(z)
        digits = torch.round(bounded + half_width).int()
        values = self._digits_to_values(digits)
        soft = bounded / half_width
        quantized = soft + (values - soft).detach()  # straight-through, as in JAX
        out = quantized.to(x.dtype)
        if self.has_projections:
            out = self.project_out(out)
        return out, self.digits_to_indices(digits), torch.zeros((), device=x.device)


class VectorQuantizeEMA(nn.Module):
    """Classic VQ with a cosine-similarity (default) or euclidean codebook
    search. The codebook and its EMA statistics are buffers, as they are
    `nnx.BatchStat`s in JAX; inference reads only `codebook`."""

    def __init__(
        self,
        *,
        dim: int,
        codebook_size: int,
        codebook_dim: int = 256,
        decay: float = 0.8,
        commitment_weight: float = 1.0,
        use_cosine_sim: bool = True,
        kmeans_init: bool = True,
        kmeans_iters: int = 10,
        threshold_ema_dead_code: float = 0.0,
        eps: float = 1e-5,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        self.dim = dim
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        # EMA and k-means settings, read by the (not yet ported) training side
        self.decay = decay
        self.commitment_weight = commitment_weight
        self.use_cosine_sim = use_cosine_sim
        self.kmeans_init = kmeans_init
        self.kmeans_iters = kmeans_iters
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.eps = eps
        self.has_projections = dim != codebook_dim
        if self.has_projections:
            self.project_in = Linear(dim, codebook_dim, bias=True, generator=generator)
            self.project_out = Linear(codebook_dim, dim, bias=True, generator=generator)
        init = torch.randn(codebook_size, codebook_dim, generator=generator)
        if use_cosine_sim:
            init = l2norm(init)
        self.register_buffer("codebook", init)
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed_avg", init.clone())
        self.register_buffer("initted", torch.tensor(not kmeans_init))
        self.to(device)

    def get_codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        codes = self.codebook[indices.long()]
        if self.has_projections:
            codes = self.project_out(codes)
        return codes

    def update_from_input(self, x: torch.Tensor, rng=None) -> None:
        raise not_ported("EMA-VQ codebook updates (k-means init, EMA, dead-code revival)", "A10")

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        rng=None,
        update_stats: Optional[bool] = None,
    ) -> QuantizerOutput:
        """x (..., dim) -> (quantized (..., dim), int32 ids (...,), commitment
        loss). `rng` and `update_stats` belong to training."""
        if train or update_stats:
            raise not_ported("EMA-VQ training (k-means init, EMA codebook updates)", "A10")
        lead_shape = x.shape[:-1]
        z = self.project_in(x) if self.has_projections else x
        z_flat = z.reshape(-1, self.codebook_dim).float()
        cb = self.codebook
        if self.use_cosine_sim:
            zeros = torch.zeros(cb.shape[0], device=cb.device)
            indices = nearest_code(l2norm(z_flat), cb, cb_sq=zeros)
        else:
            indices = nearest_code(z_flat, cb)
        quantized_flat = cb[indices.long()]
        aux_loss = self.commitment_weight * ((quantized_flat.detach() - z_flat) ** 2).mean()
        quantized_flat = z_flat + (quantized_flat - z_flat).detach()  # straight-through
        quantized = quantized_flat.reshape(*lead_shape, self.codebook_dim).to(x.dtype)
        if self.has_projections:
            quantized = self.project_out(quantized)
        return quantized, indices.reshape(lead_shape), aux_loss.float()
