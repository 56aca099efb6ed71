"""Lookup-free quantization, decode side (counterpart of `LFQ` in
`muse_maskgit_pytorch_tpu/models/quantizers.py`).

A token id is the MSB-first binary code of the sign bits of a
`codebook_dim = log2(codebook_size)` wide latent; `indices_to_codes` maps
ids back to +-1 codes and, when the latent is wider than the code, through
`project_out`. Quantizing images (`__call__`, the entropy and commitment
losses) belongs to the encode side, which is not ported yet (ROADMAP A4).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Linear
from muse_maskgit_pytorch_tpu_torch.utils.helpers import not_ported


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
    ):
        super().__init__()
        codebook_dim = int(math.log2(codebook_size))
        if 2**codebook_dim != codebook_size:
            raise ValueError("codebook_size must be a power of 2")
        self.dim = dim
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        # loss settings, read by the (not yet ported) quantizing side
        self.diversity_gamma = diversity_gamma
        self.entropy_loss_weight = entropy_loss_weight
        self.commitment_loss_weight = commitment_loss_weight
        self.inv_temperature = inv_temperature
        self.entropy_group_bits = entropy_group_bits
        self.has_projections = dim != codebook_dim
        if self.has_projections:
            self.project_out = Linear(codebook_dim, dim, generator=generator)

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

    def forward(self, x: torch.Tensor):
        raise not_ported("LFQ quantization (VAE encode side)", "A4")
