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
the values agree with it to the last rounding.

Training: with `train=True` LFQ returns its entropy and commitment losses;
EMA-VQ runs k-means on the first batch (`kmeans_init`), then EMA codebook
updates with Laplace smoothing and dead-code revival. Its codebook buffers
change under `torch.no_grad()`, outside any graph, and its one random draw
a batch, the row indices that JAX takes from `jax.random.randint(key, (K,),
0, n)`, is explicit: a `VQDraws`. JAX feeds one key to the k-means picks and
to the dead-code picks, so one `VQDraws` serves both. The per-code sums are
an index sum with no float atomics (sorted on the GPU), so a repeated update
on the card is bit-identical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Linear
from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code
from muse_maskgit_pytorch_tpu_torch.utils.helpers import resolve_device

QuantizerOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t * torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + eps)


def _entropy(p: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return -(p * torch.log(p + eps)).sum(dim=-1)


@dataclasses.dataclass
class VQDraws:
    """The random draw of one EMA-VQ codebook update: `pick`, (K,) int64
    row indices in [0, n) of the update's n latents, what the JAX package
    draws with `jax.random.randint(key, (K,), 0, n)`. k-means takes its
    first centres at these rows and dead-code revival its new codes, as JAX
    takes both from one key."""

    pick: torch.Tensor

    @classmethod
    def draw(cls, codebook_size: int, n: int, generator: Optional[torch.Generator] = None) -> "VQDraws":
        """From the CPU `generator` (the default one when None)."""
        return cls(torch.randint(0, n, (codebook_size,), generator=generator))


def _code_sums(z: torch.Tensor, codes: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K,) counts and (K, d) sums of the rows of z (n, d) per code: what
    the JAX package's `one_hot(codes).sum(0)` and `one_hot(codes).T @ z`
    give, without the (n, K) one-hot. `index_put_` with `accumulate` adds
    each code's rows in row order, with no float atomics."""
    codes = codes.long()
    counts = torch.bincount(codes, minlength=k).to(z.dtype)
    sums = z.new_zeros(k, z.shape[1])
    sums.index_put_((codes,), z, accumulate=True)
    return counts, sums


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
        self.diversity_gamma = diversity_gamma
        self.entropy_loss_weight = entropy_loss_weight
        self.commitment_loss_weight = commitment_loss_weight
        self.inv_temperature = inv_temperature
        # the largest group size <= entropy_group_bits that divides the code width
        g = min(entropy_group_bits, codebook_dim)
        while codebook_dim % g:
            g -= 1
        self.entropy_group_bits = g
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

    def _entropy_aux_loss(self, z_flat: torch.Tensor) -> torch.Tensor:
        """The mean per-sample entropy less `diversity_gamma` times the
        codebook entropy, over sub-codebooks of `entropy_group_bits` bits
        (the JAX package's factorised form)."""
        g = self.entropy_group_bits
        num_groups = self.codebook_dim // g
        shifts = torch.arange(g - 1, -1, -1, device=z_flat.device)
        combos = ((torch.arange(2**g, device=z_flat.device)[:, None] >> shifts) & 1).to(z_flat.dtype) * 2.0 - 1.0
        xg = z_flat.reshape(-1, num_groups, g)
        # softmax over the sub-codes of -distance, which is 2 x.c up to a constant
        logits = 2.0 * self.inv_temperature * torch.einsum("ngd,kd->ngk", xg, combos)
        probs = torch.softmax(logits, dim=-1)
        per_sample_entropy = _entropy(probs).mean()
        codebook_entropy = _entropy(probs.mean(dim=0)).sum() / num_groups
        return per_sample_entropy - self.diversity_gamma * codebook_entropy

    def forward(self, x: torch.Tensor, train: bool = False) -> QuantizerOutput:
        """x (..., dim) -> (quantized (..., dim), int32 ids (...,), aux loss:
        with `train` the weighted entropy and commitment losses, else 0)."""
        z = self.project_in(x) if self.has_projections else x
        z = z.float()
        codes = torch.where(z > 0, 1.0, -1.0)
        quantized = z + (codes - z).detach()  # straight-through, as in JAX
        indices = self.bits_to_indices(z > 0)
        if train:
            entropy_aux = self._entropy_aux_loss(z.reshape(-1, self.codebook_dim))
            commit = ((z - codes) ** 2).mean()
            aux_loss = self.entropy_loss_weight * entropy_aux + self.commitment_loss_weight * commit
        else:
            aux_loss = torch.zeros((), device=x.device)
        out = quantized.to(x.dtype)
        if self.has_projections:
            out = self.project_out(out)
        return out, indices, aux_loss


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
        self.decay = decay
        self.commitment_weight = commitment_weight
        self.use_cosine_sim = use_cosine_sim
        self.kmeans_init = kmeans_init
        self.kmeans_iters = kmeans_iters
        # codes whose EMA cluster size falls below this are re-seeded from
        # the batch (0 turns revival off)
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

    def _search(self, z_flat: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
        if self.use_cosine_sim:
            return nearest_code(l2norm(z_flat), cb, cb_sq=torch.zeros(cb.shape[0], device=cb.device))
        return nearest_code(z_flat, cb)

    def _draws(self, rng: Union[VQDraws, torch.Generator, None], n: int) -> Optional[VQDraws]:
        """`rng` as a `VQDraws` on the latents' device: given, drawn from a
        CPU generator, or None (no k-means init and no revival, as JAX
        without a key)."""
        if rng is None:
            return None
        draws = rng if isinstance(rng, VQDraws) else VQDraws.draw(self.codebook_size, n, rng)
        if draws.pick.shape != (self.codebook_size,):
            raise ValueError(f"VQDraws.pick must be ({self.codebook_size},), got {tuple(draws.pick.shape)}")
        return VQDraws(draws.pick.to(self.codebook.device, torch.long))

    # -- codebook bootstrap and EMA updates (under no_grad, outside any graph) --

    def _kmeans(self, z: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
        """`kmeans_iters` Lloyd steps from the rows `pick`, each assignment
        a euclidean nearest-code search (K3 on the GPU)."""
        centers = z[pick]
        zq = l2norm(z) if self.use_cosine_sim else z
        for _ in range(self.kmeans_iters):
            cb = l2norm(centers) if self.use_cosine_sim else centers
            counts, sums = _code_sums(z, nearest_code(zq, cb), self.codebook_size)
            new_centers = sums / counts[:, None].clamp(min=1.0)
            centers = torch.where(counts[:, None] > 0, new_centers, centers)
        return l2norm(centers) if self.use_cosine_sim else centers

    def _maybe_init(self, z: torch.Tensor, draws: Optional[VQDraws]) -> None:
        # reads `initted` on the host: k-means runs once, on the first update
        if not self.kmeans_init or draws is None or bool(self.initted):
            return
        centers = self._kmeans(z, draws.pick)
        self.codebook.copy_(centers)
        self.embed_avg.copy_(centers)
        self.cluster_size.fill_(1.0)
        self.initted.fill_(True)

    def _ema_update(self, z: torch.Tensor, indices: torch.Tensor, draws: Optional[VQDraws]) -> None:
        counts, sums = _code_sums(z, indices, self.codebook_size)
        d = self.decay
        self.cluster_size.copy_(d * self.cluster_size + (1 - d) * counts)
        self.embed_avg.copy_(d * self.embed_avg + (1 - d) * sums)
        # Laplace-smoothed cluster sizes
        n = self.cluster_size.sum()
        smoothed = (self.cluster_size + self.eps) / (n + self.codebook_size * self.eps) * n
        embed = self.embed_avg / smoothed[:, None]
        if self.use_cosine_sim:
            embed = l2norm(embed)
        if self.threshold_ema_dead_code > 0 and draws is not None:
            # dead codes are re-seeded from the batch rows `draws.pick`
            dead = self.cluster_size < self.threshold_ema_dead_code
            samples = z[draws.pick]
            if self.use_cosine_sim:
                samples = l2norm(samples)
            embed = torch.where(dead[:, None], samples, embed)
            self.cluster_size.copy_(torch.where(dead, self.threshold_ema_dead_code, self.cluster_size))
            self.embed_avg.copy_(torch.where(dead[:, None], samples * self.threshold_ema_dead_code, self.embed_avg))
        self.codebook.copy_(embed)

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        z = self.project_in(x) if self.has_projections else x
        return z.reshape(-1, self.codebook_dim).float()

    @torch.no_grad()
    def update_from_input(self, x: torch.Tensor, rng: Union[VQDraws, torch.Generator, None] = None) -> None:
        """k-means init (on the first call with draws) and one EMA codebook
        update from the latents x (..., dim). The trainers call it after the
        gradient, having computed the loss with `update_stats=False`. `rng`:
        a `VQDraws`, a CPU generator to draw one from, or None."""
        z_flat = self._flat(x)
        draws = self._draws(rng, z_flat.shape[0])
        self._maybe_init(z_flat, draws)
        self._ema_update(z_flat, self._search(z_flat, self.codebook), draws)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        rng: Union[VQDraws, torch.Generator, None] = None,
        update_stats: Optional[bool] = None,
    ) -> QuantizerOutput:
        """x (..., dim) -> (quantized (..., dim), int32 ids (...,), commitment
        loss). `update_stats` (default: `train`) runs k-means init and the
        EMA update in the call, as JAX does; inside a differentiated loss
        pass False and call `update_from_input` after the gradient."""
        update_stats = train if update_stats is None else update_stats
        lead_shape = x.shape[:-1]
        z_flat = self._flat(x)
        draws = None
        if update_stats:
            draws = self._draws(rng, z_flat.shape[0])
            with torch.no_grad():
                self._maybe_init(z_flat.detach(), draws)
        cb = self.codebook  # the gather below copies it before the update
        indices = self._search(z_flat, cb)
        quantized_flat = cb[indices.long()]
        aux_loss = self.commitment_weight * ((quantized_flat.detach() - z_flat) ** 2).mean()
        if update_stats:
            with torch.no_grad():
                self._ema_update(z_flat.detach(), indices, draws)
        quantized_flat = z_flat + (quantized_flat - z_flat).detach()  # straight-through
        quantized = quantized_flat.reshape(*lead_shape, self.codebook_dim).to(x.dtype)
        if self.has_projections:
            quantized = self.project_out(quantized)
        return quantized, indices.reshape(lead_shape), aux_loss.float()
