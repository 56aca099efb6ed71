"""MaskGit iterative parallel decoding and the Muse base -> super-res
cascade (counterpart of `muse_maskgit_pytorch_tpu/models/maskgit.py`).

`generate` is the port's main path: texts or text embeddings (and, in a
super-res stage, conditioning tokens) -> token grid -> images; `Muse` chains
a base and a super-res stage from prompts to images. Beside it: guidance
ramps and per-row scales held on the device, negative prompts, any (h, w)
resolution, token critics, editing (`edit`, `Muse.edit`) and best-of-K
re-ranking (`score_samples`, `generate_reranked`, `Muse(rerank_candidates=)`).
The JAX package runs the decode as a few `lax.scan` segments inside one
jitted function; here it is a Python loop that never waits on the device.
Everything the loop branches on is computed on the host once per call: the
per-step mask counts and temperatures (bit-equal to the JAX scan's f32
values, `utils.sampling`), the compact segment plan, and one (T,) int32
tensor of per-step sampler seeds drawn from the caller's `torch.Generator`
(or given: `step_seeds`), which the sampler kernel reads from device memory.

Each step attends with K2 through the transformer and samples with K1
(`ops.sampling_kernel.fused_topk_gumbel_sample`, the JAX package's
`sampler="fused"`) or, with `sampler="xla"`, by the exact `top_k` filter in
plain PyTorch on K1's noise stream written out (`philox_gumbel_noise`).

`MaskGit.forward` is the training objective (the JAX `MaskGit.__call__`):
the masked-token cross entropy, plus a token critic's binary cross entropy.
Its random draws are one explicit `TrainDraws` value, made from a
`torch.Generator` or given, so that a test can hand both packages the same
draws.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
import warnings
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models.transformer import MaskGitTransformer, SelfCritic, TokenCritic
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import VQGanVAE, _strip_towers
from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import (
    fused_topk_gumbel_sample,
    philox_gumbel_noise,
    philox_uniform,
)
from muse_maskgit_pytorch_tpu_torch.parallel.batch import row_offset, rows_from
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, exists, resolve_device
from muse_maskgit_pytorch_tpu_torch.utils.images import to_pil_images
from muse_maskgit_pytorch_tpu_torch.utils.metrics import span
from muse_maskgit_pytorch_tpu_torch.utils.sampling import (
    batch_random_mask,
    cosine_schedule,
    first_argmax,
    get_mask_subset_prob,
    gumbel_noise,
    guidance_ramp,
    gumbel_sample,
    mask_by_topk_scores,
    mask_counts,
    schedule_values,
    step_temperatures,
    top_k,
)

SEED_HIGH = 2**31 - 1
# the Philox stream of a token critic's noise (K1's noise is stream 0)
CRITIC_NOISE_STREAM = 1


def step_seeds(generator, timesteps: int, device) -> torch.Tensor:
    """The per-step sampler seeds of one `generate` call: (T,) int32 on
    `device`, drawn from `generator` (a `torch.Generator` on that device;
    seed 0 when None), or `generator` itself where it is already such a
    tensor (`serving.export_pipeline` makes it an input of its program)."""
    if isinstance(generator, torch.Tensor):
        if generator.shape != (timesteps,) or generator.dtype != torch.int32 or generator.device != torch.device(device):
            raise ValueError(
                f"seeds must be a ({timesteps},) int32 tensor on {device}, got {tuple(generator.shape)} "
                f"{generator.dtype} on {generator.device}"
            )
        return generator
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randint(0, SEED_HIGH, (timesteps,), generator=generator, device=device, dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def _compact_segments(noise_schedule, seq_len: int, timesteps: int):
    """Segment plan of the compact decode: ((start, end, bucket), ...).

    Step i masks exactly max(floor(seq * schedule(t_i)), 1) positions (every
    position is refilled each step), so the vocab head and the sampler only
    need a bucket of candidate positions: counts + 1 rounded up to seq / 8,
    equal-bucket runs merged. Step 0 covers the whole sequence. Same plan as
    the JAX package's, which evaluates the schedule eagerly (its step times
    can sit one ulp from the decode loop's; the +1 margin covers that)."""
    ks = mask_counts(noise_schedule, seq_len, timesteps, jitted=False)
    gran = max(1, seq_len // 8)
    buckets = [min(seq_len, -(-(int(k) + 1) // gran) * gran) for k in ks]
    if int(ks[0]) < seq_len:
        buckets[0] = seq_len
    segs = []
    s = 0
    for i in range(1, timesteps + 1):
        if i == timesteps or buckets[i] != buckets[s]:
            segs.append((s, i, buckets[s]))
            s = i
    return tuple(segs)


def _double_ctx_kv(ctx_kv):
    """Duplicate a per-layer K/V cache along batch for a CFG-doubled forward
    (both halves share the context values; only the mask differs)."""
    return [(torch.cat([k, k], dim=0), torch.cat([v, v], dim=0)) for k, v in ctx_kv]


def _hw(size) -> Tuple[int, int]:
    """An int or an (h, w) pair -> (h, w)."""
    return (int(size[0]), int(size[1])) if isinstance(size, (tuple, list)) else (int(size), int(size))


def _frozen_copy(vae: Optional[VQGanVAE], memo: dict) -> Optional[VQGanVAE]:
    """A frozen eval clone of a tokenizer without its discriminator and VGG
    tower, as JAX's `copy_for_eval` makes: the caller's module stays as it
    was. One `memo` for all the clones of a model keeps a VAE that was
    passed twice one object."""
    if vae is None:
        return None
    memo.update({id(t): None for t in (vae.discr, vae._vgg) if t is not None})  # not copied
    clone = copy.deepcopy(vae, memo)
    return _strip_towers(clone).eval().requires_grad_(False)


@functools.lru_cache(maxsize=64)
def _schedule_starts_full(noise_schedule) -> bool:
    """schedule(0) >= 1: step 0 remasks the whole editable region."""
    return float(noise_schedule(np.zeros(1, np.float32))[0]) >= 1.0


def _resize_nearest(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(b, H, W, c) -> (b, h, w, c) by `jax.image.resize(..., "nearest")`,
    which is torch's "nearest-exact" (half-pixel centres)."""
    out = F.interpolate(images.permute(0, 3, 1, 2), size=(h, w), mode="nearest-exact")
    return out.permute(0, 2, 3, 1).contiguous()


@dataclasses.dataclass
class TrainDraws:
    """Every random draw of one `MaskGit.forward` training call: what the
    JAX package draws from `jax.random.split(rng, 8)`, in its order.

    rand_time (b,), mask_scores (b, n), nomask_scores (b, n), keep_u (b, 1),
    self_cond_u (), sample_temperature (), gumbel (b, n, vocab) in the
    logits' dtype (with a critic only), critic_keep_u (b, 1); all U[0, 1)
    but the gumbel noise. `self_cond_u` is read on the host (it decides
    whether the self-conditioning forward runs): keep it on the CPU."""

    rand_time: torch.Tensor
    mask_scores: torch.Tensor
    nomask_scores: torch.Tensor
    keep_u: torch.Tensor
    self_cond_u: torch.Tensor
    sample_temperature: torch.Tensor
    gumbel: Optional[torch.Tensor] = None
    critic_keep_u: Optional[torch.Tensor] = None

    @classmethod
    def draw(
        cls, batch: int, seq_len: int, vocab: int, *, critic: bool, generator: Optional[torch.Generator] = None,
        device="cpu", dtype=torch.float32,
    ) -> "TrainDraws":
        """Draw from the CPU `generator` (the default one when None): the
        small uniforms on the host, copied to `device`; the critic's
        (b, n, vocab) noise on `device`, from a generator seeded by a draw
        of `generator`, so one CPU generator's state fixes every draw."""
        if generator is not None and generator.device.type != "cpu":
            raise ValueError("TrainDraws.draw takes a CPU generator")

        on_card = torch.device(device).type == "cuda"

        def u(*shape):
            t = torch.rand(shape, generator=generator)
            # from pinned memory, so the copy does not wait for the card
            return t.pin_memory().to(device, non_blocking=True) if on_card else t.to(device)

        draws = cls(
            rand_time=u(batch), mask_scores=u(batch, seq_len), nomask_scores=u(batch, seq_len),
            keep_u=u(batch, 1), self_cond_u=torch.rand((), generator=generator),
            sample_temperature=torch.rand((), generator=generator),
        )
        if critic:
            seed = int(torch.randint(0, 2**62, (), generator=generator))
            gen = torch.Generator(device).manual_seed(seed)
            draws.gumbel = gumbel_noise((batch, seq_len, vocab), gen, device, dtype)
            draws.critic_keep_u = u(batch, 1)
        return draws

    def rows(self, start: int, stop: int) -> "TrainDraws":
        """The draws of rows [start, stop) of the batch (a data-parallel
        rank's part of the global batch's draws); the scalars are shared."""
        cut = lambda t: None if t is None else t[start:stop]  # noqa: E731
        return dataclasses.replace(
            self, rand_time=cut(self.rand_time), mask_scores=cut(self.mask_scores),
            nomask_scores=cut(self.nomask_scores), keep_u=cut(self.keep_u), gumbel=cut(self.gumbel),
            critic_keep_u=cut(self.critic_keep_u),
        )


class MaskGit(nn.Module):
    def __init__(
        self,
        image_size: int,
        transformer: MaskGitTransformer,
        noise_schedule: Callable = cosine_schedule,
        token_critic: Optional[TokenCritic] = None,
        self_token_critic: bool = False,
        vae: Optional[VQGanVAE] = None,
        cond_vae: Optional[VQGanVAE] = None,
        cond_image_size: Optional[int] = None,
        cond_drop_prob: float = 0.5,
        self_cond_prob: float = 0.9,
        no_mask_token_prob: float = 0.0,
        critic_loss_weight: float = 1.0,
        device="cuda",
    ):
        """`cond_drop_prob`, `self_cond_prob`, `no_mask_token_prob` and
        `critic_loss_weight` shape the training objective (`forward`);
        `no_mask_token_prob` also tells `generate(can_remask_prev_masked=True)`
        that the model was trained to predict unmasked tokens.

        The tokenizers are stored as frozen eval clones, as the JAX package
        stores `copy_for_eval()` clones: `vae` and `cond_vae` given as one
        object stay one object here; a super-res stage conditions on the
        tokens of `cond_vae` (its own VAE when none is given)."""
        super().__init__()
        device = resolve_device(device)
        if exists(cond_vae) and not exists(cond_image_size):
            raise ValueError("cond_image_size must be specified if conditioning")
        if self_token_critic and exists(token_critic):
            raise ValueError("pass token_critic or self_token_critic, not both")
        memo: dict = {}
        self.vae = _frozen_copy(vae, memo)
        self.has_separate_cond_vae = exists(cond_vae)
        self.cond_vae = _frozen_copy(cond_vae, memo) if exists(cond_vae) else self.vae
        if exists(vae) and not (
            vae.codebook_size == self.cond_vae.codebook_size == transformer.num_tokens
        ):
            raise ValueError("transformer num_tokens must equal the vae codebook size")
        self.image_size = image_size
        self.cond_image_size = cond_image_size
        self.resize_image_for_cond_image = exists(cond_image_size)
        self.cond_drop_prob = cond_drop_prob
        self.transformer = transformer
        self.self_cond = transformer.self_cond
        self.mask_id = transformer.mask_id
        self.noise_schedule = noise_schedule
        self.token_critic = token_critic
        if self_token_critic:
            self.token_critic = SelfCritic(transformer, generator=torch.Generator().manual_seed(0))
        self.critic_loss_weight = critic_loss_weight
        self.self_cond_prob = self_cond_prob
        self.no_mask_token_prob = no_mask_token_prob
        self.to(device)  # the transformer, critic and VAE clones, too

    @property
    def jax_unshared_children(self) -> Tuple[str, ...]:
        """For `utils.from_jax.to_jax_state`: given both `vae` and
        `cond_vae`, the JAX `MaskGit` holds an eval clone of each, where the
        port keeps one object when they were one."""
        return ("vae",) if self.has_separate_cond_vae else ()

    # -- persistence: the JAX package's msgpack file (`utils.checkpoint`) ----

    def save(self, path) -> None:
        """Write the whole model, its VAE clones included, as a file the
        JAX package's `MaskGit.load` reads."""
        from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import save_module

        save_module(self, path)

    def load(self, path) -> List[str]:
        """Load a file of either package's `MaskGit.save` in place; returns
        the leaves that the port has no place for. The file's VAE weights
        land in the model's own frozen clones (the VAE the model was built
        from is left as it was); two stages loaded from files that hold one
        VAE's weights hold equal clones, which `vaes_share_weights` (and so
        `cond_via="auto"`) recognises by value."""
        from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import load_module

        return load_module(self, path)

    # -- training objective (the JAX package's `MaskGit.__call__`) -----------

    def forward(
        self,
        images_or_ids: torch.Tensor,
        ignore_index: int = -1,
        cond_images: Optional[torch.Tensor] = None,
        cond_token_ids: Optional[torch.Tensor] = None,
        texts: Optional[List[str]] = None,
        text_embeds: Optional[torch.Tensor] = None,
        text_mask: Optional[torch.Tensor] = None,
        cond_drop_prob: Optional[float] = None,
        train_only_generator: bool = False,
        sample_temperature: Optional[float] = None,
        attn_impl: str = "auto",
        *,
        generator: Optional[torch.Generator] = None,
        draws: Optional[TrainDraws] = None,
        loss_denominator: Optional[float] = None,
    ) -> torch.Tensor:
        """The training loss (0-d f32): the cross entropy of the masked
        tokens, plus `critic_loss_weight` times the critic's binary cross
        entropy when the model has a critic and `train_only_generator` is
        off. `loss_denominator` divides the cross entropy's sum in place of
        the batch's masked count (`MaskGitTrainer` over a mesh passes each
        rank the global count over the number of ranks).

        `images_or_ids`: float images (b, h, w, c) in [0, 1], tokenised by
        the frozen VAE (sizes divisible by its factor), or ids (b, n) or
        (b, fh, fw); a grid trains under the positions resized to it, a
        flat sequence off the native length must be a square. A super-res
        stage conditions on `cond_images`, on `cond_token_ids`, or on the
        images resized to `cond_image_size`. Text comes as `texts` (the
        frozen T5) or `text_embeds` (+ `text_mask`).

        The draws are `draws`, or drawn by `TrainDraws.draw` from the CPU
        `generator`: the time of each row and its cosine mask count
        `max(round(n * cos(t * pi / 2)), 1)`, the masked positions, the
        `no_mask_token_prob` subset kept unmasked (still labelled), the CFG
        dropout of the text, the self-conditioning coin (the embedding of a
        forward without dropout and without a gradient, with probability
        `self_cond_prob`), and for the critic the sampling temperature, the
        Gumbel noise and its own dropout. `attn_impl` is accepted for the
        JAX signature and ignored: every attention is K2."""
        del attn_impl
        if images_or_ids.dim() not in (2, 3, 4):
            raise ValueError(f"images or ids of rank 2, 3 or 4, got shape {tuple(images_or_ids.shape)}")
        if text_embeds is not None and text_embeds.dim() != 3:
            raise ValueError(f"text_embeds must be (b, n, d), got {tuple(text_embeds.shape)}")
        device = self.transformer.token_emb.weight.device
        images = None
        if images_or_ids.is_floating_point():
            if not exists(self.vae):
                raise ValueError("vqgan vae must be passed in to train from raw images")
            down = self.vae.dim_divisor
            if images_or_ids.shape[1] % down or images_or_ids.shape[2] % down:
                raise ValueError(
                    f"training images must be divisible by the VAE's downsampling factor {down}, "
                    f"got {tuple(images_or_ids.shape[1:3])}"
                )
            images = images_or_ids.to(device)
            with torch.no_grad():
                _, ids, _ = self.vae.encode(images)
        else:
            if self.resize_image_for_cond_image and not (exists(cond_images) or exists(cond_token_ids)):
                raise ValueError("with auto-resize conditioning, pass raw images (or explicit cond images/ids)")
            ids = images_or_ids.to(device)

        if self.resize_image_for_cond_image and not exists(cond_images) and not exists(cond_token_ids):
            cond_images = _resize_nearest(images, self.cond_image_size, self.cond_image_size)

        pos_grid = tuple(ids.shape[1:3]) if ids.dim() == 3 else None
        if ids.dim() == 2 and ids.shape[1] != self.transformer.seq_len and math.isqrt(ids.shape[1]) ** 2 != ids.shape[1]:
            raise ValueError(
                f"flat pre-tokenized ids of length {ids.shape[1]} (non-native, non-square) cannot infer their "
                "token grid: pass 3-D (b, fh, fw) ids so positions resize to the right aspect ratio"
            )
        ids = ids.reshape(ids.shape[0], -1).long()
        batch, seq_len = ids.shape
        cond_drop_prob = default(cond_drop_prob, self.cond_drop_prob)

        if exists(cond_images) and exists(cond_token_ids):
            raise ValueError("pass cond_images or cond_token_ids, not both")
        if exists(cond_images):
            if not (cond_images.shape[1] == cond_images.shape[2] == self.cond_image_size):
                raise ValueError(f"cond_images must be {self.cond_image_size}px square, got {tuple(cond_images.shape)}")
            with torch.no_grad():
                _, cond_token_ids, _ = self.cond_vae.encode(cond_images.to(device))
        if exists(cond_token_ids):
            cond_token_ids = cond_token_ids.to(device).long()

        critic = exists(self.token_critic) and not train_only_generator
        if draws is None:
            draws = TrainDraws.draw(
                batch, seq_len, self.transformer.num_tokens, critic=critic, generator=generator,
                device=device, dtype=self.transformer.dtype,
            )

        # the mask: a cosine count of positions per row, at random positions
        num_token_masked = self._num_masked(draws, seq_len).long()
        mask = batch_random_mask(draws.mask_scores.to(device), num_token_masked)
        labels = torch.where(mask, ids, torch.full_like(ids, ignore_index))
        if self.no_mask_token_prob > 0.0:
            mask = mask & ~get_mask_subset_prob(mask, self.no_mask_token_prob, draws.nomask_scores.to(device))
        x = torch.where(mask, torch.full_like(ids, self.mask_id), ids)

        if exists(texts):
            text_embeds = self.transformer.encode_text(texts)
        if not exists(text_embeds):
            raise ValueError("pass texts or text_embeds")
        text_embeds = text_embeds.to(device).detach()
        text_mask = (text_embeds != 0).any(dim=-1) if text_mask is None else text_mask.to(device)

        self_cond_embed = None
        if self.transformer.self_cond:
            if float(draws.self_cond_u) < self.self_cond_prob:
                with torch.no_grad(), span("muse.self_cond"):
                    _, self_cond_embed = self.transformer(
                        x, text_embeds=text_embeds, text_mask=text_mask, conditioning_token_ids=cond_token_ids,
                        pos_grid=pos_grid, skip_head=True,
                    )
            else:
                self_cond_embed = torch.zeros(batch, seq_len, self.transformer.dim, dtype=self.transformer.dtype, device=device)

        out = self.transformer(
            x, text_embeds=text_embeds, text_mask=text_mask, self_cond_embed=self_cond_embed,
            conditioning_token_ids=cond_token_ids, labels=labels, cond_drop_prob=cond_drop_prob,
            ignore_index=ignore_index, return_logits=critic, keep_u=draws.keep_u, pos_grid=pos_grid,
            loss_denominator=loss_denominator,
        )
        if not critic:
            return out
        ce_loss, logits = out

        temp = default(sample_temperature, draws.sample_temperature)
        with torch.no_grad():
            sampled_ids = gumbel_sample(logits.detach(), temp, noise=draws.gumbel)
        critic_input = torch.where(mask, sampled_ids, x)
        critic_labels = (ids != critic_input).float()
        bce_loss = self.token_critic(
            critic_input, text_embeds=text_embeds, text_mask=text_mask, conditioning_token_ids=cond_token_ids,
            labels=critic_labels, cond_drop_prob=cond_drop_prob, keep_u=draws.critic_keep_u, pos_grid=pos_grid,
        )
        return ce_loss + self.critic_loss_weight * bce_loss

    def _num_masked(self, draws: TrainDraws, seq_len: int) -> torch.Tensor:
        """Each row's masked count, `max(round(n * schedule(t)), 1)` (f32)."""
        device = self.transformer.token_emb.weight.device
        return torch.round(seq_len * self.noise_schedule(draws.rand_time.to(device))).clamp(min=1)

    def train_draws(
        self, shape: Tuple[int, ...], images: bool, *, generator: Optional[torch.Generator] = None,
        train_only_generator: bool = False,
    ) -> TrainDraws:
        """The draws `forward` makes for a batch of this shape (of images,
        or of ids), from the CPU `generator`, in its order."""
        if images:
            h, w = (s // self.vae.dim_divisor for s in shape[1:3])
            seq_len = h * w
        else:
            seq_len = math.prod(shape[1:])
        critic = exists(self.token_critic) and not train_only_generator
        return TrainDraws.draw(
            shape[0], seq_len, self.transformer.num_tokens, critic=critic, generator=generator,
            device=self.transformer.token_emb.weight.device, dtype=self.transformer.dtype,
        )

    def masked_token_count(self, draws: TrainDraws) -> torch.Tensor:
        """The number of masked (labelled) tokens `forward` trains on under
        `draws`: the cross entropy's denominator, on the device (f32)."""
        return self._num_masked(draws, draws.mask_scores.shape[1]).sum()

    def _fmap_hw(self, fmap_size, image_size) -> Tuple[int, int]:
        if image_size is not None:
            if fmap_size is not None:
                raise ValueError("pass image_size or fmap_size, not both")
            if not exists(self.vae):
                raise ValueError("image_size needs the VAE's downsampling factor: pass fmap_size")
            ih, iw = _hw(image_size)
            down = self.vae.dim_divisor
            if ih % down or iw % down:
                raise ValueError(
                    f"image_size {image_size} must be divisible by the VAE's downsampling factor {down}"
                )
            return ih // down, iw // down
        if fmap_size is None:
            if exists(self.vae):
                fmap_size = self.vae.get_encoded_fmap_size(self.image_size)
            else:
                fmap_size = self.transformer.seq_hw
        return _hw(fmap_size)

    @staticmethod
    def _guidance(cond_scale, timesteps: int, b: int, cfg_fold: bool, device) -> Optional[torch.Tensor]:
        """The per-step scales on the device, (T,) or per row (T, b) f32, or
        None for a constant python number. A `(start, end)` ramp is built as
        the jitted JAX decode builds it (`utils.sampling.guidance_ramp`)."""
        if isinstance(cond_scale, (int, float)):
            return None
        if isinstance(cond_scale, tuple):
            return torch.from_numpy(guidance_ramp(float(cond_scale[0]), float(cond_scale[1]), timesteps)).to(device)
        arr = torch.as_tensor(cond_scale, dtype=torch.float32, device=device)
        if arr.dim() > 2:
            raise ValueError("cond_scale must be a scalar, (timesteps,) per step, or (timesteps or 1, batch) per sample")
        if arr.dim() == 2:
            # per-sample guidance: the embedding-fold combine broadcasts a (b,) row
            if not cfg_fold:
                raise ValueError("per-sample cond_scale requires cfg_fold=True")
            if arr.shape[-1] != b:
                raise ValueError(f"per-sample cond_scale has {arr.shape[-1]} columns for a batch of {b}")
            return arr.expand(timesteps, b).contiguous()
        return arr.reshape(-1).expand(timesteps).contiguous()

    @torch.inference_mode()
    def generate(
        self,
        texts=None,
        generator: Optional[Union[torch.Generator, torch.Tensor]] = None,
        *,
        text_embeds: Optional[torch.Tensor] = None,
        text_mask: Optional[torch.Tensor] = None,
        negative_texts=None,
        neg_text_embeds: Optional[torch.Tensor] = None,
        cond_images=None,
        cond_token_ids=None,
        fmap_size: Optional[Union[int, Tuple[int, int]]] = None,
        image_size: Optional[Union[int, Tuple[int, int]]] = None,
        temperature: float = 1.0,
        topk_filter_thres: float = 0.9,
        can_remask_prev_masked: bool = False,
        force_not_use_token_critic: bool = False,
        timesteps: int = 18,
        cond_scale=3.0,
        critic_noise_scale: float = 1.0,
        return_ids: bool = False,
        attn_impl: str = "auto",
        sampler: str = "auto",
        injected_gumbel_noise: Optional[torch.Tensor] = None,
        progress: bool = False,
        compact: Union[bool, str] = "auto",
        known_token_ids=None,
        known_mask=None,
        cfg_fold: bool = True,
        null_fold: bool = True,
    ) -> torch.Tensor:
        """Texts, or text embeddings (b, L, text_embed_dim), -> images
        (b, h, w, 3), or token grids (b, fh, fw) with `return_ids`.

        `texts` are encoded by the transformer's frozen T5 on its device. A
        super-res stage (`cond_image_size` set) also needs `cond_token_ids`
        (b, ...), or `cond_images` (b, h, w, 3) that its `cond_vae` encodes
        to ids; the tokens join every cross-attention's context.

        `generator`: a `torch.Generator` on the embeddings' device; the
        per-step seeds are drawn from it once per call (seed 0 when
        omitted). Or the (T,) int32 seeds themselves (`step_seeds`): they
        are all the randomness of a call. `injected_gumbel_noise` (T, b,
        seq, vocab) replaces the sampler's own noise, for parity runs.

        `sampler`: "fused" is K1 (the top-k threshold by ten rounds of
        bisection, inside the kernel); "xla" is the exact `top_k` filter, a
        first-index argmax of `filtered / max(temp, 1e-10) + gumbel` and the
        chosen token's softmax probability, in plain PyTorch. "auto" is
        "xla" with injected noise, as in the JAX package, and "fused"
        otherwise: the JAX package's vocabulary threshold was measured on a
        TPU, this package measured none, so without injected noise "auto" is
        always K1. Both draw the same noise: Philox4x32-10 keyed on (the
        step's seed, the global row of the (b, positions) logits), on the
        device (`ops.sampling_kernel.philox_gumbel_noise` for "xla"), in the
        logits' dtype for "xla" as the JAX package draws it.

        `cond_scale`: a python number (constant guidance), a `(start, end)`
        ramp over the steps, or a tensor (numpy array): a scalar, (T,) per
        step, or (T or 1, b) per sample (needs `cfg_fold`). Every form but a
        number lives on the device as (T,) or (T, b) f32 and always runs the
        doubled CFG batch; the loop never reads it on the host, and K1 reads
        its step's scale from device memory. All forms agree token for token
        at one value.

        `negative_texts` / `neg_text_embeds`: a negative prompt takes the
        CFG null half's place (`forward_with_neg_prompt`).

        `image_size` or `fmap_size`, an int or (h, w): generate off the
        trained resolution; the positions are resized to the new grid.

        Token critics (`MaskGit(token_critic=...)` or `self_token_critic`)
        score each step's tokens for the next remask, unless
        `force_not_use_token_critic`; `critic_noise_scale` scales the
        uniform noise they add, annealed like the temperature: Philox4x32-10
        keyed on (the step's seed, the global row), on the device
        (`ops.sampling_kernel.philox_uniform`, stream `CRITIC_NOISE_STREAM`).
        `can_remask_prev_masked` lets unmasked tokens be remasked (needs
        `no_mask_token_prob > 0`; compact decode is then off without a
        critic).

        `known_token_ids` + `known_mask` ((b, fh, fw) or (b, seq), True =
        keep): editing. Known positions start from the given tokens and are
        never remasked; each step's budget runs over each row's editable
        count. Needs a schedule with p(0) = 1; compact decode is off.

        `progress` prints one line per step. `attn_impl` is accepted for
        the JAX package's call sites and ignored: the port has one attention.
        `compact`, `cfg_fold`, `null_fold`, `temperature` and
        `topk_filter_thres` behave as in the JAX package; `null_fold` is a
        no-op in a super-res stage and under negative prompts.

        Under `parallel.batch.rows_from(start)` these rows are rows `start
        ...` of a global batch that other processes decode the rest of from
        the same `generator` (data-parallel serving): both samplers and a
        critic's noise key on the global row, so each row samples what it
        would in the whole batch."""
        del attn_impl
        if sampler not in ("auto", "fused", "xla"):
            raise ValueError(f"sampler must be 'auto', 'fused' or 'xla', got {sampler!r}")
        if sampler == "auto":
            sampler = "xla" if injected_gumbel_noise is not None else "fused"
        fh, fw = self._fmap_hw(fmap_size, image_size)
        seq_len = fh * fw
        if isinstance(texts, str):
            texts = [texts]
        if text_embeds is None:
            if texts is None:
                raise ValueError("generate needs texts or text_embeds")
            text_embeds = self.transformer.encode_text(texts)
        device = text_embeds.device
        b = text_embeds.shape[0]
        if text_mask is None:
            text_mask = (text_embeds != 0).any(dim=-1)
        if negative_texts is not None and neg_text_embeds is None:
            if len(negative_texts) != b:
                raise ValueError(f"{len(negative_texts)} negative texts for a batch of {b}")
            neg_text_embeds = self.transformer.encode_text(negative_texts)
        if neg_text_embeds is not None:
            neg_text_embeds = neg_text_embeds.to(device)

        cond_ids = cond_token_ids
        if self.resize_image_for_cond_image and cond_ids is None:
            if cond_images is None:
                raise ValueError(
                    "conditioning image (or cond_token_ids) must be passed in for super res maskgit"
                )
            _, cond_ids, _ = self.cond_vae.encode(cond_images)
        if cond_ids is not None:
            cond_ids = cond_ids.to(device)

        if can_remask_prev_masked and not self.no_mask_token_prob > 0.0:
            raise ValueError(
                "can_remask_prev_masked needs a model trained with no_mask_token_prob > 0: without "
                "training with some non-masked tokens forced to predict, logits for unmasked "
                "positions are not meaningful"
            )
        use_critic = exists(self.token_critic) and not force_not_use_token_critic
        if known_mask is not None:
            if known_token_ids is None:
                raise ValueError("editing needs both known_token_ids and known_mask")
            # step 0 must refill the whole edit region, or mask ids would be left
            if not _schedule_starts_full(self.noise_schedule):
                raise ValueError("editing requires noise_schedule(0) == 1 (full remask at step 0)")
            compact = False  # per-row editable counts are data-dependent
            known_mask = torch.as_tensor(known_mask, device=device).reshape(b, seq_len).bool()
            known_token_ids = torch.as_tensor(known_token_ids, device=device).reshape(b, seq_len).long()
        if compact == "auto":
            # exact unless unmasked positions need real confidences
            # (can_remask without a critic)
            compact = timesteps > 1 and (use_critic or not can_remask_prev_masked)
        elif compact and can_remask_prev_masked and not use_critic:
            warnings.warn(
                "compact=True is incompatible with can_remask_prev_masked without a token critic "
                "(compact pins unmasked positions' confidences); forcing compact=False",
                stacklevel=3,
            )
            compact = False
        step_kb: List[Optional[int]] = [None] * timesteps
        if compact and timesteps > 1:
            for s, e, kb in _compact_segments(self.noise_schedule, seq_len, timesteps):
                step_kb[s:e] = [None if kb >= seq_len else kb] * (e - s)

        seeds = step_seeds(generator, timesteps, device)
        if injected_gumbel_noise is not None:
            injected_gumbel_noise = injected_gumbel_noise.to(device)
        critic_noise_scale = critic_noise_scale if use_critic else 0.0
        first_row = row_offset()

        ids = self._decode(
            text_embeds=text_embeds,
            text_mask=text_mask,
            neg_text_embeds=neg_text_embeds,
            cond_ids=cond_ids,
            grid=(fh, fw),
            seeds=seeds,
            step_kb=step_kb,
            noise=injected_gumbel_noise,
            temperature=temperature,
            cond_scale=cond_scale if isinstance(cond_scale, (int, float)) else None,
            scales=self._guidance(cond_scale, timesteps, b, cfg_fold, device),
            topk_filter_thres=topk_filter_thres,
            cfg_fold=cfg_fold,
            null_fold=null_fold,
            sampler=sampler,
            can_remask=can_remask_prev_masked,
            use_critic=use_critic,
            critic_noise_scale=critic_noise_scale,
            known_ids=known_token_ids if known_mask is not None else None,
            known_mask=known_mask,
            progress=progress,
            row_offset=first_row,
        ).reshape(-1, fh, fw)
        if return_ids or not exists(self.vae):
            return ids
        with span("muse.vae_decode"):
            return self.vae.decode_from_ids(ids)

    def _decode(
        self, *, text_embeds, text_mask, neg_text_embeds, cond_ids, grid, seeds, step_kb, noise,
        temperature, cond_scale, scales, topk_filter_thres, cfg_fold, null_fold, sampler, can_remask,
        use_critic, critic_noise_scale, known_ids, known_mask, progress, row_offset=0,
    ) -> torch.Tensor:
        transformer = self.transformer
        mask_id = self.mask_id
        b = text_embeds.shape[0]
        device = text_embeds.device
        vocab = transformer.dim_out
        timesteps = len(step_kb)
        seq_len = grid[0] * grid[1]
        k = max(math.ceil((1 - topk_filter_thres) * vocab), 1)
        # a scale tensor is a per-step value, so CFG always runs doubled then
        scheduled = scales is not None
        cfg_on = scheduled or cond_scale != 1
        # CFG combine inside the fused sampler; with "xla" the transformer
        # combines the logits itself
        fuse_cfg = sampler == "fused" and cfg_on and not cfg_fold
        counts = mask_counts(self.noise_schedule, seq_len, timesteps)
        fractions = schedule_values(self.noise_schedule, timesteps)
        temps = step_temperatures(temperature, timesteps)
        # the critic noise's annealing factor steps_left / T, as XLA folds it
        anneal = step_temperatures(1.0, timesteps)

        # the context (text, then conditioning tokens) is the same at every
        # step: its K/V are projected once. With a negative prompt the two
        # CFG halves attend different texts, padded to one length, and the
        # cache holds both
        with span("muse.context_kv"):
            neg_text_mask = None
            if neg_text_embeds is not None:
                ctx_kv, (text_embeds, text_mask), (neg_text_embeds, neg_text_mask) = (
                    transformer.precompute_context_kv_neg(
                        text_embeds=text_embeds, neg_text_embeds=neg_text_embeds, text_mask=text_mask,
                        conditioning_token_ids=cond_ids,
                    )
                )
                demask = functools.partial(
                    transformer.forward_with_neg_prompt, neg_text_embeds=neg_text_embeds, neg_text_mask=neg_text_mask
                )
            else:
                demask = transformer.forward_with_cond_scale
                ctx_kv = transformer.precompute_context_kv(
                    text_embeds=text_embeds, conditioning_token_ids=cond_ids
                )
                if cfg_on:
                    ctx_kv = _double_ctx_kv(ctx_kv)

            if use_critic:
                critic = self.token_critic
                # a SelfCritic runs the generator's own trunk: it shares its cache
                if neg_text_embeds is not None:
                    critic_fn = functools.partial(
                        critic.forward_with_neg_prompt, neg_text_embeds=neg_text_embeds, neg_text_mask=neg_text_mask
                    )
                    critic_kv = ctx_kv if isinstance(critic, SelfCritic) else critic.precompute_context_kv_neg(
                        text_embeds=text_embeds, neg_text_embeds=neg_text_embeds, text_mask=text_mask,
                        neg_text_mask=neg_text_mask, conditioning_token_ids=cond_ids,
                    )[0]
                else:
                    critic_fn = critic.forward_with_cond_scale
                    if isinstance(critic, SelfCritic):
                        critic_kv = ctx_kv
                    else:
                        critic_kv = critic.precompute_context_kv(
                            text_embeds=text_embeds, conditioning_token_ids=cond_ids
                        )
                        if cfg_on:
                            critic_kv = _double_ctx_kv(critic_kv)

        if known_mask is not None:
            # editing: known positions hold the source tokens and a score
            # that no remask reaches; budgets run over the editable count
            ids = torch.where(known_mask, known_ids, mask_id)
            scores = torch.where(known_mask, -1e5, 0.0).float()
            n_editable = (~known_mask).sum(dim=-1)
        else:
            ids = torch.full((b, seq_len), mask_id, dtype=torch.long, device=device)
            scores = torch.zeros((b, seq_len), dtype=torch.float32, device=device)
        self_cond = (
            torch.zeros((b, seq_len, transformer.dim), dtype=transformer.dtype, device=device)
            if self.self_cond
            else None
        )

        for i, kb in enumerate(step_kb):
            with span("muse.step"):
                if progress:
                    print(f"maskgit decode step {i + 1}/{timesteps}", flush=True)
                step_scale = scales[i] if scheduled else cond_scale
                count = int(counts[i])
                g = noise[i] if noise is not None else None
                with span("muse.remask"):
                    if kb is None:
                        # full body: remask the least-confident positions
                        budgets = count
                        if known_mask is not None:
                            # min(max(floor(p * n_editable), 1), n_editable) in f32, per row
                            budgets = torch.minimum(
                                torch.floor(n_editable.float() * float(fractions[i])).clamp_(min=1).long(), n_editable
                            )
                        remask = mask_by_topk_scores(scores, budgets)
                        x_in = ids.masked_fill(remask, mask_id)
                        npos, gather_pos = seq_len, None
                    else:
                        # compact body: the head and the sampler see only the kb
                        # highest-score candidates (ties at the lowest index, like
                        # `lax.top_k`); the first `count` of them are remasked
                        cand = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :kb]
                        sel = cand[:, : min(count, kb)]
                        remask = torch.zeros_like(ids, dtype=torch.bool).scatter_(1, sel, True)
                        x_in = ids.masked_fill(remask, mask_id)
                        npos, gather_pos = kb, cand
                        if g is not None:
                            g = torch.take_along_dim(g, cand[..., None], dim=1)

                with span("muse.trunk"):
                    logits, embed = demask(
                        x_in,
                        text_embeds=text_embeds,
                        text_mask=text_mask,
                        conditioning_token_ids=cond_ids,
                        self_cond_embed=self_cond,
                        cond_scale=step_scale,
                        return_embed=True,
                        return_raw_double=fuse_cfg,
                        cfg_fold=cfg_fold,
                        null_fold=null_fold,
                        gather_positions=gather_pos,
                        context_kv=ctx_kv,
                        pos_grid=grid,
                    )
                    if self.self_cond:
                        self_cond = embed.to(self_cond.dtype)

                with span("muse.sample"):
                    if sampler == "fused":
                        rows = (2 * b if fuse_cfg else b) * npos
                        pred, prob = fused_topk_gumbel_sample(
                            logits.reshape(rows, vocab),
                            k,
                            float(temps[i]),
                            seeds[i : i + 1],
                            noise=g.reshape(b * npos, vocab) if g is not None else None,
                            cfg_pair=fuse_cfg,
                            # the kernel reads a scheduled scale from device memory
                            cond_scale=(scales[i : i + 1] if scheduled else cond_scale) if fuse_cfg else 1.0,
                            row_offset=row_offset * npos,
                        )
                        pred = pred.reshape(b, npos).long()
                        prob = prob.reshape(b, npos)
                    else:
                        filtered = top_k(logits, topk_filter_thres)
                        if g is not None:
                            # a tensor, not a python scalar, divides: CUDA would turn
                            # the latter into a multiply by its reciprocal
                            safe_temp = torch.full((), max(float(temps[i]), 1e-10), device=device)
                            pred = first_argmax(filtered.float() / safe_temp + g)
                        else:
                            # K1's stream, keyed as K1 keys it: the flattened (b,
                            # npos) rows from the global row_offset * npos
                            g = philox_gumbel_noise(seeds[i : i + 1], b * npos, vocab, row_offset * npos, logits.dtype)
                            pred = gumbel_sample(filtered, float(temps[i]), noise=g.reshape(b, npos, vocab))
                        # the softmax in the logits' own dtype, as the JAX package takes it
                        prob = torch.softmax(logits, dim=-1).gather(-1, pred[..., None])[..., 0].float()

                with span("muse.scores"):
                    if kb is None:
                        is_mask = x_in == mask_id
                        ids = torch.where(is_mask, pred, x_in)
                    else:
                        n_sel = sel.shape[1]
                        ids = ids.scatter(1, sel, pred[:, :n_sel])

                    if use_critic:
                        # the critic's fake odds of every token of the full grid
                        scores = critic_fn(
                            ids,
                            text_embeds=text_embeds,
                            text_mask=text_mask,
                            conditioning_token_ids=cond_ids,
                            cond_scale=step_scale,
                            cfg_fold=cfg_fold,
                            null_fold=null_fold,
                            context_kv=critic_kv,
                            pos_grid=grid,
                        )[..., 0].float()
                        if critic_noise_scale:
                            u = philox_uniform(
                                seeds[i], b, seq_len, device, row_offset=row_offset, stream=CRITIC_NOISE_STREAM
                            )
                            scores = scores + (u - 0.5) * critic_noise_scale * float(anneal[i])
                    elif kb is None:
                        scores = 1.0 - prob
                        if not can_remask:
                            scores = scores.masked_fill(~is_mask, -1e5)
                    else:
                        scores = torch.full_like(scores, -1e5).scatter_(1, sel, 1.0 - prob[:, :n_sel])
                    if known_mask is not None:
                        # known positions stay out of reach of every scoring path
                        scores = scores.masked_fill(known_mask, -1e5)
        return ids

    # -- best-of-K re-ranked generation ---------------------------------------

    @torch.inference_mode()
    def score_samples(
        self,
        ids: torch.Tensor,
        *,
        text_embeds: torch.Tensor,
        text_mask: Optional[torch.Tensor] = None,
        method: str = "auto",
        attn_impl: str = "auto",
    ) -> torch.Tensor:
        """Per-sample quality score (b,), higher is better, of token grids
        (b, fh, fw) (their grid names the positions) or (b, seq).

        "critic": the mean log P(real) = `logsigmoid(-logit)` under the
        token critic. "logprob": the mean log-likelihood of each token under
        the generator (one forward without guidance), as the picked logit
        minus the f32 logsumexp, with no log-softmax materialised. "auto":
        the critic if there is one. `attn_impl` is ignored (one attention)."""
        del attn_impl
        if method == "auto":
            method = "critic" if exists(self.token_critic) else "logprob"
        b = ids.shape[0]
        pos_grid = tuple(ids.shape[1:3]) if ids.dim() == 3 else None
        x = ids.reshape(b, -1).long()
        if text_mask is None:
            text_mask = (text_embeds != 0).any(dim=-1)
        if method == "critic":
            if not exists(self.token_critic):
                raise ValueError("no token critic to score with")
            crit = self.token_critic(x, text_embeds=text_embeds, text_mask=text_mask, pos_grid=pos_grid)
            return F.logsigmoid(-crit.reshape(b, -1).float()).mean(dim=-1)
        if method != "logprob":
            raise ValueError(f"unknown score method {method!r}")
        logits = self.transformer(x, text_embeds=text_embeds, text_mask=text_mask, pos_grid=pos_grid)
        lse = torch.logsumexp(logits.float(), dim=-1)
        picked = logits.gather(-1, x[..., None])[..., 0].float()
        return (picked - lse).mean(dim=-1)

    @torch.inference_mode()
    def rerank_select(self, ids, text_embeds, text_mask, *, b: int, k: int, method: str, decode: bool):
        """Score all b * k candidates (prompt-major: a prompt's k candidates
        are neighbours), take each prompt's best (the first on a tie) and,
        with `decode`, its clamped images: (winners (b, fh, fw), best scores
        (b,), images or None)."""
        gh, gw = ids.shape[-2], ids.shape[-1]
        scores = self.score_samples(ids, text_embeds=text_embeds, text_mask=text_mask, method=method).reshape(b, k)
        best = first_argmax(scores)
        winners = ids.reshape(b, k, gh, gw)[torch.arange(b, device=ids.device), best]
        best_scores = scores.gather(1, best[:, None])[:, 0]
        images = None
        if decode:
            with span("muse.vae_decode"):
                images = self.vae.decode_from_ids(winners).clamp(0.0, 1.0)
        return winners, best_scores, images

    @torch.inference_mode()
    def generate_reranked(
        self,
        texts=None,
        generator: Optional[torch.Generator] = None,
        *,
        num_candidates: int = 4,
        score_method: str = "auto",
        text_embeds: Optional[torch.Tensor] = None,
        text_mask: Optional[torch.Tensor] = None,
        return_ids: bool = False,
        return_scores: bool = False,
        **generate_kwargs,
    ):
        """Best-of-K sampling: `num_candidates` samples a prompt in one
        batched decode (prompt-major, as `jnp.repeat` tiles), each scored by
        `score_samples`, the best kept (`rerank_select`). Images come
        clamped to [0, 1]; `return_scores` also returns the winners' scores.
        The re-ranker is model-internal (critic or log-likelihood), as in
        the JAX package: CLIP's weights are not in the repository."""
        if num_candidates < 1:
            raise ValueError("num_candidates must be at least 1")
        if isinstance(texts, str):
            texts = [texts]
        if text_embeds is None:
            if texts is None:
                raise ValueError("generate_reranked needs texts or text_embeds")
            text_embeds = self.transformer.encode_text(texts)
        if text_mask is None:
            text_mask = (text_embeds != 0).any(dim=-1)
        if self.resize_image_for_cond_image:
            raise ValueError(
                "generate_reranked targets the base stage (the cascade re-ranks at the base, "
                "then super-reses the winner)"
            )
        for bad in ("known_token_ids", "known_mask", "injected_gumbel_noise"):
            if generate_kwargs.get(bad) is not None:
                raise ValueError(
                    f"{bad} is per-sample and not supported by generate_reranked; "
                    "call generate() and score_samples() directly"
                )
        b, k = text_embeds.shape[0], num_candidates
        te = text_embeds.repeat_interleave(k, dim=0)
        tm = text_mask.repeat_interleave(k, dim=0)
        generate_kwargs = dict(generate_kwargs)
        if generate_kwargs.get("neg_text_embeds") is not None:
            generate_kwargs["neg_text_embeds"] = generate_kwargs["neg_text_embeds"].repeat_interleave(k, dim=0)
        cs = generate_kwargs.get("cond_scale")
        if cs is not None and not isinstance(cs, (int, float, tuple)):
            cs = torch.as_tensor(cs, dtype=torch.float32)
            if cs.dim() == 2:
                # per-sample guidance follows its prompt onto all k candidates
                generate_kwargs["cond_scale"] = cs.repeat_interleave(k, dim=1)
        with rows_from(row_offset() * k):  # each prompt's k candidates are consecutive rows
            ids = self.generate(text_embeds=te, text_mask=tm, generator=generator, return_ids=True, **generate_kwargs)
        method = score_method
        if method == "auto":
            method = "critic" if exists(self.token_critic) else "logprob"
        winners, best_scores, images = self.rerank_select(
            ids, te, tm, b=b, k=k, method=method, decode=not return_ids and exists(self.vae)
        )
        out = winners if (return_ids or not exists(self.vae)) else images
        if return_scores:
            return out, best_scores
        return out

    # -- editing / inpainting --------------------------------------------------

    @torch.inference_mode()
    def edit(
        self,
        images: torch.Tensor,
        edit_mask,
        texts=None,
        generator: Optional[torch.Generator] = None,
        **generate_kwargs,
    ) -> torch.Tensor:
        """Regenerate only the masked region of `images` (b, H, W, 3) in
        [0, 1], conditioned on the text and on the kept source tokens.

        `edit_mask`, True = regenerate: pixel-level (b, H, W), where a token
        is edited if any pixel of its patch is, or token-level (b, fh, fw).
        Any (H, W) that the VAE's factor divides works. A super-res stage
        without `cond_images` conditions on the source scaled down by its
        trained ratio (nearest). Takes every `generate` argument."""
        if not exists(self.vae):
            raise ValueError("editing needs the vae to tokenize the source image")
        if images.dim() != 4:
            raise ValueError(f"edit takes NHWC images, got shape {tuple(images.shape)}")
        H, W = int(images.shape[1]), int(images.shape[2])
        down = self.vae.dim_divisor
        if H % down or W % down:
            raise ValueError(f"source images {H}x{W} must be divisible by the VAE's downsampling factor {down}")
        fh, fw = H // down, W // down
        _, ids, _ = self.vae.encode(images)
        ids = ids.reshape(ids.shape[0], fh, fw)

        edit_mask = torch.as_tensor(edit_mask, device=images.device)
        if edit_mask.dtype != torch.bool:
            edit_mask = edit_mask > 0.5
        if tuple(edit_mask.shape[1:]) == (H, W):
            edit_mask = edit_mask.reshape(edit_mask.shape[0], fh, down, fw, down).any(dim=4).any(dim=2)
        if tuple(edit_mask.shape[1:]) != (fh, fw):
            raise ValueError(
                f"edit_mask must be (b, {H}, {W}) pixel-level or (b, {fh}, {fw}) token-level, "
                f"got {tuple(edit_mask.shape)}"
            )

        if self.resize_image_for_cond_image and "cond_images" not in generate_kwargs:
            # the source scaled down by the model's native ratio, which must
            # be integral, keeps its aspect ratio through the cond stage
            if self.image_size % self.cond_image_size:
                raise ValueError(
                    f"edit()'s auto-resize derives the cond size from the model's image_size/cond_image_size "
                    f"ratio, which must be integral (got {self.image_size}/{self.cond_image_size}); pass "
                    "cond_images explicitly for non-multiple pairs"
                )
            ratio = self.image_size // self.cond_image_size
            if H % ratio or W % ratio:
                raise ValueError(f"source {H}x{W} must be divisible by the cascade's conditioning ratio {ratio}")
            generate_kwargs["cond_images"] = _resize_nearest(images, H // ratio, W // ratio)

        return self.generate(
            texts=texts,
            generator=generator,
            known_token_ids=ids,
            known_mask=~edit_mask,
            fmap_size=(fh, fw),
            **generate_kwargs,
        )


# ---------------------------------------------------------------------------
# Muse cascade
# ---------------------------------------------------------------------------


def vaes_share_weights(a: Optional[VQGanVAE], b: Optional[VQGanVAE]) -> bool:
    """True iff two VAEs carry the SAME weights: the precondition for handing
    one stage's token ids to the other (`Muse(cond_via="ids")`).

    Recognised, in order, by object identity; by every parameter and buffer
    lying in the same storage (modules built around shared tensors); and,
    for VAEs restored separately from one checkpoint, by one comparison of
    the values on the device (shapes and dtypes first, then a single flag
    read by the host)."""
    if a is None or b is None:
        return a is b
    if a is b:
        return True
    ta, tb = list(a.state_dict().values()), list(b.state_dict().values())
    if len(ta) != len(tb):
        return False
    if any(x.shape != y.shape or x.dtype != y.dtype for x, y in zip(ta, tb)):
        return False
    if all(x.data_ptr() == y.data_ptr() for x, y in zip(ta, tb)):
        return True
    return bool(torch.stack([(x == y.to(x.device)).all() for x, y in zip(ta, tb)]).all())


def child_generators(generator: Optional[torch.Generator], device) -> List[torch.Generator]:
    """Two generators on `device`, one for each stage of a cascade, derived from
    the caller's generator as JAX splits a key: by its seed
    (`generator.initial_seed()`, 0 when there is none), not by its state,
    which is left as it was. The child seeds are drawn on the host, so one
    seed gives the same children whether the caller's generator lives on the
    CPU or on the card; two calls with one generator give the same images,
    as two calls with one JAX key do."""
    seed = generator.initial_seed() if generator is not None else 0
    host = torch.Generator().manual_seed(seed)
    seeds = torch.randint(0, SEED_HIGH, (2,), generator=host).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


class Muse(nn.Module):
    """base 256px MaskGit -> super-res 512px MaskGit -> (optionally) PIL."""

    def __init__(self, base: MaskGit, superres: MaskGit, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if not superres.resize_image_for_cond_image:
            raise ValueError("the super-res stage must be built with cond_image_size")
        # an upscaling ratio that is no integer would floor silently where
        # sizes are derived from it
        if superres.image_size % base.image_size != 0:
            raise ValueError(
                f"super-res image_size {superres.image_size} must be an exact "
                f"multiple of the base stage's {base.image_size}"
            )
        self.base_maskgit = base
        self.superres_maskgit = superres
        self.to(device)

    @torch.inference_mode()
    def forward(
        self,
        texts: List[str],
        generator: Optional[torch.Generator] = None,
        cond_scale=3.0,
        temperature: float = 1.0,
        timesteps: int = 18,
        superres_timesteps: Optional[int] = None,
        return_lowres: bool = False,
        return_pil_images: bool = True,
        attn_impl: str = "auto",
        rerank_candidates: int = 1,
        rerank_score: str = "auto",
        image_size: Optional[Union[int, Tuple[int, int]]] = None,
        cond_via: str = "pixels",
    ):
        """Prompts -> clamped super-res images (b, H, W, 3) in [0, 1], as PIL
        images unless `return_pil_images=False`; with `return_lowres` also
        the clamped base-stage images.

        `cond_via`: how the base stage conditions the super-res stage.
        "pixels" (default): decode the base tokens, clamp to [0, 1], and let
        the super-res stage re-encode the image through its cond VAE. "ids":
        hand the base stage's token grid over directly; valid only when the
        super-res stage's cond VAE carries the base stage's weights
        (`vaes_share_weights`), where it skips a decode and an encode and
        hands over exactly the tokens the base stage chose
        (`encode(decode(ids))` is not the identity).

        `rerank_candidates > 1` draws that many base-stage samples a prompt
        and sends the best by `rerank_score` (`MaskGit.score_samples`) on to
        the super-res stage, which then runs once a prompt. `image_size`
        (int or (h, w)) is the base stage's resolution; the super-res stage
        scales it by the cascade's ratio. `attn_impl` is ignored: the port
        has one attention.

        `generator`: see `child_generators`; the base stage gets the first
        child, the super-res stage the second."""
        del attn_impl
        # ValueError, not assert: a wrong-codebook ids hand-off would give
        # garbage images silently
        if cond_via not in ("pixels", "ids"):
            raise ValueError(f"cond_via must be 'pixels' or 'ids', got {cond_via!r}")
        base, superres = self.base_maskgit, self.superres_maskgit
        if cond_via == "ids" and not vaes_share_weights(superres.cond_vae, base.vae):
            raise ValueError(
                "cond_via='ids' requires the cascade stages to share one VAE "
                "(the super-res cond codebook must be the base stage's); "
                "this cascade's differ: use cond_via='pixels'"
            )
        g_base, g_sr = child_generators(generator, base.transformer.token_emb.weight.device)
        sr_size = None
        if image_size is not None:
            image_size = _hw(image_size)
            ratio = superres.image_size // base.image_size
            sr_size = (image_size[0] * ratio, image_size[1] * ratio)

        via_ids = cond_via == "ids"
        kw = dict(cond_scale=cond_scale, temperature=temperature, timesteps=timesteps, image_size=image_size)
        with span("muse.base"):
            if rerank_candidates > 1:
                base_out = base.generate_reranked(
                    texts=texts, generator=g_base, num_candidates=rerank_candidates, score_method=rerank_score,
                    return_ids=via_ids, **kw,
                )
            else:
                base_out = base.generate(texts=texts, generator=g_base, return_ids=via_ids, **kw)
            if via_ids:
                lowres_image = None
                sr_cond = dict(cond_token_ids=base_out)
            else:
                # the decoder's output is clamped before it conditions the next stage
                lowres_image = base_out.clamp(0.0, 1.0)
                sr_cond = dict(cond_images=lowres_image)

        with span("muse.superres"):
            superres_image = superres.generate(
                texts=texts, generator=g_sr, cond_scale=cond_scale, temperature=temperature,
                timesteps=default(superres_timesteps, timesteps), image_size=sr_size, **sr_cond,
            ).clamp(0.0, 1.0)

        if via_ids and return_lowres:
            # decoded only because the caller asked for the images
            with span("muse.vae_decode"):
                lowres_image = base.vae.decode_from_ids(base_out).clamp(0.0, 1.0)

        if return_pil_images:
            superres_image = to_pil_images(superres_image)
            if return_lowres:
                lowres_image = to_pil_images(lowres_image)
        if not return_lowres:
            return superres_image
        return superres_image, lowres_image

    @torch.inference_mode()
    def edit(
        self,
        images: torch.Tensor,
        edit_mask,
        texts: Optional[List[str]] = None,
        generator: Optional[torch.Generator] = None,
        cond_scale=3.0,
        temperature: float = 1.0,
        timesteps: int = 18,
        superres_timesteps: Optional[int] = None,
        return_pil_images: bool = True,
        attn_impl: str = "auto",
        text_embeds: Optional[torch.Tensor] = None,
        text_mask: Optional[torch.Tensor] = None,
        neg_text_embeds: Optional[torch.Tensor] = None,
    ):
        """Cascade editing: edit the region at the base resolution, then the
        same region of the original images with the edited low-res result,
        clamped, as the super-res stage's conditioning pixels (as the JAX
        package does, even when the stages share a VAE).

        `images` (b, H, W, 3) at the super-res resolution, (H, W) divisible
        by the cascade's ratio and both VAEs' factors; `edit_mask` (b, H, W),
        True = regenerate: the base stage's pixel is edited if any pixel it
        covers is. One T5 pass serves both stages when they share an
        encoder; `neg_text_embeds` needs that. `attn_impl` is ignored."""
        del attn_impl
        sr, base = self.superres_maskgit, self.base_maskgit
        g_base, g_sr = child_generators(generator, base.transformer.token_emb.weight.device)
        H, W = int(images.shape[1]), int(images.shape[2])
        ratio = sr.image_size // base.image_size
        if H % ratio or W % ratio:
            raise ValueError(f"source {H}x{W} must be divisible by the cascade ratio {ratio}")
        bh, bw = H // ratio, W // ratio
        edit_mask = torch.as_tensor(edit_mask, device=images.device)
        if edit_mask.dtype != torch.bool:
            edit_mask = edit_mask > 0.5
        if edit_mask.dim() != 3 or tuple(edit_mask.shape[1:]) != (H, W):
            raise ValueError(
                f"edit_mask must match the source images' resolution ({H}, {W}), got {tuple(edit_mask.shape)}"
            )
        lowres_src = _resize_nearest(images, bh, bw)
        lowres_mask = edit_mask.reshape(edit_mask.shape[0], bh, ratio, bw, ratio).any(dim=4).any(dim=2)

        # one T5 pass for both stages when they read the same encoder
        shared_encoder = (
            base.transformer.t5_name == sr.transformer.t5_name
            and base.transformer.text_embed_dim == sr.transformer.text_embed_dim
        )
        sr_text_embeds, sr_text_mask = text_embeds, text_mask
        if text_embeds is None:
            if texts is None:
                raise ValueError("edit needs texts or text_embeds")
            text_embeds = base.transformer.encode_text(texts)
            sr_text_embeds = text_embeds if shared_encoder else sr.transformer.encode_text(texts)
        if text_mask is None:
            text_mask = (text_embeds != 0).any(dim=-1)
        if sr_text_mask is None:
            sr_text_mask = (sr_text_embeds != 0).any(dim=-1)
        if neg_text_embeds is not None and not shared_encoder:
            raise ValueError(
                "neg_text_embeds requires both cascade stages to use the same text encoder; "
                "encode per stage and call MaskGit.edit directly otherwise"
            )

        kw = dict(cond_scale=cond_scale, temperature=temperature, neg_text_embeds=neg_text_embeds)
        lowres_edited = base.edit(
            lowres_src, lowres_mask, generator=g_base, text_embeds=text_embeds, text_mask=text_mask,
            timesteps=timesteps, **kw,
        ).clamp(0.0, 1.0)
        superres_image = sr.edit(
            images, edit_mask, generator=g_sr, text_embeds=sr_text_embeds, text_mask=sr_text_mask,
            cond_images=lowres_edited, timesteps=default(superres_timesteps, timesteps), **kw,
        ).clamp(0.0, 1.0)
        if return_pil_images:
            return to_pil_images(superres_image)
        return superres_image
