"""MaskGit iterative parallel decoding, base stage (counterpart of
`muse_maskgit_pytorch_tpu/models/maskgit.py`).

`generate` is the port's main path: text embeddings -> token grid -> images.
The JAX package runs the decode as a few `lax.scan` segments inside one
jitted function; here it is a Python loop that never waits on the device.
Everything the loop branches on is computed on the host once per call: the
per-step mask counts and temperatures (bit-equal to the JAX scan's f32
values, `utils.sampling`), the compact segment plan, and one (T,) int32
tensor of per-step sampler seeds drawn from the caller's `torch.Generator`,
which the sampler kernel reads from device memory.

Each step samples with K1 (`ops.sampling_kernel.fused_topk_gumbel_sample`,
the JAX package's `sampler="fused"` semantics) and attends with K2 through
the transformer.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models.transformer import MaskGitTransformer
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import VQGanVAE
from muse_maskgit_pytorch_tpu_torch.ops.sampling_kernel import fused_topk_gumbel_sample
from muse_maskgit_pytorch_tpu_torch.utils.helpers import exists, not_ported, resolve_device
from muse_maskgit_pytorch_tpu_torch.utils.sampling import (
    cosine_schedule,
    mask_by_topk_scores,
    mask_counts,
    step_temperatures,
)

SEED_HIGH = 2**31 - 1


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


class MaskGit(nn.Module):
    def __init__(
        self,
        image_size: int,
        transformer: MaskGitTransformer,
        noise_schedule: Callable = cosine_schedule,
        token_critic=None,
        self_token_critic: bool = False,
        vae: Optional[VQGanVAE] = None,
        cond_vae: Optional[VQGanVAE] = None,
        cond_image_size: Optional[int] = None,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        if exists(token_critic) or self_token_critic:
            raise not_ported("token critics", "A8")
        if exists(cond_vae) or exists(cond_image_size):
            raise not_ported("the super-res stage (cond_vae, cond_image_size)", "A7")
        if exists(vae):
            if vae.codebook_size != transformer.num_tokens:
                raise ValueError("transformer num_tokens must equal the vae codebook size")
            vae.eval().requires_grad_(False)
        self.vae = vae
        self.image_size = image_size
        self.transformer = transformer
        self.self_cond = transformer.self_cond
        self.mask_id = transformer.mask_id
        self.noise_schedule = noise_schedule
        self.to(device)  # the transformer and VAE it was given, too

    def _fmap_hw(self, fmap_size, image_size) -> Tuple[int, int]:
        if image_size is not None:
            if fmap_size is not None:
                raise ValueError("pass image_size or fmap_size, not both")
            hw = image_size if isinstance(image_size, (tuple, list)) else (image_size,) * 2
            fmap_size = tuple(int(s) // self.vae.dim_divisor for s in hw)
        if fmap_size is None:
            if exists(self.vae):
                fmap_size = self.vae.get_encoded_fmap_size(self.image_size)
            else:
                fmap_size = self.transformer.seq_hw
        hw = tuple(fmap_size) if isinstance(fmap_size, (tuple, list)) else (fmap_size,) * 2
        hw = (int(hw[0]), int(hw[1]))
        if hw != self.transformer.seq_hw:
            raise not_ported("variable-resolution and rectangular generation", "A8")
        return hw

    @torch.inference_mode()
    def generate(
        self,
        texts=None,
        generator: Optional[torch.Generator] = None,
        *,
        text_embeds: Optional[torch.Tensor] = None,
        text_mask: Optional[torch.Tensor] = None,
        negative_texts=None,
        neg_text_embeds=None,
        cond_images=None,
        cond_token_ids=None,
        fmap_size: Optional[Union[int, Tuple[int, int]]] = None,
        image_size: Optional[Union[int, Tuple[int, int]]] = None,
        temperature: float = 1.0,
        topk_filter_thres: float = 0.9,
        timesteps: int = 18,
        cond_scale: float = 3.0,
        return_ids: bool = False,
        injected_gumbel_noise: Optional[torch.Tensor] = None,
        compact: Union[bool, str] = "auto",
        known_token_ids=None,
        known_mask=None,
        cfg_fold: bool = True,
        null_fold: bool = True,
    ) -> torch.Tensor:
        """Text embeddings (b, L, text_embed_dim) -> images (b, h, w, 3), or
        token grids (b, fh, fw) with `return_ids`.

        `generator`: a `torch.Generator` on the embeddings' device; the
        per-step sampler seeds are drawn from it once per call (seed 0 when
        omitted). `injected_gumbel_noise` (T, b, seq, vocab) replaces the
        sampler's own noise, for parity runs. `compact`, `cfg_fold`,
        `null_fold`, `temperature` and `topk_filter_thres` behave as in the
        JAX package."""
        if texts is not None:
            raise not_ported("texts (T5 text encoding)", "A6")
        if negative_texts is not None or neg_text_embeds is not None:
            raise not_ported("negative prompts", "A8")
        if cond_images is not None or cond_token_ids is not None:
            raise not_ported("conditioning images and tokens (super-res stage)", "A7")
        if known_token_ids is not None or known_mask is not None:
            raise not_ported("editing (known_token_ids / known_mask)", "A8")
        if not isinstance(cond_scale, (int, float)):
            raise not_ported("scheduled, traced or per-sample cond_scale", "A8")
        if text_embeds is None:
            raise ValueError("generate needs text_embeds")
        fh, fw = self._fmap_hw(fmap_size, image_size)
        seq_len = fh * fw
        device = text_embeds.device
        if text_mask is None:
            text_mask = (text_embeds != 0).any(dim=-1)

        if compact == "auto":
            compact = timesteps > 1
        step_kb: List[Optional[int]] = [None] * timesteps
        if compact and timesteps > 1:
            for s, e, kb in _compact_segments(self.noise_schedule, seq_len, timesteps):
                step_kb[s:e] = [None if kb >= seq_len else kb] * (e - s)

        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        seeds = torch.randint(
            0, SEED_HIGH, (timesteps,), generator=generator, device=device, dtype=torch.int32
        )
        counts = mask_counts(self.noise_schedule, seq_len, timesteps)
        temps = step_temperatures(temperature, timesteps)
        if injected_gumbel_noise is not None:
            injected_gumbel_noise = injected_gumbel_noise.to(device)

        ids = self._decode(
            text_embeds, text_mask, seq_len, seeds, counts, temps, step_kb,
            injected_gumbel_noise, float(cond_scale), topk_filter_thres, cfg_fold, null_fold,
        ).reshape(-1, fh, fw)
        if return_ids or not exists(self.vae):
            return ids
        return self.vae.decode_from_ids(ids)

    def _decode(
        self, text_embeds, text_mask, seq_len, seeds, counts, temps, step_kb,
        noise, cond_scale, topk_filter_thres, cfg_fold, null_fold,
    ) -> torch.Tensor:
        transformer = self.transformer
        mask_id = self.mask_id
        b = text_embeds.shape[0]
        device = text_embeds.device
        vocab = transformer.dim_out
        k = max(math.ceil((1 - topk_filter_thres) * vocab), 1)
        cfg_on = cond_scale != 1
        fuse_cfg = cfg_on and not cfg_fold  # CFG combine inside the sampler

        ctx_kv = transformer.precompute_context_kv(text_embeds=text_embeds)
        if cfg_on:
            ctx_kv = _double_ctx_kv(ctx_kv)

        ids = torch.full((b, seq_len), mask_id, dtype=torch.long, device=device)
        scores = torch.zeros((b, seq_len), dtype=torch.float32, device=device)
        self_cond = (
            torch.zeros((b, seq_len, transformer.dim), dtype=transformer.dtype, device=device)
            if self.self_cond
            else None
        )

        for i, kb in enumerate(step_kb):
            count = int(counts[i])
            g = noise[i] if noise is not None else None
            if kb is None:
                # full body: remask the least-confident positions
                remask = mask_by_topk_scores(scores, count)
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

            logits, embed = transformer.forward_with_cond_scale(
                x_in,
                text_embeds=text_embeds,
                text_mask=text_mask,
                self_cond_embed=self_cond,
                cond_scale=cond_scale,
                return_embed=True,
                return_raw_double=fuse_cfg,
                cfg_fold=cfg_fold,
                null_fold=null_fold,
                gather_positions=gather_pos,
                context_kv=ctx_kv,
            )
            if self.self_cond:
                self_cond = embed.to(self_cond.dtype)

            rows = (2 * b if fuse_cfg else b) * npos
            pred, prob = fused_topk_gumbel_sample(
                logits.reshape(rows, vocab),
                k,
                float(temps[i]),
                seeds[i : i + 1],
                noise=g.reshape(b * npos, vocab) if g is not None else None,
                cfg_pair=fuse_cfg,
                cond_scale=cond_scale if fuse_cfg else 1.0,
            )
            pred = pred.reshape(b, npos).long()
            prob = prob.reshape(b, npos)

            if kb is None:
                is_mask = x_in == mask_id
                ids = torch.where(is_mask, pred, x_in)
                scores = (1.0 - prob).masked_fill(~is_mask, -1e5)
            else:
                n_sel = sel.shape[1]
                ids = ids.scatter(1, sel, pred[:, :n_sel])
                scores = torch.full_like(scores, -1e5).scatter_(1, sel, 1.0 - prob[:, :n_sel])
        return ids
