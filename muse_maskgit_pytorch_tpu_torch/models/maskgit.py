"""MaskGit iterative parallel decoding and the Muse base -> super-res
cascade (counterpart of `muse_maskgit_pytorch_tpu/models/maskgit.py`).

`generate` is the port's main path: texts or text embeddings (and, in a
super-res stage, conditioning tokens) -> token grid -> images; `Muse` chains
a base and a super-res stage from prompts to images.
The JAX package runs the decode as a few `lax.scan` segments inside one
jitted function; here it is a Python loop that never waits on the device.
Everything the loop branches on is computed on the host once per call: the
per-step mask counts and temperatures (bit-equal to the JAX scan's f32
values, `utils.sampling`), the compact segment plan, and one (T,) int32
tensor of per-step sampler seeds drawn from the caller's `torch.Generator`,
which the sampler kernel reads from device memory.

Each step attends with K2 through the transformer and samples with K1
(`ops.sampling_kernel.fused_topk_gumbel_sample`, the JAX package's
`sampler="fused"`) or, with `sampler="xla"`, by the exact `top_k` filter in
plain PyTorch.
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
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, exists, not_ported, resolve_device
from muse_maskgit_pytorch_tpu_torch.utils.images import to_pil_images
from muse_maskgit_pytorch_tpu_torch.utils.sampling import (
    cosine_schedule,
    first_argmax,
    gumbel_sample,
    mask_by_topk_scores,
    mask_counts,
    step_temperatures,
    top_k,
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
        if exists(cond_vae) and not exists(cond_image_size):
            raise ValueError("cond_image_size must be specified if conditioning")
        # the tokenizers are frozen; a super-res stage conditions on the
        # tokens of `cond_vae` (its own VAE when none is given)
        for v in (vae, cond_vae):
            if exists(v):
                v.eval().requires_grad_(False)
        self.vae = vae
        self.has_separate_cond_vae = exists(cond_vae)
        self.cond_vae = cond_vae if exists(cond_vae) else vae
        if exists(vae) and not (
            vae.codebook_size == self.cond_vae.codebook_size == transformer.num_tokens
        ):
            raise ValueError("transformer num_tokens must equal the vae codebook size")
        self.image_size = image_size
        self.cond_image_size = cond_image_size
        self.resize_image_for_cond_image = exists(cond_image_size)
        self.transformer = transformer
        self.self_cond = transformer.self_cond
        self.mask_id = transformer.mask_id
        self.noise_schedule = noise_schedule
        self.to(device)  # the transformer and VAEs it was given, too

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
        sampler: str = "auto",
        injected_gumbel_noise: Optional[torch.Tensor] = None,
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
        omitted). `injected_gumbel_noise` (T, b, seq, vocab) replaces the
        sampler's own noise, for parity runs.

        `sampler`: "fused" is K1 (the top-k threshold by ten rounds of
        bisection, inside the kernel); "xla" is the exact `top_k` filter, a
        first-index argmax of `filtered / max(temp, 1e-10) + gumbel` and the
        chosen token's softmax probability, in plain PyTorch. "auto" is
        "xla" with injected noise, as in the JAX package, and "fused"
        otherwise: the JAX package's vocabulary threshold was measured on a
        TPU, this package measured none, so without injected noise "auto" is
        always K1. "xla" draws each step's noise from a generator seeded
        with that step's seed.

        `compact`, `cfg_fold`, `null_fold`, `temperature` and
        `topk_filter_thres` behave as in the JAX package; `null_fold` is a
        no-op in a super-res stage."""
        if negative_texts is not None or neg_text_embeds is not None:
            raise not_ported("negative prompts", "A8")
        if known_token_ids is not None or known_mask is not None:
            raise not_ported("editing (known_token_ids / known_mask)", "A8")
        if not isinstance(cond_scale, (int, float)):
            raise not_ported("scheduled, traced or per-sample cond_scale", "A8")
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
        if text_mask is None:
            text_mask = (text_embeds != 0).any(dim=-1)

        cond_ids = cond_token_ids
        if self.resize_image_for_cond_image and cond_ids is None:
            if cond_images is None:
                raise ValueError(
                    "conditioning image (or cond_token_ids) must be passed in for super res maskgit"
                )
            _, cond_ids, _ = self.cond_vae.encode(cond_images)
        if cond_ids is not None:
            cond_ids = cond_ids.to(device)

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
            text_embeds, text_mask, cond_ids, seq_len, seeds, counts, temps, step_kb,
            injected_gumbel_noise, float(cond_scale), topk_filter_thres, cfg_fold, null_fold, sampler,
        ).reshape(-1, fh, fw)
        if return_ids or not exists(self.vae):
            return ids
        return self.vae.decode_from_ids(ids)

    def _decode(
        self, text_embeds, text_mask, cond_ids, seq_len, seeds, counts, temps, step_kb,
        noise, cond_scale, topk_filter_thres, cfg_fold, null_fold, sampler,
    ) -> torch.Tensor:
        transformer = self.transformer
        mask_id = self.mask_id
        b = text_embeds.shape[0]
        device = text_embeds.device
        vocab = transformer.dim_out
        k = max(math.ceil((1 - topk_filter_thres) * vocab), 1)
        cfg_on = cond_scale != 1
        # CFG combine inside the fused sampler; with "xla" the transformer
        # combines the logits itself
        fuse_cfg = sampler == "fused" and cfg_on and not cfg_fold
        step_seeds = None
        if sampler == "xla" and noise is None:
            step_seeds = seeds.tolist()  # the one host read of this path, before the loop

        # the context (text, then conditioning tokens) is the same at every
        # step: its K/V are projected once
        ctx_kv = transformer.precompute_context_kv(
            text_embeds=text_embeds, conditioning_token_ids=cond_ids
        )
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
                conditioning_token_ids=cond_ids,
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

            if sampler == "fused":
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
            else:
                filtered = top_k(logits, topk_filter_thres)
                if g is not None:
                    # a tensor, not a python scalar, divides: CUDA would turn
                    # the latter into a multiply by its reciprocal
                    safe_temp = torch.full((), max(float(temps[i]), 1e-10), device=device)
                    pred = first_argmax(filtered.float() / safe_temp + g)
                else:
                    gen = torch.Generator(device=device).manual_seed(step_seeds[i])
                    pred = gumbel_sample(filtered, float(temps[i]), gen)
                # the softmax in the logits' own dtype, as the JAX package takes it
                prob = torch.softmax(logits, dim=-1).gather(-1, pred[..., None])[..., 0].float()

            if kb is None:
                is_mask = x_in == mask_id
                ids = torch.where(is_mask, pred, x_in)
                scores = (1.0 - prob).masked_fill(~is_mask, -1e5)
            else:
                n_sel = sel.shape[1]
                ids = ids.scatter(1, sel, pred[:, :n_sel])
                scores = torch.full_like(scores, -1e5).scatter_(1, sel, 1.0 - prob[:, :n_sel])
        return ids


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
        cond_scale: float = 3.0,
        temperature: float = 1.0,
        timesteps: int = 18,
        superres_timesteps: Optional[int] = None,
        return_lowres: bool = False,
        return_pil_images: bool = True,
        rerank_candidates: int = 1,
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

        `generator`: see `child_generators`; the base stage gets the first
        child, the super-res stage the second."""
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
        if rerank_candidates > 1:
            raise not_ported("re-ranked base-stage candidates (rerank_candidates > 1)", "A8")
        if image_size is not None:
            raise not_ported("variable-resolution cascades (image_size)", "A8")
        g_base, g_sr = child_generators(generator, base.transformer.token_emb.weight.device)

        via_ids = cond_via == "ids"
        base_out = base.generate(
            texts=texts, generator=g_base, cond_scale=cond_scale, temperature=temperature,
            timesteps=timesteps, return_ids=via_ids,
        )
        if via_ids:
            lowres_image = None
            sr_cond = dict(cond_token_ids=base_out)
        else:
            # the decoder's output is clamped before it conditions the next stage
            lowres_image = base_out.clamp(0.0, 1.0)
            sr_cond = dict(cond_images=lowres_image)

        superres_image = superres.generate(
            texts=texts, generator=g_sr, cond_scale=cond_scale, temperature=temperature,
            timesteps=default(superres_timesteps, timesteps), **sr_cond,
        ).clamp(0.0, 1.0)

        if via_ids and return_lowres:
            # decoded only because the caller asked for the images
            lowres_image = base.vae.decode_from_ids(base_out).clamp(0.0, 1.0)

        if return_pil_images:
            superres_image = to_pil_images(superres_image)
            if return_lowres:
                lowres_image = to_pil_images(lowres_image)
        if not return_lowres:
            return superres_image
        return superres_image, lowres_image
