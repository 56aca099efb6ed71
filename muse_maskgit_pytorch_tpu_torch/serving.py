"""Serving pipeline: fixed-shape batched text -> image generation on the card
(counterpart of `muse_maskgit_pytorch_tpu/serving.py`).

`GeneratePipeline` wraps one `MaskGit` or a `Muse` cascade for a server: it
pads every batch to a fixed `batch_size` and every prompt to `text_len`
tokens, so each request runs the shapes `warmup()` already ran (cuBLAS and
cuDNN pick their algorithms at the first call of a shape), and it serves any
number of prompts by chunking. Guidance scales and negative prompts may
differ from row to row of one batch: the scales travel as a (1, batch) f32
tensor on the card and the negative prompts as per-row embeddings, so
requests with different settings share one decode. Images are quantised to
uint8 on the card before the copy to the host.

Data-parallel serving (`mesh=`, a `parallel.create_mesh()` over a process
group): every rank is handed the same prompts, decodes its rows of each
batch from the same seed stream (K1 keys its noise on the global row, so
the ids are the ones one process decodes), and the images are all-gathered
in rank order, so every rank, rank 0 among them, returns the whole batch.
Edits run whole on every rank. The batch splits over the mesh's `data`
axis, else its first, as in the JAX package; the ranks of a `tensor` axis
that a model is split over (`parallel.tensor.shard_module`) decode the
same rows together.

`export_pipeline` traces the fixed-shape generate program (a `MaskGit` or
a whole `Muse` cascade, through the uint8 quantisation) once with
`torch.export` into an `ExportedPipeline`: a program that `save` writes and
`load_exported_pipeline` reads back without the model classes, its
parameters passed in at each call. K1, K2, K3 and the exact sampler's
noise are PyTorch operators in it (`ops/_library.py`), so the program
launches the kernels on the card.

Not ported: the persistent compile cache (nothing to cache: the kernels are
built once per checkout, `ops/_build.py`).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch.export.passes import move_to_device_pass
from torch.nn.utils.stateless import _reparametrize_module

from muse_maskgit_pytorch_tpu_torch.models._layers import _cudnn_ieee
from muse_maskgit_pytorch_tpu_torch.models.maskgit import (
    SEED_HIGH,
    MaskGit,
    Muse,
    child_generators,
    step_seeds,
    vaes_share_weights,
)
from muse_maskgit_pytorch_tpu_torch.models.t5 import t5_encode_text_with_mask
from muse_maskgit_pytorch_tpu_torch.ops import _build, attention, sampling_kernel, vq  # noqa: F401 (the operators)
from muse_maskgit_pytorch_tpu_torch.parallel.batch import rows_from
from muse_maskgit_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, TENSOR_AXIS, axis_coordinate, mesh_axes
from muse_maskgit_pytorch_tpu_torch.parallel.tensor import all_gather
from muse_maskgit_pytorch_tpu_torch.utils.helpers import resolve_device
from muse_maskgit_pytorch_tpu_torch.utils.metrics import span


def _quantize_u8(imgs: torch.Tensor) -> torch.Tensor:
    """f32 [0, 1] -> uint8 on the images' device, before the host copy (a
    quarter of the f32 bytes): `clamp(x, 0, 1) * 255 + 0.5` truncated, as the
    JAX package quantises."""
    return (imgs.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def backend_compile_count() -> int:
    """Process-wide count of what stands in for an XLA compile in the port:
    nvcc builds and loads of a kernel library (`ops._build.load`). A warmed
    server's count is flat during traffic; `/stats` reports it under the
    JAX package's name."""
    return _build.compile_events()


def _per_row(value, n: int, what: str) -> Optional[np.ndarray]:
    """A scalar or one value per prompt -> (n,) f32, or None."""
    if value is None:
        return None
    arr = np.asarray(value, np.float32)
    arr = np.full((n,), float(arr), np.float32) if arr.ndim == 0 else arr.reshape(-1)
    if arr.shape != (n,):
        raise ValueError(f"{what} must be a scalar or one value per prompt ({n}), got shape {arr.shape}")
    return arr


class GeneratePipeline:
    """Batched, shape-stable sampling service around one MaskGit (or a Muse
    cascade's base + super-res pair), on one device.

    Usage:
        pipe = GeneratePipeline(maskgit, batch_size=16)   # device="cuda"
        pipe.warmup("all")
        images = pipe(["a cat", "a dog", ...])   # any number of prompts

    Returns PIL images (`return_pil=True`, the default; Pillow is imported
    then) or a uint8 (n, H, W, 3) array.

    Each batch samples with its own generator: its seed is drawn from a host
    generator seeded with `seed`, so one seed gives one stream of images, and
    the stream advances from batch to batch. A cascade batch hands its
    generator to `child_generators`, as `Muse` does.

    The pipeline's tensor work (T5, the per-row scales and negative rows,
    the quantisation) runs under `torch.inference_mode`, entered on the
    calling thread, which for a server is the batcher's worker.
    """

    WARMUP_SURFACES = ("generate", "dynamic_scale", "neg_dynamic", "edit", "edit_dynamic_scale")

    def __init__(
        self,
        model: Union[MaskGit, Muse],
        batch_size: int = 16,
        timesteps: int = 18,
        cond_scale: float = 3.0,
        temperature: float = 1.0,
        text_len: int = 64,
        seed: int = 0,
        return_pil: bool = True,
        negative_prompt: Optional[str] = None,
        mesh=None,
        rerank_candidates: int = 1,
        rerank_score: str = "auto",
        image_size=None,
        cond_via: str = "auto",
        device="cuda",
    ):
        device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != device.type or device.index not in (None, model_device.index):
            raise ValueError(f"the model lies on {model_device}, the pipeline was asked to serve on {device}")
        self.device = model_device
        if rerank_candidates < 1:
            raise ValueError(f"rerank_candidates must be at least 1, got {rerank_candidates}")
        self.model = model
        self.is_cascade = isinstance(model, Muse)
        # data-parallel serving: this rank decodes rows [start, stop) of every batch
        self.mesh = mesh
        self._rows, self._data_group = (0, batch_size), None
        if mesh is not None:
            axis = DATA_AXIS if DATA_AXIS in mesh_axes(mesh) else mesh.mesh_dim_names[0]
            index, n = axis_coordinate(mesh, axis)
            if axis == TENSOR_AXIS and any(getattr(m, "tensor_split", None) is not None for m in model.modules()):
                index, n = 0, 1  # the tensor ranks of a model split over them decode the same rows together
            if batch_size % n:
                raise ValueError(f"batch_size {batch_size} must divide over the mesh's {axis!r} axis ({n} ranks)")
            per = batch_size // n
            self._rows = (index * per, (index + 1) * per)
            self._data_group = mesh.get_group(axis) if n > 1 else None
        self.batch_size = batch_size
        self.timesteps = timesteps
        self.cond_scale = cond_scale
        self.temperature = temperature
        self.text_len = text_len
        self.return_pil = return_pil
        self.negative_prompt = negative_prompt
        # best-of-K: each batch decodes batch_size * K candidates and serves
        # the per-prompt winners
        self.rerank_candidates = rerank_candidates
        self.rerank_score = rerank_score
        # a deployment's resolution (int or (h, w)): the base stage generates
        # at it; a cascade's super-res stage scales it by the trained ratio.
        # edit() stays at the models' native sizes
        self._gen_base_size = self._gen_sr_size = None
        if image_size is not None:
            bh, bw = (
                (int(image_size[0]), int(image_size[1]))
                if isinstance(image_size, (tuple, list))
                else (int(image_size), int(image_size))
            )
            self._gen_base_size = (bh, bw)
            if self.is_cascade:
                ratio = model.superres_maskgit.image_size // model.base_maskgit.image_size
                self._gen_sr_size = (bh * ratio, bw * ratio)
        # the cascade's hand-off (Muse's `cond_via`): "ids" skips the decode
        # -> re-encode round trip and hands over exactly the base tokens, but
        # is valid only when the stages share one VAE; "auto" picks it
        # exactly then. ValueError, not assert: a wrong-codebook hand-off
        # would serve garbage silently
        if cond_via not in ("auto", "pixels", "ids"):
            raise ValueError(f"cond_via must be auto/pixels/ids, got {cond_via!r}")
        if not self.is_cascade and cond_via != "auto":
            raise ValueError("cond_via is a cascade inter-stage knob; this pipeline serves a single MaskGit")
        self.cond_via = "pixels"
        if self.is_cascade:
            shared = vaes_share_weights(model.superres_maskgit.cond_vae, model.base_maskgit.vae)
            if cond_via == "ids" and not shared:
                raise ValueError("cond_via='ids' requires the cascade stages to share one VAE; this cascade's differ")
            self.cond_via = ("ids" if shared else "pixels") if cond_via == "auto" else cond_via
        self._seeds = torch.Generator().manual_seed(seed)
        self._neg_cache: Optional[torch.Tensor] = None
        self.stats = {"requests": 0, "images": 0, "batches": 0, "generate_seconds": 0.0}
        # a surface is warm once it has run in this process
        self.warm_surfaces: set = set()

    # -- internals ------------------------------------------------------------

    def _transformer(self):
        m = self.model.base_maskgit if self.is_cascade else self.model
        return m.transformer

    @property
    def image_size(self) -> int:
        """The models' native pixel size (the super-res stage's for a
        cascade): what edit() expects sources and masks to measure. With a
        deployment `image_size`, generated images come out at `output_size`."""
        m = self.model.superres_maskgit if self.is_cascade else self.model
        return m.image_size

    @property
    def output_size(self) -> tuple:
        """(h, w) of the images __call__ returns."""
        if self.is_cascade and self._gen_sr_size is not None:
            return self._gen_sr_size
        if not self.is_cascade and self._gen_base_size is not None:
            return self._gen_base_size
        return (self.image_size, self.image_size)

    def _encode_prompts(self, prompts: Sequence[str]):
        """T5 embeddings and mask of exactly `text_len` tokens (longer prompts
        are cut), so every batch has one shape."""
        with span("muse.t5"):
            return t5_encode_text_with_mask(
                list(prompts), name=self._transformer().t5_name, max_length=self.text_len,
                pad_to_multiple=self.text_len, device=self.device,
            )

    def _next_generator(self) -> torch.Generator:
        """The next batch's generator on the device, from the seed stream."""
        seed = int(torch.randint(0, SEED_HIGH, (1,), generator=self._seeds))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _neg_embeds(self) -> Optional[torch.Tensor]:
        """The pipeline's negative prompt, encoded once."""
        if self.negative_prompt is None:
            return None
        if self._neg_cache is None:
            self._neg_cache = self._encode_prompts([self.negative_prompt] * self.batch_size)[0]
        return self._neg_cache

    def _encode_neg_rows(self, negs: Sequence[Optional[str]]) -> torch.Tensor:
        """Per-row negative prompts -> one (batch, text_len, dim) tensor.

        A `None` row takes the pipeline's `negative_prompt`; a row with no
        negative at all gets all-zero embeddings, from which the model
        derives an all-False negative mask: that row's negative half attends
        only the null key, which is exactly the CFG null. So a batch that
        mixes rows with and without a negative prompt is one decode, and its
        no-negative rows equal plain guidance."""
        effective = [n if n is not None else self.negative_prompt for n in negs]
        embeds, _ = self._encode_prompts([n if n is not None else "" for n in effective])
        # "" still encodes an end token, which would read as an empty prompt
        has_neg = torch.tensor([n is not None for n in effective], dtype=embeds.dtype, device=self.device)
        return embeds * has_neg[:, None, None]

    def _scale_vector(self, scales: Sequence[float]) -> torch.Tensor:
        """Per-row guidance as a (1, batch) f32 tensor on the device: the
        decode reads it there, never on the host."""
        return torch.tensor(np.asarray(scales, np.float32)[None, :], device=self.device)

    def _base_generate(self, base: MaskGit, embeds, mask, generator, cond_scale=None, neg_embeds=None, return_ids=False):
        """The base stage's generate, re-ranked when the pipeline asks."""
        common = dict(
            neg_text_embeds=neg_embeds,
            timesteps=self.timesteps,
            cond_scale=self.cond_scale if cond_scale is None else cond_scale,
            temperature=self.temperature,
            image_size=self._gen_base_size,
            return_ids=return_ids,
        )
        if self.rerank_candidates > 1:
            return base.generate_reranked(
                text_embeds=embeds, text_mask=mask, generator=generator, num_candidates=self.rerank_candidates,
                score_method=self.rerank_score, **common,
            )
        return base.generate(text_embeds=embeds, text_mask=mask, generator=generator, **common)

    def _generate_batch(self, embeds, mask, cond_scale=None, neg_embeds=None) -> torch.Tensor:
        generator = self._next_generator()
        neg_embeds = self._neg_embeds() if neg_embeds is None else neg_embeds
        start, stop = self._rows
        if self._data_group is not None:
            # this rank's rows (and their columns of a per-row scale)
            embeds, mask = embeds[start:stop], mask[start:stop]
            neg_embeds = None if neg_embeds is None else neg_embeds[start:stop]
            cond_scale = None if cond_scale is None else cond_scale[:, start:stop]
        with rows_from(start):  # K1 keys each row's noise on its global row
            if not self.is_cascade:
                return self._gather_rows(self._base_generate(self.model, embeds, mask, generator, cond_scale, neg_embeds))
            g_base, g_sr = child_generators(generator, self.device)
            via_ids = self.cond_via == "ids"
            with span("muse.base"):
                low = self._base_generate(
                    self.model.base_maskgit, embeds, mask, g_base, cond_scale, neg_embeds, return_ids=via_ids
                )
                sr_cond = dict(cond_token_ids=low) if via_ids else dict(cond_images=low.clamp(0.0, 1.0))
            with span("muse.superres"):
                images = self.model.superres_maskgit.generate(
                    text_embeds=embeds, text_mask=mask, generator=g_sr, **sr_cond,
                    neg_text_embeds=neg_embeds,
                    timesteps=self.timesteps,
                    cond_scale=self.cond_scale if cond_scale is None else cond_scale,
                    temperature=self.temperature,
                    image_size=self._gen_sr_size,
                )
            return self._gather_rows(images)

    def _gather_rows(self, images: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a batch, in rank order (the rows as they
        are without a mesh)."""
        if self._data_group is None:
            return images
        return torch.cat(all_gather(images, self._data_group))

    def _edit_batch(self, images, masks, embeds, tmask, generator, cond_scale=None) -> torch.Tensor:
        # the pipeline's negative prompt applies to edits too, as to __call__
        common = dict(
            generator=generator, text_embeds=embeds, text_mask=tmask,
            cond_scale=self.cond_scale if cond_scale is None else cond_scale,
            temperature=self.temperature, timesteps=self.timesteps, neg_text_embeds=self._neg_embeds(),
        )
        if self.is_cascade:
            return self.model.edit(images, masks, return_pil_images=False, **common)
        return self.model.edit(images, masks, **common)

    def _to_host(self, imgs: torch.Tensor) -> np.ndarray:
        """Quantise on the device, then copy the uint8 images to the host."""
        with span("muse.to_host"):
            return _quantize_u8(imgs).cpu().numpy()

    def _output(self, images: np.ndarray):
        if self.return_pil:
            from PIL import Image

            return [Image.fromarray(im) for im in images]
        return images

    # -- public ----------------------------------------------------------------

    def warmup(self, surfaces: Union[str, Sequence[str]] = ("generate",)) -> float:
        """Run each serving surface once at the pipeline's shapes, at boot;
        returns the seconds in all (each surface's in
        `stats["warmup_seconds"]`, the surfaces in `warm_surfaces`).

        `surfaces`: "all" or some of "generate" (default guidance; covers
        re-ranking), "dynamic_scale" (per-request guidance,
        `__call__(..., cond_scale=...)`), "neg_dynamic" (per-request negative
        prompts: per-row negative embeddings and scales), "edit" and
        "edit_dynamic_scale" (`edit`, without and with a per-request scale).
        A surface not warmed pays its first-call costs (kernel builds,
        cuBLAS / cuDNN algorithm choice) in its first live request."""
        if surfaces == "all":
            surfaces = self.WARMUP_SURFACES
        if isinstance(surfaces, str):
            surfaces = (surfaces,)
        for s in surfaces:
            if s not in self.WARMUP_SURFACES:
                raise ValueError(f"unknown warmup surface {s!r} (choose from {self.WARMUP_SURFACES})")
        per_surface = self.stats.setdefault("warmup_seconds", {})
        b = self.batch_size
        t_start = time.perf_counter()
        with torch.inference_mode():
            for s in surfaces:
                t0 = time.perf_counter()
                embeds, mask = self._encode_prompts([""] * b)
                scale = None if s in ("generate", "edit") else self._scale_vector([self.cond_scale] * b)
                if s.startswith("edit"):
                    size = self.image_size
                    # an all-False mask: nothing to regenerate, but every
                    # shape and step of a live edit
                    img = torch.zeros((b, size, size, 3), device=self.device)
                    no_edit = torch.zeros((b, size, size), dtype=torch.bool, device=self.device)
                    out = self._edit_batch(img, no_edit, embeds, mask, self._next_generator(), scale)
                else:
                    # _encode_neg_rows([None] * b) is the all-zero null rows
                    negs = self._encode_neg_rows([None] * b) if s == "neg_dynamic" else None
                    out = self._generate_batch(embeds, mask, scale, negs)
                self._to_host(out)
                per_surface[s] = time.perf_counter() - t0
                self.warm_surfaces.add(s)
        return time.perf_counter() - t_start

    def __call__(self, prompts: Union[str, List[str]], cond_scale=None, negative_prompts=None):
        """`cond_scale`: a guidance override, a scalar for the call or one
        value per prompt; it runs as a per-row scale tensor, so requests with
        different scales share a batch. None: the pipeline's scale.

        `negative_prompts`: one string for the call, or one entry per prompt
        whose `None` means no negative for that row (the pipeline's
        `negative_prompt`, else the CFG null; `_encode_neg_rows`). A batch
        with any negative prompt runs with per-row negative embeddings and
        per-row scales, one more T5 pass a batch."""
        with span("muse.request"):
            if isinstance(prompts, str):
                prompts = [prompts]
            n = len(prompts)
            scales = _per_row(cond_scale, n, "cond_scale")
            negs = None
            if negative_prompts is not None:
                negs = [negative_prompts] * n if isinstance(negative_prompts, str) else list(negative_prompts)
                if len(negs) != n:
                    raise ValueError(
                        f"negative_prompts must be a string or one entry (str or None) per prompt ({n}), "
                        f"got {len(negs)}"
                    )
                if all(e is None for e in negs):
                    negs = None  # nothing to do: the default program
            self.stats["requests"] += 1

            outputs = []
            b = self.batch_size
            with torch.inference_mode():
                for start in range(0, n, b):
                    chunk = list(prompts[start : start + b])
                    pad = b - len(chunk)
                    chunk_scale = chunk_negs = None
                    if scales is not None or negs is not None:
                        # per-request negatives always ride the per-row scales
                        sc = list(scales[start : start + b]) if scales is not None else [self.cond_scale] * len(chunk)
                        chunk_scale = self._scale_vector(sc + [self.cond_scale] * pad)
                    if negs is not None:
                        chunk_negs = self._encode_neg_rows(list(negs[start : start + b]) + [None] * pad)
                    embeds, mask = self._encode_prompts(chunk + [""] * pad)
                    t0 = time.perf_counter()
                    imgs = self._to_host(self._generate_batch(embeds, mask, chunk_scale, chunk_negs))
                    self.stats["generate_seconds"] += time.perf_counter() - t0
                    self.stats["batches"] += 1
                    surface = "generate" if chunk_scale is None else "dynamic_scale"
                    self.warm_surfaces.add("neg_dynamic" if chunk_negs is not None else surface)
                    outputs.append(imgs[: len(chunk)])
            self.stats["images"] += n
            return self._output(np.concatenate(outputs, axis=0))

    def edit(self, images, edit_masks, prompts: Union[str, List[str]], cond_scale=None):
        """Batched editing: regenerate the masked region of each image under
        its prompt (`MaskGit.edit` / `Muse.edit` at the pipeline's shapes).
        `images`: (n, H, W, 3) float in [0, 1] or uint8, at the models'
        (cascade: super-res) image size; `edit_masks`: (n, H, W) pixel-level
        or, for a single MaskGit, (n, f, f) token-level, True = regenerate.
        Chunked and padded like __call__; a padding row has an all-False mask,
        so it passes through untouched, and is dropped. `cond_scale` as in
        __call__. Returns uint8 images (or PIL with `return_pil`)."""
        with span("muse.request"):
            if isinstance(prompts, str):
                prompts = [prompts]
            images = np.asarray(images)
            if images.dtype == np.uint8:
                images = images.astype(np.float32) / 255.0
            images = images.astype(np.float32, copy=False)
            edit_masks = np.asarray(edit_masks)
            if edit_masks.dtype != np.bool_:
                edit_masks = edit_masks > 0.5
            n = len(prompts)
            if not images.shape[0] == edit_masks.shape[0] == n:
                raise ValueError(
                    f"prompts ({n}), images ({images.shape[0]}) and masks ({edit_masks.shape[0]}) must align"
                )
            scales = _per_row(cond_scale, n, "cond_scale")
            self.stats["requests"] += 1

            outputs = []
            b = self.batch_size
            with torch.inference_mode():
                for start in range(0, n, b):
                    chunk = list(prompts[start : start + b])
                    pad = b - len(chunk)
                    img = torch.zeros((b, *images.shape[1:]), device=self.device)
                    img[: len(chunk)] = torch.from_numpy(images[start : start + b]).to(self.device)
                    mask = torch.zeros((b, *edit_masks.shape[1:]), dtype=torch.bool, device=self.device)
                    mask[: len(chunk)] = torch.from_numpy(edit_masks[start : start + b]).to(self.device)
                    chunk_scale = None
                    if scales is not None:
                        chunk_scale = self._scale_vector(list(scales[start : start + b]) + [self.cond_scale] * pad)
                    embeds, tmask = self._encode_prompts(chunk + [""] * pad)
                    t0 = time.perf_counter()
                    out = self._to_host(self._edit_batch(img, mask, embeds, tmask, self._next_generator(), chunk_scale))
                    self.stats["generate_seconds"] += time.perf_counter() - t0
                    self.stats["batches"] += 1
                    self.warm_surfaces.add("edit" if chunk_scale is None else "edit_dynamic_scale")
                    outputs.append(out[: len(chunk)])
            self.stats["images"] += n
            return self._output(np.concatenate(outputs, axis=0))

    @property
    def images_per_second(self) -> Optional[float]:
        if self.stats["generate_seconds"] == 0:
            return None
        return self.stats["images"] / self.stats["generate_seconds"]


# ---------------------------------------------------------------------------
# AOT export: a deployable generate program (torch.export)
# ---------------------------------------------------------------------------


class ExportedPipeline:
    """A saved, ahead-of-time-exported generate program.

    `export_pipeline` traces the whole fixed-shape sampling program (a base
    `MaskGit` or a `Muse` cascade: the decode loop, the samplers, the VAE
    decode and the uint8 quantisation on the device) once with
    `torch.export` into an `ExportedProgram`. A serving host needs only
    PyTorch, this package's operators (`ops/_library.py`: K1, K2, K3 and
    the exact sampler's noise, built at their first use), the saved
    program and the parameters: no tracing and no model classes.

    The parameters travel outside the program, as the flat list of the
    model's `state_dict()` values in order: the program holds none of them.

    Call as `exported(state, text_embeds, text_mask, key)`: `state` is the
    state dict of a model built like the exported one (or its values as a
    list); `key` a `torch.Generator` or an int seed, turned into the
    per-step seeds on the host as `generate` draws them (a cascade first
    splits it with `child_generators`), so the program's images equal eager
    `generate`'s bit for bit. Returns uint8 (batch, H, W, 3) on the
    program's device.
    """

    def __init__(self, program: torch.export.ExportedProgram, meta: dict):
        self.program = program
        self.meta = dict(meta)
        self._module = None

    @property
    def device(self) -> torch.device:
        return torch.device(self.meta["platforms"][0])

    def _seeds(self, key) -> torch.Tensor:
        """The program's seeds input from `key`: (T,) int32, or (2, T) for
        a cascade, on the program's device."""
        timesteps, device = self.meta["timesteps"], self.device
        if not isinstance(key, torch.Generator):
            key = torch.Generator(device=device).manual_seed(int(key))
        if self.meta["kind"] == "muse":
            return torch.stack([step_seeds(g, timesteps, device) for g in child_generators(key, device)])
        return step_seeds(key, timesteps, key.device).to(device)

    def __call__(self, state, text_embeds, text_mask, key, cond_images=None, cond_scale=None):
        leaves = tuple(state.values()) if isinstance(state, Mapping) else tuple(state)
        n_expected = self.meta["n_state_leaves"]
        if len(leaves) != n_expected:
            raise ValueError(
                f"state has {len(leaves)} leaves, the exported program expects {n_expected}: was the model built "
                "with the same architecture as at export time?"
            )
        device = self.device
        leaves = tuple(t.to(device) for t in leaves)
        args = [
            leaves,
            torch.as_tensor(text_embeds, dtype=torch.float32, device=device),
            torch.as_tensor(text_mask, dtype=torch.bool, device=device),
            self._seeds(key),
        ]
        if self.meta["dynamic_cond_scale"]:
            # a scalar broadcasts, a (batch,) vector gives each row its own
            # scale, None is the default recorded at export time
            scale = self.meta["cond_scale"] if cond_scale is None else cond_scale
            scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
            args.append(scale.broadcast_to((self.meta["batch_size"],)).contiguous())
        elif cond_scale is not None:
            raise ValueError(
                "this artifact bakes a static cond_scale; re-export with dynamic_cond_scale=True for per-call guidance"
            )
        if self.meta["needs_cond_images"]:
            if cond_images is None:
                raise ValueError(
                    "this artifact was exported from a conditioned (super-res) MaskGit: pass "
                    "cond_images=(batch, H, W, 3)"
                )
            args.append(torch.as_tensor(cond_images, dtype=torch.float32, device=device))
        elif cond_images is not None:
            raise ValueError("cond_images passed but the exported program takes none")
        if self._module is None:
            self._module = self.program.module()
        # the graph keeps each convolution but not `conv_ieee`'s scope: f32
        # convolutions run in IEEE f32 whatever the caller's cuDNN TF32 flag
        with torch.inference_mode(), _cudnn_ieee():
            return self._module(*args)

    def save(self, path) -> str:
        """Write `<path>/program.pt2` (`torch.export.save`) and
        `<path>/meta.json`."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        torch.export.save(self.program, path / "program.pt2")
        (path / "meta.json").write_text(json.dumps(self.meta, indent=2))
        return str(path)

    @classmethod
    def load(cls, path) -> "ExportedPipeline":
        path = Path(path)
        program = torch.export.load(path / "program.pt2")
        return cls(program, json.loads((path / "meta.json").read_text()))


def _drop_no_ops(program: torch.export.ExportedProgram) -> None:
    """Remove what eager code does not run: the metadata asserts that
    export puts beside each `.to`, and the casts to the dtype a tensor
    already has (eager `.to` returns the tensor itself there). At the main
    path's width (b32 T18) it takes the graph from 21705 nodes to 15669
    and, on an H100, the program's save, load and request times down with
    them (`chip_smoke.py --phases env,build,export_no_ops`)."""
    graph = program.graph
    aten = torch.ops.aten
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target == aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif node.target == aten.to.dtype and len(node.args) == 2 and not node.kwargs:
            src = node.args[0]
            same = src.meta["val"].dtype == node.meta["val"].dtype
            if same and all(user.op != "output" for user in node.users):
                node.replace_all_uses_with(src)
                graph.erase_node(node)
    program.graph_module.recompile()


def _state_slots(model: torch.nn.Module) -> dict:
    """{state_dict name: its index} with one name per parameter or buffer
    slot: a module held under two names (a MaskGit's `vae` and `cond_vae`
    when they are one VAE) is swapped once, so it is restored once."""
    seen, names = set(), {}
    for i, name in enumerate(model.state_dict()):
        prefix, _, attr = name.rpartition(".")
        slot = (id(model.get_submodule(prefix)), attr)
        if slot not in seen:
            seen.add(slot)
            names[name] = i
    return names


class _Program(torch.nn.Module):
    """The traced root: holds no module, so the model's tensors reach the
    trace only as the leaves input."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def forward(self, *args):
        return self.run(*args)


def export_pipeline(
    model: Union[MaskGit, Muse],
    *,
    batch_size: int = 16,
    text_len: int = 64,
    timesteps: int = 18,
    cond_scale: float = 3.0,
    temperature: float = 1.0,
    sampler: str = "auto",
    platforms: Optional[Sequence[str]] = None,
    dynamic_cond_scale: bool = False,
    cond_via: str = "auto",
) -> ExportedPipeline:
    """AOT-export the fixed-shape generate program (see `ExportedPipeline`).

    The program's inputs are the state leaves, text embeddings (batch,
    text_len, D) f32, their mask (batch, text_len) bool and the seeds (T,)
    int32 ((2, T) for a `Muse`); then, with `dynamic_cond_scale`, a
    (batch,) f32 guidance scale per row (`cond_scale` only names the
    default recorded in meta), and for a standalone super-res `MaskGit`
    the (batch, s, s, 3) f32 conditioning images. It is traced where the
    model lies (`torch.export.export`, non-strict) and moved to
    `platforms` (one of "cuda", "cpu"; default: the model's device) with
    `torch.export.passes.move_to_device_pass`: the kernels are operators
    that the dispatcher routes by device when the program runs, so a
    program traced on the CPU and moved to the card launches them there.

    `cond_via` ("auto", "pixels" or "ids") is a cascade's hand-off between
    its stages, resolved here as `GeneratePipeline(cond_via=)` resolves it.
    `sampler` is `generate`'s: "auto" (K1, as no noise is injected here),
    "fused" (K1) or "xla", the exact sampler, whose noise is the operator
    `muse_torch::philox_gumbel` reading its step's seed from the seeds
    input, so that program too makes no host read and equals eager code.
    """
    if sampler not in ("auto", "fused", "xla"):
        raise ValueError(f"sampler must be 'auto', 'fused' or 'xla', got {sampler!r}")
    if cond_via not in ("auto", "pixels", "ids"):
        raise ValueError(f"cond_via must be auto/pixels/ids, got {cond_via!r}")
    is_cascade = isinstance(model, Muse)
    if not is_cascade and cond_via != "auto":
        raise ValueError("cond_via is a cascade inter-stage knob; this export is a single MaskGit")
    via_ids = False
    if is_cascade:
        base, superres = model.base_maskgit, model.superres_maskgit
        shared = vaes_share_weights(superres.cond_vae, base.vae)
        if cond_via == "ids" and not shared:
            raise ValueError("cond_via='ids' requires a shared cascade VAE")
        via_ids = shared if cond_via == "auto" else cond_via == "ids"
    standalone_cond = not is_cascade and model.resize_image_for_cond_image
    device = next(model.parameters()).device
    platforms = list(platforms) if platforms else [device.type]
    if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
        raise ValueError(f"platforms must name one of 'cuda', 'cpu', got {platforms!r}")

    state = model.state_dict()
    slots = _state_slots(model)
    gen_kw = dict(timesteps=timesteps, temperature=temperature, sampler=sampler)

    def run(leaves, text_embeds, text_mask, seeds, *rest):
        rest = list(rest)
        scale = rest.pop(0)[None, :] if dynamic_cond_scale else cond_scale
        common = dict(text_embeds=text_embeds, text_mask=text_mask, cond_scale=scale, **gen_kw)
        with _reparametrize_module(model, {name: leaves[i] for name, i in slots.items()}):
            if is_cascade:
                low = base.generate(generator=seeds[0], return_ids=via_ids, **common)
                sr_cond = dict(cond_token_ids=low) if via_ids else dict(cond_images=low.clamp(0.0, 1.0))
                images = superres.generate(generator=seeds[1], **sr_cond, **common)
            else:
                images = model.generate(generator=seeds, cond_images=rest[0] if standalone_cond else None, **common)
        return _quantize_u8(images)

    tr = (base if is_cascade else model).transformer
    ctx_dim = tr.text_embed_dim
    example = [
        tuple(t.detach() for t in state.values()),
        torch.zeros(batch_size, text_len, ctx_dim, device=device),
        torch.ones(batch_size, text_len, dtype=torch.bool, device=device),
        torch.zeros((2, timesteps) if is_cascade else (timesteps,), dtype=torch.int32, device=device),
    ]
    if dynamic_cond_scale:
        example.append(torch.full((batch_size,), float(cond_scale), device=device))
    if standalone_cond:
        s = model.cond_image_size
        example.append(torch.zeros(batch_size, s, s, 3, device=device))
    with torch.no_grad():
        program = torch.export.export(_Program(run), tuple(example), strict=False)
    held = [s.target for s in program.graph_signature.input_specs if s.kind.name in ("PARAMETER", "BUFFER")]
    storages = {t.untyped_storage().data_ptr() for t in state.values()}
    held += [k for k, t in program.constants.items() if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() in storages]
    if held:
        raise RuntimeError(f"the exported program holds model tensors: {held[:5]}")
    program.example_inputs = None  # they hold the parameters: keep them out of the artifact
    _drop_no_ops(program)
    if platforms[0] != device.type:
        program = move_to_device_pass(program, platforms[0])
    meta = {
        "kind": "muse" if is_cascade else "maskgit",
        "batch_size": batch_size,
        "text_len": text_len,
        "text_embed_dim": int(ctx_dim),
        "timesteps": timesteps,
        "cond_scale": cond_scale,
        "temperature": temperature,
        "sampler": sampler,
        "n_state_leaves": len(state),
        "needs_cond_images": bool(standalone_cond),
        "dynamic_cond_scale": bool(dynamic_cond_scale),
        "cond_via": ("ids" if via_ids else "pixels") if is_cascade else None,
        "platforms": platforms,
        "image_size": int((model.superres_maskgit if is_cascade else model).image_size),
    }
    return ExportedPipeline(program, meta)


def load_exported_pipeline(path) -> ExportedPipeline:
    """Load an artifact written by `ExportedPipeline.save`. It needs the
    `muse_torch` operators, which this module's imports register, and none
    of the model classes."""
    return ExportedPipeline.load(path)
