"""`VQGanVAETrainer` and `MaskGitTrainer` (counterparts of the trainers of
`muse_maskgit_pytorch_tpu/training/trainers.py`).

`VQGanVAETrainer` trains a `VQGanVAE` as a GAN in the JAX step's order: for
each micro-batch the generator loss and its gradient (EMA-VQ's codebook
held still), then EMA-VQ's codebook update from that micro-batch on the
pre-step weights; one generator update; the discriminator's loss and
update on the updated generator and codebook, with the R1 penalty every
`apply_grad_penalty_every` steps; the EMA of the generator. Each phase
differentiates only its own parameters (`torch.autograd.grad` with explicit
inputs), so neither leaves gradients on the other and the frozen VGG takes
none. Its draws (EMA-VQ's k-means and revival rows) come from a CPU
generator whose state is checkpointed.

`MaskGitTrainer`: the masked-token loss of
`MaskGit.forward` (plus the critic's), Adam or AdamW with an optional
global-norm clip and a warmup / cosine schedule, gradient accumulation, an
EMA of the weights, train-state checkpoints with exact resume, periodic
samples, and training from native token shards.

The JAX trainer runs a step as one jitted program; here a step is eager
PyTorch on the model's device: each micro-batch's forward and backward
(every attention through K2 and its gradient), the update with
`torch._foreach_*`, and one host read at the end for the logs. Its random
draws come from one CPU `torch.Generator` (seeded by `seed`), whose state
is part of the checkpoint, so a resumed run draws what a straight run draws.
The frozen VAE and T5 are not trained. Data and FSDP parallelism over a
mesh wait for ROADMAP A11.
"""

from __future__ import annotations

import copy
from pathlib import Path
from shutil import rmtree
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from muse_maskgit_pytorch_tpu_torch.models.maskgit import MaskGit, TrainDraws
from muse_maskgit_pytorch_tpu_torch.models.quantizers import VectorQuantizeEMA
from muse_maskgit_pytorch_tpu_torch.models.t5 import t5_encode_text_with_mask
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import VQGanVAE
from muse_maskgit_pytorch_tpu_torch.training.data import (
    DataLoader,
    ImageDataset,
    cycle,
    make_grid,
    prefetch_iterator,
    save_image,
    split_dataset,
)
from muse_maskgit_pytorch_tpu_torch.training.ema import ema_init, ema_update
from muse_maskgit_pytorch_tpu_torch.training.optim import Adam, global_norm, lr_schedule
from muse_maskgit_pytorch_tpu_torch.training.preemption import PreemptionGuard
from muse_maskgit_pytorch_tpu_torch.training.shard_loader import ShardLoader, read_shard_header
from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import (
    latest_step,
    load_train_state,
    save_train_state,
    wait_for_saves,
)
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, exists, not_ported
from muse_maskgit_pytorch_tpu_torch.utils.metrics import MetricsLogger, StepTimer

FROZEN_CHILDREN = ("vae", "cond_vae")


def _pad_text(tes: List, tms: List) -> None:
    """Right-pad each micro-batch's text to the longest, in place."""
    length = max(te.shape[1] for te in tes)
    for i, (te, tm) in enumerate(zip(tes, tms)):
        pad = length - te.shape[1]
        if pad:
            tes[i] = torch.nn.functional.pad(torch.as_tensor(te), (0, 0, 0, pad))
            tms[i] = torch.nn.functional.pad(torch.as_tensor(tm), (0, pad), value=False)


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not reach."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


class VQGanVAETrainer:
    """GAN trainer of a `VQGanVAE` with the JAX trainer's arguments. It
    trains `vae` in place; `vae_module(use_ema=True)` gives a copy with the
    EMA weights. `dataset` (anything with `__len__` and `__getitem__` giving
    (h, w, c) float images) replaces the image folder `folder`."""

    def __init__(
        self,
        vae: VQGanVAE,
        *,
        folder,
        num_train_steps: int,
        batch_size: int,
        image_size,
        lr: float = 3e-4,
        warmup_steps: int = 0,
        lr_decay_steps: Optional[int] = None,
        grad_accum_every: int = 1,
        max_grad_norm: Optional[float] = None,
        discr_max_grad_norm: Optional[float] = None,
        save_results_every: int = 100,
        save_model_every: int = 1000,
        results_folder: str = "./results",
        valid_frac: float = 0.05,
        random_split_seed: int = 42,
        use_ema: bool = True,
        ema_beta: float = 0.995,
        ema_update_after_step: int = 0,
        ema_update_every: int = 1,
        apply_grad_penalty_every: int = 4,
        mesh=None,
        shard_state: bool = False,
        shard_state_rules=None,
        seed: int = 0,
        clear_previous_results: Optional[bool] = None,
        dataset=None,
        metrics_file=None,
        auto_resume: bool = False,
        async_checkpoints: bool = False,
        max_checkpoints: Optional[int] = None,
        random_flip: bool = True,
    ):
        if mesh is not None or shard_state or shard_state_rules is not None:
            raise not_ported("VQGanVAETrainer over a mesh (mesh=, shard_state=)", "A11")
        self.vae = vae
        self.num_train_steps = num_train_steps
        self.batch_size = batch_size
        self.image_size = image_size
        self.grad_accum_every = grad_accum_every
        self.apply_grad_penalty_every = apply_grad_penalty_every
        self.save_results_every = save_results_every
        self.save_model_every = save_model_every
        self.async_checkpoints = async_checkpoints
        self.max_checkpoints = max_checkpoints
        self.use_ema = use_ema
        self.ema_kwargs = dict(beta=ema_beta, update_after_step=ema_update_after_step, update_every=ema_update_every)
        self.device = vae.enc_dec.final_conv.weight.device
        self.has_discr = vae.discr is not None
        if self.has_discr:
            vae.vgg  # builds the lazy tower now: its weights are part of the train state, as in JAX

        # discriminator / generator parameters; the VGG tower is frozen
        named = [(n, p) for n, p in vae.named_parameters() if not n.startswith("_vgg.")]
        self.gen_names = [n for n, _ in named if not n.startswith("discr.")]
        self.discr_names = [n for n, _ in named if n.startswith("discr.")]
        params = dict(named)
        self.gen_params = [params[n].requires_grad_(True) for n in self.gen_names]
        self.discr_params = [params[n].requires_grad_(True) for n in self.discr_names]

        self._lr_sched = lr_schedule(lr, warmup_steps, lr_decay_steps)
        self.gen_opt = Adam(self.gen_params, self._lr_sched, max_grad_norm=max_grad_norm)
        self.discr_opt = Adam(self.discr_params, self._lr_sched, max_grad_norm=discr_max_grad_norm)
        self.ema = ema_init(self.gen_params) if use_ema else None
        self._step = 0
        self.generator = torch.Generator().manual_seed(seed)

        ds = default(dataset, lambda: ImageDataset(folder, image_size, random_flip=random_flip))
        self.ds, self.valid_ds = split_dataset(ds, valid_frac, random_split_seed)
        self.print(
            f"training with dataset of {len(self.ds)} samples and validating with randomly splitted "
            f"{len(self.valid_ds)} samples"
        )
        self.dl_iter = cycle(DataLoader(self.ds, batch_size, shuffle=True, seed=seed))
        self.valid_dl_iter = cycle(DataLoader(self.valid_ds, batch_size, shuffle=True, seed=seed))

        self.results_folder = Path(results_folder)
        if clear_previous_results and self.results_folder.exists() and any(self.results_folder.iterdir()):
            rmtree(self.results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.metrics = MetricsLogger(default(metrics_file, self.results_folder / "metrics.jsonl"))
        self.timer = StepTimer()

        # drain a save in flight before listing the steps
        if auto_resume:
            wait_for_saves()
            if latest_step(self.results_folder / "checkpoints") is not None:
                self.load()
                self.print(f"auto-resumed from step {self.steps}")

    @property
    def steps(self) -> int:
        return self._step

    def print(self, msg):
        print(msg)

    # -- state ------------------------------------------------------------------

    def vae_module(self, use_ema: bool = False) -> VQGanVAE:
        """The live VAE, or (`use_ema` with EMA on) a copy of it holding the
        EMA generator weights with the live codebook, discriminator and
        VGG (the latter two shared, not copied)."""
        if not (use_ema and self.use_ema):
            return self.vae
        memo = {id(t): t for t in (self.vae.discr, self.vae._vgg) if t is not None}
        model = copy.deepcopy(self.vae, memo)
        live = dict(model.named_parameters())
        with torch.no_grad():
            for name, e in zip(self.gen_names, self.ema):
                live[name].copy_(e)
        return model

    def _state(self) -> dict:
        return dict(
            gen_params=dict(zip(self.gen_names, self.gen_params)),
            discr_params=dict(zip(self.discr_names, self.discr_params)),
            buffers=dict(self.vae.named_buffers()),
            vgg=self.vae.vgg.state_dict() if self.has_discr else None,
            gen_opt=self.gen_opt.state_dict(self.gen_names),
            discr_opt=self.discr_opt.state_dict(self.discr_names),
            ema=dict(zip(self.gen_names, self.ema)) if self.use_ema else None,
            step=self._step,
            generator=self.generator.get_state(),
        )

    def save(self, path=None):
        save_train_state(
            default(path, self.results_folder / "checkpoints"), self.steps, self._state(),
            async_save=self.async_checkpoints, keep=self.max_checkpoints,
        )

    @torch.no_grad()
    def load(self, path=None, step=None):
        wait_for_saves()  # the save in flight may be the latest step
        state, s = load_train_state(default(path, self.results_folder / "checkpoints"), step)
        torch._foreach_copy_(self.gen_params, [state["gen_params"][n].to(self.device) for n in self.gen_names])
        self.gen_opt.load_state_dict(state["gen_opt"], self.gen_names)
        if self.has_discr:
            torch._foreach_copy_(self.discr_params, [state["discr_params"][n].to(self.device) for n in self.discr_names])
            self.discr_opt.load_state_dict(state["discr_opt"], self.discr_names)
            self.vae.vgg.load_state_dict(state["vgg"])
        for name, buf in self.vae.named_buffers():
            buf.copy_(state["buffers"][name])
        if self.use_ema:
            if state["ema"] is None:
                raise ValueError("the checkpoint has no EMA weights, this trainer keeps them")
            torch._foreach_copy_(self.ema, [state["ema"][n].to(self.device) for n in self.gen_names])
        self.generator.set_state(state["generator"])
        self._step = int(s)

    # -- one step ---------------------------------------------------------------

    def _micro(self, t, i) -> torch.Tensor:
        return torch.as_tensor(t[i]).to(self.device, torch.float32)

    def train_step_arrays(self, gen_images, discr_images=None, draws=None):
        """One GAN step over `grad_accum_every` micro-batches: arrays
        (numpy or tensors) of images shaped (accum, B, H, W, C), one set for
        the generator and one for the discriminator (the generator's when
        None). `draws` (one `VQDraws` a micro-batch) replaces the trainer's
        own draws for EMA-VQ's codebook updates.

        Logs `loss`, `grad_norm`, `lr` (under a schedule), `discr_loss`,
        `discr_grad_norm` and `steps_per_sec` to `metrics.jsonl`, with one
        host read a step."""
        accum = self.grad_accum_every
        if len(gen_images) != accum:
            raise ValueError(f"leading dim {len(gen_images)} != grad_accum_every {accum}")
        discr_images = gen_images if discr_images is None else discr_images
        step = self._step
        update_codebook = isinstance(self.vae.quantizer, VectorQuantizeEMA)

        # the generator: each micro-batch's loss and gradient, then its
        # codebook update on the pre-step weights, which the next
        # micro-batch's loss sees
        g_sum, loss_sum = None, torch.zeros((), device=self.device)
        for i in range(accum):
            img = self._micro(gen_images, i)
            loss = self.vae(img, return_loss=True, train=True, update_stats=False)
            grads = _grads(loss, self.gen_params)
            g_sum = grads if g_sum is None else torch._foreach_add(g_sum, grads)
            loss_sum = loss_sum + loss.detach()
            if update_codebook:
                self.vae.update_quantizer_stats(img, rng=draws[i] if draws is not None else self.generator)
        with torch.no_grad():
            torch._foreach_div_(g_sum, float(accum))
            norm = global_norm(g_sum)
            lr = self.gen_opt.lr_at(self.gen_opt.count)
            self.gen_opt.step(g_sum, norm)
        del g_sum
        host = {"loss": loss_sum / accum, "grad_norm": norm}

        # the discriminator, on the updated generator and codebook
        if self.has_discr:
            apply_gp = step % self.apply_grad_penalty_every == 0
            d_sum, d_loss_sum = None, torch.zeros((), device=self.device)
            for i in range(accum):
                d_loss = self.vae(
                    self._micro(discr_images, i), return_discr_loss=True, add_gradient_penalty=apply_gp, train=False
                )
                grads = _grads(d_loss, self.discr_params)
                d_sum = grads if d_sum is None else torch._foreach_add(d_sum, grads)
                d_loss_sum = d_loss_sum + d_loss.detach()
            with torch.no_grad():
                torch._foreach_div_(d_sum, float(accum))
                d_norm = global_norm(d_sum)
                self.discr_opt.step(d_sum, d_norm)
            host |= {"discr_loss": d_loss_sum / accum, "discr_grad_norm": d_norm}

        if self.use_ema:
            ema_update(self.ema, self.gen_params, step, **self.ema_kwargs)
        self._step += 1
        logs = dict(zip(host, torch.stack(list(host.values())).tolist()))  # the step's one host read
        if callable(self._lr_sched):
            logs["lr"] = lr
        self.timer.tick()
        sps = self.timer.steps_per_sec
        if sps is not None:
            logs["steps_per_sec"] = round(sps, 3)
        self.metrics.log(step, **logs)
        return logs

    def _next_accum_batch(self, it) -> np.ndarray:
        return np.stack([next(it) for _ in range(self.grad_accum_every)])

    @torch.no_grad()
    def save_reconstructions(self, step: int, logs: dict) -> None:
        """Valid images beside their reconstructions (clipped to [0, 1]),
        as `<step>.png` and, with EMA, `<step>.ema.png`."""
        valid = self._micro([next(self.valid_dl_iter)], 0)
        evals = [(False, str(step))]
        if self.use_ema:
            evals.insert(0, (True, f"{step}.ema"))
        for use_ema, filename in evals:
            recons = self.vae_module(use_ema)(valid, train=False).clamp(0.0, 1.0)
            stacked = torch.stack([valid, recons], dim=1).reshape(-1, *valid.shape[1:]).cpu().numpy()
            grid = make_grid(stacked, nrow=2)
            save_image(grid, self.results_folder / f"{filename}.png")
            logs["reconstructions"] = grid
        self.print(f"{step}: saving to {self.results_folder}")

    def train_step(self) -> dict:
        """One step from the dataset (two batches with a discriminator: the
        generator's, then the discriminator's), then the periodic
        reconstruction grids and checkpoints (`vae.<step>.pt` files in the
        JAX package's format)."""
        steps = self.steps
        gen_images = self._next_accum_batch(self.dl_iter)
        discr_images = self._next_accum_batch(self.dl_iter) if self.has_discr else gen_images
        logs = self.train_step_arrays(gen_images, discr_images)
        if self.has_discr:
            self.print(f"{steps}: vae loss: {logs['loss']} - discr loss: {logs.get('discr_loss')}")
        else:
            self.print(f"{steps}: vae loss: {logs['loss']}")
        if steps % self.save_results_every == 0:
            self.save_reconstructions(steps, logs)
        if steps % self.save_model_every == 0:
            self.save()
            self.vae_module(use_ema=False).save(self.results_folder / f"vae.{steps}.pt")
            if self.use_ema:
                self.vae_module(use_ema=True).save(self.results_folder / f"vae.{steps}.ema.pt")
            self.print(f"{steps}: saving model to {self.results_folder}")
        return logs

    def train(self, log_fn: Callable = lambda *a, **k: None):
        """Steps until `num_train_steps` or a preemption signal (then a save)."""
        with PreemptionGuard() as guard:
            while self.steps < self.num_train_steps and not guard.requested:
                log_fn(self.train_step())
            if guard.requested:
                self.print(f"preemption signal: checkpointing step {self.steps} and exiting")
                self.save()
        wait_for_saves()
        self.print("training complete")


class MaskGitTrainer:
    """Trainer of a base or super-res `MaskGit` (its transformer and
    critic; the VAE clones are frozen), with the JAX trainer's arguments.

    It trains `maskgit` in place; `maskgit_module(use_ema=True)` gives a
    copy with the EMA weights."""

    def __init__(
        self,
        maskgit: MaskGit,
        *,
        num_train_steps: int,
        batch_size: int,
        lr: float = 1e-4,
        warmup_steps: int = 0,
        lr_decay_steps: Optional[int] = None,
        weight_decay: float = 0.0,
        grad_accum_every: int = 1,
        max_grad_norm: Optional[float] = None,
        save_model_every: int = 1000,
        results_folder: str = "./results-maskgit",
        use_ema: bool = True,
        ema_beta: float = 0.995,
        ema_update_after_step: int = 0,
        ema_update_every: int = 1,
        mesh=None,
        shard_state: bool = False,
        shard_state_rules=None,
        seed: int = 0,
        attn_impl: str = "auto",
        metrics_file=None,
        auto_resume: bool = False,
        async_checkpoints: bool = False,
        max_checkpoints: Optional[int] = None,
        save_results_every: Optional[int] = None,
        sample_texts: Optional[Sequence[str]] = None,
        sample_kwargs: Optional[dict] = None,
    ):
        if mesh is not None or shard_state or shard_state_rules is not None:
            raise not_ported("MaskGitTrainer over a mesh (mesh=, shard_state=)", "A11")
        if attn_impl != "auto":
            raise ValueError(
                f"attn_impl {attn_impl!r}: the port attends through K2 on the GPU and its plain version on the CPU "
                "('auto' only)"
            )
        if exists(save_results_every) and not sample_texts:
            raise ValueError("save_results_every needs sample_texts to render")
        self.maskgit = maskgit
        self.num_train_steps = num_train_steps
        self.batch_size = batch_size
        self.grad_accum_every = grad_accum_every
        self.async_checkpoints = async_checkpoints
        self.max_checkpoints = max_checkpoints
        self.save_results_every = save_results_every
        self.sample_texts = sample_texts
        self.sample_kwargs = dict(sample_kwargs or {})
        self.save_model_every = save_model_every
        self.use_ema = use_ema
        self.ema_kwargs = dict(beta=ema_beta, update_after_step=ema_update_after_step, update_every=ema_update_every)
        self.device = maskgit.transformer.token_emb.weight.device

        # trainable: everything but the frozen VAE clones; a SelfCritic's
        # shared trunk is one set of parameters (named_parameters dedups it)
        named = [(n, p) for n, p in maskgit.named_parameters() if n.split(".")[0] not in FROZEN_CHILDREN]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        for p in self.params:
            p.requires_grad_(True)

        self._lr_sched = lr_schedule(lr, warmup_steps, lr_decay_steps)
        self.optimizer = Adam(self.params, self._lr_sched, weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        self.ema = ema_init(self.params) if use_ema else None
        self._step = 0
        self.generator = torch.Generator().manual_seed(seed)

        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.metrics = MetricsLogger(default(metrics_file, self.results_folder / "metrics.jsonl"))
        self.timer = StepTimer()

        # drain a save in flight before listing the steps, or the newest
        # step is still a temporary directory and resume goes stale
        if auto_resume:
            wait_for_saves()
            if latest_step(self.results_folder / "checkpoints") is not None:
                self.load()
                self.print(f"auto-resumed from step {self.steps}")

    @property
    def steps(self) -> int:
        return self._step

    def print(self, msg):
        print(msg)

    # -- state ------------------------------------------------------------------

    def maskgit_module(self, use_ema: bool = False) -> MaskGit:
        """The live model, or (`use_ema` with EMA on) a copy of it holding
        the EMA weights, which shares the frozen VAE clones."""
        if not (use_ema and self.use_ema):
            return self.maskgit
        memo = {id(getattr(self.maskgit, c)): getattr(self.maskgit, c) for c in FROZEN_CHILDREN}
        model = copy.deepcopy(self.maskgit, memo)
        live = dict(model.named_parameters())
        with torch.no_grad():
            for name, e in zip(self.param_names, self.ema):
                live[name].copy_(e)
        return model

    def _state(self) -> dict:
        return dict(
            params=dict(zip(self.param_names, self.params)),
            opt=self.optimizer.state_dict(self.param_names),
            ema=dict(zip(self.param_names, self.ema)) if self.use_ema else None,
            step=self._step,
            generator=self.generator.get_state(),
        )

    def save(self, path=None):
        save_train_state(
            default(path, self.results_folder / "checkpoints"), self.steps, self._state(),
            async_save=self.async_checkpoints, keep=self.max_checkpoints,
        )

    @torch.no_grad()
    def load(self, path=None, step=None):
        wait_for_saves()  # the save in flight may be the latest step
        state, s = load_train_state(default(path, self.results_folder / "checkpoints"), step)
        torch._foreach_copy_(self.params, [state["params"][n].to(self.device) for n in self.param_names])
        self.optimizer.load_state_dict(state["opt"], self.param_names)
        if self.use_ema:
            if state["ema"] is None:
                raise ValueError("the checkpoint has no EMA weights, this trainer keeps them")
            torch._foreach_copy_(self.ema, [state["ema"][n].to(self.device) for n in self.param_names])
        self.generator.set_state(state["generator"])
        self._step = int(s)

    def save_sample_results(self, step: Optional[int] = None):
        """Render `sample_texts` (EMA weights when kept) to a PNG grid
        `maskgit.<step>.png` in the results folder."""
        step = default(step, self.steps)
        model = self.maskgit_module(use_ema=self.use_ema)
        gen = torch.Generator(self.device).manual_seed((0x5A << 32) + step)
        images = model.generate(list(self.sample_texts), generator=gen, **self.sample_kwargs)
        images_u8 = (images.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
        n = len(self.sample_texts)
        grid = make_grid(images_u8.astype(np.float32) / 255.0, nrow=min(n, 4))
        save_image(grid, self.results_folder / f"maskgit.{step}.png")
        self.print(f"{step}: saving samples to {self.results_folder}")

    # -- one step ---------------------------------------------------------------

    def _micro(self, t, i):
        return None if t is None else torch.as_tensor(t[i]).to(self.device)

    def train_step_arrays(self, images, text_embeds, text_mask, cond_token_ids=None, draws=None):
        """One optimizer step over `grad_accum_every` micro-batches: arrays
        (numpy or tensors) shaped (accum, B, ...): images (float) or ids,
        text embeddings and mask, and for a super-res stage trained on ids
        `cond_token_ids` (accum, B, n). `draws` (one `TrainDraws` a
        micro-batch) replaces the trainer's own draws.

        The micro-batch gradients are summed and divided by the count, then
        clipped, applied and followed by the EMA. Logs `loss`, `grad_norm`
        (before the clip), `lr` (under a schedule) and `steps_per_sec` to
        `metrics.jsonl`, with one host read a step."""
        accum = self.grad_accum_every
        if len(images) != accum:
            raise ValueError(f"leading dim {len(images)} != grad_accum_every {accum}")
        for p in self.params:
            p.grad = None
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            loss = self.maskgit(
                self._micro(images, i), text_embeds=self._micro(text_embeds, i), text_mask=self._micro(text_mask, i),
                cond_token_ids=self._micro(cond_token_ids, i), generator=self.generator,
                draws=draws[i] if draws is not None else None,
            )
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
            torch._foreach_div_(grads, float(accum))
            norm = global_norm(grads)
            lr = self.optimizer.lr_at(self.optimizer.count)
            self.optimizer.step(grads, norm)
            if self.use_ema:
                ema_update(self.ema, self.params, self._step, **self.ema_kwargs)
            self._step += 1
            loss_v, norm_v = torch.stack([loss_sum / accum, norm]).tolist()  # the step's one host read
        for p in self.params:
            p.grad = None
        logs = {"loss": loss_v, "grad_norm": norm_v}
        if callable(self._lr_sched):
            logs["lr"] = lr
        self.timer.tick()
        sps = self.timer.steps_per_sec
        if sps is not None:
            logs["steps_per_sec"] = round(sps, 3)
        self.metrics.log(self.steps - 1, **logs)
        return logs

    # -- loops ------------------------------------------------------------------

    def _encoded_accum_batches(self, data_iter):
        """(images, text_embeds, text_mask) stacked over the micro-batches
        of a step, the texts through the frozen T5 and padded to one length."""
        t5_name = self.maskgit.transformer.t5_name
        while True:
            imgs, tes, tms = [], [], []
            for _ in range(self.grad_accum_every):
                images, texts = next(data_iter)
                te, tm = t5_encode_text_with_mask(texts, name=t5_name, device=self.device)
                imgs.append(torch.as_tensor(np.asarray(images)))
                tes.append(te)
                tms.append(tm)
            _pad_text(tes, tms)
            yield torch.stack(imgs), torch.stack(tes), torch.stack(tms)

    def _after_step(self, logs, log_fn):
        self.print(f"{self.steps - 1}: maskgit loss: {logs['loss']}")
        if (self.steps - 1) % self.save_model_every == 0:
            self.save()
        if exists(self.save_results_every) and (self.steps - 1) % self.save_results_every == 0:
            self.save_sample_results(self.steps - 1)
        log_fn(logs)

    def _run(self, batches, log_fn):
        """Steps until `num_train_steps` or a preemption signal (then a save)."""
        with PreemptionGuard() as guard:
            while self.steps < self.num_train_steps and not guard.requested:
                images, tes, tms, cond = next(batches)
                self._after_step(self.train_step_arrays(images, tes, tms, cond_token_ids=cond), log_fn)
            if guard.requested:
                self.print(f"preemption signal: checkpointing step {self.steps} and exiting")
                self.save()

    def train(self, data_iter, log_fn: Callable = lambda *a, **k: None, prefetch: int = 2):
        """`data_iter` yields (images (B, H, W, C) float in [0, 1], texts)
        per micro-batch; with `prefetch` > 0 the batches (the T5 pass
        included) are made on a background thread."""
        batches = prefetch_iterator(((*b, None) for b in self._encoded_accum_batches(data_iter)), prefetch)
        try:
            self._run(batches, log_fn)
        finally:
            batches.close()
        wait_for_saves()
        self.print("training complete")

    def train_from_shards(
        self,
        token_paths,
        *,
        use_captions: bool = False,
        cond_token_len: Optional[int] = None,
        loader_seed: int = 0,
        num_threads: int = 2,
        prefetch: int = 2,
        log_fn: Callable = lambda *a, **k: None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """Ids-path training from native token shards (the JAX package's
        format; `training.shard_loader`).

        Shards are grouped by (seq_len, grid) into buckets, one loader each;
        a schedule seeded by `loader_seed` draws each optimizer step's
        bucket, weighted by its size, and every micro-batch of the step
        comes from it (grid shards train as (b, fh, fw) grids). A resumed
        run replays the first `steps` draws and skips `steps x
        grad_accum_every` batches in all, so the data stream continues
        exactly (bit-identical at `num_threads=1`). `use_captions` joins the
        `<shard>.captions` sidecars through the frozen T5, else the text is
        empty (unconditional). `cond_token_len`: paired super-res shards,
        the trailing ids of each row are the conditioning tokens. A bucket
        smaller than one batch is refused."""
        if process_count > 1:
            raise not_ported("multi-process shard training (process_count > 1)", "A11")
        transformer = self.maskgit.transformer
        t5_name, text_dim = transformer.t5_name, transformer.text_embed_dim

        by_shape: dict = {}
        group_seqs: dict = {}
        for p in map(str, token_paths):
            hdr = read_shard_header(p)
            key = (hdr["seq_len"], hdr["grid"])
            by_shape.setdefault(key, []).append(p)
            group_seqs[key] = group_seqs.get(key, 0) + hdr["num_seqs"]
        groups = sorted(by_shape.items(), key=lambda kv: (kv[0][0], kv[0][1] or (0, 0)))

        sched_rng = np.random.default_rng(loader_seed)
        weights = np.array([group_seqs[k] for k, _ in groups], np.float64)
        weights /= weights.sum()

        def draw():
            return 0 if len(groups) == 1 else int(sched_rng.choice(len(groups), p=weights))

        skips = [0] * len(groups)
        for _ in range(self.steps):
            skips[draw()] += self.grad_accum_every

        loaders = []
        try:
            for gi, (_, paths) in enumerate(groups):
                loaders.append(
                    ShardLoader(
                        paths, self.batch_size, seed=loader_seed + 1000003 * gi, num_threads=num_threads,
                        drop_last=True, process_index=process_index, process_count=process_count,
                        skip_batches=skips[gi],
                    )
                )
            # a bucket below one batch wraps its epoch and returns a partial
            # batch: refuse it when it opens
            for gi, ld in enumerate(loaders):
                if ld.num_seqs < self.batch_size:
                    raise ValueError(
                        f"shard bucket {groups[gi][0]} holds only {ld.num_seqs} sequences, fewer than "
                        f"batch_size={self.batch_size}, so it cannot yield a full batch. Merge small aspect "
                        "buckets or lower batch_size."
                    )
        except BaseException:
            for ld in loaders:
                ld.close()
            raise
        cap_iters = [ld.captioned() if use_captions else None for ld in loaders]

        def pull(gi):
            loader = loaders[gi]
            if use_captions:
                tokens, texts = next(cap_iters[gi])
                te, tm = t5_encode_text_with_mask(texts, name=t5_name, device=self.device)
            else:
                tokens = loader.next_batch()
                te = torch.zeros(tokens.shape[0], 1, text_dim)
                tm = torch.zeros(tokens.shape[0], 1, dtype=torch.bool)
            tokens = tokens.astype(np.int32)
            cond = None
            if cond_token_len:
                cond = tokens[:, -cond_token_len:]
                tokens = tokens[:, :-cond_token_len]
            if loader.grid is not None:
                fh, fw = loader.grid
                if fh * fw != tokens.shape[1]:
                    raise ValueError(f"shard grid {loader.grid} does not tile the target ids ({tokens.shape[1]})")
                tokens = tokens.reshape(tokens.shape[0], fh, fw)
            return tokens, cond, te, tm

        def accum_batches():
            while True:
                gi = draw()  # a whole step in one bucket
                toks, conds, tes, tms = [], [], [], []
                for _ in range(self.grad_accum_every):
                    tokens, cond, te, tm = pull(gi)
                    toks.append(torch.from_numpy(tokens))
                    conds.append(cond)
                    tes.append(te)
                    tms.append(tm)
                _pad_text(tes, tms)
                cond = torch.from_numpy(np.stack(conds)) if cond_token_len else None
                yield torch.stack(toks), torch.stack(tes), torch.stack(tms), cond

        batches = prefetch_iterator(accum_batches(), prefetch)
        try:
            self._run(batches, log_fn)
        finally:
            batches.close()  # joins the producer before the native handles are freed
            for it in cap_iters:
                if it is not None:
                    it.close()
            for loader in loaders:
                loader.close()
        wait_for_saves()
        self.print("training complete")
