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
The frozen VAE and T5 are not trained.

Over a mesh (`mesh=`, default `parallel.create_mesh()`: trivial without a
process group, the whole group on the `data` axis with one) each rank
trains on its rows of the global batch, which every rank is given whole,
and the gradients are averaged across ranks (`parallel.zero`): the step is
the one a single process makes from the whole batch. The draws are drawn
for the global batch from the same generator on every rank and each rank
takes its rows; the masked-token loss divides each rank's sum by its share
of the global masked count; LFQ's codebook entropy, EMA-VQ's codebook
update and the adaptive weight reduce over the ranks (`parallel.batch`).
`shard_state=True` shards the parameters, Adam's moments and the EMA over
the mesh's `fsdp` (else `data`) axis by `fsdp_partition_specs` (ZeRO-3 by
hand: the whole weights are gathered for a step and freed after it).
With it, `shard_state_rules` (`parallel.DEFAULT_TP_RULES`) places leaves on
the mesh's `tensor` axis as the JAX trainer's `_maybe_shard_state` does,
and the modules those leaves belong to compute on their rank's share
(tensor parallelism, `parallel.tensor`): a rank runs K2 on its heads, its
slice of the vocab head and of the FF's inner dim where it divides; the
ranks of one data index take the same rows. The rules act only with
`shard_state`, as in JAX. Checkpoints are gathered whole on every rank and
written by rank 0, so one file format serves every mesh.
"""

from __future__ import annotations

import copy
from pathlib import Path
from shutil import rmtree
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from muse_maskgit_pytorch_tpu_torch.models.maskgit import MaskGit
from muse_maskgit_pytorch_tpu_torch.models.quantizers import VectorQuantizeEMA
from muse_maskgit_pytorch_tpu_torch.models.t5 import t5_encode_text_with_mask
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import VQGanVAE
from muse_maskgit_pytorch_tpu_torch.parallel.batch import split_over
from muse_maskgit_pytorch_tpu_torch.parallel.mesh import (
    create_mesh,
    is_main_process,
    jax_dim_orders,
    replicate,
    sharded_state_bytes,
)
from muse_maskgit_pytorch_tpu_torch.parallel.tensor import plan, unsplit
from muse_maskgit_pytorch_tpu_torch.parallel.zero import DistributedParams
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
from muse_maskgit_pytorch_tpu_torch.training.optim import Adam, global_norm, local_tensors, lr_schedule
from muse_maskgit_pytorch_tpu_torch.training.preemption import PreemptionGuard
from muse_maskgit_pytorch_tpu_torch.training.shard_loader import ShardLoader, read_shard_header
from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import (
    latest_step,
    load_train_state,
    save_train_state,
    wait_for_saves,
)
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, exists
from muse_maskgit_pytorch_tpu_torch.utils.metrics import MetricsLogger, StepTimer, span

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


def _distribute(trainer, module, groups, mesh, shard_state, rules) -> List[DistributedParams]:
    """Each (names, params) group of `module` over `mesh`, after rank 0's
    weights and buffers are broadcast to every rank; the modules whose
    leaves the rules split on the tensor axis compute their share."""
    trainer.mesh = default(mesh, create_mesh)
    replicate([*module.parameters(), *module.buffers()], trainer.mesh)
    orders = jax_dim_orders(module)
    rules = rules if shard_state else None  # as JAX's _maybe_shard_state
    dps = [DistributedParams(trainer.mesh, n, p, orders, shard=shard_state, rules=rules) for n, p in groups]
    stored = {n: pl for dp in dps for n, pl in zip(dp.names, dp.placements) if pl is not None}
    local = plan(module, stored, trainer.mesh)
    for dp in dps:
        dp.split_compute(local)
    return dps


def _report_sharding(trainer, dps) -> None:
    if any(dp.sharded for dp in dps):
        total, local = sharded_state_bytes(trainer.state)
        trainer.print(
            f"sharded train state over mesh {dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))}: "
            f"{total / 1e9:.2f}G total, {local / 1e9:.2f}G per rank"
        )


def _gathered_opt(opt: Adam, dp: DistributedParams, names) -> dict:
    """An optimizer's state dict with whole moments (every rank calls it)."""
    return dict(count=opt.count, mu=dict(zip(names, dp.gather(opt.mu))), nu=dict(zip(names, dp.gather(opt.nu))))


def _load_opt(opt: Adam, dp: DistributedParams, state: dict, names) -> None:
    opt.count = int(state["count"])
    dp.load(opt.mu, [state["mu"][n] for n in names])
    dp.load(opt.nu, [state["nu"][n] for n in names])


def _module_copy(module, memo, names, weights):
    """A copy of `module` (sharing what `memo` holds) with `weights`
    (whole tensors, by parameter name) in place of its parameters; it
    computes whole."""
    model = unsplit(copy.deepcopy(module, memo))
    live = dict(model.named_parameters())
    with torch.no_grad():
        for name, w in zip(names, weights):
            live[name].data = w.detach().clone()
    return model


def vqgan_param_groups(vae: VQGanVAE):
    """(generator, discriminator) parameter names of a VAE's train state;
    the VGG tower is frozen and in neither."""
    names = [n for n, _ in vae.named_parameters() if not n.startswith("_vgg.")]
    return [n for n in names if not n.startswith("discr.")], [n for n in names if n.startswith("discr.")]


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

        self.gen_names, self.discr_names = vqgan_param_groups(vae)
        params = dict(vae.named_parameters())
        self.gen_params = [params[n].requires_grad_(True) for n in self.gen_names]
        self.discr_params = [params[n].requires_grad_(True) for n in self.discr_names]

        self._lr_sched = lr_schedule(lr, warmup_steps, lr_decay_steps)
        self.gen_dp, self.discr_dp = _distribute(
            self, vae, [(self.gen_names, self.gen_params), (self.discr_names, self.discr_params)], mesh, shard_state,
            shard_state_rules,
        )
        self.gen_opt = Adam(self.gen_dp.masters, self._lr_sched, max_grad_norm=max_grad_norm)
        self.discr_opt = Adam(self.discr_dp.masters, self._lr_sched, max_grad_norm=discr_max_grad_norm)
        self.ema = ema_init(self.gen_dp.masters) if use_ema else None
        _report_sharding(self, (self.gen_dp, self.discr_dp))
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
        if (
            clear_previous_results and is_main_process() and self.results_folder.exists()
            and any(self.results_folder.iterdir())
        ):
            rmtree(self.results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.metrics = MetricsLogger(default(metrics_file, self.results_folder / "metrics.jsonl"), enabled=is_main_process())
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
        if is_main_process():
            print(msg)

    # -- state ------------------------------------------------------------------

    def vae_module(self, use_ema: bool = False) -> VQGanVAE:
        """The live VAE, or (`use_ema` with EMA on) a copy of it holding the
        EMA generator weights with the live codebook, discriminator and
        VGG (the latter two shared, not copied). Under a sharded state
        always a copy with the whole weights (every rank calls it)."""
        sharded = bool(self.gen_dp.sharded or self.discr_dp.sharded)
        if not (use_ema and self.use_ema) and not sharded:
            return self.vae
        shared = (self.vae._vgg,) if sharded else (self.vae.discr, self.vae._vgg)
        memo = {id(t): t for t in shared if t is not None}
        gen = self.gen_dp.gather(self.ema if (use_ema and self.use_ema) else self.gen_dp.masters)
        names, weights = list(self.gen_names), list(gen)
        if sharded:
            names += self.discr_names
            weights += self.discr_dp.gather(self.discr_dp.masters)
        return _module_copy(self.vae, memo, names, weights)

    @property
    def state(self) -> dict:
        """The train state's tensors as the trainer holds them (sharded
        ones as `DTensor`s): what `parallel.sharded_state_bytes` reads."""
        return dict(
            gen_params=dict(zip(self.gen_names, self.gen_dp.masters)),
            discr_params=dict(zip(self.discr_names, self.discr_dp.masters)),
            buffers=dict(self.vae.named_buffers()),
            gen_opt=self.gen_opt.state_dict(self.gen_names),
            discr_opt=self.discr_opt.state_dict(self.discr_names),
            ema=dict(zip(self.gen_names, self.ema)) if self.use_ema else None,
        )

    def _state(self) -> dict:
        """The whole train state (sharded tensors gathered: every rank calls it)."""
        gen, discr = self.gen_dp, self.discr_dp
        return dict(
            gen_params=dict(zip(self.gen_names, gen.gather(gen.masters))),
            discr_params=dict(zip(self.discr_names, discr.gather(discr.masters))),
            buffers=dict(self.vae.named_buffers()),
            vgg=self.vae.vgg.state_dict() if self.has_discr else None,
            gen_opt=_gathered_opt(self.gen_opt, gen, self.gen_names),
            discr_opt=_gathered_opt(self.discr_opt, discr, self.discr_names),
            ema=dict(zip(self.gen_names, gen.gather(self.ema))) if self.use_ema else None,
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
        self.gen_dp.load(self.gen_dp.masters, [state["gen_params"][n] for n in self.gen_names])
        _load_opt(self.gen_opt, self.gen_dp, state["gen_opt"], self.gen_names)
        if self.has_discr:
            self.discr_dp.load(self.discr_dp.masters, [state["discr_params"][n] for n in self.discr_names])
            _load_opt(self.discr_opt, self.discr_dp, state["discr_opt"], self.discr_names)
            self.vae.vgg.load_state_dict(state["vgg"])
        for name, buf in self.vae.named_buffers():
            buf.copy_(state["buffers"][name])
        if self.use_ema:
            if state["ema"] is None:
                raise ValueError("the checkpoint has no EMA weights, this trainer keeps them")
            self.gen_dp.load(self.ema, [state["ema"][n] for n in self.gen_names])
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
        dp = self.gen_dp

        def rows(images, i):
            """This rank's rows of micro-batch i, and the ranks that split it."""
            img = self._micro(images, i)
            start, stop, parts = dp.rows(img.shape[0])
            return img[start:stop], split_over(dp.data_group, parts)

        self.gen_dp.materialize()
        self.discr_dp.materialize()
        # the generator: each micro-batch's loss and gradient, then its
        # codebook update on the pre-step weights, which the next
        # micro-batch's loss sees
        g_sum, loss_sum = None, torch.zeros((), device=self.device)
        for i in range(accum):
            img, split = rows(gen_images, i)
            with split:
                loss = self.vae(img, return_loss=True, train=True, update_stats=False)
                grads = _grads(loss, self.gen_params)
                g_sum = grads if g_sum is None else torch._foreach_add(g_sum, grads)
                loss_sum = loss_sum + loss.detach()
                if update_codebook:
                    self.vae.update_quantizer_stats(img, rng=draws[i] if draws is not None else self.generator)
        with torch.no_grad():
            g_sum, (loss_sum,) = self.gen_dp.reduce(g_sum, loss_sum)
            torch._foreach_div_(local_tensors(g_sum), float(accum))
            norm = global_norm(g_sum)
            lr = self.gen_opt.lr_at(self.gen_opt.count)
            self.gen_opt.step(g_sum, norm)
        del g_sum
        host = {"loss": loss_sum / accum, "grad_norm": norm}

        # the discriminator, on the updated generator and codebook
        if self.has_discr:
            self.gen_dp.materialize()  # the updated generator
            apply_gp = step % self.apply_grad_penalty_every == 0
            d_sum, d_loss_sum = None, torch.zeros((), device=self.device)
            for i in range(accum):
                img, split = rows(discr_images, i)
                with split:
                    d_loss = self.vae(img, return_discr_loss=True, add_gradient_penalty=apply_gp, train=False)
                    grads = _grads(d_loss, self.discr_params)
                d_sum = grads if d_sum is None else torch._foreach_add(d_sum, grads)
                d_loss_sum = d_loss_sum + d_loss.detach()
            with torch.no_grad():
                d_sum, (d_loss_sum,) = self.discr_dp.reduce(d_sum, d_loss_sum)
                torch._foreach_div_(local_tensors(d_sum), float(accum))
                d_norm = global_norm(d_sum)
                self.discr_opt.step(d_sum, d_norm)
            host |= {"discr_loss": d_loss_sum / accum, "discr_grad_norm": d_norm}

        if self.use_ema:
            ema_update(self.ema, self.gen_dp.masters, step, **self.ema_kwargs)
        self.gen_dp.release()
        self.discr_dp.release()
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
            if is_main_process():
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
        (self.dp,) = _distribute(self, maskgit, [(self.param_names, self.params)], mesh, shard_state, shard_state_rules)
        self.optimizer = Adam(self.dp.masters, self._lr_sched, weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        self.ema = ema_init(self.dp.masters) if use_ema else None
        _report_sharding(self, (self.dp,))
        self._step = 0
        self.generator = torch.Generator().manual_seed(seed)

        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.metrics = MetricsLogger(default(metrics_file, self.results_folder / "metrics.jsonl"), enabled=is_main_process())
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
        if is_main_process():
            print(msg)

    # -- state ------------------------------------------------------------------

    def maskgit_module(self, use_ema: bool = False) -> MaskGit:
        """The live model, or (`use_ema` with EMA on) a copy of it holding
        the EMA weights, which shares the frozen VAE clones. Under a
        sharded state always a copy with the whole weights (every rank
        calls it)."""
        ema = use_ema and self.use_ema
        if not ema and not self.dp.sharded:
            return self.maskgit
        memo = {id(getattr(self.maskgit, c)): getattr(self.maskgit, c) for c in FROZEN_CHILDREN}
        weights = self.dp.gather(self.ema if ema else self.dp.masters)
        return _module_copy(self.maskgit, memo, self.param_names, weights)

    @property
    def state(self) -> dict:
        """The train state's tensors as the trainer holds them (sharded
        ones as `DTensor`s): what `parallel.sharded_state_bytes` reads."""
        return dict(
            params=dict(zip(self.param_names, self.dp.masters)),
            opt=self.optimizer.state_dict(self.param_names),
            ema=dict(zip(self.param_names, self.ema)) if self.use_ema else None,
        )

    def _state(self) -> dict:
        """The whole train state (sharded tensors gathered: every rank calls it)."""
        return dict(
            params=dict(zip(self.param_names, self.dp.gather(self.dp.masters))),
            opt=_gathered_opt(self.optimizer, self.dp, self.param_names),
            ema=dict(zip(self.param_names, self.dp.gather(self.ema))) if self.use_ema else None,
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
        self.dp.load(self.dp.masters, [state["params"][n] for n in self.param_names])
        _load_opt(self.optimizer, self.dp, state["opt"], self.param_names)
        if self.use_ema:
            if state["ema"] is None:
                raise ValueError("the checkpoint has no EMA weights, this trainer keeps them")
            self.dp.load(self.ema, [state["ema"][n] for n in self.param_names])
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
        if is_main_process():
            save_image(grid, self.results_folder / f"maskgit.{step}.png")
        self.print(f"{step}: saving samples to {self.results_folder}")

    # -- one step ---------------------------------------------------------------

    def _micro(self, t, i):
        return None if t is None else torch.as_tensor(t[i]).to(self.device)

    def train_step_arrays(self, images, text_embeds, text_mask, cond_token_ids=None, draws=None, local_rows=False):
        """One optimizer step over `grad_accum_every` micro-batches: arrays
        (numpy or tensors) shaped (accum, B, ...): images (float) or ids,
        text embeddings and mask, and for a super-res stage trained on ids
        `cond_token_ids` (accum, B, n). `draws` (one `TrainDraws` a
        micro-batch, for the global batch) replaces the trainer's own draws.
        Over a mesh every rank is given the global batch and trains on its
        rows; `local_rows`: the arrays are already this rank's rows, in rank
        order over the data axis.

        The micro-batch gradients are summed and divided by the count, then
        clipped, applied and followed by the EMA. Logs `loss`, `grad_norm`
        (before the clip), `lr` (under a schedule) and `steps_per_sec` to
        `metrics.jsonl`, with one host read a step."""
        with span("muse.train_step"):
            accum = self.grad_accum_every
            if len(images) != accum:
                raise ValueError(f"leading dim {len(images)} != grad_accum_every {accum}")
            dp = self.dp
            dp.materialize()
            for p in self.params:
                p.grad = None
            loss_sum = torch.zeros((), device=self.device)
            for i in range(accum):
                micro = [self._micro(t, i) for t in (images, text_embeds, text_mask, cond_token_ids)]
                draw, denominator = draws[i] if draws is not None else None, None
                if dp.active:
                    # the global batch's draws, as one process draws them; this rank's rows of them
                    b = micro[0].shape[0]
                    if local_rows:
                        start, stop, parts = dp.data_index * b, (dp.data_index + 1) * b, dp.data_size
                        b *= parts
                    else:
                        start, stop, parts = dp.rows(b)
                        micro = [None if t is None else t[start:stop] for t in micro]
                    if draw is None:
                        draw = self.maskgit.train_draws(
                            (b, *micro[0].shape[1:]), micro[0].is_floating_point(), generator=self.generator
                        )
                    if parts > 1:
                        # each rank's cross-entropy sum over its share of the global masked count
                        denominator = self.maskgit.masked_token_count(draw) / parts
                    draw = draw.rows(start, stop)
                with span("muse.forward"):
                    loss = self.maskgit(
                        micro[0], text_embeds=micro[1], text_mask=micro[2], cond_token_ids=micro[3],
                        generator=self.generator, draws=draw, loss_denominator=denominator,
                    )
                with span("muse.backward"):
                    loss.backward()
                loss_sum = loss_sum + loss.detach()
            with torch.no_grad():
                with span("muse.optimizer"):
                    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
                    grads, (loss_sum,) = dp.reduce(grads, loss_sum)
                    torch._foreach_div_(local_tensors(grads), float(accum))
                    norm = global_norm(grads)
                    lr = self.optimizer.lr_at(self.optimizer.count)
                    self.optimizer.step(grads, norm)
                if self.use_ema:
                    with span("muse.ema"):
                        ema_update(self.ema, dp.masters, self._step, **self.ema_kwargs)
                self._step += 1
                loss_v, norm_v = torch.stack([loss_sum / accum, norm]).tolist()  # the step's one host read
            for p in self.params:
                p.grad = None
            dp.release()
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

    def _run(self, batches, log_fn, local_rows: bool = False):
        """Steps until `num_train_steps` or a preemption signal (then a save)."""
        with PreemptionGuard() as guard:
            while self.steps < self.num_train_steps and not guard.requested:
                images, tes, tms, cond = next(batches)
                rows = dict(local_rows=True) if local_rows else {}
                logs = self.train_step_arrays(images, tes, tms, cond_token_ids=cond, **rows)
                self._after_step(logs, log_fn)
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
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
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
        smaller than one batch is refused.

        Over a mesh, `process_index` / `process_count` default to this
        rank's place on the data axis and its size: each rank opens its
        round-robin share of the shards (the loader's split and seed rule)
        and loads `batch_size / process_count` rows a micro-batch, its part
        of the global batch."""
        default_index, default_count = self.dp.data_index, self.dp.data_size
        process_index = default(process_index, default_index)
        process_count = default(process_count, default_count)
        if process_count > 1 and (process_count, process_index) != (default_count, default_index):
            raise ValueError(
                f"process {process_index} of {process_count}: over this mesh the data axis puts this rank at "
                f"{default_index} of {default_count}"
            )
        if self.batch_size % process_count:
            raise ValueError(f"batch_size {self.batch_size} does not divide over {process_count} processes")
        rank_batch = self.batch_size // process_count
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
                        paths, rank_batch, seed=loader_seed + 1000003 * gi, num_threads=num_threads,
                        drop_last=True, process_index=process_index, process_count=process_count,
                        skip_batches=skips[gi],
                    )
                )
            # a bucket below one batch wraps its epoch and returns a partial
            # batch: refuse it when it opens
            for gi, ld in enumerate(loaders):
                if ld.num_seqs < rank_batch:
                    raise ValueError(
                        f"shard bucket {groups[gi][0]} holds only {ld.num_seqs} sequences, fewer than "
                        f"batch_size={self.batch_size}"
                        + (f" over {process_count} processes ({rank_batch} each)" if process_count > 1 else "")
                        + ", so it cannot yield a full batch. Merge small aspect buckets or lower batch_size."
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
            self._run(batches, log_fn, local_rows=process_count > 1)
        finally:
            batches.close()  # joins the producer before the native handles are freed
            for it in cap_iters:
                if it is not None:
                    it.close()
            for loader in loaders:
                loader.close()
        wait_for_saves()
        self.print("training complete")
