"""The multi-rank side of `tests/test_torch_parallel.py`: model builders
and the scenarios that each of two gloo ranks runs on the CPU. This module
imports torch and the port only, so the spawned processes never import JAX.

`main(rank, world, store_path, out_dir)` joins a process group through a
`FileStore`, runs every scenario, saves what each one measured to
`out_dir/<scenario>.<rank>.pt` and leaves the group. The test process runs
the same builders without a process group for the one-rank references.
"""

from __future__ import annotations

import os
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from muse_maskgit_pytorch_tpu_torch import GeneratePipeline, MaskGit, MaskGitTransformer, VQGanVAE
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.models.quantizers import VQDraws
from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d, Linear
from muse_maskgit_pytorch_tpu_torch.parallel import create_mesh, init_distributed, sharded_state_bytes
from muse_maskgit_pytorch_tpu_torch.parallel.batch import rows_from
from muse_maskgit_pytorch_tpu_torch.training import MaskGitTrainer, ShardLoader, VQGanVAETrainer
from muse_maskgit_pytorch_tpu_torch.utils import checkpoint

VOCAB, TEXT_DIM, SEQ, B = 64, 16, 16, 4
IMAGE = 16
TINY_T5 = "test/tiny-t5-dist"
pt5.T5_CONFIGS.setdefault(TINY_T5, pt5.T5Config(32, 64, 2, 16, 2, True))


# -- builders ------------------------------------------------------------------


def maskgit_model(seed: int = 0, critic: bool = True) -> MaskGit:
    """A toy base stage trained on ids (self-conditioning and a self critic,
    so the trainer's draws hold the self-conditioning coin and the critic's
    Gumbel noise); dims chosen so several leaves reach the FSDP size."""
    gen = torch.Generator().manual_seed(seed)
    t = MaskGitTransformer(
        num_tokens=VOCAB, dim=64, seq_len=SEQ, depth=2, dim_head=16, heads=4, text_embed_dim=TEXT_DIM,
        self_cond=True, device="cpu", generator=gen,
    )
    vae = VQGanVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=False, device="cpu", generator=gen)
    return MaskGit(image_size=IMAGE, transformer=t, vae=vae, self_token_critic=critic, self_cond_prob=0.5, device="cpu")


def maskgit_batches(n: int, accum: int = 2, b: int = B, seed: int = 0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, VOCAB, (accum, b, SEQ))
        te = rs.randn(accum, b, 3, TEXT_DIM).astype(np.float32)
        tm = np.ones((accum, b, 3), bool)
        tm[:, 0, 2] = False
        te[~tm] = 0.0
        out.append((ids, te, tm))
    return out


def maskgit_trainer(folder, mesh=None, shard_state=False, **kw) -> MaskGitTrainer:
    base = dict(
        num_train_steps=100, batch_size=B, lr=1e-3, warmup_steps=1, grad_accum_every=2, max_grad_norm=0.5,
        save_model_every=10**9, seed=5,
    )
    return MaskGitTrainer(maskgit_model(), results_folder=str(folder), mesh=mesh, shard_state=shard_state, **(base | kw))


class Tower(torch.nn.Module):
    """A small stand-in for the VGG16 perceptual tower."""

    def __init__(self, generator=None):
        super().__init__()
        self.conv = Conv2d(3, 8, 3, padding=1, generator=generator)
        self.fc = Linear(8, 16, bias=True, generator=generator)

    def forward(self, x):
        h = torch.relu(self.conv(x.permute(0, 3, 1, 2))).mean(dim=(2, 3))
        return torch.relu(self.fc(h))


class Images:
    def __init__(self, n=16, size=IMAGE, seed=3):
        self.data = np.random.default_rng(seed).uniform(size=(n, size, size, 3)).astype(np.float32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


def gan_trainer(folder, quantizer: str, mesh=None, shard_state=False, **kw) -> VQGanVAETrainer:
    vq = dict(lookup_free_quantization=False, vq_kwargs=dict(codebook_dim=8, threshold_ema_dead_code=2.0))
    vae = VQGanVAE(
        dim=32, layers=2, codebook_size=VOCAB, use_vgg_and_gan=True, device="cpu",
        generator=torch.Generator().manual_seed(0), **(vq if quantizer == "ema" else {}),
    )
    vae.set_vgg(Tower(torch.Generator().manual_seed(1)))
    base = dict(
        folder=None, dataset=Images(), num_train_steps=100, batch_size=B, image_size=IMAGE, lr=1e-3,
        save_results_every=10**9, save_model_every=10**9, apply_grad_penalty_every=2, seed=5, valid_frac=0.0,
        max_grad_norm=1.0,
    )
    return VQGanVAETrainer(vae, results_folder=str(folder), mesh=mesh, shard_state=shard_state, **(base | kw))


def gan_batches(n: int, b: int = B, seed: int = 9):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(size=(1, b, IMAGE, IMAGE, 3)).astype(np.float32),) * 2 for _ in range(n)]


def vq_draws(n_rows: int, steps: int, seed: int = 4):
    """One `VQDraws` a step for EMA-VQ's k-means and revival, over the
    global batch's latent rows."""
    g = torch.Generator().manual_seed(seed)
    return [[VQDraws.draw(VOCAB, n_rows, g)] for _ in range(steps)]


def pipeline_model() -> MaskGit:
    gen = torch.Generator().manual_seed(3)
    t = MaskGitTransformer(
        num_tokens=VOCAB, dim=32, seq_len=SEQ, depth=1, dim_head=16, heads=2, t5_name=TINY_T5, device="cpu",
        generator=gen,
    )
    vae = VQGanVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=False, device="cpu", generator=gen)
    return MaskGit(image_size=IMAGE, transformer=t, vae=vae, device="cpu").eval()


def generate_inputs(b: int = 8):
    rs = np.random.RandomState(21)
    te = torch.from_numpy(rs.randn(b, 5, 32).astype(np.float32))
    tm = torch.ones(b, 5, dtype=torch.bool)
    tm[1, 3:] = False
    return te, tm


PROMPTS = ["a", "b c", "d", "e f g", "h", "i", "j k", "l"]


# -- what each scenario measures --------------------------------------------------


def run_maskgit(folder, mesh, shard_state, steps=3):
    t = maskgit_trainer(folder, mesh=mesh, shard_state=shard_state)
    logs = [t.train_step_arrays(*b) for b in maskgit_batches(steps)]
    state = t._state()
    total, local = sharded_state_bytes(t.state)
    return dict(
        loss=[l["loss"] for l in logs], grad_norm=[l["grad_norm"] for l in logs], params=state["params"],
        ema=state["ema"], mu=state["opt"]["mu"], total=total, local=local,
    )


def run_indivisible(folder, mesh):
    t = maskgit_trainer(folder, mesh=mesh, batch_size=3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        logs = t.train_step_arrays(*maskgit_batches(1, b=3)[0])
    return dict(loss=logs["loss"], warned=any("not divisible" in str(w.message) for w in caught))


def run_resume(folder, mesh):
    """Two sharded trainers from one seed: straight 3 steps, and 2 steps,
    a save, an auto-resume and 1 step."""
    batches = maskgit_batches(3)
    straight = maskgit_trainer(Path(folder) / "straight", mesh=mesh, shard_state=True)
    want = [straight.train_step_arrays(*b)["loss"] for b in batches]
    first = maskgit_trainer(Path(folder) / "resumed", mesh=mesh, shard_state=True)
    got = [first.train_step_arrays(*b)["loss"] for b in batches[:2]]
    first.save()
    second = maskgit_trainer(Path(folder) / "resumed", mesh=mesh, shard_state=True, auto_resume=True)
    got += [second.train_step_arrays(*b)["loss"] for b in batches[2:]]
    a, b = straight._state(), second._state()
    same = all(torch.equal(a[k][n], b[k][n]) for k in ("params", "ema") for n in a[k])
    # the module file: every rank gathers, rank 0 alone writes
    replaced = []
    real = checkpoint.os.replace
    checkpoint.os.replace = lambda src, dst: (replaced.append(str(dst)), real(src, dst))[1]
    try:
        second.maskgit_module(use_ema=True).save(Path(folder) / "maskgit.ema.msgpack")
    finally:
        checkpoint.os.replace = real
    return dict(want=want, got=got, same=same, steps=second.steps, replaced=replaced)


def _record_grads(opt, dp, names, into: list):
    """Keep each step's (whole) gradients as the optimizer receives them."""
    step = opt.step

    def recording(grads, norm=None):
        into.append(dict(zip(names, (g.clone() for g in dp.gather(grads)))))
        return step(grads, norm)

    opt.step = recording


def run_gan(folder, quantizer, mesh, shard_state, steps=2, lr=1e-5, **kw):
    t = gan_trainer(folder, quantizer, mesh=mesh, shard_state=shard_state, lr=lr, **kw)
    gen_grads, discr_grads = [], []
    _record_grads(t.gen_opt, t.gen_dp, t.gen_names, gen_grads)
    _record_grads(t.discr_opt, t.discr_dp, t.discr_names, discr_grads)
    draws = vq_draws(B * (IMAGE // 4) ** 2, steps) if quantizer == "ema" else [None] * steps
    logs = [t.train_step_arrays(*imgs, draws=d) for imgs, d in zip(gan_batches(steps), draws)]
    state = t._state()
    return dict(
        logs=logs, gen_grads=gen_grads, discr_grads=discr_grads, gen=state["gen_params"],
        discr=state["discr_params"], buffers={k: v.clone() for k, v in state["buffers"].items()},
    )


def shard_files(folder) -> list:
    """Four token shards (two a rank under the loader's round-robin)."""
    from muse_maskgit_pytorch_tpu_torch.training.shard_loader import write_shard

    rs = np.random.RandomState(12)
    paths = []
    for i in range(4):
        path = Path(folder) / f"shard{i}.bin"
        write_shard(path, rs.randint(0, VOCAB, (8, SEQ)).astype(np.int32))
        paths.append(path)
    return paths


def run_shards(folder, mesh, paths, steps=2):
    t = maskgit_trainer(folder, mesh=mesh, shard_state=True, grad_accum_every=1, num_train_steps=steps, max_grad_norm=None)
    t.train_from_shards(paths, num_threads=1, prefetch=0)
    return dict(params=t._state()["params"], steps=t.steps)


def shard_reference_batches(paths, steps=2, world=2):
    """The global batches a `world`-rank `train_from_shards` trains on: each
    rank's loader (its shards, its seed) stacked in rank order."""
    loaders = [ShardLoader(paths, B // world, seed=0, num_threads=1, process_index=r, process_count=world) for r in range(world)]
    try:
        out = []
        for _ in range(steps):
            ids = np.concatenate([ld.next_batch().astype(np.int32) for ld in loaders])
            out.append((ids[None], np.zeros((1, B, 1, TEXT_DIM), np.float32), np.zeros((1, B, 1), bool)))
        return out
    finally:
        for ld in loaders:
            ld.close()


def run_generate(mesh, world: int = 2):
    """This rank's rows of one `generate` batch (K1's noise keyed on the
    global rows), and a pipeline's images over the mesh."""
    model = pipeline_model()
    te, tm = generate_inputs()
    per = te.shape[0] // world
    start = dist.get_rank() * per if dist.is_initialized() else 0
    stop = start + per if dist.is_initialized() else te.shape[0]
    with rows_from(start):
        ids = model.generate(
            text_embeds=te[start:stop], text_mask=tm[start:stop], generator=torch.Generator().manual_seed(11),
            timesteps=3, return_ids=True,
        )
    pipe = GeneratePipeline(model, batch_size=4, timesteps=3, text_len=8, seed=7, return_pil=False, mesh=mesh, device="cpu")
    return dict(ids=ids, start=start, images=pipe(PROMPTS[:6]), scaled=pipe(PROMPTS[:3], cond_scale=[1.0, 2.0, 4.0]))


# -- the spawned side ----------------------------------------------------------------


def main(rank: int, world: int, store_path: str, out_dir: str, shard_paths):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks talk over the loopback interface only
    store = dist.FileStore(store_path, world)
    init_distributed(backend="gloo", store=store, rank=rank, world_size=world)
    out = Path(out_dir)
    scenarios = {
        "maskgit_rep": lambda mesh: run_maskgit(out / "rep", mesh, False),
        "maskgit_shard": lambda mesh: run_maskgit(out / "shard", mesh, True),
        "indivisible": lambda mesh: run_indivisible(out / "indiv", mesh),
        "resume": lambda mesh: run_resume(out / "resume", mesh),
        "gan_lfq": lambda mesh: run_gan(out / "lfq", "lfq", mesh, True),
        "gan_ema": lambda mesh: run_gan(out / "ema", "ema", mesh, False),
        "shards": lambda mesh: run_shards(out / "shards", mesh, shard_paths),
        "generate": lambda mesh: run_generate(mesh),
    }
    try:
        mesh = create_mesh()
        for name, fn in scenarios.items():
            try:
                result = fn(mesh)
            except Exception:  # recorded for the test to show; the other scenarios still run
                result = {"error": traceback.format_exc()}
            torch.save(result, out / f"{name}.{rank}.pt")
            dist.barrier()
    finally:
        dist.destroy_process_group()
