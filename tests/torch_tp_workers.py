"""The multi-rank side of `tests/test_torch_tensor_parallel.py`: the
scenarios that each of four gloo ranks runs on the CPU over meshes with a
`tensor` axis. Like `tests/torch_dist_workers.py`, whose builders it uses,
it imports torch and the port only, so the spawned processes never import
JAX.

`main(rank, world, store_path, out_dir, shapes)` joins a process group
through a `FileStore`, runs every scenario on each mesh of `shapes` that
its world fills, saves what each measured to `out_dir/<scenario>.<rank>.pt`
and leaves the group. The test process runs the same builders without a
process group for the one-rank references.
"""

from __future__ import annotations

import os
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from muse_maskgit_pytorch_tpu_torch import GeneratePipeline, MaskGit, MaskGitTransformer, VQGanVAE
from muse_maskgit_pytorch_tpu_torch.parallel import DEFAULT_TP_RULES, create_mesh, init_distributed, shard_batch, sharded_state_bytes
from muse_maskgit_pytorch_tpu_torch.parallel.tensor import all_gather, gather_by_all_reduce, shard_module
from tests import torch_dist_workers as dw

STEPS = 3
# test_parallel.py:84's transformer; then one whose FF inner dim (85) is odd
# and whose token table (63 + the mask id) splits
FORWARD_KW = {
    "jax84": dict(num_tokens=32, dim=64, seq_len=16, depth=1, dim_head=16, heads=4, text_embed_dim=32),
    "odd_ff": dict(num_tokens=63, dim=32, seq_len=16, depth=2, dim_head=8, heads=4, text_embed_dim=32),
}


def tp_trainer(folder, mesh=None, tp=True, **kw):
    """`dw.maskgit_trainer` with the TP rules on a sharded state."""
    rules = dict(shard_state=True, shard_state_rules=DEFAULT_TP_RULES) if tp else {}
    return dw.maskgit_trainer(folder, mesh=mesh, **(rules | kw))


def run_maskgit(folder, mesh, tp=True):
    """STEPS steps from one seed; the whole state after them, the per-rank
    bytes, the largest leaf's share on this rank, a checkpoint and the EMA
    model written by rank 0."""
    t = tp_trainer(folder, mesh=mesh, tp=tp)
    logs = [t.train_step_arrays(*b) for b in dw.maskgit_batches(STEPS)]
    total, local = sharded_state_bytes(t.state)
    largest = max(t.state["params"].values(), key=lambda x: x.numel())
    share = (largest.to_local().numel() if hasattr(largest, "to_local") else largest.numel()) / largest.numel()
    state = t._state()
    t.save()
    model_path = Path(folder) / "maskgit.ema.msgpack"
    t.maskgit_module(use_ema=True).save(model_path)
    return dict(
        loss=[x["loss"] for x in logs], grad_norm=[x["grad_norm"] for x in logs], params=state["params"],
        ema=state["ema"], mu=state["opt"]["mu"], total=total, local=local, largest_share=share,
        folder=str(folder), model_path=str(model_path),
    )


def run_gan(folder, mesh):
    """EMA-VQ with the rules: they match no VAE leaf, so the state shards
    over the fsdp (here data) axis only and the tensor ranks replicate."""
    return dw.run_gan(folder, "ema", mesh, True, lr=1e-5, shard_state_rules=DEFAULT_TP_RULES)


def forward_inputs(kind: str, b: int = 4, seed: int = 0):
    kw = FORWARD_KW[kind]
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, kw["num_tokens"] + 1, (b, kw["seq_len"]))
    te = rs.randn(b, 5, kw["text_embed_dim"]).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(te)


def run_forward(state_dir, mesh):
    """Each bridged toy transformer (`<kind>.pt`, written by the test
    process) made tensor-parallel by `shard_module`: this rank's rows of
    the logits (the batch over `data`) and of a loss's gradients."""
    out = {}
    for kind, kw in FORWARD_KW.items():
        model = MaskGitTransformer(device="cpu", **kw)
        model.load_state_dict(torch.load(Path(state_dir) / f"{kind}.pt"))
        shard_module(model, mesh)
        ids, te = (shard_batch(t, mesh) for t in forward_inputs(kind))
        with torch.no_grad():
            out[kind] = model(ids, text_embeds=te)
        out[f"{kind}_split"] = {n: type(m).__name__ for n, m in model.named_modules() if getattr(m, "tensor_split", None)}
    return out


def generate_model() -> MaskGit:
    """A toy f32 base stage whose heads, FF and vocab head all split two
    ways. No self-conditioning: at this width its feedback multiplies a
    rounding-level difference in the logits by about 3.5 a step (1e-5 at
    step 0, a changed argmax at step 9), so no two summation orders would
    keep one grid over 18 steps."""
    gen = torch.Generator().manual_seed(7)
    t = MaskGitTransformer(
        num_tokens=dw.VOCAB, dim=64, seq_len=dw.SEQ, depth=2, dim_head=16, heads=4,
        t5_name=dw.TINY_T5, device="cpu", generator=gen,
    )
    vae = VQGanVAE(dim=16, layers=2, codebook_size=dw.VOCAB, use_vgg_and_gan=False, device="cpu", generator=gen)
    return MaskGit(image_size=dw.IMAGE, transformer=t, vae=vae, device="cpu").eval()


def injected_noise(b: int, steps: int = 18):
    return torch.from_numpy(-np.log(-np.log(np.random.RandomState(5).uniform(1e-6, 1.0, (steps, b, dw.SEQ, dw.VOCAB)))).astype(np.float32))


def run_generate(mesh):
    """18 f32 steps under injected noise (every rank the whole batch), the
    first step's logits, and a pipeline over the mesh (its batch on `data`);
    then the pipeline of a model split four ways over a mesh whose first
    axis is `tensor` (every rank decodes the whole batch)."""
    model = generate_model()
    if mesh is not None:
        shard_module(model.transformer, mesh)
    te, tm = dw.generate_inputs()
    with torch.no_grad():
        ids = model.generate(text_embeds=te, text_mask=tm, injected_gumbel_noise=injected_noise(te.shape[0]), return_ids=True)
        logits = model.transformer.forward_with_cond_scale(
            torch.full((te.shape[0], dw.SEQ), model.mask_id), text_embeds=te, text_mask=tm, cond_scale=3.0,
        )
    pipe = GeneratePipeline(model, batch_size=4, timesteps=3, text_len=8, seed=7, return_pil=False, mesh=mesh, device="cpu")
    out = dict(ids=ids, logits=logits, images=pipe(dw.PROMPTS[:6]))
    if mesh is not None:
        tensor4 = create_mesh({"tensor": dist.get_world_size()})
        model = generate_model()
        shard_module(model.transformer, tensor4)
        pipe = GeneratePipeline(model, batch_size=4, timesteps=3, text_len=8, seed=7, return_pil=False, mesh=tensor4, device="cpu")
        out["tensor4_images"] = pipe(dw.PROMPTS[:6])
    return out


def run_gather(mesh):
    """`all_gather` through the integer all-reduce against gloo's own, on
    the tensor group: f32 with a -0.0, bf16, int64 and bool, odd sizes."""
    from muse_maskgit_pytorch_tpu_torch.parallel.tensor import tensor_split

    split = tensor_split(mesh)
    g = torch.Generator().manual_seed(split.rank)
    x = torch.randn(3, 5, generator=g)
    x[0, 0] = -0.0
    tensors = (x, x.to(torch.bfloat16), torch.randint(-9, 9, (7,), generator=g), torch.rand(5, generator=g) > 0.5)
    got = [gather_by_all_reduce(t, split.group) for t in tensors]
    want = [all_gather(t, split.group) for t in tensors]
    return dict(got=got, want=want)


def scenarios(out: Path, shape: dict):
    tag = "-".join(f"{k}{v}" for k, v in shape.items())
    if shape == {"data": 2, "tensor": 2}:
        return {
            f"maskgit.{tag}": lambda mesh: run_maskgit(out / f"mg-{tag}", mesh),
            f"gan.{tag}": lambda mesh: run_gan(out / f"gan-{tag}", mesh),
            f"forward.{tag}": lambda mesh: run_forward(out, mesh),
            f"generate.{tag}": lambda mesh: run_generate(mesh),
            f"gather.{tag}": lambda mesh: run_gather(mesh),
        }
    return {f"maskgit.{tag}": lambda mesh: run_maskgit(out / f"mg-{tag}", mesh)}


def main(rank: int, world: int, store_path: str, out_dir: str, shapes):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks talk over the loopback interface only
    init_distributed(backend="gloo", device="cpu", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    out = Path(out_dir)
    try:
        for shape in shapes:
            mesh = create_mesh(shape)
            for name, fn in scenarios(out, shape).items():
                try:
                    result = fn(mesh)
                except Exception:  # recorded for the test to show; the other scenarios still run
                    result = {"error": traceback.format_exc()}
                torch.save(result, out / f"{name}.{rank}.pt")
                dist.barrier()
    finally:
        dist.destroy_process_group()
