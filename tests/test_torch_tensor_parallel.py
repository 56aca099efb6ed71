"""The port's tensor parallelism (`parallel.tensor`, `shard_state_rules=`,
`shard_module`) on meshes with a `tensor` axis, against the JAX package and
against the port's own single-process run.

One spawn of four gloo ranks on the CPU (`tests/torch_tp_workers.py`,
torch and the port only) runs every scenario on {data: 2, tensor: 2} and
the trainer on {fsdp: 2, tensor: 2}; the references run in the test
process. Tolerances, f32:

  * the TP forward of `tests/test_parallel.py:84`'s transformer (and of one
    whose FF inner dim, 85, is odd and runs whole) against JAX's logits of
    the same weights (the port's, from a seed, through the weight bridge):
    atol 1e-4, as that test holds JAX's own TP forward;
  * `MaskGitTrainer(shard_state=True, shard_state_rules=DEFAULT_TP_RULES)`,
    3 steps, against one process: losses rtol 2e-5 / atol 2e-6 and every
    parameter rtol 2e-4 / atol 2e-4, as `tests/test_fsdp.py:127` holds
    JAX's; per-rank state bytes below 0.7 of the total and the largest leaf
    at most half on a rank;
  * `VQGanVAETrainer` with the rules (they match no VAE leaf): the limits
    `tests/test_torch_parallel.py` holds its two-rank GAN runs to;
  * an 18-step `generate` under injected noise on a `shard_module`d model:
    ids equal, and a `GeneratePipeline(mesh=)`'s images equal, on
    {data: 2, tensor: 2} and with the model split four ways on {tensor: 4};
  * a TP trainer's checkpoint and EMA model file read by one process and by
    JAX's `load_module`: bit-equal.

`test_trainer_3d_mesh_data_fsdp_tensor` (marked slow) spawns eight ranks
for JAX's `tests/test_fsdp.py:311` mesh {data: 2, fsdp: 2, tensor: 2}.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax import nnx

from muse_maskgit_pytorch_tpu.models import transformer as jt
from muse_maskgit_pytorch_tpu.models.maskgit import MaskGit as JMaskGit
from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu.utils.checkpoint import load_module as jax_load_module
from muse_maskgit_pytorch_tpu_torch.models import transformer as pt
from muse_maskgit_pytorch_tpu_torch.ops.attention import qknorm_attend
from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import load_module, load_train_state
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, to_jax_state
from tests import torch_dist_workers as dw
from tests import torch_tp_workers as workers
from tests.torch_threads import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

MESHES = [{"data": 2, "tensor": 2}, {"fsdp": 2, "tensor": 2}]
MESH_IDS = ["data2-tensor2", "fsdp2-tensor2"]
LOSS_TOL, PARAM_TOL = dict(rtol=2e-5, atol=2e-6), dict(rtol=2e-4, atol=2e-4)


def _start(out: Path, world: int, shapes):
    return mp.start_processes(
        workers.main, args=(world, str(out / "store"), str(out), shapes), nprocs=world, join=False, start_method="spawn"
    )


def _results(ctx, out: Path, world: int):
    while not ctx.join(timeout=300):
        pass
    results = {}
    for f in sorted(out.glob("*.*.*.pt")):
        name, rank = f.stem.rsplit(".", 1)
        results.setdefault(name, [None] * world)[int(rank)] = torch.load(f, weights_only=False)
    return results


def _port_model(kind, out: Path):
    """The toy transformer `kind` from a seed, written where the ranks read it."""
    pm = pt.MaskGitTransformer(device="cpu", generator=torch.Generator().manual_seed(0), **workers.FORWARD_KW[kind])
    torch.save(pm.state_dict(), out / f"{kind}.pt")
    return pm


def _jax_logits(kind, pm):
    """JAX's logits of the toy transformer `kind` holding the port model's
    weights (built abstractly, then filled through the weight bridge)."""
    jm = nnx.eval_shape(lambda: jt.MaskGitTransformer(rngs=nnx.Rngs(0), **workers.FORWARD_KW[kind]))
    state = nnx.state(jm)
    state.replace_by_pure_dict(jax.tree.map(jnp.asarray, to_jax_state(pm)))
    graphdef = nnx.graphdef(jm)
    ids, te = workers.forward_inputs(kind)
    fwd = jax.jit(lambda state, x, te: nnx.merge(graphdef, state)(x, text_embeds=te))
    return np.asarray(fwd(state, jnp.asarray(ids.numpy()), jnp.asarray(te.numpy())))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four ranks that runs every scenario (JAX's logits are
    computed while they run); name -> each rank's result, and JAX's
    forward logits."""
    out = tmp_path_factory.mktemp("tp_ranks")
    models = {kind: _port_model(kind, out) for kind in workers.FORWARD_KW}
    ctx = _start(out, 4, MESHES)
    jax_logits = {kind: _jax_logits(kind, pm) for kind, pm in models.items()}
    return _results(ctx, out, 4), jax_logits


def _ok(ranks, name):
    results, _ = ranks
    got = results[name]
    for r in got:
        assert r is not None and "error" not in r, r and r.get("error")
    return got


@pytest.mark.parametrize("kind", list(workers.FORWARD_KW))
def test_tp_forward_matches_jax(ranks, kind):
    got = _ok(ranks, "forward.data2-tensor2")
    _, jax_logits = ranks
    # ranks 0, 1 hold data rows 0-1, ranks 2, 3 rows 2-3; the tensor ranks agree
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(got[a][kind].numpy(), got[b][kind].numpy())
    logits = torch.cat([got[0][kind], got[2][kind]]).numpy()
    np.testing.assert_allclose(logits, jax_logits[kind], atol=1e-4)
    split = set(got[0][f"{kind}_split"].values())
    if kind == "jax84":  # heads 4, FF inner 170, vocab head 32 rows: all split; 33 embedding rows do not
        assert split == {"Attention", "FeedForward", "MaskGitTransformer"}
    else:  # FF inner 85 runs whole; the vocab head (63 rows) whole, the embedding (64 rows) split
        assert split == {"Attention", "MaskGitTransformer"}


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    return workers.run_maskgit(tmp_path_factory.mktemp("tp_ref") / "ref", None, tp=False)


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_maskgit_trainer_tp_matches_one_process(ranks, one_process, mesh):
    got = _ok(ranks, f"maskgit.{mesh}")
    want = one_process
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], **LOSS_TOL)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"], rtol=1e-4)
        for key in ("params", "ema"):
            for n, w in want[key].items():
                np.testing.assert_allclose(r[key][n].detach().numpy(), w.detach().numpy(), **PARAM_TOL, err_msg=f"{key} {n}")
        # the state genuinely distributed, as JAX's test_fsdp.py:127 and :311 require
        assert r["local"] < 0.7 * r["total"], (r["local"], r["total"])
        assert r["largest_share"] <= 0.5
    # every rank holds the same whole state after the gather
    for k in ("params", "ema", "mu"):
        assert all(torch.equal(got[0][k][n], r[k][n]) for r in got[1:] for n in got[0][k])


def _jax_maskgit():
    from muse_maskgit_pytorch_tpu.models.transformer import MaskGitTransformer as JTransformer

    t = JTransformer(
        num_tokens=dw.VOCAB, dim=64, seq_len=dw.SEQ, depth=2, dim_head=16, heads=4, text_embed_dim=dw.TEXT_DIM,
        self_cond=True, rngs=nnx.Rngs(0),
    )
    vae = JVAE(dim=16, layers=2, codebook_size=dw.VOCAB, use_vgg_and_gan=False, rngs=nnx.Rngs(0))
    return JMaskGit(image_size=dw.IMAGE, transformer=t, vae=vae, self_token_critic=True, rngs=nnx.Rngs(1))


def test_tp_checkpoint_reads_whole_in_one_process_and_in_jax(ranks):
    got = _ok(ranks, "maskgit.data2-tensor2")[0]
    state, step = load_train_state(Path(got["folder"]) / "checkpoints")
    assert step == workers.STEPS
    for n, w in got["params"].items():
        assert torch.equal(state["params"][n], w), n
    pm = dw.maskgit_model(seed=9)
    load_module(pm, got["model_path"])
    live = dict(pm.named_parameters())
    for n, w in got["ema"].items():
        assert torch.equal(live[n], w), n
    jm = nnx.eval_shape(_jax_maskgit)  # every leaf the file holds is loaded into it
    jax_load_module(jm, got["model_path"])
    want = flatten_tree(jax.tree.map(np.asarray, nnx.state(jm, (nnx.Param, nnx.BatchStat)).to_pure_dict()))
    have = flatten_tree(to_jax_state(pm))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], have[k], err_msg=k)


def test_gan_trainer_with_tp_rules_matches_one_process(ranks, tmp_path):
    """EMA-VQ (K3's plain version, k-means over the data ranks) with the
    rules on {data: 2, tensor: 2}: the state shards over data only."""
    got = _ok(ranks, "gan.data2-tensor2")
    want = dw.run_gan(tmp_path, "ema", None, False, lr=1e-5)
    for r in got:
        for step, rtol in ((0, 1e-5), (1, 1e-4)):
            for key in ("loss", "discr_loss", "grad_norm", "discr_grad_norm"):
                np.testing.assert_allclose(r["logs"][step][key], want["logs"][step][key], rtol=rtol, err_msg=key)
        for key in ("gen", "discr"):
            for n, w in want[key].items():
                assert float((r[key][n] - w).detach().abs().max()) <= 2 * 1e-5 * 2, (key, n)
        for n, buf in want["buffers"].items():
            np.testing.assert_allclose(r["buffers"][n].numpy(), buf.numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
    for r in got[1:]:
        for n in got[0]["buffers"]:
            assert torch.equal(got[0]["buffers"][n], r["buffers"][n]), n


def test_tp_generate_matches_one_process(ranks):
    got = _ok(ranks, "generate.data2-tensor2")
    want = workers.run_generate(None)
    for r in got:
        assert torch.equal(r["ids"], want["ids"])
        np.testing.assert_allclose(r["logits"].numpy(), want["logits"].numpy(), atol=1e-4)
        np.testing.assert_array_equal(r["images"], want["images"])
        np.testing.assert_array_equal(r["tensor4_images"], want["images"])


def test_all_gather_through_an_integer_all_reduce_is_exact(ranks):
    for r in _ok(ranks, "gather.data2-tensor2"):
        for got, want in zip(r["got"], r["want"]):
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)) if a.dtype != torch.bool else torch.equal(a, b)
        assert torch.signbit(r["got"][0][0][0, 0]) and r["got"][0][0][0, 0] == 0  # a -0.0 arrives as -0.0


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_k2_on_a_head_slice_equals_that_slice(cross):
    """What a tensor rank computes: K2 (its plain version here) on heads
    [2, 4) of (b, n, 4, 16) inputs -- q a dense slice, k and v views of one
    [k | v] projection -- equals heads [2, 4) of the whole, forward and
    gradients."""
    g = torch.Generator().manual_seed(3)
    b, n, m, h, d = 2, 9, 7 if cross else 9, 4, 16
    q = torch.randn(b, n, h, d, generator=g)
    k, v = torch.randn(b, m, 2 * h * d, generator=g).chunk(2, dim=-1)
    k, v = k.reshape(b, m, h, d), v.reshape(b, m, h, d)
    null_kv = torch.randn(2, h, d, generator=g)
    scales = 1 + 0.1 * torch.randn(2, d, generator=g)
    mask = torch.rand(b, m, generator=g) > 0.3 if cross else None
    cot = torch.randn(b, n, h, d, generator=g)

    def run(heads):
        leaves = [t.detach().requires_grad_() for t in (q, k, v, null_kv, scales)]
        qq, kk, vv, nkv, sc = leaves
        out = qknorm_attend(
            qq[:, :, heads], kk[:, :, heads], vv[:, :, heads], null_k=nkv[0, heads], null_v=nkv[1, heads],
            q_scale=sc[0], k_scale=sc[1], mask=mask,
        )
        grads = torch.autograd.grad(out, leaves, cot[:, :, heads])
        return out, grads

    whole, _ = run(slice(0, 4))
    part, grads = run(slice(2, 4))
    np.testing.assert_allclose(part.detach().numpy(), whole[:, :, 2:].detach().numpy(), atol=1e-6)
    # the slice's gradients land on its heads only
    for t in grads[:3]:
        assert not t[:, :, :2].any()
    assert not grads[3][:, :2].any()


@pytest.mark.slow
def test_trainer_3d_mesh_data_fsdp_tensor(tmp_path):
    """JAX's tests/test_fsdp.py:311 on eight gloo ranks: batch over data,
    state over fsdp, the TP rules over tensor; loss within 2e-4 of the
    one-process run's, the largest leaf at most half on a rank."""
    shape = {"data": 2, "fsdp": 2, "tensor": 2}
    got = _results(_start(tmp_path, 8, [shape]), tmp_path, 8)["maskgit.data2-fsdp2-tensor2"]
    want = workers.run_maskgit(tmp_path / "ref", None, tp=False)
    for r in got:
        assert r is not None and "error" not in r, r and r.get("error")
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=0, atol=2e-4)
        assert r["largest_share"] <= 0.5
    shutil.rmtree(tmp_path, ignore_errors=True)
