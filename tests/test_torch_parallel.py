"""The port's data-parallel and FSDP training and serving
(`muse_maskgit_pytorch_tpu_torch.parallel`) against the JAX package's mesh
specs and against the port's own single-process run.

Spec parity, in one process: for a toy `MaskGitTransformer` and a toy
`VQGanVAE`, on meshes {data: 8}, {data: 4, fsdp: 2}, {data: 2, tensor: 2},
{data: 4, tensor: 2}, {data: 2, fsdp: 2, tensor: 2} and the trivial one,
every leaf's placement read back as a spec and put in
flax's layout through the weight bridge's names and transposes equals
JAX's `fsdp_partition_specs` (with and without `DEFAULT_TP_RULES`) and
`partition_specs_for` spec for the same leaf.

Two gloo ranks against one, at the same global batch: one spawn of two
processes on the CPU (`tests/torch_dist_workers.py`, which imports torch
and the port only) runs every scenario and writes its results; the one-rank
references run in the test process. Tolerances (f32): losses and gradient
norms within 1e-5 relative; each parameter's change over the steps against
one rank's change within 1e-4 of the leaf's largest change plus 8 ulps of
the weight, for all but 0.1% of a leaf's entries, and every entry within
2 * lr * steps (the rule `tests/test_torch_vqgan_trainer.py` holds the
port to JAX by: two ranks sum a gradient in another order than one, and
Adam's first steps move a weight by about lr whatever its gradient's size,
so an entry whose gradient is at rounding level may move either way). The
GAN runs at lr 1e-5, where that file's parity runs, the MaskGit at 1e-3.
Token ids from `GeneratePipeline(mesh=)` are equal; a resume from a sharded
checkpoint continues bit for bit; codebooks are equal on both ranks.
"""

import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax import nnx

from muse_maskgit_pytorch_tpu.models import transformer as jt
from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu.parallel import mesh as jmesh
from muse_maskgit_pytorch_tpu_torch.models import transformer as pt
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import VQGanVAE
from muse_maskgit_pytorch_tpu_torch.parallel import mesh as pmesh
from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import load_module
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import _module_rules, flatten_tree, to_jax_state
from tests import torch_dist_workers as workers
from tests.torch_threads import few_threads  # noqa: F401

# the one-rank references run beside the suite's other workers and the two
# spawned ranks (one thread each): two threads keep the cores from thrashing
pytestmark = pytest.mark.usefixtures("few_threads")

MESHES = [
    {"data": 8}, {"data": 4, "fsdp": 2}, {"data": 2, "tensor": 2}, {"data": 4, "tensor": 2},
    {"data": 2, "fsdp": 2, "tensor": 2}, {"data": 1},
]
MESH_IDS = ["data8", "data4-fsdp2", "data2-tensor2", "data4-tensor2", "data2-fsdp2-tensor2", "trivial"]


# -- spec parity with JAX, in one process ------------------------------------


def _toy_pair(kind):
    """(JAX state as a nested dict of shapes, the port module) of one
    configuration: the specs read only names and shapes, so the JAX module
    is built abstractly (`nnx.eval_shape`)."""
    if kind == "transformer":
        kw = dict(num_tokens=512, dim=128, seq_len=16, depth=2, dim_head=32, heads=4, text_embed_dim=32)
        j = nnx.eval_shape(lambda: jt.MaskGitTransformer(rngs=nnx.Rngs(0), **kw))
        p = pt.MaskGitTransformer(device="cpu", **kw)
    else:
        kw = dict(dim=64, layers=2, codebook_size=512, use_vgg_and_gan=True)
        j = nnx.eval_shape(lambda: JVAE(vgg=None, rngs=nnx.Rngs(0), **kw))
        p = VQGanVAE(device="cpu", **kw)
    return nnx.state(j, (nnx.Param, nnx.BatchStat)).to_pure_dict(), p


def _jax_path_of(module) -> dict:
    """port leaf name -> '/'-joined JAX path, through the bridge's rules."""
    out = {}
    for mod_name, mod in module.named_modules():
        for pname, jname, _, _ in _module_rules(mod):
            if getattr(mod, pname, None) is not None:
                port = f"{mod_name}.{pname}" if mod_name else pname
                out[port] = f"{mod_name}.{jname}".replace(".", "/") if mod_name else jname
    return out


def _flat_jax(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_jax(v, path + "/"))
        else:
            out[path] = v
    return out


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return jmesh.create_mesh(shape, devices=jax.devices()[:n])


def _jax_spec_tuple(spec, ndim):
    parts = list(tuple(spec)) + [None] * (ndim - len(tuple(spec)))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _port_spec_in_flax_layout(spec, order, ndim):
    """A port spec (port dims) as the spec of the flax layout's dims."""
    parts = list(spec) + [None] * (ndim - len(spec))
    order = order or tuple(range(ndim))
    flax = [parts[order[j]] for j in range(ndim)]
    while flax and flax[-1] is None:
        flax.pop()
    return tuple(flax)


@pytest.mark.parametrize("kind", ["transformer", "vae"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_specs_match_jax(kind, shape):
    state, module = _toy_pair(kind)
    flat = _flat_jax(state)
    paths = _jax_path_of(module)
    orders = pmesh.jax_dim_orders(module)
    leaves = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    assert set(paths.values()) == set(flat), set(paths.values()) ^ set(flat)
    jm = _jax_mesh(shape)

    jax_fsdp = _flat_jax(jax.tree.map(tuple, jmesh.fsdp_partition_specs(state, jm), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    jax_tp = _flat_jax(jax.tree.map(tuple, jmesh.partition_specs_for(state), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    jax_2d = _flat_jax(jax.tree.map(tuple, jmesh.fsdp_partition_specs(state, jm, base_rules=jmesh.DEFAULT_TP_RULES), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))

    port_fsdp = pmesh.fsdp_partition_specs(module, shape)
    port_2d = pmesh.fsdp_partition_specs(module, shape, base_rules=pmesh.DEFAULT_TP_RULES)
    port_tp = pmesh.partition_specs_for(module)
    sharded = 0
    for name, leaf in leaves.items():
        path, nd, order = paths[name], leaf.dim(), orders.get(name)
        for port, want in ((port_fsdp, jax_fsdp), (port_2d, jax_2d)):
            spec = pmesh.to_spec(port[name], shape, nd)
            got = _port_spec_in_flax_layout(spec, order, nd)
            assert got == _jax_spec_tuple(want[path], nd), (name, path, port[name], want[path])
            assert len(port[name]) == len(shape)
        got = _port_spec_in_flax_layout(port_tp[name], order, nd)
        assert got == _jax_spec_tuple(jax_tp[path], nd), (name, path, port_tp[name], jax_tp[path])
        sharded += any(isinstance(p, pmesh.Shard) for p in port_fsdp[name])
    if shape.get("data", 1) * shape.get("fsdp", 1) > 1:
        assert sharded >= 4  # the big leaves, ties between equal dims among them
    else:
        assert sharded == 0
    if kind == "transformer":
        assert any(s for s in port_tp.values())


def test_mesh_helpers_without_a_process_group():
    mesh = pmesh.create_mesh()
    assert isinstance(mesh, pmesh.TrivialMesh) and pmesh.mesh_axes(mesh) == {"data": 1}
    assert pmesh.mesh_axes(pmesh.create_mesh({"data": -1, "tensor": 1})) == {"data": 1, "tensor": 1}
    with pytest.raises(ValueError, match="init_distributed"):
        pmesh.create_mesh({"data": 2})
    assert pmesh.is_main_process() and pmesh.fsdp_axis_for(mesh) is None
    assert pmesh.fsdp_axis_for({"data": 2, "fsdp": 4}) == "fsdp" and pmesh.fsdp_axis_for({"data": 8}) == "data"
    x = torch.arange(12).reshape(6, 2)
    assert pmesh.shard_batch({"x": x}, mesh)["x"] is x
    assert pmesh.replicate([x], mesh)[0] is x
    tree = {"w": torch.zeros(256, 256), "b": torch.zeros(16)}
    assert pmesh.shard_tree(tree, mesh) == tree
    assert pmesh.sharded_state_bytes(tree) == (4 * (256 * 256 + 16),) * 2
    placements = pmesh.fsdp_partition_specs(tree, {"data": 2, "fsdp": 4})
    assert placements["w"] == (pmesh.Replicate(), pmesh.Shard(0)) and placements["b"] == (pmesh.Replicate(),) * 2
    assert pmesh.fsdp_partition_specs(tree, mesh)["w"] == (pmesh.Replicate(),)
    two_d = {"data": 2, "fsdp": 4}
    assert pmesh.state_shardings(tree, two_d)["w"] == (two_d, placements["w"])
    assert pmesh.to_spec(placements["w"], two_d, 2) == ("fsdp",)


# -- two gloo ranks against one ----------------------------------------------------

LOG_RTOL = 1e-5
DELTA_REL, ROUND_ULPS, LEAF_SHARE = 1e-4, 8, 0.999
MASKGIT_LR, GAN_LR, GAN_STEPS = 1e-3, 1e-5, 2
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of two ranks that runs every scenario; name -> [rank 0's
    result, rank 1's]."""
    out = tmp_path_factory.mktemp("ranks")
    paths = workers.shard_files(out)
    ShardLoaderWarm = workers.ShardLoader(paths, 2, num_threads=1)  # builds the native loader before the spawn
    ShardLoaderWarm.close()
    ctx = mp.start_processes(
        workers.main, args=(WORLD, str(out / "store"), str(out), paths), nprocs=WORLD, join=False,
        start_method="spawn",
    )
    while not ctx.join(timeout=300):
        pass
    results = {}
    for f in sorted(out.glob("*.*.pt")):
        name, rank = f.stem.rsplit(".", 1)
        results.setdefault(name, [None] * WORLD)[int(rank)] = torch.load(f, weights_only=False)
    return results, paths


def _ok(ranks, name):
    results, _ = ranks
    got = results[name]
    for r in got:
        assert r is not None and "error" not in r, r and r.get("error")
    return got


def _change_close(got: dict, want: dict, start: dict, lr: float, steps: int, what: str):
    """Each leaf's change from `start` against one rank's, by the rule in
    the module's docstring."""
    assert got.keys() == want.keys()
    for n in want:
        g, w, s = (t[n].detach().double().numpy() for t in (got, want, start))
        err = np.abs(g - w)
        largest = max(float(np.abs(w - s).max()), 1e-30)
        tol = DELTA_REL * largest + ROUND_ULPS * np.spacing(np.maximum(np.abs(s), np.abs(w)).astype(np.float32))
        assert err.max() <= 2 * lr * steps, (what, n, float(err.max()))
        outside = int((err > tol).sum())
        assert outside <= math.ceil((1 - LEAF_SHARE) * err.size), (what, n, outside, err.size, float(err.max() / largest))


def _start_params():
    t = workers.maskgit_model()
    return {n: p.detach().clone() for n, p in t.named_parameters() if n.split(".")[0] not in ("vae", "cond_vae")}


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_maskgit_trainer_two_ranks_match_one(ranks, tmp_path, mode):
    got = _ok(ranks, "maskgit_rep" if mode == "replicated" else "maskgit_shard")
    want = workers.run_maskgit(tmp_path, None, False)
    start = _start_params()
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOG_RTOL)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"], rtol=LOG_RTOL)
        _change_close(r["params"], want["params"], start, MASKGIT_LR, 3, "params")
        _change_close(r["ema"], want["ema"], start, MASKGIT_LR, 3, "ema")
    # every rank holds the same whole state after the gather
    for k in ("params", "ema", "mu"):
        assert all(torch.equal(got[0][k][n], got[1][k][n]) for n in got[0][k])
    if mode == "sharded":
        assert got[0]["local"] < 0.85 * got[0]["total"], (got[0]["local"], got[0]["total"])  # the FF and head leaves shard
    else:
        assert got[0]["local"] == got[0]["total"]


def test_indivisible_batch_warns_and_stays_whole(ranks, tmp_path):
    got = _ok(ranks, "indivisible")
    want = workers.run_indivisible(tmp_path, None)
    assert not want["warned"] and all(r["warned"] for r in got)
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=LOG_RTOL)


def test_sharded_resume_is_exact_and_jax_reads_the_file(ranks, tmp_path):
    got = _ok(ranks, "resume")
    for r in got:
        assert r["got"] == r["want"] and r["same"] and r["steps"] == 3
    assert got[0]["replaced"] and not got[1]["replaced"]  # rank 0 alone renamed a file into place
    # the JAX package's load_module reads the two-rank run's EMA model
    from muse_maskgit_pytorch_tpu.models.maskgit import MaskGit as JMaskGit
    from muse_maskgit_pytorch_tpu.models.transformer import MaskGitTransformer as JTransformer
    from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
    from muse_maskgit_pytorch_tpu.utils.checkpoint import load_module as jax_load_module

    results, _ = ranks
    path = Path(got[0]["replaced"][-1])
    def build():
        jt = JTransformer(
            num_tokens=workers.VOCAB, dim=64, seq_len=workers.SEQ, depth=2, dim_head=16, heads=4,
            text_embed_dim=workers.TEXT_DIM, self_cond=True, rngs=nnx.Rngs(0),
        )
        jvae = JVAE(dim=16, layers=2, codebook_size=workers.VOCAB, use_vgg_and_gan=False, rngs=nnx.Rngs(0))
        return JMaskGit(image_size=workers.IMAGE, transformer=jt, vae=jvae, self_token_critic=True, rngs=nnx.Rngs(1))

    jm = nnx.eval_shape(build)  # every leaf the file holds is loaded into it
    jax_load_module(jm, path)
    pm = workers.maskgit_model(seed=9)
    load_module(pm, path)
    want = flatten_tree(jax.tree.map(np.asarray, nnx.state(jm, (nnx.Param, nnx.BatchStat)).to_pure_dict()))
    have = flatten_tree(to_jax_state(pm))
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], have[k], err_msg=k)


@pytest.mark.parametrize("quantizer", ["lfq", "ema"])
def test_gan_trainer_two_ranks_match_one(ranks, tmp_path, quantizer):
    """LFQ sharded, EMA-VQ replicated; step 0 takes the R1 penalty. The
    first step's gradients (what the optimizers are handed) and logs match
    one rank's at f32 rounding; after it the two runs part where Adam moved
    an entry whose gradient was at rounding level (this toy discriminator's
    1 x 1 last maps give many such entries), so the second step's logs are
    held to 1e-4 and the weights to the 2 * lr * steps bound."""
    got = _ok(ranks, f"gan_{quantizer}")
    want = workers.run_gan(tmp_path, quantizer, None, quantizer == "lfq", lr=GAN_LR)
    for r in got:
        for step, rtol in ((0, LOG_RTOL), (1, 10 * LOG_RTOL)):
            for key in ("loss", "discr_loss", "grad_norm", "discr_grad_norm"):
                np.testing.assert_allclose(r["logs"][step][key], want["logs"][step][key], rtol=rtol, err_msg=key)
        for key in ("gen_grads", "discr_grads"):
            for n, g in want[key][0].items():
                err = float((r[key][0][n] - g).abs().max())
                assert err <= LOG_RTOL * max(float(g.abs().max()), 1e-30), (key, n, err)
        for key in ("gen", "discr"):
            for n, w in want[key].items():
                assert float((r[key][n] - w).abs().max()) <= 2 * GAN_LR * GAN_STEPS, (key, n)
        for n, buf in want["buffers"].items():
            np.testing.assert_allclose(r["buffers"][n].numpy(), buf.numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
    # the codebook and its statistics are one on both ranks
    for n in got[0]["buffers"]:
        assert torch.equal(got[0]["buffers"][n], got[1]["buffers"][n]), n


def test_train_from_shards_two_processes(ranks, tmp_path):
    got = _ok(ranks, "shards")
    _, paths = ranks
    t = workers.maskgit_trainer(tmp_path, grad_accum_every=1, max_grad_norm=None)
    for batch in workers.shard_reference_batches(paths):
        t.train_step_arrays(*batch)
    want = t._state()["params"]
    start = _start_params()
    for r in got:
        assert r["steps"] == 2
        _change_close(r["params"], want, start, MASKGIT_LR, 2, "params")


def test_generate_over_a_mesh_matches_one_process(ranks):
    got = _ok(ranks, "generate")
    want = workers.run_generate(pmesh.create_mesh())
    ids = torch.cat([r["ids"] for r in sorted(got, key=lambda r: r["start"])])
    assert torch.equal(ids, want["ids"])
    for r in got:
        np.testing.assert_array_equal(r["images"], want["images"])
        np.testing.assert_array_equal(r["scaled"], want["scaled"])


# -- the pieces a rank's share rests on, in one process --------------------------------


def test_philox_row_offset_is_the_global_rows():
    """K1's plain version keys its noise on `row_offset + row`: a rank's
    rows draw what the whole batch draws there, and sample alike."""
    from muse_maskgit_pytorch_tpu_torch.ops import sampling_kernel as sk

    whole = sk.philox_gumbel(5, 12, 40)
    assert torch.equal(sk.philox_gumbel(5, 7, 40, row_offset=5), whole[5:])
    logits = torch.randn(12, 40, generator=torch.Generator().manual_seed(0))
    seed = torch.tensor([5], dtype=torch.int32)
    idx, prob = sk.fused_topk_gumbel_sample(logits, 8, 1.0, seed)
    idx_off, prob_off = sk.fused_topk_gumbel_sample(logits[5:], 8, 1.0, seed, row_offset=5)
    assert torch.equal(idx_off, idx[5:]) and torch.equal(prob_off, prob[5:])


def test_generate_row_offset_xla_sampler_equals_the_whole_batch():
    """The exact sampler's noise is K1's stream keyed on the global row
    (`philox_gumbel_noise`): rows 2-3 decoded under `rows_from(2)` are rows
    2-3 of the whole batch of 4, through the compact steps too."""
    from muse_maskgit_pytorch_tpu_torch.parallel.batch import rows_from

    model = workers.pipeline_model()
    te, tm = workers.generate_inputs(4)
    kw = dict(timesteps=4, sampler="xla", return_ids=True)
    whole = model.generate(generator=torch.Generator().manual_seed(6), text_embeds=te, text_mask=tm, **kw)
    with rows_from(2):
        part = model.generate(generator=torch.Generator().manual_seed(6), text_embeds=te[2:], text_mask=tm[2:], **kw)
    assert torch.equal(part, whole[2:])
    # the rows' own noise: decoded as a batch of their own, they differ
    alone = model.generate(generator=torch.Generator().manual_seed(6), text_embeds=te[2:], text_mask=tm[2:], **kw)
    assert not torch.equal(alone, whole[2:])


def test_loss_denominator_and_draw_rows():
    """A rank's cross entropy is its sum over its share of the global
    masked count; its draws are its rows of the global batch's."""
    from muse_maskgit_pytorch_tpu_torch.models.transformer import cross_entropy_ignore_index

    g = torch.Generator().manual_seed(2)
    logits, labels = torch.randn(4, 6, 10, generator=g), torch.randint(-1, 10, (4, 6), generator=g)
    whole = cross_entropy_ignore_index(logits, labels, -1)
    count = float((labels != -1).sum())
    halves = [cross_entropy_ignore_index(logits[i : i + 2], labels[i : i + 2], -1, count / 2) for i in (0, 2)]
    assert torch.allclose((halves[0] + halves[1]) / 2, whole, rtol=1e-6)
    model = workers.maskgit_model()
    draws = model.train_draws((4, workers.SEQ), False, generator=torch.Generator().manual_seed(3))
    part = draws.rows(2, 4)
    assert torch.equal(part.mask_scores, draws.mask_scores[2:]) and torch.equal(part.gumbel, draws.gumbel[2:])
    assert part.self_cond_u is draws.self_cond_u
    assert float(model.masked_token_count(draws)) == float(model._num_masked(draws, workers.SEQ).sum())
