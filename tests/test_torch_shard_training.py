"""Port parity of training from native token shards: the port's own ctypes
binding of `native/shard_loader.cpp` reads shards that the JAX package's
`write_shard` wrote in the same batch order (one loader thread), and
`MaskGitTrainer.train_from_shards` feeds a step the batches the JAX
trainer's feeds it: the bucket schedule over (seq_len, grid), the resume
skips, captions through the frozen T5 (toy T5, bridged weights), paired
conditioning ids, and the refusal of a bucket smaller than one batch. The
data path is compared with each trainer's step replaced by a recorder; one
port run then trains for real. CPU, toy size; batches exact, text
embeddings to 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import t5 as jt5
from muse_maskgit_pytorch_tpu.parallel.mesh import create_mesh
from muse_maskgit_pytorch_tpu.training.shard_loader import ShardLoader as JaxShardLoader
from muse_maskgit_pytorch_tpu.training.shard_loader import write_shard as jax_write_shard
from muse_maskgit_pytorch_tpu.training.trainers import MaskGitTrainer as JaxTrainer
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.training import MaskGitTrainer, ShardLoader, read_shard_header, write_shard
from muse_maskgit_pytorch_tpu_torch.training.shard_loader import caption_path_for
from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import latest_step
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state
from tests.torch_surface_pairs import TEXT_DIM, VOCAB, build_pair, jax_params

SHARD_T5 = "test/torch-shard-t5"
_T5 = dict(d_model=TEXT_DIM, d_ff=48, num_heads=2, d_kv=16, num_layers=1, gated=True)
jt5.T5_CONFIGS.setdefault(SHARD_T5, jt5.T5Config(**_T5))
pt5.T5_CONFIGS.setdefault(SHARD_T5, pt5.T5Config(**_T5))
BATCH = 4


@pytest.fixture(scope="module")
def tiny_t5():
    jm = jt5.T5Encoder(jt5.get_config(SHARD_T5), rngs=nnx.Rngs(11))
    pm = pt5.T5Encoder(pt5.get_config(SHARD_T5), device="cpu")
    assert load_jax_state(pm, jax_params(jm)) == []
    jt5.set_model(SHARD_T5, jm)
    pt5.set_model(SHARD_T5, pm)


@pytest.fixture(scope="module")
def pair():
    return build_pair(vae=False, t5_name=SHARD_T5)


def _captions(n, seed):
    rs = np.random.RandomState(seed)
    words = ["red", "cube", "a", "small", "green", "sphere", "on", "table", "two", "blue"]
    return [" ".join(rs.choice(words, rs.randint(1, 6))) for _ in range(n)]


def test_port_loader_reads_jax_shards_in_jax_order(tmp_path):
    rs = np.random.RandomState(0)
    paths = []
    for i, n in enumerate((13, 9)):
        p = tmp_path / f"s{i}.bin"
        jax_write_shard(p, rs.randint(0, VOCAB, (n, 16)).astype(np.int32), captions=_captions(n, i), grid=(2, 8))
        paths.append(p)
    assert read_shard_header(paths[0]) == {"num_seqs": 13, "seq_len": 16, "grid": (2, 8)}
    want = JaxShardLoader(paths, BATCH, seed=7, num_threads=1, skip_batches=3)
    got = ShardLoader(paths, BATCH, seed=7, num_threads=1, skip_batches=3)
    try:
        assert (got.num_seqs, got.batches_per_epoch, got.grid) == (want.num_seqs, want.batches_per_epoch, (2, 8))
        jcap, pcap = want.captioned(), got.captioned()
        for _ in range(12):  # past an epoch's end
            (wt, wc), (gt, gc) = next(jcap), next(pcap)
            np.testing.assert_array_equal(gt, wt)
            assert gc == wc
        assert got.delivered_batches == want.delivered_batches == 15
        jcap.close()
        pcap.close()
    finally:
        want.close()
        got.close()
    # and the port's writer writes the JAX package's bytes
    tokens = rs.randint(0, VOCAB, (5, 16)).astype(np.int32)
    jax_write_shard(tmp_path / "j.bin", tokens, captions=_captions(5, 3), grid=(4, 4))
    write_shard(tmp_path / "p.bin", tokens, captions=_captions(5, 3), grid=(4, 4))
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "p.bin").read_bytes()
    assert caption_path_for(tmp_path / "j.bin").read_bytes() == caption_path_for(tmp_path / "p.bin").read_bytes()


def _record(trainer, is_jax):
    """Replace the trainer's step by a recorder of what it is fed."""
    seen = []

    def step(tokens, tes, tms, cond_token_ids=None):
        seen.append([np.asarray(tokens), None if cond_token_ids is None else np.asarray(cond_token_ids),
                     np.asarray(tes, np.float32), np.asarray(tms)])
        if is_jax:
            trainer.state["step"] = trainer.state["step"] + 1
        else:
            trainer._step += 1
        return {"loss": 0.0}

    trainer.train_step_arrays = step
    return seen


def _buckets(tmp_path, cond_len=0):
    """Shards of three shapes: 16 ids on a 4 x 4 grid (two shards), 16 on
    2 x 8, and v1 shards of 16 (no grid); with `cond_len` each row carries
    that many conditioning ids after its target."""
    rs = np.random.RandomState(1)
    specs = [("a0", 11, (4, 4)), ("a1", 7, (4, 4)), ("b", 9, (2, 8)), ("c", 8, None)]
    paths = []
    for name, n, grid in specs:
        p = tmp_path / f"{name}.bin"
        jax_write_shard(p, rs.randint(0, VOCAB, (n, 16 + cond_len)).astype(np.int32),
                        captions=_captions(n, len(paths)), grid=grid)
        paths.append(p)
    return paths


@pytest.mark.parametrize(
    "captions, cond_len, accum", [(True, 0, 1), (False, 4, 2)], ids=["captions", "paired-cond-accum2"]
)
def test_shard_batches_and_resume_match_jax(tmp_path, tiny_t5, pair, captions, cond_len, accum):
    jm, pm = pair
    paths = _buckets(tmp_path, cond_len)
    kw = dict(batch_size=BATCH, grad_accum_every=accum, save_model_every=10**9, use_ema=False)
    run = dict(use_captions=captions, cond_token_len=cond_len or None, loader_seed=5, num_threads=1, prefetch=0)
    jt = JaxTrainer(jm, num_train_steps=6, results_folder=str(tmp_path / "j"), mesh=create_mesh(devices=jax.devices()[:1]), **kw)
    want = _record(jt, True)
    jt.train_from_shards(paths, **run)
    assert len(want) == 6 and len({w[0].shape for w in want}) > 1  # more than one bucket drawn

    pt = MaskGitTrainer(pm, num_train_steps=3, results_folder=str(tmp_path / "p"), **kw)
    got = _record(pt, False)
    pt.train_from_shards(paths, **run)
    pt.num_train_steps = 6  # resume: the same trainer's step count, the loaders reopened
    pt.train_from_shards(paths, **run)
    assert len(got) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        if cond_len:
            np.testing.assert_array_equal(g[1], w[1])
        else:
            assert g[1] is None and w[1] is None
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-5)


def test_train_from_shards_trains_and_resumes(tmp_path, tiny_t5, pair):
    _, pm = pair
    paths = _buckets(tmp_path)[:2]  # one bucket, with captions
    kw = dict(batch_size=BATCH, save_model_every=1, use_ema=True, results_folder=str(tmp_path / "r"))
    t = MaskGitTrainer(pm, num_train_steps=2, **kw)
    losses = []
    t.train_from_shards(paths, use_captions=True, num_threads=1, log_fn=lambda logs: losses.append(logs["loss"]))
    assert t.steps == 2 and len(losses) == 2 and all(np.isfinite(losses))
    assert latest_step(tmp_path / "r" / "checkpoints") == 2  # saved after each step, under its count
    r = MaskGitTrainer(pm, num_train_steps=3, auto_resume=True, **kw)
    assert r.steps == 2
    r.train_from_shards(paths, use_captions=True, num_threads=1)
    assert r.steps == 3


def test_small_bucket_and_process_count_are_refused(tmp_path, pair):
    _, pm = pair
    rs = np.random.RandomState(2)
    write_shard(tmp_path / "big.bin", rs.randint(0, VOCAB, (8, 16)).astype(np.int32))
    write_shard(tmp_path / "small.bin", rs.randint(0, VOCAB, (3, 16)).astype(np.int32), grid=(2, 8))
    t = MaskGitTrainer(pm, num_train_steps=1, batch_size=BATCH, results_folder=str(tmp_path / "s"), use_ema=False)
    with pytest.raises(ValueError, match="fewer than batch_size"):
        t.train_from_shards([tmp_path / "big.bin", tmp_path / "small.bin"], num_threads=1)
    with pytest.raises(NotImplementedError, match="A11"):
        t.train_from_shards([tmp_path / "big.bin"], process_count=2)
    assert t.steps == 0 and torch.is_tensor(t.params[0])
