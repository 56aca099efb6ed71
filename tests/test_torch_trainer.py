"""Port parity of training: the schedule, clip and EMA against the JAX
package (optax, `training/ema.py`), three `MaskGitTrainer` steps against
the JAX `MaskGitTrainer` with the same weights and the same draws, and the
port's trainer on its own: exact resume, checkpoint retention, async saves,
a SIGTERM save, `metrics.jsonl` and periodic samples. CPU, f32, toy size.

Tolerances: losses 1e-5 relative; the logged gradient norm 1e-4 relative
(a sum of squares over every parameter, in another order); parameters and EMA after three steps
1e-5 absolute for at least 99.9% of the entries and 2 * lr * steps for all
(Adam moves a weight by about lr a step whatever its gradient's size, so a
gradient at rounding level, whose sign the two frameworks may take apart,
can move one entry by up to that); resume on the CPU bitwise.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from muse_maskgit_pytorch_tpu.parallel.mesh import create_mesh
from muse_maskgit_pytorch_tpu.training.ema import ema_init as jax_ema_init
from muse_maskgit_pytorch_tpu.training.ema import ema_update as jax_ema_update
from muse_maskgit_pytorch_tpu.training.trainers import MaskGitTrainer as JaxTrainer
from muse_maskgit_pytorch_tpu.training.trainers import lr_schedule as jax_lr_schedule
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, VQGanVAE
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.parallel import DEFAULT_TP_RULES
from muse_maskgit_pytorch_tpu_torch.training import MaskGitTrainer, ema_init, ema_update, lr_schedule
from muse_maskgit_pytorch_tpu_torch.training.optim import clip_by_global_norm, global_norm
from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import finalized_steps, latest_step, wait_for_saves
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, to_jax_state
from tests.torch_surface_pairs import B, TEXT_DIM, VOCAB, build_pair, jax_draws, text_inputs, transformer_kw

LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_SHARE = 1e-5, 0.999

SAMPLE_T5 = "test/torch-trainer-t5"
pt5.T5_CONFIGS.setdefault(SAMPLE_T5, pt5.T5Config(d_model=TEXT_DIM, d_ff=48, num_heads=2, d_kv=16, num_layers=1, gated=True))


# -- schedule, clip, EMA --------------------------------------------------------


@pytest.mark.parametrize(
    "warmup, decay", [(0, None), (5, None), (0, 20), (5, 20)], ids=["constant", "warmup", "decay", "both"]
)
def test_lr_schedule_matches_optax(warmup, decay):
    want = jax_lr_schedule(3e-4, warmup, decay, end_lr_ratio=0.2)
    got = lr_schedule(3e-4, warmup, decay, end_lr_ratio=0.2)
    if not callable(want):
        assert not callable(got) and got == want
        return
    for count in range(0, 40):
        np.testing.assert_allclose(got(count), float(want(jnp.asarray(count, jnp.int32))), rtol=1e-6, atol=1e-12)
    if warmup:
        assert got(0) == 0.0


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rs = np.random.RandomState(0)
    grads = [rs.randn(5, 3).astype(np.float32), rs.randn(7).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    norm = global_norm([torch.from_numpy(g) for g in grads])
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    got = clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_ema_semantics():
    # the JAX package's test_ema_semantics, on the port
    params = [torch.ones(3)]
    new_params = [torch.full((3,), 2.0)]
    e = ema_update(ema_init(params), new_params, step=0, beta=0.9, update_after_step=5)  # copy
    torch.testing.assert_close(e[0], torch.full((3,), 2.0))
    e = ema_update(ema_init(params), new_params, step=10, beta=0.9, update_after_step=5)  # lerp
    torch.testing.assert_close(e[0], torch.full((3,), 0.9 * 1 + 0.1 * 2))
    e = ema_update(ema_init(params), new_params, step=11, beta=0.9, update_after_step=5, update_every=2)
    torch.testing.assert_close(e[0], torch.ones(3))  # update_every gates
    # and bit for bit what the JAX update gives (1 - beta taken in f32)
    rs = np.random.RandomState(1)
    a, b = rs.randn(50).astype(np.float32), rs.randn(50).astype(np.float32)
    want = jax_ema_update(jax_ema_init({"w": jnp.asarray(a)}), {"w": jnp.asarray(b)}, 3, beta=0.995)["w"]
    got = ema_update([torch.from_numpy(a.copy())], [torch.from_numpy(b)], 3, beta=0.995)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- three steps against the JAX trainer -------------------------------------

TRAINER_CASES = {
    # AdamW, a clip that bites, a warmup, two micro-batches a step, EMA after step 1
    "adamw-clip-warmup-accum2": dict(
        trainer=dict(lr=3e-3, warmup_steps=2, weight_decay=0.05, max_grad_norm=0.5, grad_accum_every=2,
                     ema_update_after_step=1, ema_beta=0.9),
        pair=dict(vae=False, self_cond=True),
    ),
    # Adam, a cosine decay, images through the VAE, a SelfCritic
    "adam-decay-images-critic": dict(
        trainer=dict(lr=2e-3, lr_decay_steps=4, ema_beta=0.8),
        pair=dict(vae=True, critic="self"),
    ),
}


def _steps_inputs(accum, images, steps=3, seed=0):
    rs, te, mask = text_inputs(seed)
    out = []
    for _ in range(steps):
        if images:
            x = rs.uniform(size=(accum, B, 16, 16, 3)).astype(np.float32)
        else:
            x = rs.randint(0, VOCAB, (accum, B, 16)).astype(np.int32)
        tes = np.stack([te + 0.1 * rs.randn(*te.shape).astype(np.float32) * (te != 0) for _ in range(accum)])
        out.append((x, tes, np.stack([mask] * accum)))
    return out


def _close_share(got: dict, want: dict, bound: float):
    """Every leaf within `bound`, and the share of entries within PARAM_ATOL."""
    n = ok = 0
    for key, w in want.items():
        d = np.abs(got[key] - np.asarray(w))
        assert d.max() <= bound, (key, float(d.max()))
        n += d.size
        ok += int((d <= PARAM_ATOL).sum())
    return ok / n


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_three_trainer_steps_match_jax(tmp_path, case):
    cfg = TRAINER_CASES[case]
    jm, pm = build_pair(**cfg["pair"])
    kw = dict(num_train_steps=3, batch_size=B, use_ema=True, save_model_every=10**9, seed=3, **cfg["trainer"])
    jt = JaxTrainer(jm, results_folder=str(tmp_path / "jax"), mesh=create_mesh(devices=jax.devices()[:1]), **kw)
    pt = MaskGitTrainer(pm, results_folder=str(tmp_path / "port"), **kw)
    accum = kw.get("grad_accum_every", 1)
    rng = jax.random.PRNGKey(3)  # the JAX trainer's chain: rng, *keys = split(rng, accum + 1) a step
    for images, te, tm in _steps_inputs(accum, cfg["pair"]["vae"]):
        rng, *keys = jax.random.split(rng, accum + 1)
        want = jt.train_step_arrays(images, te, tm)
        got = pt.train_step_arrays(images, te, tm, draws=[jax_draws(k, B, 16) for k in keys])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        if "lr" in want:
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    bound = 2 * kw["lr"] * 3
    want_params = flatten_tree(jt.state["params"].to_pure_dict())
    share = _close_share(flatten_tree(to_jax_state(pm)), want_params, bound)
    assert share >= PARAM_SHARE, share
    share = _close_share(flatten_tree(to_jax_state(pt.maskgit_module(use_ema=True))), flatten_tree(jt.state["ema"].to_pure_dict()), bound)
    assert share >= PARAM_SHARE, share


# -- the port's trainer alone ------------------------------------------------


def _port_model(vae=False, seed=0, t5_name=None):
    gen = torch.Generator().manual_seed(seed)
    extra = dict(t5_name=t5_name) if t5_name else {}
    transformer = MaskGitTransformer(device="cpu", generator=gen, **transformer_kw(16, self_cond=True, **extra))
    v = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=VOCAB, device="cpu", generator=gen) if vae else None
    return MaskGit(image_size=16, transformer=transformer, vae=v, device="cpu")


def _ids_batches(n, seed=0, accum=1):
    rs, te, mask = text_inputs(seed)
    return [(rs.randint(0, VOCAB, (accum, B, 16)), np.stack([te] * accum), np.stack([mask] * accum)) for _ in range(n)]


def _trainer(folder, **kw):
    base = dict(num_train_steps=100, batch_size=B, lr=1e-3, warmup_steps=1, save_model_every=10**9, seed=5)
    return MaskGitTrainer(_port_model(), results_folder=str(folder), **(base | kw))


def test_resume_is_bitwise_exact(tmp_path):
    batches = _ids_batches(4, accum=2)
    straight = _trainer(tmp_path / "straight", grad_accum_every=2)
    want = [straight.train_step_arrays(*b)["loss"] for b in batches]

    first = _trainer(tmp_path / "resumed", grad_accum_every=2)
    got = [first.train_step_arrays(*b)["loss"] for b in batches[:2]]
    first.save()
    second = _trainer(tmp_path / "resumed", grad_accum_every=2, auto_resume=True)
    assert second.steps == 2
    got += [second.train_step_arrays(*b)["loss"] for b in batches[2:]]
    assert got == want
    for a, b in zip(straight.params + straight.ema, second.params + second.ema):
        assert torch.equal(a, b)
    assert torch.equal(straight.generator.get_state(), second.generator.get_state())
    assert straight.optimizer.count == second.optimizer.count == 4


def test_max_checkpoints_and_async_saves(tmp_path):
    # synchronous saves keep exactly the newest N
    t = _trainer(tmp_path / "sync", max_checkpoints=2)
    for b in _ids_batches(3):
        t.train_step_arrays(*b)
        t.save()
    assert finalized_steps(tmp_path / "sync" / "checkpoints") == [2, 3]
    # async: the newest N finalized ones and the one in flight, which never
    # displaces a finalized one
    t = _trainer(tmp_path / "keep", max_checkpoints=2, async_checkpoints=True)
    for b in _ids_batches(4):
        t.train_step_arrays(*b)
        t.save()
    wait_for_saves()
    ckpts = tmp_path / "keep" / "checkpoints"
    assert finalized_steps(ckpts) == [2, 3, 4]
    t.save()  # step 4 again: 2 is pruned, 4 rewritten
    wait_for_saves()
    assert finalized_steps(ckpts) == [3, 4]
    # an abandoned temporary directory is never a step
    (ckpts / "step_00000009.tmp-1-2").mkdir()
    assert latest_step(ckpts) == 4
    r = _trainer(tmp_path / "keep", auto_resume=True)
    assert r.steps == 4
    for a, b in zip(t.params, r.params):
        assert torch.equal(a, b)


def test_sigterm_saves_and_resumes(tmp_path):
    rs = np.random.RandomState(0)

    def data():
        while True:
            yield rs.uniform(size=(B, 16, 16, 3)).astype(np.float32), ["a", "b"]

    # images in, texts through T5
    t1 = MaskGitTrainer(_port_model(vae=True, t5_name=SAMPLE_T5), results_folder=str(tmp_path / "preempt"),
                        num_train_steps=50, batch_size=B, save_model_every=10**9, use_ema=False)
    t1.train(data(), log_fn=lambda logs: os.kill(os.getpid(), signal.SIGTERM), prefetch=0)
    assert 1 <= t1.steps < 50
    assert latest_step(tmp_path / "preempt" / "checkpoints") == t1.steps
    t2 = MaskGitTrainer(_port_model(vae=True, t5_name=SAMPLE_T5), results_folder=str(tmp_path / "preempt"),
                        num_train_steps=50, batch_size=B, use_ema=False, auto_resume=True)
    assert t2.steps == t1.steps
    for a, b in zip(t1.params, t2.params):
        assert torch.equal(a, b)


def test_metrics_and_periodic_samples(tmp_path):
    t = MaskGitTrainer(
        _port_model(vae=True, t5_name=SAMPLE_T5), results_folder=str(tmp_path / "mg"), num_train_steps=2, batch_size=B,
        warmup_steps=2, save_model_every=1, save_results_every=1, sample_texts=["a red cube", "a blue ball", "x"],
        sample_kwargs=dict(timesteps=2), max_checkpoints=1,
    )
    rs = np.random.RandomState(1)
    t.train(iter([(rs.uniform(size=(B, 16, 16, 3)).astype(np.float32), ["p", "q"]) for _ in range(3)]))
    assert t.steps == 2
    records = [json.loads(line) for line in (tmp_path / "mg" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    assert {"loss", "grad_norm", "lr", "time"} <= set(records[0]) and "steps_per_sec" in records[1]
    assert records[0]["lr"] == 0.0 and all(np.isfinite(r["loss"]) for r in records)
    for step in (0, 1):
        png = (tmp_path / "mg" / f"maskgit.{step}.png").read_bytes()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert finalized_steps(tmp_path / "mg" / "checkpoints") == [2]


def test_refusals(tmp_path):
    # the TP rules act only on a sharded state, as in JAX's _maybe_shard_state:
    # without shard_state nothing shards and every module computes whole
    t = MaskGitTrainer(
        _port_model(), num_train_steps=1, batch_size=B, shard_state_rules=DEFAULT_TP_RULES, results_folder=str(tmp_path)
    )
    assert not t.dp.sharded and all(getattr(m, "tensor_split", None) is None for m in t.maskgit.modules())
    with pytest.raises(ValueError, match="sample_texts"):
        MaskGitTrainer(_port_model(), num_train_steps=1, batch_size=B, save_results_every=1)


def test_trainable_set_excludes_the_vae_and_counts_a_shared_trunk_once(tmp_path):
    _, pm = build_pair(vae=True, critic="self")
    t = MaskGitTrainer(pm, num_train_steps=1, batch_size=B, results_folder=str(tmp_path), use_ema=False)
    assert not any(n.startswith(("vae.", "cond_vae.")) for n in t.param_names)
    assert len({id(p) for p in t.params}) == len(t.params)
    assert "token_critic.to_pred.weight" in t.param_names
    assert not any(n.startswith("token_critic.net.") for n in t.param_names)
