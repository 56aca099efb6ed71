"""Port parity of VQ-GAN training: three `VQGanVAETrainer` steps against the
JAX trainer's jitted `_train_step` (EMA-VQ with the GAN towers, two
micro-batches a step, the R1 penalty every second step, k-means on the
first step, the JAX key's row draws injected), the port's trainer on its own
(exact resume, `vae.<step>.pt` files the JAX package reads, reconstruction
grids, a SIGTERM save, no gradient left between the phases), and the image
data path (`ImageDataset`, `DataLoader`, `split_dataset`) against the JAX
package's. CPU, f32, toy size (dim 32, 2 layers, 32px).

Tolerances. Logs (loss, gradient norms, discriminator loss) 1e-5 relative.
Both optimizers' moments and the codebook after three steps: every entry
within 1e-4 of its leaf's largest entry. Parameters and the
EMA: their change over the three steps against JAX's change, within 1e-4 of
the largest change of the leaf plus 8 ulps of the weight (the f32 rounding
of three updates of a weight near 1) for all but 0.1% of its entries, that
share rounded up to whole entries, and every entry within 2 * lr * steps.
Adam's first steps move a weight by about lr whatever its gradient's size,
so an entry whose gradient is at rounding level may move either way on
either side (measured: one entry of a 256-bias and one of a 64-scale); the
hinge loss's kinks then carry such moves into the next steps. At lr 1e-3
that parts the two sides by 2% of the discriminator loss within three steps
(measured at this size), so the parity runs at lr 1e-5, where the logs agree
to 1e-6. A run with either optimizer's step skipped fails the change check.
Resume on the CPU is bitwise. Pixels of the image data path within one
level (1/255) of the JAX dataset's, which resamples with Pillow (measured:
one level at most, on about 1% of the pixels).
"""

import json
import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from PIL import Image

from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu.parallel.mesh import create_mesh
from muse_maskgit_pytorch_tpu.training import data as jdata
from muse_maskgit_pytorch_tpu.training.trainers import VQGanVAETrainer as JaxTrainer
from muse_maskgit_pytorch_tpu_torch import VQGanVAE, VQGanVAETrainer
from muse_maskgit_pytorch_tpu_torch.models.quantizers import VQDraws
from muse_maskgit_pytorch_tpu_torch.parallel import DEFAULT_TP_RULES
from muse_maskgit_pytorch_tpu_torch.training import data as pdata
from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import finalized_steps, latest_step
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, to_jax_state
from muse_maskgit_pytorch_tpu_torch.utils.png import encode_png
from tests.torch_gan_pairs import build_pair, images, torch_grads_by_jax_path

LOG_RTOL = 1e-5
LEAF_REL, LEAF_SHARE = 1e-4, 0.999
DELTA_REL, ROUND_ULPS = 1e-4, 8
PIXEL_TOL = 1 / 255 + 1e-6
B, ACCUM, STEPS, LR, K = 2, 2, 3, 1e-5, 64
VQ_KW = dict(lookup_free_quantization=False, vq_kwargs=dict(codebook_dim=8, threshold_ema_dead_code=2.0))


class ArrayDataset:
    def __init__(self, n, size=32, channels=3, seed=0):
        self.data = images(seed, n, size, size, channels)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


def _flat(tree) -> dict:
    return flatten_tree(jax.tree.map(np.asarray, tree.to_pure_dict()))


def _leaves_close(got: dict, want: dict):
    assert want and set(want) <= set(got), sorted(set(want) - set(got))[:5]
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        d = np.abs(np.asarray(got[key], np.float32) - w)
        assert d.max() <= LEAF_REL * max(float(np.abs(w).max()), 1e-30), (key, float(d.max()))


def _changes_close(got: dict, want: dict, start: dict):
    """Each leaf's change from `start` against JAX's change (module docstring)."""
    assert want and set(want) <= set(got), sorted(set(want) - set(got))[:5]
    for key, w in want.items():
        w, s = np.asarray(w, np.float32), start[key]
        want_move, got_move = w - s, np.asarray(got[key], np.float32) - s
        largest = float(np.abs(want_move).max())  # 0 for the head's bias while every hinge term is on
        err = np.abs(got_move - want_move)
        tol = DELTA_REL * largest + ROUND_ULPS * np.spacing(np.maximum(np.abs(s), np.abs(w)))
        assert err.max() <= 2 * LR * STEPS, (key, float(err.max()))
        outside = int((err > tol).sum())
        assert outside <= math.ceil((1 - LEAF_SHARE) * err.size), (key, outside, err.size, float(err.max() / largest))


# -- three steps against the JAX trainer -------------------------------------

TRAINER_KW = dict(
    folder=None, num_train_steps=STEPS, batch_size=B, image_size=32, grad_accum_every=ACCUM,
    apply_grad_penalty_every=2, lr=LR, max_grad_norm=1.0, save_results_every=10**9, save_model_every=10**9,
    valid_frac=0.25, use_ema=True, ema_beta=0.9, seed=3,
)


def _step_batches(step):
    return images(20 + step, ACCUM, B, 32, 32, 3), images(40 + step, ACCUM, B, 32, 32, 3)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Three JAX trainer steps: the start, the logs, the final state and the
    codebook row draws of each step's keys."""
    jvae, _ = build_pair(codebook_size=K, **VQ_KW)
    start = _flat(nnx.state(jvae, nnx.Param))
    folder = tmp_path_factory.mktemp("jax")
    jt = JaxTrainer(jvae, results_folder=str(folder), mesh=create_mesh(devices=jax.devices()[:1]),
                    dataset=ArrayDataset(8), **TRAINER_KW)
    rng = jax.random.PRNGKey(3)  # the JAX step: rng, *keys = split(rng, 2 accum + 1); keys[:accum] feed the codebook
    rows = B * 8 * 8
    logs, draws = [], []
    for step in range(STEPS):
        rng, *keys = jax.random.split(rng, 2 * ACCUM + 1)
        draws.append([np.array(jax.random.randint(k, (K,), 0, rows)) for k in keys[:ACCUM]])
        jt.state, out = jt._train_step(jt.state, *map(jnp.asarray, _step_batches(step)))
        logs.append({k: float(v) for k, v in out.items()})
    return start, logs, draws, jt.state


def _port_run(jax_run, folder, skip=None):
    """The port's three steps from the same start and draws; `skip` names an
    optimizer whose step is left out."""
    _, pvae = build_pair(codebook_size=K, **VQ_KW)
    pt = VQGanVAETrainer(pvae, results_folder=str(folder), dataset=ArrayDataset(8), **TRAINER_KW)
    if skip is not None:
        getattr(pt, skip).step = lambda *a, **k: None
    logs = [
        pt.train_step_arrays(*_step_batches(step), draws=[VQDraws(torch.from_numpy(d)) for d in draws])
        for step, draws in enumerate(jax_run[2])
    ]
    return pt, logs


def test_three_trainer_steps_match_jax(jax_run, tmp_path):
    start, want_logs, _, state = jax_run
    pt, logs = _port_run(jax_run, tmp_path)
    for step, (got, want) in enumerate(zip(logs, want_logs)):
        for key in ("loss", "grad_norm", "discr_loss", "discr_grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOG_RTOL, err_msg=f"step {step} {key}")
    pvae = pt.vae
    port = flatten_tree(to_jax_state(pvae))
    _changes_close(port, _flat(state["gen_params"]), start)
    _changes_close(port, _flat(state["discr_params"]), start)
    rest = {k: v for k, v in _flat(state["rest"]).items() if v.dtype != np.bool_}
    assert {"quantizer.codebook", "quantizer.cluster_size", "quantizer.embed_avg"} <= set(rest)
    _leaves_close(port, rest)
    assert bool(pvae.quantizer.initted)
    _changes_close(torch_grads_by_jax_path(pvae, pt.gen_names, pt.ema), _flat(state["ema"]), start)
    # the moments: optax's chain (clip, adam) for the generator, (adam,) for the discriminator
    for opt, names, opt_state in (
        (pt.gen_opt, pt.gen_names, state["gen_opt"][1][0]),
        (pt.discr_opt, pt.discr_names, state["discr_opt"][0][0]),
    ):
        assert opt.count == int(opt_state.count) == STEPS
        for moment in ("mu", "nu"):
            _leaves_close(torch_grads_by_jax_path(pvae, names, getattr(opt, moment)), _flat(getattr(opt_state, moment)))


@pytest.mark.parametrize("skip, group", [("gen_opt", "gen_params"), ("discr_opt", "discr_params")])
def test_parity_check_sees_a_skipped_update(jax_run, tmp_path, skip, group):
    """The change check is not blind to the update: a run that leaves out one
    optimizer's step fails it on that group's leaves."""
    start, _, _, state = jax_run
    pt, _ = _port_run(jax_run, tmp_path, skip=skip)
    with pytest.raises(AssertionError):
        _changes_close(flatten_tree(to_jax_state(pt.vae)), _flat(state[group]), start)


# -- the port's trainer alone --------------------------------------------------


def _port_trainer(folder, gan=True, seed=0, **kw):
    vae = VQGanVAE(
        dim=32, layers=2, codebook_size=K, use_vgg_and_gan=gan, device="cpu",
        generator=torch.Generator().manual_seed(seed), **VQ_KW,
    )
    if gan:
        from tests.torch_gan_pairs import PTower

        vae.set_vgg(PTower(torch.Generator().manual_seed(seed + 1)))
    base = dict(
        folder=None, dataset=ArrayDataset(8), num_train_steps=100, batch_size=B, image_size=32, lr=1e-3,
        save_results_every=10**9, save_model_every=10**9, results_folder=str(folder), apply_grad_penalty_every=2,
        seed=5, valid_frac=0.25,
    )
    return VQGanVAETrainer(vae, **(base | kw))


def _state_tensors(t):
    return [*t.gen_params, *t.discr_params, *t.vae.buffers(), *t.gen_opt.mu, *t.gen_opt.nu, *t.discr_opt.mu, *t.discr_opt.nu, *t.ema]


def test_resume_is_bitwise_exact(tmp_path):
    batches = [images(60 + i, ACCUM, B, 32, 32, 3) for i in range(3)]
    straight = _port_trainer(tmp_path / "straight", grad_accum_every=ACCUM)
    want = [straight.train_step_arrays(b) for b in batches]
    first = _port_trainer(tmp_path / "resumed", grad_accum_every=ACCUM)
    got = [first.train_step_arrays(b) for b in batches[:2]]
    first.save()
    second = _port_trainer(tmp_path / "resumed", grad_accum_every=ACCUM, seed=9, auto_resume=True)
    assert second.steps == 2
    got.append(second.train_step_arrays(batches[2]))
    for a, b in zip(got, want):
        assert {k: a[k] for k in ("loss", "discr_loss")} == {k: b[k] for k in ("loss", "discr_loss")}
    for a, b in zip(_state_tensors(second), _state_tensors(straight)):
        assert torch.equal(a, b)
    assert torch.equal(second.generator.get_state(), straight.generator.get_state())


def test_phases_leave_no_gradients(tmp_path):
    t = _port_trainer(tmp_path / "t")
    t.train_step_arrays(images(70, 1, B, 32, 32, 3))
    assert all(p.grad is None for p in t.vae.parameters())
    assert not any(p.requires_grad for p in t.vae.vgg.parameters())
    assert not any(n.startswith("_vgg.") for n in t.gen_names + t.discr_names)
    assert t.discr_names and all(n.startswith("discr.") for n in t.discr_names)


def test_vae_files_grids_metrics_and_ema_module(tmp_path):
    t = _port_trainer(tmp_path / "run", save_results_every=1, save_model_every=2, num_train_steps=3)
    t.train()
    assert t.steps == 3
    for name in ("0.png", "0.ema.png", "2.png", "2.ema.png", "vae.0.pt", "vae.0.ema.pt", "vae.2.pt", "vae.2.ema.pt"):
        assert (tmp_path / "run" / name).exists(), name
    assert (tmp_path / "run" / "0.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # named by the steps done, as the JAX trainer names them; the files by the step
    assert finalized_steps(tmp_path / "run" / "checkpoints") == [1, 3]
    records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert {"loss", "grad_norm", "discr_loss", "discr_grad_norm"} <= set(records[0]) and "steps_per_sec" in records[1]
    # the EMA VAE: EMA generator weights, the live codebook, one shared discriminator
    ema_vae = t.vae_module(use_ema=True)
    live = dict(ema_vae.named_parameters())
    for name, e in zip(t.gen_names, t.ema):
        assert torch.equal(live[name], e)
    assert ema_vae.discr is t.vae.discr and torch.equal(ema_vae.quantizer.codebook, t.vae.quantizer.codebook)
    # the files are the JAX package's: a JAX GAN VAE of the same shape reads them
    jvae = JVAE(dim=32, layers=2, codebook_size=K, rngs=nnx.Rngs(0), **VQ_KW)
    jvae.load(tmp_path / "run" / "vae.2.pt")
    want = flatten_tree(to_jax_state(t.vae_module(use_ema=False)))
    want.pop("_vgg", None)
    got = _flat(nnx.state(jvae, (nnx.Param, nnx.BatchStat)))
    assert set(got) == {k for k in want if not k.startswith("_vgg.")}
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_sigterm_saves_and_resumes(tmp_path):
    t1 = _port_trainer(tmp_path / "p", gan=False, num_train_steps=50)
    t1.train(log_fn=lambda logs: os.kill(os.getpid(), signal.SIGTERM))
    assert 1 <= t1.steps < 50 and latest_step(tmp_path / "p" / "checkpoints") == t1.steps
    t2 = _port_trainer(tmp_path / "p", gan=False, num_train_steps=50, seed=4, auto_resume=True)
    assert t2.steps == t1.steps
    for a, b in zip(t1.gen_params, t2.gen_params):
        assert torch.equal(a, b)


def test_refusals(tmp_path):
    # the TP rules act only on a sharded state (as in JAX) and match no VAE leaf
    ruled = _port_trainer(tmp_path / "m", shard_state_rules=DEFAULT_TP_RULES)
    assert not ruled.gen_dp.sharded and not ruled.discr_dp.sharded
    t = _port_trainer(tmp_path / "g", gan=False)
    assert not t.has_discr and t.discr_names == []
    logs = t.train_step_arrays(images(80, 1, B, 32, 32, 3))
    assert "discr_loss" not in logs and np.isfinite(logs["loss"])
    with pytest.raises(ValueError, match="grad_accum_every"):
        t.train_step_arrays(images(81, 2, B, 32, 32, 3))
    # an empty valid split fails at the first reconstruction grid, not spins
    empty = _port_trainer(tmp_path / "e", gan=False, valid_frac=0.05, save_results_every=1)
    assert len(empty.valid_ds) == 0
    with pytest.raises(ValueError, match="yields nothing"):
        empty.train_step()


# -- the image data path against the JAX package's ------------------------------


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """PNGs of several sizes and colour types (RGB, grey, RGBA written by
    Pillow), larger and smaller than the targets, and two JPEGs."""
    folder = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    sizes = [(150, 160), (40, 30), (64, 64), (97, 61), (33, 50), (200, 120)]
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        img = (127 + 60 * np.sin(xx[..., None] / (3 + i) + rs.rand(3)) + 60 * rs.rand(h, w, 3)).clip(0, 255).astype(np.uint8)
        (folder / f"rgb{i}.png").write_bytes(encode_png(img))
    sub = folder / "sub"
    sub.mkdir()
    Image.fromarray(rs.randint(0, 256, (45, 70), np.uint8)).save(sub / "grey.png")
    Image.fromarray(rs.randint(0, 256, (52, 41, 4), np.uint8), "RGBA").save(sub / "rgba.png")
    for i in range(2):
        Image.fromarray(rs.randint(0, 256, (60 + 9 * i, 80, 3), np.uint8)).save(folder / f"photo{i}.jpg", quality=90)
    return folder


@pytest.mark.parametrize("size", [32, (24, 40)], ids=["square", "rectangular"])
def test_image_dataset_matches_jax(image_folder, size):
    jds = jdata.ImageDataset(image_folder, size, random_flip=True, seed=7)
    pds = pdata.ImageDataset(image_folder, size, random_flip=True, seed=7)
    assert [str(p) for p in pds.paths] == [str(p) for p in jds.paths] and len(pds) == 10
    for i in range(len(jds)):  # the flips come from one generator on each side, in item order
        want, got = jds[i], pds[i]
        assert got.dtype == np.float32 and got.shape == want.shape == (*((size, size) if isinstance(size, int) else size), 3)
        assert np.abs(got - want).max() <= PIXEL_TOL, (pds.paths[i], np.abs(got - want).max())


def test_loader_and_split_match_jax(image_folder):
    jtrain, jvalid = jdata.split_dataset(jdata.ImageDataset(image_folder, 32, seed=1), 0.3, seed=42)
    ptrain, pvalid = pdata.split_dataset(pdata.ImageDataset(image_folder, 32, seed=1), 0.3, seed=42)
    assert ptrain.indices == jtrain.indices and pvalid.indices == jvalid.indices and len(pvalid) == 3
    # the JAX loader on one thread draws the flips in batch order; the port
    # does so on any number of threads
    jl = jdata.DataLoader(jtrain, 3, shuffle=True, seed=5, num_workers=1)
    pl = pdata.DataLoader(ptrain, 3, shuffle=True, seed=5, num_workers=4)
    for epoch in range(2):
        want, got = list(jl), list(pl)
        assert [b.shape for b in got] == [b.shape for b in want] == [(3, 32, 32, 3), (3, 32, 32, 3), (1, 32, 32, 3)]
        for a, b in zip(got, want):
            assert np.abs(a - b).max() <= PIXEL_TOL
    # a dataset with only __getitem__ goes through too
    plain = pdata.split_dataset(ArrayDataset(5), 0.2, seed=42)[0]
    assert np.concatenate(list(pdata.DataLoader(plain, 2, shuffle=False))).shape == (4, 32, 32, 3)


def test_jpegs_without_pillow_are_refused_by_name(image_folder, monkeypatch):
    monkeypatch.setattr(pdata, "_pillow_available", lambda: False)
    with pytest.raises(RuntimeError, match="photo0.jpg"):
        pdata.ImageDataset(image_folder, 32)
    ds = pdata.ImageDataset(image_folder, 32, exts=("png",))  # PNGs alone need no Pillow
    assert len(ds) == 8 and ds[0].shape == (32, 32, 3)


def test_trainer_from_a_folder(image_folder, tmp_path):
    t = VQGanVAETrainer(
        VQGanVAE(dim=32, layers=2, codebook_size=K, use_vgg_and_gan=False, device="cpu", **VQ_KW),
        folder=str(image_folder), num_train_steps=2, batch_size=4, image_size=32, results_folder=str(tmp_path),
        save_results_every=10**9, save_model_every=10**9, valid_frac=0.2,
    )
    losses = [t.train_step()["loss"] for _ in range(2)]
    assert t.steps == 2 and all(np.isfinite(losses)) and bool(t.vae.quantizer.initted)
