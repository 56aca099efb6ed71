"""The port's deployable generate program (`export_pipeline`,
`ExportedPipeline`, `load_exported_pipeline`) on the CPU, at a toy size
(dim 32, depth 2, seq 16, vocab 256, T 2):

  * against the JAX package's `export_pipeline` with the same weights
    (bridged, `to_jax_state`) at `temperature=1e-6`, where the noise cannot choose a token,
    with K1 and with the exact sampler (`sampler="xla"`): the uint8 images
    within one level, `meta` equal but for `platforms` and `n_state_leaves`;
  * against the port's eager `generate`, for a `MaskGit` with either sampler, a `Muse` cascade
    handing over pixels and ids, per-row guidance, a standalone super-res
    stage and a token critic with its noise on (device-keyed Philox, also
    under `rows_from`): byte-equal in this process, and after `save` and a
    load in a fresh process whose model entry points raise (the seeds are a
    program input, so the images are byte-equal across the file). That
    process is started with the module and loads each artifact as its test
    saves it, beside the tests that follow;
  * the graph: K1 (or the exact sampler's noise) and K2 as `muse_torch`
    operators, no `aten.rand` or `aten.randint`, no parameter inside; the
    operators' CUDA implementations hold their kernels' contract
    themselves.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models.maskgit import MaskGit as JMaskGit
from muse_maskgit_pytorch_tpu.models.transformer import MaskGitTransformer as JTransformer
from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu.serving import export_pipeline as jax_export_pipeline
from muse_maskgit_pytorch_tpu_torch import (
    ExportedPipeline,
    MaskGit,
    MaskGitTransformer,
    Muse,
    TokenCritic,
    VQGanVAE,
    export_pipeline,
)
from muse_maskgit_pytorch_tpu_torch.models.maskgit import child_generators
from muse_maskgit_pytorch_tpu_torch.ops import attention, sampling_kernel, vq
from muse_maskgit_pytorch_tpu_torch.parallel.batch import rows_from
from muse_maskgit_pytorch_tpu_torch.serving import _quantize_u8
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import to_jax_state
from tests.torch_threads import few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
VOCAB, SEQ, B, L, TEXT_DIM, T = 256, 16, 2, 5, 24, 2
KW = dict(num_tokens=VOCAB, dim=32, dim_head=16, heads=2, text_embed_dim=TEXT_DIM)


def _vae(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=VOCAB, device="cpu", generator=gen)


def _maskgit(seed=0, seq=SEQ, depth=2, vae=None, image_size=16, **kw):
    gen = torch.Generator().manual_seed(seed)
    tr = MaskGitTransformer(seq_len=seq, depth=depth, device="cpu", generator=gen, **KW)
    vae = vae if vae is not None else _vae(seed)
    return MaskGit(image_size=image_size, transformer=tr, vae=vae, device="cpu", **kw).eval()


def _superres(vae, seed=1):
    """A super-res stage: 32px on an 8 x 8 grid, conditioned on 16px images
    that `vae` encodes (or on the base stage's ids when it is the base's)."""
    return _maskgit(seed, seq=64, depth=1, vae=vae, image_size=32, cond_image_size=16, cond_vae=vae)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    te = rs.randn(B, L, TEXT_DIM).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, 3:] = False
    te[~mask] = 0.0
    return torch.from_numpy(te), torch.from_numpy(mask)


def _eager(model, seed, **kw):
    te, tm = _inputs()
    gen = torch.Generator().manual_seed(seed)
    return _quantize_u8(model.generate(generator=gen, text_embeds=te, text_mask=tm, timesteps=T, **kw))


# The fresh process: it waits for `<name>.ready` in its folder, loads the
# artifact `<name>` with the model code made to raise, makes the images of
# `<name>.call.pt`'s request and of the next seed, and writes
# `<name>.json`. Each test's artifact is thus loaded beside the tests that
# follow it; `test_load_in_a_fresh_process_without_the_model_code` reads
# the answers.
FRESH = r"""
import json, os, sys, time, traceback
from pathlib import Path
import torch
torch.set_num_threads(1)
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, TokenCritic, VQGanVAE, load_exported_pipeline

def refuse(*args, **kwargs):
    raise AssertionError("the artifact called the model code")

MaskGit.generate = MaskGitTransformer.forward = TokenCritic.forward = VQGanVAE.decode_from_ids = refuse
folder, done = Path(sys.argv[1]), set()
while True:
    for ready in sorted(folder.glob("*.ready")):
        name = ready.stem
        if name in done:
            continue
        done.add(name)
        try:
            call = torch.load(folder / f"{name}.call.pt")
            ep = load_exported_pipeline(folder / name)
            request = lambda seed: ep(call["leaves"], call["te"], call["tm"], seed, **call["kw"])
            got, other = request(call["seed"]), request(call["seed"] + 1)
            result = dict(equal=torch.equal(got, call["want"]), other_seed_differs=not torch.equal(other, got),
                          meta=ep.meta)
        except Exception:
            result = dict(error=traceback.format_exc())
        (folder / f"{name}.tmp").write_text(json.dumps(result))
        os.replace(folder / f"{name}.tmp", folder / f"{name}.json")
    time.sleep(0.05)
"""


class Fresh:
    """The fresh process and the artifacts handed to it, by name."""

    def __init__(self, folder: Path):
        self.folder, self.artifacts = folder, {}
        self.log = open(folder / "stderr.txt", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", FRESH, str(folder)], cwd=ROOT, stdout=subprocess.DEVNULL, stderr=self.log
        )

    def submit(self, name, ep, state, seed, want, **kw):
        """Save `ep` as `name` and ask for its request (seed, `kw`) on
        `_inputs()` with `state` as a flat list of leaves."""
        ep.save(self.folder / name)
        te, tm = _inputs()
        call = dict(leaves=list(state.values()), te=te, tm=tm, seed=seed, want=want, kw=kw)
        torch.save(call, self.folder / f"{name}.call.pt")
        (self.folder / f"{name}.ready").touch()

    def result(self, name, timeout=120):
        answer = self.folder / f"{name}.json"
        deadline = time.monotonic() + timeout
        while not answer.exists():
            assert self.proc.poll() is None, (self.folder / "stderr.txt").read_text()[-3000:]
            assert time.monotonic() < deadline, f"no answer for {name}"
            time.sleep(0.05)
        return json.loads(answer.read_text())

    def close(self):
        self.proc.kill()
        self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    process = Fresh(tmp_path_factory.mktemp("fresh"))
    yield process
    process.close()


def _artifact(fresh, name, make):
    """`make()`'s (model, ep, want) once a module; `make` submits it."""
    if name not in fresh.artifacts:
        fresh.artifacts[name] = make()
    return fresh.artifacts[name]


@pytest.fixture(scope="module")
def base(fresh):
    def make():
        model = _maskgit()
        ep = export_pipeline(model, batch_size=B, text_len=L, timesteps=T)
        want = _eager(model, 11)
        fresh.submit("base", ep, model.state_dict(), 11, want)
        return model, ep, want

    return _artifact(fresh, "base", make)


@pytest.fixture(scope="module")
def base_xla(base, fresh):
    """`base`'s model exported with the exact sampler."""

    def make():
        model = base[0]
        ep = export_pipeline(model, batch_size=B, text_len=L, timesteps=T, sampler="xla")
        want = _eager(model, 11, sampler="xla")
        fresh.submit("base-xla", ep, model.state_dict(), 11, want)
        return model, ep, want

    return _artifact(fresh, "base-xla", make)


# -- (a) against the JAX package's artifact --------------------------------------


@pytest.fixture(scope="module")
def jax_pair():
    """The port's toy and the JAX package's with its weights. The JAX model
    is built abstractly and takes the port's weights through the bridge's
    inverse (`to_jax_state`): a random init of it on the CPU dispatches op
    by op and takes about 15 s here."""
    pm = _maskgit()

    def build():
        jt = JTransformer(seq_len=SEQ, depth=2, rngs=nnx.Rngs(0), **KW)
        jvae = JVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=False, rngs=nnx.Rngs(1))
        return JMaskGit(image_size=16, transformer=jt, vae=jvae)

    graphdef, state = nnx.split(nnx.eval_shape(build))
    state.replace_by_pure_dict(to_jax_state(pm))
    return pm, nnx.merge(graphdef, state)


@pytest.mark.parametrize("sampler", ["auto", "xla"])
def test_images_and_meta_match_jax_export(sampler, jax_pair):
    pm, jm = jax_pair
    kw = dict(batch_size=B, text_len=L, timesteps=T, cond_scale=3.0, temperature=1e-6, sampler=sampler)
    jep, pep = jax_export_pipeline(jm, **kw), export_pipeline(pm, **kw)
    te, tm = _inputs()
    want = np.asarray(jep(nnx.split(jm)[1], jnp.asarray(te.numpy()), jnp.asarray(tm.numpy()), jax.random.PRNGKey(3)))
    got = pep(pm.state_dict(), te, tm, 3).numpy()
    assert got.shape == want.shape == (B, 16, 16, 3) and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    skip = {"platforms", "n_state_leaves"}
    assert {k: v for k, v in pep.meta.items() if k not in skip} == {k: v for k, v in jep.meta.items() if k not in skip}
    assert pep.meta["platforms"] == ["cpu"] and pep.meta["n_state_leaves"] == len(pm.state_dict())
    assert pep.meta["sampler"] == sampler


# -- (b) byte-equal to eager code across save and load -------------------------------


def test_artifact_equals_eager_generate_after_save_and_load(base, fresh):
    """Here, the program before `save`; after it, the fresh process's load
    with a flat list of leaves and an int seed
    (`test_load_in_a_fresh_process_without_the_model_code[base]`)."""
    model, ep, want = base
    te, tm = _inputs()
    state = model.state_dict()
    got = ep(state, te, tm, torch.Generator().manual_seed(11))
    assert isinstance(ep, ExportedPipeline) and got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(ep(list(state.values()), te, tm, 11), want)  # an int seed is a CPU generator's seed here
    assert (fresh.folder / "base" / "meta.json").is_file()
    # no parameter inside: the file is a fraction of the state's bytes
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    assert (fresh.folder / "base" / "program.pt2").stat().st_size < state_bytes


def test_exact_sampler_artifact_equals_eager_generate(base_xla):
    """`sampler="xla"`: its noise is `muse_torch::philox_gumbel` on the
    seeds input, so the program equals eager `generate(sampler="xla")`
    byte for byte; the fresh process's load is
    `test_load_in_a_fresh_process_without_the_model_code[base-xla]`."""
    model, ep, want = base_xla
    te, tm = _inputs()
    state = model.state_dict()
    assert ep.meta["sampler"] == "xla" and torch.equal(ep(state, te, tm, 11), want)
    assert not torch.equal(ep(state, te, tm, 12), want)  # the seeds reach the noise


# -- (c) the cascade in both hand-offs ------------------------------------------------


def _cascade(fresh, cond_via):
    def make():
        vae = _vae()
        muse = Muse(_maskgit(vae=vae, depth=1), _superres(vae), device="cpu")
        ep = export_pipeline(muse, batch_size=B, text_len=L, timesteps=T, cond_via=cond_via)
        te, tm = _inputs()
        g_base, g_sr = child_generators(torch.Generator().manual_seed(5), "cpu")
        kw = dict(text_embeds=te, text_mask=tm, timesteps=T)
        via_ids = ep.meta["cond_via"] == "ids"
        low = muse.base_maskgit.generate(generator=g_base, return_ids=via_ids, **kw)
        sr_cond = dict(cond_token_ids=low) if via_ids else dict(cond_images=low.clamp(0.0, 1.0))
        want = _quantize_u8(muse.superres_maskgit.generate(generator=g_sr, **sr_cond, **kw))
        fresh.submit(f"cascade-{cond_via}", ep, muse.state_dict(), 5, want)
        return muse, ep, want

    return _artifact(fresh, f"cascade-{cond_via}", make)


@pytest.mark.parametrize("cond_via", ["pixels", "auto"])
def test_cascade_equals_its_stages_run_eagerly(cond_via, fresh):
    muse, ep, want = _cascade(fresh, cond_via)
    # the stages share the VAE's weights: "auto" hands over ids
    assert ep.meta["kind"] == "muse" and ep.meta["cond_via"] == ("ids" if cond_via == "auto" else "pixels")
    te, tm = _inputs()
    got = ep(muse.state_dict(), te, tm, torch.Generator().manual_seed(5))
    assert got.shape == (B, 32, 32, 3) and torch.equal(got, want)
    with pytest.raises(ValueError, match="cond_via"):
        export_pipeline(muse.base_maskgit, batch_size=B, text_len=L, timesteps=T, cond_via="ids")


# -- (d) per-row guidance as a program input, (h) a critic's device-keyed noise --------


@pytest.fixture(scope="module")
def critic_model():
    gen = torch.Generator().manual_seed(9)
    critic = TokenCritic(seq_len=SEQ, depth=1, device="cpu", generator=gen, **KW)
    return _maskgit(3, token_critic=critic)


@pytest.fixture(scope="module")
def critic_artifact(critic_model, fresh):
    """A token critic's model (its noise on, as `generate`'s default has it)
    exported with per-row guidance, and handed to the fresh process with
    per-row scales."""

    def make():
        ep = export_pipeline(
            critic_model, batch_size=B, text_len=L, timesteps=T, cond_scale=3.0, dynamic_cond_scale=True
        )
        want = _eager(critic_model, 4, cond_scale=torch.tensor([[2.0, 6.0]]))
        fresh.submit("critic", ep, critic_model.state_dict(), 4, want, cond_scale=[2.0, 6.0])
        return critic_model, ep, want

    return _artifact(fresh, "critic", make)[1]


def test_dynamic_cond_scale(critic_model, critic_artifact, base):
    te, tm = _inputs()
    state = critic_model.state_dict()
    want = _eager(critic_model, 4, cond_scale=torch.tensor([[2.0, 6.0]]))
    assert torch.equal(critic_artifact(state, te, tm, 4, cond_scale=[2.0, 6.0]), want)
    # None is the default recorded at export; a scalar broadcasts
    default = critic_artifact(state, te, tm, 4)
    assert torch.equal(default, critic_artifact(state, te, tm, 4, cond_scale=3.0))
    assert torch.equal(default, _eager(critic_model, 4, cond_scale=torch.tensor([[3.0, 3.0]])))
    model, static, _ = base
    with pytest.raises(ValueError, match="dynamic_cond_scale"):
        static(model.state_dict(), te, tm, 4, cond_scale=2.0)


def test_critic_model_exports_with_its_noise(critic_model, critic_artifact):
    te, tm = _inputs()
    scale = torch.tensor([[2.0, 6.0]])
    got = critic_artifact(critic_model.state_dict(), te, tm, 8, cond_scale=scale[0])
    assert torch.equal(got, _eager(critic_model, 8, cond_scale=scale))
    # the noise is on in the program: without it this request decodes otherwise
    assert not torch.equal(got, _eager(critic_model, 8, cond_scale=scale, critic_noise_scale=0.0))


def test_critic_rows_from_equal_the_whole_batch(critic_model):
    te, tm = _inputs()
    kw = dict(timesteps=T, critic_noise_scale=20.0, return_ids=True)
    whole = critic_model.generate(generator=torch.Generator().manual_seed(2), text_embeds=te, text_mask=tm, **kw)
    with rows_from(1):
        row = critic_model.generate(generator=torch.Generator().manual_seed(2), text_embeds=te[1:], text_mask=tm[1:], **kw)
    assert torch.equal(row, whole[1:])


# -- (e) the errors ---------------------------------------------------------------------


def test_errors(base):
    model, ep, _ = base
    te, tm = _inputs()
    leaves = list(model.state_dict().values())
    with pytest.raises(ValueError, match="leaves"):
        ep(leaves[:-1], te, tm, 0)
    with pytest.raises(ValueError, match="takes none"):
        ep(leaves, te, tm, 0, cond_images=torch.zeros(B, 16, 16, 3))
    with pytest.raises(ValueError, match="platforms"):
        export_pipeline(model, batch_size=B, text_len=L, timesteps=T, platforms=("tpu",))


def test_standalone_superres_takes_cond_images():
    sr = _superres(_vae(2))
    ep = export_pipeline(sr, batch_size=B, text_len=L, timesteps=T)
    assert ep.meta["needs_cond_images"] and ep.meta["image_size"] == 32
    te, tm = _inputs()
    with pytest.raises(ValueError, match="cond_images"):
        ep(sr.state_dict(), te, tm, 0)
    cond = torch.rand(B, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ep(sr.state_dict(), te, tm, 6, cond_images=cond), _eager(sr, 6, cond_images=cond))


# -- (f) what the graph holds -------------------------------------------------------------


@pytest.mark.parametrize("name", ["base", "base-xla"])
def test_graph_holds_the_operators_and_no_parameter(name, request):
    _, ep, _ = request.getfixturevalue(name.replace("-", "_"))
    targets = [str(n.target) for n in ep.program.graph.nodes if n.op == "call_function"]
    exact = name == "base-xla"  # K1, or the exact sampler's noise, once a step
    assert targets.count("muse_torch.fused_topk_gumbel_sample.default") == (0 if exact else T)
    assert targets.count("muse_torch.philox_gumbel.default") == (T if exact else 0)
    assert targets.count("muse_torch.qknorm_attend.default") == T * 2 * 2  # steps x depth x (self, cross)
    assert not [t for t in targets if "rand" in t]  # the randomness is the seeds input
    kinds = {s.kind.name for s in ep.program.graph_signature.input_specs}
    assert kinds == {"USER_INPUT"} and not ep.program.constants and not ep.program.state_dict
    assert ep.program.example_inputs is None


# -- the kernels' contract where a program reaches them ----------------------------


def _bad_k1():
    logits = torch.zeros(6, 64)
    seed = torch.zeros(1, dtype=torch.int32)
    one = torch.ones(1)
    return [
        (TypeError, "f32 or bf16", (logits.half(), 4, 1.0, seed, None, False, 1.0, None, 0)),
        (ValueError, "outside", (logits, 65, 1.0, seed, None, False, 1.0, None, 0)),
        (ValueError, "even number", (logits[:5], 4, 1.0, seed, None, True, 1.0, None, 0)),
        (ValueError, "int32", (logits, 4, 1.0, seed.long(), None, False, 1.0, None, 0)),
        (ValueError, "one-element", (logits, 4, 1.0, seed, None, True, 1.0, torch.ones(2), 0)),
        (ValueError, "CUDA", (logits, 4, 1.0, seed, None, True, 1.0, one, 0)),
    ]


def _bad_k2():
    def args(d=64, dtype=torch.float32, m=4, bias=None, scales=64):
        q, k = torch.zeros(2, 3, 2, d, dtype=dtype), torch.zeros(2, m, 2, d, dtype=dtype)
        return (q, k, k, torch.zeros(2, d), torch.zeros(2, d), torch.ones(scales), torch.ones(scales), bias, 8.0)

    return [
        (ValueError, "head dim 64", args(d=16)),  # the CPU tests' toy width
        (TypeError, "f32 or bf16", args(dtype=torch.float16)),
        (ValueError, "q_scale", args(scales=32)),
        (ValueError, "key bias", args(bias=torch.zeros(2, 5))),
        (ValueError, "CUDA", args()),
    ]


def _bad_k3():
    x, cb = torch.zeros(5, 8), torch.zeros(7, 8)
    return [
        (ValueError, "multiple of 4", (torch.zeros(5, 6), torch.zeros(7, 6), None)),
        (ValueError, "cb_sq", (x, cb, torch.zeros(6))),
        (ValueError, "CUDA", (x, cb, None)),
    ]


def _bad_gumbel():
    seed = torch.zeros(1, dtype=torch.int32)
    return [
        (TypeError, "f32 or bf16", (seed, 4, 64, 0, torch.float16)),
        (ValueError, "one-element int32", (seed.long(), 4, 64, 0, torch.float32)),
        (ValueError, "one-element int32", (torch.zeros(2, dtype=torch.int32), 4, 64, 0, torch.float32)),
        (ValueError, "positive", (seed, 0, 64, 0, torch.float32)),
        (ValueError, "positive", (seed, 4, 0, 0, torch.float32)),
        (ValueError, "outside", (seed, 4, 64, -1, torch.float32)),
        (ValueError, "CUDA", (seed, 4, 64, 0, torch.bfloat16)),
    ]


@pytest.mark.parametrize(
    "launch, cases",
    [
        (lambda: sampling_kernel._sample_cuda, _bad_k1),
        (lambda: attention._qknorm_cuda, _bad_k2),
        (lambda: vq._nearest_cuda, _bad_k3),
        (lambda: sampling_kernel._gumbel_cuda, _bad_gumbel),
    ],
    ids=["k1", "k2", "k3", "philox_gumbel"],
)
def test_cuda_implementations_check_their_arguments(launch, cases):
    """A program reaches each kernel through the operator's CUDA
    implementation, not the public wrapper (and so does a direct
    `torch.ops.muse_torch` call): the implementation itself refuses what
    its kernel cannot read -- K2 a head dim of 16, as the toys here have --
    before it launches anything. CPU tensors reach the last check, which
    refuses them."""
    for error, words, args in cases():
        with pytest.raises(error, match=words):
            launch()(*args)


# -- (g) each saved artifact loaded without the model classes --------------------------


@pytest.mark.parametrize("name", ["base", "base-xla", "cascade-pixels", "cascade-auto", "critic"])
def test_load_in_a_fresh_process_without_the_model_code(name, fresh, request):
    """The fresh process loaded the artifact with `MaskGit.generate`,
    `MaskGitTransformer.forward`, `TokenCritic.forward` and
    `VQGanVAE.decode_from_ids` made to raise: its images equal eager
    code's, the next seed's differ (the seeds reach the program), and its
    meta is the exporter's."""
    if name.startswith("cascade"):
        _cascade(fresh, name.split("-")[1])
    else:
        request.getfixturevalue({"critic": "critic_artifact", "base-xla": "base_xla"}.get(name, "base"))
    _, ep, _ = fresh.artifacts[name]
    result = fresh.result(name)
    assert "error" not in result, result.get("error")
    assert result["equal"] and result["other_seed_differs"]
    assert result["meta"] == ep.meta
