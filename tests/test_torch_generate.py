"""Port parity for the base stage as a whole: JAX `MaskGit.generate(
text_embeds, text_mask, injected_gumbel_noise=g, sampler=...)` against the
port's `MaskGit.generate` with the same weights (bridged), the same noise
and the same sampler ("fused": the bisection threshold of K1; "xla": the
exact `top_k` filter, which is also what "auto" means under injected noise
in both packages). The token grids must be identical; the decoded images
agree to 1e-4 (f32).
"""

import ast
import subprocess
import sys
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
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, VQGanVAE, load_jax_state
from muse_maskgit_pytorch_tpu_torch.models.t5 import HFTokenizer, load_hf_t5_weights

ROOT = Path(__file__).resolve().parents[1]
VOCAB, SEQ, B, L, TEXT_DIM = 256, 16, 2, 5, 24
KW = dict(num_tokens=VOCAB, dim=32, seq_len=SEQ, depth=2, dim_head=16, heads=2, text_embed_dim=TEXT_DIM)


def jax_params(module):
    return jax.tree.map(np.asarray, nnx.state(module, nnx.Param).to_pure_dict())


def _pair(self_cond=False):
    jt = JTransformer(self_cond=self_cond, rngs=nnx.Rngs(0), **KW)
    jvae = JVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=False, rngs=nnx.Rngs(1))
    pt = MaskGitTransformer(self_cond=self_cond, device="cpu", **KW)
    pvae = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=VOCAB, device="cpu")
    assert load_jax_state(pt, jax_params(jt)) == []
    load_jax_state(pvae, jax_params(jvae))
    return (
        JMaskGit(image_size=16, transformer=jt, vae=jvae),
        MaskGit(image_size=16, transformer=pt, vae=pvae, device="cpu"),
    )


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _inputs(timesteps, seed=0):
    rs = np.random.RandomState(seed)
    te = rs.randn(B, L, TEXT_DIM).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, 3:] = False
    g = -np.log(-np.log(rs.uniform(1e-9, 1 - 1e-9, (timesteps, B, SEQ, VOCAB)))).astype(np.float32)
    return te, mask, g


def _generate_both(jm, pm, timesteps, sampler="fused", **kw):
    te, mask, g = _inputs(timesteps)
    want = jm.generate(
        text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask), timesteps=timesteps,
        injected_gumbel_noise=jnp.asarray(g), sampler=sampler, **kw,
    )
    got = pm.generate(
        text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask), timesteps=timesteps,
        injected_gumbel_noise=torch.from_numpy(g), sampler=sampler, **kw,
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("cfg_fold", [True, False], ids=["cfg_fold", "cfg_pair"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_token_grids_identical(pair, compact, cfg_fold):
    want, got = _generate_both(
        *pair, 6, cond_scale=3.0, compact=compact, cfg_fold=cfg_fold, return_ids=True
    )
    assert got.shape == want.shape == (B, 4, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg_fold", [True, False], ids=["cfg_fold", "cfg_logits"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("sampler", ["xla", "auto"])
def test_token_grids_identical_xla_sampler(pair, sampler, compact, cfg_fold):
    # the exact top-k path: what JAX `generate(injected_gumbel_noise=...,
    # sampler="xla")` gives, and what "auto" means under injected noise
    want, got = _generate_both(
        *pair, 6, sampler=sampler, cond_scale=3.0, compact=compact, cfg_fold=cfg_fold, return_ids=True
    )
    np.testing.assert_array_equal(got, want)


def test_auto_sampler_is_xla_under_injected_noise(pair):
    _, pm = pair
    te, mask, g = _inputs(6)
    kw = dict(text_embeds=torch.from_numpy(te), timesteps=6, injected_gumbel_noise=torch.from_numpy(g), return_ids=True)
    xla, auto = pm.generate(sampler="xla", **kw), pm.generate(**kw)
    assert torch.equal(xla, auto)
    with pytest.raises(ValueError, match="sampler must be"):
        pm.generate(sampler="pallas", **kw)


@pytest.mark.parametrize("timesteps", [7, 12])
def test_token_grids_identical_other_step_counts(pair, timesteps):
    # step counts whose schedules round differently under torch.linspace
    want, got = _generate_both(*pair, timesteps, cond_scale=2.5, temperature=0.8, return_ids=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("timesteps", [7, 12])
def test_token_grids_identical_other_step_counts_xla_sampler(pair, timesteps):
    want, got = _generate_both(
        *pair, timesteps, sampler="xla", cond_scale=2.5, temperature=0.8, return_ids=True
    )
    np.testing.assert_array_equal(got, want)


def test_token_grids_identical_self_cond_no_null_fold():
    want, got = _generate_both(*_pair(self_cond=True), 6, null_fold=False, return_ids=True)
    np.testing.assert_array_equal(got, want)


def test_images_match(pair):
    want, got = _generate_both(*pair, 6)
    assert got.shape == want.shape == (B, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_generator_drives_the_sampler_noise(pair, sampler="fused"):
    _, pm = pair
    te = torch.from_numpy(_inputs(4)[0])

    def run(seed):
        gen = torch.Generator().manual_seed(seed) if seed is not None else None
        return pm.generate(generator=gen, text_embeds=te, timesteps=4, return_ids=True, sampler=sampler)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(None), run(0))
    assert int(a.max()) < VOCAB  # no mask id reaches the output


def test_generator_drives_the_xla_sampler_noise(pair):
    test_generator_drives_the_sampler_noise(pair, sampler="xla")


@pytest.mark.parametrize(
    "kwargs, item",
    [
        (dict(negative_texts=["a blur"] * B), None),
        (dict(neg_text_embeds=torch.zeros(B, L, TEXT_DIM)), None),
        (dict(known_token_ids=torch.zeros(B, 4, 4, dtype=torch.long), known_mask=torch.zeros(B, 4, 4, dtype=torch.bool)), None),
        (dict(cond_scale=(1.0, 3.0)), None),
        (dict(fmap_size=8), None),
        (dict(hf_weights="google/t5-v1_1-base"), "A13"),
        (dict(vae_train=True), None),
        (dict(hf_tokenizer="google/t5-v1_1-base"), "A13"),
    ],
)
def test_unported_options_raise(pair, kwargs, item, monkeypatch):
    # the sampling surfaces run now (None: the call returns a token grid),
    # and so does the VAE's training encode (LFQ's losses, ROADMAP A10)
    _, pm = pair
    if "vae_train" in kwargs:
        _, ids, aux = pm.vae.encode(torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0)), train=True)
        assert ids.shape == (1, 4, 4) and torch.isfinite(aux) and float(aux) != 0.0
        return
    if item is None:
        monkeypatch.setattr(pm.transformer, "encode_text", lambda texts: torch.ones(len(texts), 3, TEXT_DIM))
        ids = pm.generate(**(dict(text_embeds=torch.ones(B, L, TEXT_DIM), timesteps=2, return_ids=True) | kwargs))
        side = int(kwargs.get("fmap_size", 4))
        assert ids.shape == (B, side, side) and int(ids.max()) < VOCAB
        return
    # "A13": the Hugging Face files, ported with ROADMAP A13, are read from
    # local files only, so a name that is not in the local cache raises
    assert item == "A13"
    with pytest.raises(OSError):
        if "hf_tokenizer" in kwargs:
            HFTokenizer(kwargs["hf_tokenizer"])
        else:
            load_hf_t5_weights(None, kwargs["hf_weights"])


def test_port_imports_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "muse_maskgit_pytorch_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    assert "muse_maskgit_pytorch_tpu_torch.models.t5" in modules
    assert "muse_maskgit_pytorch_tpu_torch.models.vgg" in modules
    assert "muse_maskgit_pytorch_tpu_torch.utils.images" in modules
    for serving in ("serving", "serving_http", "utils.checkpoint", "utils.msgpack_codec", "utils.png"):
        assert f"muse_maskgit_pytorch_tpu_torch.{serving}" in modules
    for training in ("data", "ema", "optim", "preemption", "shard_loader", "trainers"):
        assert f"muse_maskgit_pytorch_tpu_torch.training.{training}" in modules
    assert "muse_maskgit_pytorch_tpu_torch.utils.metrics" in modules
    banned = ("jax", "flax", "optax", "orbax", "msgpack", "PIL", "muse_maskgit_pytorch_tpu")
    code = (
        f"import sys, importlib, muse_maskgit_pytorch_tpu_torch; [importlib.import_module(m) for m in {modules!r}]; "
        f"bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]; "
        "assert not bad, bad"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT
    )
    # nor inside a function: every import statement of the port and of
    # chip_smoke.py, but Pillow's where images become PIL images on request
    # and where the image dataset decodes a JPEG
    lazy_pil = {"utils/images.py", "serving.py", "training/data.py"}
    for path in [*(ROOT / "muse_maskgit_pytorch_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                rel = path.relative_to(ROOT / "muse_maskgit_pytorch_tpu_torch").as_posix() if path.name != "chip_smoke.py" else ""
                assert top not in banned or (top == "PIL" and rel in lazy_pil), f"{path.name} imports {name}"
