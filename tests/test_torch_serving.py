"""The port's serving pipeline (`muse_maskgit_pytorch_tpu_torch.serving`) at a
toy size on the CPU: chunking and padding, the seed stream, per-row guidance
and negative prompts in one batch, editing, the cascade's hand-off, warmup.

Tolerances: every comparison of images is exact on the uint8 output (the
port's pipeline against the port's own `generate` / `edit` called directly
with the generator the pipeline derived, f32 on the CPU); `_quantize_u8`
equals the JAX package's exactly.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu.serving import _quantize_u8 as jax_quantize_u8
from muse_maskgit_pytorch_tpu_torch import MaskGit, MaskGitTransformer, Muse, VQGanVAE
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.models.maskgit import child_generators
from muse_maskgit_pytorch_tpu_torch.serving import GeneratePipeline, _quantize_u8, backend_compile_count

TINY_T5 = "test/tiny-t5-serving"
pt5.T5_CONFIGS.setdefault(TINY_T5, pt5.T5Config(32, 64, 2, 16, 2, True))
TEXT_LEN = 8


def toy_maskgit(image_size=16, cond=None, vae=None, seed=0, vae_seed=0):
    """A port MaskGit (VAE of two layers: 4 x 4 tokens at 16px) on the CPU;
    a super-res stage with `cond` conditions on `vae` too."""
    if vae is None:
        vae = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=32, device="cpu", generator=torch.Generator().manual_seed(vae_seed))
    fmap = image_size // 4
    tr = MaskGitTransformer(
        num_tokens=32, dim=32, seq_len=fmap * fmap, depth=1, dim_head=16, heads=2, t5_name=TINY_T5,
        generator=torch.Generator().manual_seed(seed), device="cpu",
    )
    return MaskGit(
        image_size=image_size, cond_image_size=cond, transformer=tr, vae=vae, cond_vae=vae if cond else None,
        device="cpu",
    ).eval()


def pipe(model=None, **kw):
    kw = dict(batch_size=2, timesteps=2, text_len=TEXT_LEN, return_pil=False, device="cpu") | kw
    return GeneratePipeline(model if model is not None else toy_maskgit(), **kw)


@pytest.fixture(scope="module")
def model():
    return toy_maskgit()


def cascade(shared=True):
    vae = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=32, device="cpu", generator=torch.Generator().manual_seed(0))
    base = toy_maskgit(16, vae=vae)
    sr = toy_maskgit(32, cond=16, vae=vae if shared else None, seed=1, vae_seed=5)
    return Muse(base, sr, device="cpu")


def test_quantize_u8_equals_jax():
    k = np.arange(256, dtype=np.float32)
    edges = np.concatenate([k / 255, (k + 0.5) / 255])
    x = np.concatenate([
        edges, np.nextafter(edges, np.float32(-1)), np.nextafter(edges, np.float32(2)),
        np.float32([-1e30, -1.0, -0.0, 0.0, 1.0, 1.5, 1e30, 0.5 / 255, 254.5 / 255]),
        np.random.RandomState(0).uniform(-0.5, 1.5, 4000).astype(np.float32),
    ]).astype(np.float32)
    want = np.asarray(jax_quantize_u8(jnp.asarray(x)))
    got = _quantize_u8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_pipeline_chunks_pads_and_counts(model):
    p = pipe(model, batch_size=4, return_pil=True)
    assert p.warmup() > 0
    images = p(["a", "b", "c", "d", "e"])
    assert len(images) == 5 and images[0].size == (16, 16)
    assert p.stats["batches"] == 2 and p.stats["images"] == 5 and p.stats["requests"] == 1
    assert p.images_per_second is not None
    out = pipe(model)("hello")
    assert out.shape == (1, 16, 16, 3) and out.dtype == np.uint8


def test_pipeline_images_equal_direct_generate(model):
    """Three prompts in batches of two: each batch is `_quantize_u8` of the
    model's own `generate` with the generator the pipeline derived, and
    the padding row is dropped."""
    prompts = ["a red fox", "a blue bird", "a cat"]
    got = pipe(model, seed=11)(prompts)
    twin = pipe(model, seed=11)  # the same seed stream
    want = []
    with torch.inference_mode():
        for chunk in (prompts[:2], prompts[2:] + [""]):
            embeds, mask = twin._encode_prompts(chunk)
            img = model.generate(
                text_embeds=embeds, text_mask=mask, generator=twin._next_generator(), timesteps=2, cond_scale=3.0
            )
            want.append(_quantize_u8(img).numpy())
    np.testing.assert_array_equal(got, np.concatenate(want)[:3])


def test_seed_stream_advances_and_repeats(model):
    p = pipe(model, seed=3)
    a, b = p(["same", "same"]), p(["same", "same"])
    assert not np.array_equal(a, b)  # the stream advances between batches
    np.testing.assert_array_equal(a, pipe(model, seed=3)(["same", "same"]))  # and one seed repeats it


def test_per_prompt_cond_scale_rows_equal_solo_runs(model):
    """A batch mixing guidance scales gives each row what that row's scale
    gives for the whole batch (same seed)."""
    mixed = pipe(model, seed=13)(["a", "b"], cond_scale=[2.0, 6.0])
    lo = pipe(model, seed=13)(["a", "b"], cond_scale=2.0)
    hi = pipe(model, seed=13)(["a", "b"], cond_scale=6.0)
    np.testing.assert_array_equal(mixed[0], lo[0])
    np.testing.assert_array_equal(mixed[1], hi[1])
    assert not np.array_equal(lo, hi)
    # the default scale as a per-row vector is the default program's result
    np.testing.assert_array_equal(pipe(model, seed=13)(["a", "b"], cond_scale=3.0), pipe(model, seed=13)(["a", "b"]))
    with pytest.raises(ValueError, match="cond_scale"):
        pipe(model)(["a", "b"], cond_scale=[1.0])


def test_negative_prompt_rows(model):
    """Rows with and without a negative prompt in one batch: each equals
    its row run alone, and a row without one (all-zero negative
    embeddings) equals plain guidance."""
    mixed = pipe(model, seed=21)(["a cat", "a dog"], negative_prompts=["blurry", None])
    solo_neg = pipe(model, seed=21)(["a cat", "a dog"], negative_prompts="blurry")
    plain = pipe(model, seed=21)(["a cat", "a dog"])
    np.testing.assert_array_equal(mixed[0], solo_neg[0])
    np.testing.assert_array_equal(mixed[1], plain[1])
    assert not np.array_equal(mixed[0], plain[0])  # the negative prompt applied
    # a row's negative prompt leaves the other row alone
    other = pipe(model, seed=21)(["a cat", "a dog"], negative_prompts=["low-res", None])
    np.testing.assert_array_equal(other[1], mixed[1])
    with pytest.raises(ValueError, match="negative_prompts"):
        pipe(model)(["a", "b"], negative_prompts=["x"])


def test_pipeline_negative_prompt_reaches_generate_and_edit(model, monkeypatch):
    p = pipe(model, negative_prompt="blurry", seed=2)
    seen = []
    orig = model.generate

    def spy(*a, **kw):  # `edit` calls `generate` with its keywords
        seen.append(kw.get("neg_text_embeds"))
        return orig(*a, **kw)

    monkeypatch.setattr(model, "generate", spy)
    p(["a", "b"])
    p.edit(np.zeros((2, 16, 16, 3), np.float32), np.ones((2, 16, 16), bool), ["a", "b"])
    assert len(seen) == 2 and all(s is not None and s.shape == (2, TEXT_LEN, 32) for s in seen)
    assert seen[0] is seen[1]  # encoded once per pipeline


def test_edit_pads_and_passes_untouched_rows(model):
    """Five sources in batches of four: row 0 edits its top half, the rest
    keep every token (the VAE round trip of their source), and each batch
    equals `model.edit` with the pipeline's generator."""
    rs = np.random.RandomState(0)
    images = rs.uniform(size=(5, 16, 16, 3)).astype(np.float32)
    masks = np.zeros((5, 16, 16), bool)
    masks[0, :8] = True
    prompts = ["a", "b", "c", "d", "e"]
    out = pipe(model, batch_size=4, seed=7).edit(images, masks, prompts)
    assert out.shape == (5, 16, 16, 3) and out.dtype == np.uint8
    with torch.inference_mode():
        _, ids, _ = model.vae.encode(torch.from_numpy(images[1:]))
        np.testing.assert_array_equal(out[1:], _quantize_u8(model.vae.decode_from_ids(ids)).numpy())
        twin = pipe(model, batch_size=4, seed=7)
        embeds, tmask = twin._encode_prompts(prompts[:4])
        direct = model.edit(
            torch.from_numpy(images[:4]), torch.from_numpy(masks[:4]), generator=twin._next_generator(),
            text_embeds=embeds, text_mask=tmask, timesteps=2, cond_scale=3.0,
        )
    np.testing.assert_array_equal(out[:4], _quantize_u8(direct).numpy())
    # uint8 sources and a per-prompt scale take the same path
    u8 = pipe(model, batch_size=4, seed=7).edit((images * 255).astype(np.uint8), masks, prompts, cond_scale=[2.0] * 5)
    assert u8.shape == (5, 16, 16, 3)
    with pytest.raises(ValueError, match="align"):
        pipe(model).edit(images[:2], masks[:3], ["a", "b"])


def test_cascade_cond_via_resolution():
    """`cond_via="auto"` is "ids" exactly when the stages' VAE clones hold
    one VAE's weights; "ids" then equals "auto", "pixels" differs; a
    cascade of two VAEs refuses "ids" and serves "pixels"."""
    auto = pipe(cascade(), seed=7)
    assert auto.cond_via == "ids"
    explicit = pipe(cascade(), seed=7, cond_via="ids")
    pixels = pipe(cascade(), seed=7, cond_via="pixels")
    prompts = ["a cat", "a dog", "a fox"]
    a, e, p = auto(prompts), explicit(prompts), pixels(prompts)
    assert a.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(a, e)
    assert not np.array_equal(a, p)
    assert pipe(cascade(shared=False)).cond_via == "pixels"
    with pytest.raises(ValueError, match="share"):
        pipe(cascade(shared=False), cond_via="ids")
    with pytest.raises(ValueError, match="cascade"):
        pipe(toy_maskgit(), cond_via="ids")
    with pytest.raises(ValueError, match="auto/pixels/ids"):
        pipe(cascade(), cond_via="tokens")


def test_cascade_batch_equals_direct_chain():
    """A cascade batch: the base stage's ids, then the super-res stage, each
    with the child generator `child_generators` derives from the batch's."""
    muse = cascade()
    got = pipe(muse, seed=5)(["a cat", "a dog"])
    twin = pipe(muse, seed=5)
    with torch.inference_mode():
        embeds, mask = twin._encode_prompts(["a cat", "a dog"])
        g_base, g_sr = child_generators(twin._next_generator(), "cpu")
        kw = dict(text_embeds=embeds, text_mask=mask, timesteps=2, cond_scale=3.0)
        ids = muse.base_maskgit.generate(generator=g_base, return_ids=True, **kw)
        img = muse.superres_maskgit.generate(generator=g_sr, cond_token_ids=ids, **kw)
    np.testing.assert_array_equal(got, _quantize_u8(img).numpy())


def test_warmup_surfaces():
    p = pipe(seed=3)
    before = backend_compile_count()
    assert p.warmup("all") > 0
    assert p.warm_surfaces == set(GeneratePipeline.WARMUP_SURFACES) == {
        "generate", "dynamic_scale", "neg_dynamic", "edit", "edit_dynamic_scale"
    }
    assert set(p.stats["warmup_seconds"]) == p.warm_surfaces
    assert p.stats["batches"] == 0  # warmup serves nobody
    assert backend_compile_count() == before  # no kernel library on the CPU
    c = pipe(cascade(), seed=4)
    c.warmup(("generate", "edit"))
    assert c.warm_surfaces == {"generate", "edit"}
    with pytest.raises(ValueError, match="unknown warmup surface"):
        p.warmup("compile")


def test_output_size_and_rectangular_override(model):
    assert pipe(model).output_size == (16, 16)
    rect = pipe(model, image_size=(8, 24))
    assert rect.output_size == (8, 24) and rect.image_size == 16  # edit's native size stays
    assert rect(["a", "b"]).shape == (2, 8, 24, 3)
    c = pipe(cascade(), image_size=(8, 24))
    assert c.output_size == (16, 48) and c("one").shape == (1, 16, 48, 3)


def test_rerank_candidates_equal_direct_generate_reranked(model):
    got = pipe(model, seed=5, rerank_candidates=3, rerank_score="logprob")(["a cat", "a dog"])
    twin = pipe(model, seed=5)
    with torch.inference_mode():
        embeds, mask = twin._encode_prompts(["a cat", "a dog"])
        want = model.generate_reranked(
            text_embeds=embeds, text_mask=mask, generator=twin._next_generator(), num_candidates=3,
            score_method="logprob", timesteps=2, cond_scale=3.0,
        )
    np.testing.assert_array_equal(got, _quantize_u8(want).numpy())
    assert not np.array_equal(got, pipe(model, seed=5)(["a cat", "a dog"]))
    with pytest.raises(ValueError, match="rerank_candidates"):
        pipe(model, rerank_candidates=0)


def test_pipeline_work_runs_in_inference_mode_on_its_thread(model, monkeypatch):
    """The pipeline enters inference mode itself, on the thread that calls
    it (a server's worker), whatever the caller's thread does."""
    p = pipe(model)
    modes = []
    to_host = p._to_host
    monkeypatch.setattr(p, "_to_host", lambda imgs: (modes.append(torch.is_inference_mode_enabled()), to_host(imgs))[1])
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("images", p(["a", "b", "c"])))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and out["images"].shape == (3, 16, 16, 3)
    assert modes == [True, True]


class _FakeMesh:
    """Axis names and sizes, as a `DeviceMesh` reports them."""

    def __init__(self, axes):
        self.mesh_dim_names, self.shape = tuple(axes), tuple(axes.values())

    def get_local_rank(self, axis):
        return 0


def test_unported_and_wrong_devices_raise(model):
    # a batch that does not divide over the mesh's data axis
    with pytest.raises(ValueError, match="must divide over the mesh's 'data' axis"):
        pipe(model, batch_size=3, mesh=_FakeMesh({"data": 2}))
    if not torch.cuda.is_available():
        # built without device="cpu", a pipeline runs on the card or raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GeneratePipeline(model)
