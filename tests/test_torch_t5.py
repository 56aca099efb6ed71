"""Port parity: the T5 text encoder of
`muse_maskgit_pytorch_tpu_torch/models/t5.py` against the JAX module, with
the JAX weights copied across by `utils.from_jax`. All f32 on the CPU at a
toy config (d_model 32, 2 layers, 2 heads x 16); tolerance 1e-5 (f32 matmuls
summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import t5 as jt5
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state

GATED = "test/torch-tiny-t5"
RELU = "test/torch-tiny-t5-relu"
SHAPE = dict(d_model=32, d_ff=64, num_heads=2, d_kv=16, num_layers=2)
TOL = dict(atol=1e-5, rtol=1e-5)

for _name, _gated in ((GATED, True), (RELU, False)):
    jt5.T5_CONFIGS.setdefault(_name, jt5.T5Config(gated=_gated, **SHAPE))
    pt5.T5_CONFIGS.setdefault(_name, pt5.T5Config(gated=_gated, **SHAPE))


def jax_params(module):
    return jax.tree.map(np.asarray, nnx.state(module, nnx.Param).to_pure_dict())


def bridged_pair(name, seed=0):
    """A JAX encoder with non-trivial norm weights and the port's encoder
    holding the same weights."""
    jm = jt5.T5Encoder(jt5.get_config(name), rngs=nnx.Rngs(seed))
    rs = np.random.RandomState(seed + 1)
    for norm in [jm.final_norm] + [n for blk in jm.blocks for n in (blk.ln1, blk.ln2)]:
        norm.weight[...] = jnp.asarray(1 + 0.1 * rs.randn(SHAPE["d_model"]).astype(np.float32))
    pm = pt5.T5Encoder(pt5.get_config(name), device="cpu")
    assert load_jax_state(pm, jax_params(jm)) == []
    return jm, pm


@pytest.mark.parametrize("n", [1, 2, 8, 9, 16, 17, 33, 64, 129, 256])
def test_bucket_table_matches_jax_at_length(n):
    want = jt5._relative_position_bucket(jnp.arange(n)[None, :] - jnp.arange(n)[:, None])
    np.testing.assert_array_equal(pt5._relative_position_bucket(n), np.asarray(want))


def test_bucket_table_matches_jax_for_every_length():
    # a table depends on key - query alone: every n in 1..256 reads the same
    # 511 distances, eagerly and under jit (where XLA folds the constants)
    rel = jnp.arange(-255, 256)
    eager = np.asarray(jt5._relative_position_bucket(rel))
    jitted = np.asarray(jax.jit(jt5._relative_position_bucket)(rel))
    np.testing.assert_array_equal(eager, jitted)
    for n in range(1, 257):
        idx = np.arange(n)[None, :] - np.arange(n)[:, None] + 255
        np.testing.assert_array_equal(pt5._relative_position_bucket(n), eager[idx], err_msg=f"n={n}")


@pytest.mark.parametrize("name", [GATED, RELU], ids=["gated_tanh_gelu", "relu"])
def test_encoder_forward_matches_jax(name):
    jm, pm = bridged_pair(name)
    rs = np.random.RandomState(3)
    ids = rs.randint(2, 260, size=(3, 24)).astype(np.int32)
    mask = np.ones((3, 24), bool)
    mask[0, 17:] = False
    mask[2, 5:] = False  # ragged, with keys past distance 16 in play
    want = np.asarray(jm(jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_feed_forward_gelu_is_the_tanh_form():
    jm, pm = bridged_pair(GATED)
    x = np.random.RandomState(4).randn(2, 5, SHAPE["d_model"]).astype(np.float32) * 3
    want = np.asarray(jm.blocks[0].ff(jnp.asarray(x)))
    with torch.no_grad():
        ff = pm.blocks[0].ff
        got = ff(torch.from_numpy(x)).numpy()
        erf = ff.wo(torch.nn.functional.gelu(ff.wi_0(torch.from_numpy(x))) * ff.wi_1(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(erf - want).max() > 1e-4  # the erf form is another function


def test_masked_keys_are_filled_with_minus_1e9_not_inf():
    # a batch row with no real key at all stays finite and equals JAX's
    jm, pm = bridged_pair(GATED)
    ids = np.full((2, 8), 7, np.int32)
    mask = np.ones((2, 8), bool)
    mask[1] = False
    want = np.asarray(jm(jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "texts, max_length",
    [
        (["a red square", "a blue circle on a hill"], 256),
        (["naïve café — 日本語", "\U0001f600"], 256),
        (["x" * 300, "short"], 256),
        (["", "b"], 256),
        (["abcdefghij"], 6),
    ],
    ids=["ascii", "multibyte", "overlong", "empty", "cut"],
)
def test_byte_tokenizer_matches_jax(texts, max_length):
    want_ids, want_mask = jt5.ByteFallbackTokenizer()(texts, max_length)
    got_ids, got_mask = pt5.ByteFallbackTokenizer()(texts, max_length)
    assert got_ids.dtype == want_ids.dtype and got_mask.dtype == want_mask.dtype
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert (got_ids[np.arange(len(texts)), got_mask.sum(-1) - 1] == 1).all()  # every text keeps its eos


@pytest.fixture(scope="module")
def cached_pair():
    jm, pm = bridged_pair(GATED, seed=5)
    jt5.set_model(GATED, jm)
    pt5.set_model(GATED, pm)
    return jm, pm


@pytest.mark.parametrize(
    "texts",
    [
        ["a red square", "a blue circle on a green hill under the sun"],
        ["", "tiny"],
        "one string",
        ["y" * 400, "z"],
    ],
    ids=["ragged", "empty_prompt", "str", "cut_at_max_length"],
)
def test_t5_encode_text_with_mask_matches_jax(cached_pair, texts):
    want, want_mask = jt5.t5_encode_text_with_mask(texts, name=GATED)
    got, got_mask = pt5.t5_encode_text_with_mask(texts, name=GATED, device="cpu")
    want, want_mask = np.asarray(want), np.asarray(want_mask)
    assert got.shape == want.shape and got.shape[1] % 8 == 0 and got.shape[1] <= pt5.MAX_LENGTH
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got.numpy()[~want_mask] == 0).all()  # padding exactly zero
    # downstream recovers the mask from the embeddings
    np.testing.assert_array_equal((got != 0).any(-1).numpy(), want_mask)
    only = pt5.t5_encode_text(texts, name=GATED, device="cpu")
    assert torch.equal(only, got)


def test_cache_is_keyed_by_name_and_device(cached_pair):
    _, pm = cached_pair
    model, tok = pt5.get_model_and_tokenizer(GATED, device="cpu")
    assert model is pm and isinstance(tok, pt5.ByteFallbackTokenizer)
    assert pt5._key(GATED, "cpu") != pt5._key(GATED, "cuda:0")
    # a name never injected is built at random init from seed 0, once
    a, _ = pt5.get_model_and_tokenizer(RELU, device="cpu")
    b, _ = pt5.get_model_and_tokenizer(RELU, device="cpu")
    assert a is b and not any(p.requires_grad for p in a.parameters())
    fresh = pt5.T5Encoder(pt5.get_config(RELU), generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), fresh.parameters()))


def test_config_table_and_what_waits_for_files():
    assert pt5.T5_CONFIGS.keys() >= {k for k in jt5._BUILTIN_CONFIGS}
    for name in jt5._BUILTIN_CONFIGS:
        assert pt5.get_config(name) == pt5.T5Config(**jt5.get_config(name).__dict__)
    assert pt5.get_encoded_dim(pt5.DEFAULT_T5_NAME) == 768 and pt5.MAX_LENGTH == jt5.MAX_LENGTH
    with pytest.raises(ValueError, match="unknown t5 config"):
        pt5.get_config("no/such-model")
    # Hugging Face files are read from local files only (ROADMAP A13): a
    # name that is not in the local cache raises, and nothing is fetched
    with pytest.raises(OSError):
        pt5.HFTokenizer(pt5.DEFAULT_T5_NAME)
    with pytest.raises(OSError):
        pt5.load_hf_t5_weights(None, pt5.DEFAULT_T5_NAME)


def test_encoder_builds_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt5.T5Encoder(pt5.get_config(GATED))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt5.t5_encode_text(["a"], name=GATED)
