"""The port's Hugging Face T5 files (`utils/convert.py::load_hf_t5_weights`,
`models/t5.py::HFTokenizer` and `get_model_and_tokenizer`) against Hugging
Face's own encoder and the JAX package's, on the CPU, from local files
only: a tiny `T5EncoderModel` and a Unigram tokenizer saved to temporary
directories; any socket connection fails a test that forbids the network.
Embeddings at the tolerance of `tests/test_convert.py`.
"""

import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from muse_maskgit_pytorch_tpu.models import t5 as jt5
from muse_maskgit_pytorch_tpu.utils import convert as jconvert

from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.utils import convert as pconvert
from tests.test_convert import _tiny_hf_t5

transformers = pytest.importorskip("transformers")

T5_TOL = dict(atol=2e-4, rtol=1e-3)
TINY_T5 = dict(d_model=32, d_ff=64, num_heads=4, d_kv=8, num_layers=2, vocab_size=128)


@pytest.fixture(scope="module")
def hf_t5_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_t5")
    hf = _tiny_hf_t5(True).eval()
    hf.save_pretrained(d)
    return hf, d


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "relu"])
def test_load_hf_t5_weights_matches_hf_and_jax(tmp_path, gated):
    hf = _tiny_hf_t5(gated).eval()
    hf.save_pretrained(tmp_path)
    ids = np.array([[5, 9, 17, 33, 1, 0, 0, 0], [2, 3, 1, 0, 0, 0, 0, 0]], np.int32)
    mask = ids != 0
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids.astype(np.int64)), attention_mask=torch.from_numpy(mask)).last_hidden_state

    cfg = dict(TINY_T5, gated=gated)
    from_dir = pt5.T5Encoder(pt5.T5Config(**cfg), generator=torch.Generator().manual_seed(1), device="cpu")
    pconvert.load_hf_t5_weights(from_dir, str(tmp_path))
    in_memory = pt5.T5Encoder(pt5.T5Config(**cfg), generator=torch.Generator().manual_seed(2), device="cpu")
    pt5.load_hf_t5_weights(in_memory, hf)  # the re-export in models.t5
    for p, q in zip(from_dir.parameters(), in_memory.parameters()):
        assert torch.equal(p, q)
    jm = jt5.T5Encoder(jt5.T5Config(**cfg), rngs=nnx.Rngs(0))
    jconvert.load_hf_t5_weights(jm, str(tmp_path))
    want = np.asarray(jm(jnp.asarray(ids), jnp.asarray(mask)))
    got = from_dir(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[mask], ref.numpy()[mask], **T5_TOL)
    np.testing.assert_allclose(got.numpy()[mask], want[mask], **T5_TOL)


def _save_tokenizer(path):
    """A T5-style fast tokenizer (Unigram over a toy vocabulary, pad 0,
    eos 1, unk 2, eos appended) saved as `save_pretrained` writes it."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors
    from transformers import T5TokenizerFast

    words = ["a", "cat", "dog", "on", "the", "mat", "red", "blue", "s", "t", "c", "o", "d", "g", "m", "e", "r"]
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    vocab += [("▁" + w, -1.0 - 0.1 * i) for i, w in enumerate(words)] + [(w, -5.0 - 0.1 * i) for i, w in enumerate(words)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 1)])
    T5TokenizerFast(tokenizer_object=tok, eos_token="</s>", pad_token="<pad>", unk_token="<unk>", extra_ids=0).save_pretrained(path)


def test_hf_tokenizer_reads_a_local_directory(tmp_path):
    _save_tokenizer(tmp_path)
    texts = ["a red cat on the mat", "dog", "blue zzz cat dog mat red a the on"]
    got_ids, got_mask = pt5.HFTokenizer(str(tmp_path))(texts, 8)
    want_ids, want_mask = jt5.HFTokenizer(str(tmp_path))(texts, 8)
    assert got_ids.dtype == np.int32 and got_mask.dtype == bool
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_ids.shape == (3, 8) and got_ids[1, 1] == 1 and not got_mask[1, 2:].any()


@pytest.fixture
def no_network(monkeypatch):
    """Any socket connection fails the test."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    calls = []

    def refuse(self, address, *a, **k):
        calls.append(address)
        raise AssertionError(f"network call to {address}")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    yield calls
    assert calls == []


def test_missing_files_raise_without_a_network_call(tmp_path, no_network):
    model = pt5.T5Encoder(pt5.T5Config(**TINY_T5, gated=True), device="cpu")
    # a missing directory reads as a hub id, which the hub's validator
    # refuses (a ValueError); a hub id not in the local cache is an OSError
    for where in (str(tmp_path / "no-such-dir"), "google/t5-v1_1-base"):
        with pytest.raises((OSError, ValueError)):
            pt5.HFTokenizer(where)
        with pytest.raises((OSError, ValueError)):
            pconvert.load_hf_t5_weights(model, where)


def test_builtin_names_look_for_local_files_first(monkeypatch, no_network, hf_t5_dir):
    """A built-in name takes Hugging Face weights and tokenizer from local
    files where they are and falls back to random init and the byte
    tokenizer where they are not, as the JAX package does; a config
    registered at run time goes straight to random init."""
    hf, d = hf_t5_dir
    name, custom = "google/t5-v1_1-small", "test/torch-convert-t5"
    monkeypatch.setitem(pt5.T5_CONFIGS, name, pt5.T5Config(**TINY_T5, gated=True))
    monkeypatch.setitem(pt5.T5_CONFIGS, custom, pt5.T5Config(**TINY_T5, gated=True))
    monkeypatch.setattr(pt5, "_T5_CACHE", {})
    asked = []
    real_load = pconvert.load_hf_t5_weights

    def load_local(model, where):
        asked.append(where)
        real_load(model, str(d))  # where a local copy of `name` would be

    monkeypatch.setattr(pt5, "load_hf_t5_weights", load_local)
    model, tok = pt5.get_model_and_tokenizer(name, device="cpu")
    assert asked == [name] and pt5._T5_CACHE[pt5._key(name, "cpu")]["pretrained"]
    assert isinstance(tok, pt5.ByteFallbackTokenizer)  # no local tokenizer of `name`
    assert torch.equal(model.token_emb.weight, hf.state_dict()["shared.weight"])
    model, tok = pt5.get_model_and_tokenizer(custom, device="cpu")
    assert asked == [name] and not pt5._T5_CACHE[pt5._key(custom, "cpu")]["pretrained"]
    fresh = pt5.T5Encoder(pt5.T5Config(**TINY_T5, gated=True), generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), fresh.parameters()))
    # a built-in name with no local files: random init, the byte tokenizer
    monkeypatch.setattr(pt5, "load_hf_t5_weights", real_load)
    monkeypatch.setitem(pt5.T5_CONFIGS, "t5-small", pt5.T5Config(**TINY_T5, gated=False))
    model, tok = pt5.get_model_and_tokenizer("t5-small", device="cpu")
    assert isinstance(tok, pt5.ByteFallbackTokenizer) and not pt5._T5_CACHE[pt5._key("t5-small", "cpu")]["pretrained"]
