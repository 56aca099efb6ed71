"""Module checkpoints across the two packages: a file written by the JAX
package's `save_module` loads into the port without JAX (the port's msgpack
codec and `load_jax_state`), and a file the port writes loads into the JAX
package. Toy scale, f32 on the CPU.

Tolerances: token grids from `generate` under injected gumbel noise are
identical (exact); every state leaf is bit-equal after a round trip; the
port's file is byte-equal to the one the JAX package writes for the same
state; the codec's bytes and decoded trees equal the `msgpack` package's.
"""

import flax.serialization as ser
import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models.vqgan_vae import VQGanVAE as JVAE
from muse_maskgit_pytorch_tpu.utils import checkpoint as jck
from muse_maskgit_pytorch_tpu_torch import Muse, VQGanVAE
from muse_maskgit_pytorch_tpu_torch.serving import GeneratePipeline
from muse_maskgit_pytorch_tpu_torch.utils import checkpoint as pck
from muse_maskgit_pytorch_tpu_torch.utils import msgpack_codec
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, load_jax_state, to_jax_state

from tests.torch_surface_pairs import VOCAB, build_pair, generate_both, gumbel, text_inputs

EMA_KW = dict(dim=16, layers=2, codebook_size=VOCAB, lookup_free_quantization=False, vq_kwargs=dict(codebook_dim=8, kmeans_init=False))


def jax_state(module):
    return flatten_tree(jax.tree.map(np.asarray, nnx.state(module).to_pure_dict()))


def assert_same_state(a: dict, b: dict):
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))[:8]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def models():
    """(JAX MaskGit, port MaskGit) with different weights: every load below
    has to move all of them."""
    jm, _ = build_pair(seed=5)
    _, pm = build_pair(seed=9)
    return jm, pm


def _tokens_equal(jm, pm):
    rs, te, mask = text_inputs(seed=3)
    want, got = generate_both(jm, pm, te, mask, gumbel(rs, 16), cond_scale=3.0)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("via", ["load_module", "MaskGit.load"])
def test_jax_file_loads_into_port(models, tmp_path, via):
    jm, pm = models
    path = tmp_path / "maskgit.msgpack"
    jm.save(path)
    unused = pck.load_module(pm, path) if via == "load_module" else pm.load(path)
    assert unused == []
    assert_same_state(jax_state(jm), flatten_tree(to_jax_state(pm)))
    assert not any(p.requires_grad for p in pm.vae.parameters())
    _tokens_equal(jm, pm)


def test_port_file_loads_into_jax(tmp_path):
    """The reverse: the port's `save_module` -> the JAX `load_module` (whose
    fresh model starts from other weights), the same tokens; the port's file
    is the JAX package's, byte for byte."""
    j_src, pm = build_pair(seed=6)
    j_dst, _ = build_pair(seed=8)
    path = tmp_path / "port.msgpack"
    pm.save(path)
    j_dst.load(path)
    assert_same_state(jax_state(j_src), jax_state(j_dst))
    _tokens_equal(j_dst, pm)
    assert path.read_bytes() == jck.module_state_bytes(j_src) == pck.module_state_bytes(pm)


@pytest.mark.parametrize(
    "kind", ["plain", "self_critic", "token_critic", "separate_cond_vae"]
)
def test_to_jax_state_is_the_nnx_state(kind):
    """`to_jax_state` writes what `nnx.state(m).to_pure_dict()` holds: the
    same paths (a shared module once, where nnx keeps it), layouts and
    dtypes, bit for bit."""
    kw = {
        "plain": {}, "self_critic": dict(critic="self"), "token_critic": dict(critic="token"),
        "separate_cond_vae": dict(cond_image_size=8),
    }[kind]
    jm, pm = build_pair(**kw)
    assert_same_state(jax_state(jm), flatten_tree(to_jax_state(pm)))


def _ema_pair(seed):
    """A JAX EMA-VQ VAE whose batch statistics are not their init values."""
    jv = JVAE(use_vgg_and_gan=False, rngs=nnx.Rngs(seed), **EMA_KW)
    rs = np.random.RandomState(seed)
    q = jv.quantizer
    q.cluster_size.value = jnp.asarray(rs.rand(VOCAB).astype(np.float32))
    q.embed_avg.value = jnp.asarray(rs.randn(VOCAB, 8).astype(np.float32))
    q.initted.value = jnp.asarray(True)
    return jv


def test_ema_vq_batch_stats_both_ways(tmp_path):
    jv = _ema_pair(1)
    pv = VQGanVAE(use_vgg_and_gan=False, device="cpu", **EMA_KW)
    jv.save(tmp_path / "vae.msgpack")
    assert pv.load(tmp_path / "vae.msgpack") == []
    assert_same_state(jax_state(jv), flatten_tree(to_jax_state(pv)))
    assert pv.quantizer.initted.dtype == torch.bool and bool(pv.quantizer.initted)
    # decode of the same ids agrees (f32 convolutions, 1e-4)
    ids = np.random.RandomState(0).randint(0, VOCAB, (2, 4, 4))
    want = np.asarray(jv.decode_from_ids(jnp.asarray(ids)))
    got = pv.decode_from_ids(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # and back: the port's file into another JAX VAE
    other = _ema_pair(2)
    pv.save(tmp_path / "back.msgpack")
    other.load(tmp_path / "back.msgpack")
    assert_same_state(jax_state(jv), jax_state(other))


def test_discriminator_leaves_are_returned_not_raised(tmp_path):
    """A VAE saved with its GAN tower, loaded into a VAE built without one
    (`use_vgg_and_gan=False`): the port loads the rest and names the
    discriminator's leaves it skipped."""
    jv = JVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=True, rngs=nnx.Rngs(0))
    jv.save(tmp_path / "gan.msgpack")
    pv = VQGanVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=False, device="cpu")
    unused = pv.load(tmp_path / "gan.msgpack")
    assert unused and all(k.startswith("discr.") for k in unused)
    want = {k: v for k, v in jax_state(jv).items() if not k.startswith("discr.")}
    assert_same_state(want, flatten_tree(to_jax_state(pv)))


def test_gan_vae_file_loads_fully_both_ways(tmp_path):
    """The same file into a GAN VAE of the port: every leaf, the
    discriminator's too, and back into a JAX GAN VAE; the VGG tower is never
    saved on either side."""
    jv = JVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=True, rngs=nnx.Rngs(0))
    jv.save(tmp_path / "gan.msgpack")
    pv = VQGanVAE(dim=16, layers=2, codebook_size=VOCAB, device="cpu", generator=torch.Generator().manual_seed(3))
    assert pv.load(tmp_path / "gan.msgpack") == []
    assert_same_state(jax_state(jv), flatten_tree(to_jax_state(pv)))
    pv.set_vgg(torch.nn.Linear(2, 2))  # an injected tower stays out of the file
    pv.save(tmp_path / "back.msgpack")
    assert (tmp_path / "back.msgpack").read_bytes() == (tmp_path / "gan.msgpack").read_bytes()
    other = JVAE(dim=16, layers=2, codebook_size=VOCAB, use_vgg_and_gan=True, rngs=nnx.Rngs(7))
    other.load(tmp_path / "back.msgpack")
    assert_same_state(jax_state(jv), jax_state(other))


def test_default_vae_files_hold_the_same_leaves(tmp_path):
    """Both packages' VQGanVAE default to `use_vgg_and_gan=True`: their
    files hold the same leaves (paths, shapes, dtypes)."""
    JVAE(dim=16, layers=2, codebook_size=VOCAB, rngs=nnx.Rngs(0)).save(tmp_path / "jax.msgpack")
    VQGanVAE(dim=16, layers=2, codebook_size=VOCAB, device="cpu").save(tmp_path / "port.msgpack")
    trees = [flatten_tree(msgpack_codec.unpackb((tmp_path / f).read_bytes())) for f in ("jax.msgpack", "port.msgpack")]
    assert any(k.startswith("discr.") for k in trees[0])
    assert {k: (v.shape, v.dtype) for k, v in trees[0].items()} == {k: (v.shape, v.dtype) for k, v in trees[1].items()}


def test_missing_or_misshapen_leaf_raises(models, tmp_path):
    jm, pm = models
    tree = jax.tree.map(np.asarray, nnx.state(jm).to_pure_dict())
    del tree["transformer"]["norm"]
    (tmp_path / "missing.msgpack").write_bytes(ser.msgpack_serialize(jck._str_keys(tree)))
    with pytest.raises(KeyError, match="transformer.norm"):
        pck.load_module(pm, tmp_path / "missing.msgpack")
    tree = jax.tree.map(np.asarray, nnx.state(jm).to_pure_dict())
    tree["transformer"]["to_logits"]["kernel"] = tree["transformer"]["to_logits"]["kernel"][:, :-1]
    (tmp_path / "shape.msgpack").write_bytes(ser.msgpack_serialize(jck._str_keys(tree)))
    with pytest.raises(ValueError, match="to_logits"):
        pck.load_module(pm, tmp_path / "shape.msgpack")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chunked_leaves_read_back_equal(models, tmp_path, monkeypatch, writer):
    """Leaves over the chunk size travel in flax's chunked form; a small
    limit makes every kernel chunked. Both writers give the same bytes and
    each reader gets the state back."""
    jm, pm = models
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 1000)
    _, src = build_pair(seed=4)
    load_jax_state(src, jax.tree.map(np.asarray, nnx.state(jm).to_pure_dict()))
    path = tmp_path / "chunked.msgpack"
    if writer == "jax":
        jck.save_module(jm, path)
    else:
        pck.save_module(src, path)
    assert path.read_bytes() == jck.module_state_bytes(jm)
    assert b"__msgpack_chunked_array__" in path.read_bytes()
    _, dst = build_pair(seed=7)
    pck.load_module(dst, path)
    assert_same_state(jax_state(jm), flatten_tree(to_jax_state(dst)))
    j_dst, _ = build_pair(seed=2)
    jck.load_module(j_dst, path)
    assert_same_state(jax_state(jm), jax_state(j_dst))


def test_bf16_leaf_keeps_its_bits():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5).astype(ml_dtypes.bfloat16)
    blob = ser.msgpack_serialize({"w": x})
    got = msgpack_codec.unpackb(blob)
    assert got["w"].dtype == torch.bfloat16 and tuple(got["w"].shape) == (3, 5)
    assert torch.equal(got["w"].view(torch.int16), torch.from_numpy(x.view(np.int16)))
    assert msgpack_codec.packb(got) == blob
    # widened to f32 exactly when it fills an f32 parameter
    lin = torch.nn.Linear(3, 5, bias=False)
    load_jax_state(lin, {"kernel": got["w"]})
    np.testing.assert_array_equal(lin.weight.detach().numpy(), x.astype(np.float32).T)


def test_manifests_verify_across_packages(models, tmp_path):
    jm, pm = models
    path = tmp_path / "m.msgpack"
    jck.save_module(jm, path)
    jck.write_manifest(tmp_path, {path.name: jck.manifest_entry(path, jm)})
    assert pck.verify_manifest(path, require=True)
    pck.load_module(pm, path)
    # the port's entry for the same file and state is the JAX package's
    assert pck.manifest_entry(path, pm) == jck.manifest_entry(path, jm)
    # and the port's own save keeps the manifest true for the JAX reader
    pck.save_module(pm, path)
    assert jck.verify_manifest(path, require=True)

    data = path.read_bytes()
    path.write_bytes(data[:-10])  # truncated
    with pytest.raises(ValueError, match="size"):
        pck.verify_manifest(path)
    with pytest.raises(ValueError, match="size"):
        pck.load_module(pm, path)
    flipped = bytearray(data)
    flipped[len(flipped) // 2] ^= 0xFF  # same size, other sha256
    path.write_bytes(bytes(flipped))
    with pytest.raises(ValueError, match="sha256"):
        pck.verify_manifest(path)
    other = tmp_path / "unlisted.msgpack"
    other.write_bytes(data)
    assert pck.verify_manifest(other) is False
    with pytest.raises(ValueError, match="no manifest entry"):
        pck.verify_manifest(other, require=True)


def _random_leaf(rs, depth):
    k = rs.randint(10)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32769, -(2**31) - 1, -(2**63)]
    if k == 0:
        return ints[rs.randint(len(ints))]
    if k == 1:
        return float(rs.randn())
    if k == 2:
        return "é" * int([0, 5, 31, 32, 255, 256, 70000][rs.randint(7)])
    if k == 3:
        return rs.randint(0, 256, [0, 3, 300, 70000][rs.randint(4)]).astype(np.uint8).tobytes()
    if k == 4:
        return None
    if k == 5:
        return bool(rs.randint(2))
    if k == 6:
        dtype = ["float32", "float64", "int32", "int8", "uint16", "bool", "float16", "complex64", "int64"][rs.randint(9)]
        return np.asarray(rs.randn(*rs.randint(0, 4, rs.randint(0, 4)))).astype(dtype)
    if k == 7 and depth < 4:
        return [_random_leaf(rs, depth + 1) for _ in range(rs.randint(0, 20))]
    if depth < 4:
        return {f"k{i}" + "y" * rs.randint(40): _random_leaf(rs, depth + 1) for i in range(rs.randint(0, 20))}
    return 7


def _same_tree(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same_tree, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    return type(a) is type(b) and (a == b or (a != a and b != b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_equals_msgpack_package(seed):
    """Random nested trees of every type flax writes: the port's bytes are
    the msgpack package's (with flax's ext hooks), and the port decodes the
    package's bytes to the same tree."""
    rs = np.random.RandomState(seed)
    for _ in range(30):
        tree = {f"r{j}": _random_leaf(rs, 0) for j in range(rs.randint(1, 30))}
        ref = msgpack.packb(tree, default=ser._msgpack_ext_pack, strict_types=True)
        assert msgpack_codec.packb(tree) == ref
        want = msgpack.unpackb(ref, ext_hook=ser._msgpack_ext_unpack, raw=False, strict_map_key=False)
        assert _same_tree(want, msgpack_codec.unpackb(ref))


def test_codec_rejects_bad_input():
    with pytest.raises(ValueError, match="ends"):
        msgpack_codec.unpackb(msgpack_codec.packb({"a": np.zeros(4)})[:-3])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_codec.unpackb(msgpack_codec.packb(1) + b"\x01")
    with pytest.raises(TypeError, match="tuple"):
        msgpack_codec.packb({"a": (1, 2)})
    with pytest.raises(TypeError, match="complex"):
        msgpack_codec.packb({"a": 1j})
    with pytest.raises(ValueError, match="ext type 2"):  # flax's complex ext: not a module's state
        msgpack_codec.unpackb(ser.msgpack_serialize({"a": 1j}))


def test_cascade_saved_sharing_one_vae_still_hands_over_ids(tmp_path):
    """Two stages built around one VAE, saved and loaded into stages built
    around two different VAEs: the loaded clones hold one VAE's weights, so
    the pipeline's `cond_via="auto"` resolves to "ids" again."""
    from tests.test_torch_serving import toy_maskgit

    vae = VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=32, device="cpu", generator=torch.Generator().manual_seed(0))
    toy_maskgit(16, vae=vae).save(tmp_path / "base.msgpack")
    toy_maskgit(32, cond=16, vae=vae, seed=1).save(tmp_path / "sr.msgpack")
    base, sr = toy_maskgit(16, vae_seed=3), toy_maskgit(32, cond=16, seed=1, vae_seed=4)
    fresh = GeneratePipeline(Muse(base, sr, device="cpu"), device="cpu", batch_size=2, text_len=8)
    assert fresh.cond_via == "pixels"
    base.load(tmp_path / "base.msgpack")
    sr.load(tmp_path / "sr.msgpack")
    loaded = GeneratePipeline(Muse(base, sr, device="cpu"), device="cpu", batch_size=2, text_len=8)
    assert loaded.cond_via == "ids"
