"""The port's evaluation (`utils/eval.py`, `models/inception.py`) against the
JAX package's, on the CPU, from the same numpy inputs.

The JAX towers are built once per module, abstractly (`nnx.eval_shape`),
and filled with seeded numpy weights, BatchNorm statistics included (a
random-init JAX InceptionV3 takes about 17 s to build here); the port's
towers take the same weights through `utils.from_jax.load_jax_state`.
Features are held at rtol 1e-4, atol 1e-4 of the JAX features' largest
magnitude; the numpy moments bit-equal; the distances within 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from muse_maskgit_pytorch_tpu.models.inception import InceptionV3 as JInceptionV3
from muse_maskgit_pytorch_tpu.models.vgg import VGG16 as JVGG16
from muse_maskgit_pytorch_tpu.utils import checkpoint as jckpt
from muse_maskgit_pytorch_tpu.utils import eval as jeval

import muse_maskgit_pytorch_tpu_torch as port
from muse_maskgit_pytorch_tpu_torch.models.inception import InceptionV3
from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16
from muse_maskgit_pytorch_tpu_torch.utils import checkpoint as pckpt
from muse_maskgit_pytorch_tpu_torch.utils import eval as peval
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state
from muse_maskgit_pytorch_tpu_torch.utils.metrics import profile_trace
from tests.torch_threads import few_threads  # noqa: F401

RTOL = 1e-4  # and atol RTOL * max|jax|



def close(got, want):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))


def _fill(rng):
    """Seeded numpy values for each leaf of a tower: He-scaled kernels, and
    BatchNorm statistics away from (0, 1) so the inference BN is exercised."""

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return jnp.asarray(rng.standard_normal(s.shape, np.float32) * np.float32(np.sqrt(2.0 / fan_in)))
        if name == "bn_var":
            return jnp.asarray(1.0 + 0.1 * rng.random(s.shape, np.float32))
        if name == "bn_scale":
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(s.shape, np.float32))
        return jnp.asarray(0.05 * rng.standard_normal(s.shape, np.float32))  # biases, bn_mean, bn_bias

    return leaf


def _jax_tower(cls, seed):
    graphdef, state = nnx.split(nnx.eval_shape(lambda: cls(rngs=nnx.Rngs(0))))
    state.replace_by_pure_dict(jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), state.to_pure_dict()))
    return nnx.merge(graphdef, state)


def _jax_tree(module):
    return jax.tree.map(np.asarray, nnx.state(module).to_pure_dict())


def _bridged(cls, jm):
    """The port's tower with the JAX tower's weights (built on the meta
    device: a CPU random init of VGG16's 138 M parameters takes seconds)."""
    with torch.device("meta"):
        pm = cls(device="meta")
    pm.to_empty(device="cpu")
    assert load_jax_state(pm, _jax_tree(jm)) == []
    return pm


@pytest.fixture(scope="module")
def inception_pair():
    jm = _jax_tower(JInceptionV3, 0)
    return jm, _bridged(InceptionV3, jm)


@pytest.fixture(scope="module")
def vgg_pair():
    jm = _jax_tower(JVGG16, 1)
    return jm, _bridged(VGG16, jm)


def _images(seed, shape, lo=0.0):
    return np.random.default_rng(seed).uniform(lo, 1.0, size=shape).astype(np.float32)


# -- FeatureStats, the distance ------------------------------------------------


def _feature_batches(dim=16, sizes=(5, 7, 3)):
    rng = np.random.default_rng(3)
    return [rng.standard_normal((n, dim)).astype(np.float32) for n in sizes]


def _same_moments(p, j):
    assert (p.dim, p.n) == (j.dim, j.n)
    assert np.array_equal(p._sum, j._sum) and np.array_equal(p._outer, j._outer)


def test_feature_stats_moments_bit_equal_to_jax():
    batches = _feature_batches()
    j, p, p_tensor = jeval.FeatureStats(16), peval.FeatureStats(16), peval.FeatureStats(16)
    for f in batches:
        j.update(f)
        p.update(f)
        p_tensor.update(torch.from_numpy(f))  # a tensor on any device: moved to the host
    _same_moments(p, j)
    _same_moments(p_tensor, j)
    pm, pc = p.mean_cov()
    jm, jc = j.mean_cov()
    assert np.array_equal(pm, jm) and np.array_equal(pc, jc)
    # merge: shards add up as in JAX
    ja, jb = jeval.FeatureStats(16).update(batches[0]), jeval.FeatureStats(16).update(batches[1])
    pa, pb = peval.FeatureStats(16).update(batches[0]), peval.FeatureStats(16).update(batches[1])
    _same_moments(pa.merge(pb), ja.merge(jb))
    with pytest.raises(ValueError, match="expected"):
        p.update(np.zeros((2, 15), np.float32))
    with pytest.raises(ValueError, match="dim mismatch"):
        p.merge(peval.FeatureStats(8))
    with pytest.raises(ValueError, match=">= 2 samples"):
        peval.FeatureStats(4).update(np.ones((1, 4))).mean_cov()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["ref.npz", "coco.ref"])
def test_stats_files_cross_the_packages(tmp_path, writer, name):
    """A file either package writes loads in the other; both append `.npz`
    to another suffix and return the name written."""
    jw, pw = jeval.FeatureStats(16), peval.FeatureStats(16)
    for f in _feature_batches():
        jw.update(f)
        pw.update(f)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    written = {"jax": jw.save(tmp_path / "jax" / name), "port": pw.save(tmp_path / "port" / name)}
    expected = "ref.npz" if name == "ref.npz" else "coco.ref.npz"
    assert written == {d: str(tmp_path / d / expected) for d in ("jax", "port")}
    reader = peval.FeatureStats if writer == "jax" else jeval.FeatureStats
    _same_moments(reader.load(written[writer]), jw)


def test_frechet_distance_and_fid_match_jax():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((40, 12)), rng.standard_normal((40, 12)) * 1.3 + 0.2
    mu1, c1, mu2, c2 = a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)
    got, want = peval.frechet_distance(mu1, c1, mu2, c2), jeval.frechet_distance(mu1, c1, mu2, c2)
    assert abs(got - want) <= 1e-9 and want > 0
    assert abs(peval.frechet_distance(mu1, c1, mu1, c1)) < 1e-6
    sa, sb = peval.FeatureStats(12).update(a), peval.FeatureStats(12).update(b)
    ja, jb = jeval.FeatureStats(12).update(a), jeval.FeatureStats(12).update(b)
    assert abs(peval.fid_score(sa, sb) - jeval.fid_score(ja, jb)) <= 1e-9


# -- the towers and the extractors ---------------------------------------------


def test_inception_features_match_jax(inception_pair):
    jm, pm = inception_pair
    x = _images(5, (2, 80, 80, 3), lo=-1.0)
    want = np.asarray(nnx.jit(lambda m, x: m(x))(jm, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (2, InceptionV3.FEATURE_DIM)
    close(got, want)


@pytest.mark.parametrize("size", [128, 32], ids=["shrink_128_to_96", "grow_32_to_96"])
def test_inception_extractor_matches_jax(inception_pair, size):
    """The resize (antialiased when it shrinks, as `jax.image.resize`), the
    [-1, 1] rescale and the tower."""
    jm, pm = inception_pair
    x = _images(6, (2, size, size, 3))
    want = jeval.make_inception_extractor(inception=jm, resize_to=96)(x)
    got = peval.make_inception_extractor(inception=pm, resize_to=96)(x)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    close(got, want)


def test_vgg_extractor_matches_jax(vgg_pair):
    jm, pm = vgg_pair
    x = _images(7, (2, 64, 64, 3))
    want = jeval.make_vgg_extractor(vgg=jm)(x)
    got = peval.make_vgg_extractor(vgg=pm)(torch.from_numpy(x))
    assert got.shape == (2, 4096)
    close(got, want)


def test_compute_feature_stats_matches_jax(inception_pair):
    jm, pm = inception_pair
    batches = [_images(8 + i, (3, 64, 64, 3)) for i in range(2)]
    # one extractor for both: the moments are bit-equal
    fixed = lambda b: b.reshape(b.shape[0], -1)[:, :24]  # noqa: E731
    _same_moments(peval.compute_feature_stats(batches, fixed), jeval.compute_feature_stats(batches, fixed))
    # each package's own tower: the means and covariances agree
    want = jeval.compute_feature_stats(batches, jeval.make_inception_extractor(inception=jm, resize_to=80))
    got = peval.compute_feature_stats(batches, peval.make_inception_extractor(inception=pm, resize_to=80))
    assert (got.n, got.dim) == (want.n, want.dim) == (6, 2048)
    for g, w in zip(got.mean_cov(), want.mean_cov()):
        close(g, w)
    # streaming into a given accumulator, and an empty stream
    more = peval.compute_feature_stats(batches[:1], fixed, stats=peval.FeatureStats(24))
    assert more.n == 3
    with pytest.raises(ValueError, match="no batches"):
        peval.compute_feature_stats([], fixed)


def test_fid_orders_identical_and_shifted_sets(inception_pair):
    _, pm = inception_pair
    extract = peval.make_inception_extractor(inception=pm, resize_to=80)
    a = _images(9, (3, 32, 32, 3))
    b = np.clip(a + 0.25, 0, 1)
    sa, sa2, sb = (peval.compute_feature_stats([x], extract) for x in (a, a, b))
    assert port.fid_score(sa, sa2) < 1e-4 < port.fid_score(sa, sb)


def test_inception_msgpack_round_trip(tmp_path, inception_pair):
    """The JAX package's `save_module` file loads into the port's tower;
    the port's `save_module` writes the same bytes back, and the JAX package
    reads them."""
    jm, pm = inception_pair
    jax_file, port_file = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jckpt.save_module(jm, jax_file)
    with torch.device("meta"):
        fresh = InceptionV3(device="meta")
    fresh.to_empty(device="cpu")
    assert pckpt.load_module(fresh, jax_file) == []
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), pm.state_dict().values()))
    pckpt.save_module(fresh, port_file)
    assert port_file.read_bytes() == jax_file.read_bytes()
    graphdef, state = nnx.split(jm)
    back = nnx.merge(graphdef, jax.tree.map(jnp.zeros_like, state))
    jckpt.load_module(back, port_file)
    for a, b in zip(jax.tree.leaves(_jax_tree(back)), jax.tree.leaves(_jax_tree(jm))):
        assert np.array_equal(a, b)


def test_extractors_build_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (peval.make_inception_extractor, peval.make_vgg_extractor):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_public_names():
    for name in ("FeatureStats", "compute_feature_stats", "fid_score", "frechet_distance",
                 "make_inception_extractor", "make_vgg_extractor"):
        assert getattr(port, name) is getattr(peval, name)
    assert not hasattr(port, "InceptionV3")  # as in the JAX package: models.inception only


@pytest.mark.parametrize("enabled", [True, False], ids=["enabled", "disabled"])
def test_profile_trace(tmp_path, enabled):
    out = tmp_path / "trace"
    with profile_trace(out, enabled=enabled):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(out.glob("*.pt.trace.json")) if out.exists() else []
    assert len(traces) == (1 if enabled else 0)
    if enabled:
        assert "aten::mm" in traces[0].read_text()
