"""The port's torchvision weight converters (`utils/convert.py`) against
the torch originals and the JAX package's converters, on the CPU, with no
download: the towers are the pure-torch restatements of
`tests/test_convert.py` (torchvision's state-dict layout, random values,
BatchNorm statistics randomised). Features at rtol 1e-4, atol 1e-4 of the
reference's largest magnitude. The Hugging Face converter is held in
`tests/test_torch_hf_t5.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from muse_maskgit_pytorch_tpu.models.inception import InceptionV3 as JInceptionV3
from muse_maskgit_pytorch_tpu.utils import convert as jconvert

from muse_maskgit_pytorch_tpu_torch.models.inception import InceptionV3
from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16
from muse_maskgit_pytorch_tpu_torch.utils import convert as pconvert
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, to_jax_state
from tests.test_convert import _torch_inception_v3, _torchvision_vgg16_truncated
from tests.torch_threads import few_threads  # noqa: F401

RTOL = 1e-4



def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))


def _meta_built(cls):
    with torch.device("meta"):
        m = cls(device="meta")
    return m.to_empty(device="cpu")


def _jax_zeros(cls):
    """A JAX tower with zero leaves, built abstractly (a converter fills it)."""
    graphdef, state = nnx.split(nnx.eval_shape(lambda: cls(rngs=nnx.Rngs(0))))
    state.replace_by_pure_dict(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), state.to_pure_dict()))
    return nnx.merge(graphdef, state)


@pytest.fixture(scope="module")
def inception_sd():
    torch.manual_seed(0)
    tv = _torch_inception_v3().eval()
    g = torch.Generator().manual_seed(1)
    for m in tv.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(0.05 * torch.randn(m.running_mean.shape, generator=g))
            m.running_var.copy_(1.0 + 0.1 * torch.rand(m.running_var.shape, generator=g))
            m.weight.data.copy_(1.0 + 0.1 * torch.randn(m.weight.shape, generator=g))
            m.bias.data.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    return tv, tv.state_dict()


# -- torchvision towers --------------------------------------------------------


def test_inception_converter_matches_torchvision_and_jax(inception_sd):
    """The port's tower from the state dict computes torchvision's features;
    it holds the leaves the JAX converter writes (the JAX tower's features
    are held against the port's in `tests/test_torch_eval.py`)."""
    tv, sd = inception_sd
    pm = _meta_built(InceptionV3)
    # the aux head and fc of a full torchvision state dict are ignored
    extra = {"AuxLogits.fc.weight": torch.zeros(1000, 768), "fc.weight": torch.zeros(1000, 2048)}
    pconvert.load_torchvision_inception_v3(pm, state_dict={**sd, **extra})
    jm = _jax_zeros(JInceptionV3)
    jconvert.load_torchvision_inception_v3(jm, state_dict=sd)
    want = flatten_tree(jax.tree.map(np.asarray, nnx.state(jm).to_pure_dict()))
    got = flatten_tree(to_jax_state(pm))
    assert got.keys() == want.keys() and len(got) == 94 * 5
    for key, value in got.items():
        assert np.array_equal(value, want[key]), key

    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 96, 96, 3)).astype(np.float32)
    with torch.no_grad():
        ref = tv(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        out = pm(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 2048)
    close(out, ref)


def test_converters_read_local_files(tmp_path, inception_sd):
    """`weights_path`: a torch file (`weights_only`) or safetensors, the same
    weights either way; with neither, or a missing file, they raise and
    never reach for torchvision."""
    from safetensors.torch import save_file

    _, sd = inception_sd
    pt_file, st_file = tmp_path / "inception.pt", tmp_path / "inception.safetensors"
    torch.save(sd, pt_file)
    save_file({k: v.contiguous() for k, v in sd.items()}, str(st_file))
    a, b = _meta_built(InceptionV3), _meta_built(InceptionV3)
    pconvert.load_torchvision_inception_v3(a, weights_path=pt_file)
    pconvert.load_torchvision_inception_v3(b, weights_path=st_file)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(a.Mixed_7c.branch_pool.bn_var, sd["Mixed_7c.branch_pool.bn.running_var"])
    for convert, model in ((pconvert.load_torchvision_inception_v3, a), (pconvert.load_torchvision_vgg16, None)):
        with pytest.raises(ValueError, match="state_dict= or weights_path="):
            convert(model)
        with pytest.raises(FileNotFoundError, match="missing.pt"):
            convert(model, weights_path=tmp_path / "missing.pt")


def test_vgg16_converter_matches_torchvision_and_jax():
    from muse_maskgit_pytorch_tpu.models.vgg import VGG16 as JVGG16

    torch.manual_seed(0)
    tv = _torchvision_vgg16_truncated().eval()
    sd = tv.state_dict()
    pm = _meta_built(VGG16)
    pconvert.load_torchvision_vgg16(pm, state_dict=sd)
    jm = _jax_zeros(JVGG16)
    jconvert.load_torchvision_vgg16(jm, state_dict=sd)
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = tv(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4096)
    close(got, ref)
    close(got, jm(jnp.asarray(x)))
    bad = {k: v for k, v in sd.items() if k != "features.0.weight"}
    with pytest.raises(ValueError, match="12 conv weights"):
        pconvert.load_torchvision_vgg16(pm, state_dict=bad)
