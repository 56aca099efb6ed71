"""Port parity: the VAE decode side and LFQ codes
(`muse_maskgit_pytorch_tpu_torch/models/vqgan_vae.py`, `quantizers.py`)
against the JAX modules with bridged weights. Codes are exact; pixels agree
to 1e-4 (f32 convolutions summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import quantizers as jq
from muse_maskgit_pytorch_tpu.models import vqgan_vae as jv
from muse_maskgit_pytorch_tpu_torch.models import quantizers as pq
from muse_maskgit_pytorch_tpu_torch.models import vqgan_vae as pv
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state

TOL = dict(atol=1e-4, rtol=1e-4)


def jax_params(module):
    return jax.tree.map(np.asarray, nnx.state(module, nnx.Param).to_pure_dict())


def _perturb_norms(module):
    """Non-trivial GroupNorm scales and biases, so their bridge is tested."""
    rs = np.random.RandomState(0)
    for _, node in nnx.iter_graph(module):
        if isinstance(node, nnx.GroupNorm):
            n = node.scale[...].shape[0]
            node.scale[...] = jnp.asarray(1 + 0.1 * rs.randn(n).astype(np.float32))
            node.bias[...] = jnp.asarray(0.1 * rs.randn(n).astype(np.float32))


@pytest.mark.parametrize("dim", [8, 24], ids=["no_projection", "projection"])
def test_lfq_indices_to_codes_exact(dim):
    jl = jq.LFQ(dim=dim, codebook_size=256, rngs=nnx.Rngs(0))
    pl = pq.LFQ(dim=dim, codebook_size=256)
    assert load_jax_state(pl, jax_params(jl)) == ([] if dim == 8 else ["project_in.kernel"])
    ids = np.random.RandomState(1).randint(0, 256, size=(2, 4, 4))
    np.testing.assert_array_equal(
        pl.indices_to_bits(torch.from_numpy(ids)).numpy(),
        np.asarray(jl.indices_to_bits(jnp.asarray(ids))),
    )
    want = np.asarray(jl.indices_to_codes(jnp.asarray(ids)))
    with torch.no_grad():
        got = pl.indices_to_codes(torch.from_numpy(ids)).numpy()
    if dim == 8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("size", [4, 5], ids=["even", "odd"])
def test_upconv_matches_flax_same_padding(size):
    ju = jv._UpConv(6, 4, rngs=nnx.Rngs(2))
    ju.conv.bias[...] = jnp.asarray(np.linspace(-0.5, 0.5, 4, dtype=np.float32))
    pu = pv._UpConv(6, 4)
    assert load_jax_state(pu, jax_params(ju)) == []
    x = np.random.RandomState(3).randn(2, size, size + 1, 6).astype(np.float32)  # NHWC
    want = np.asarray(ju(jnp.asarray(x)))
    with torch.no_grad():
        got = pu(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 2 * size, 2 * size + 2, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_glu_resblock():
    jb = jv.GLUResBlock(32, rngs=nnx.Rngs(4))
    _perturb_norms(jb)
    pb = pv.GLUResBlock(32)
    assert load_jax_state(pb, jax_params(jb)) == []
    x = np.random.RandomState(5).randn(2, 5, 5, 32).astype(np.float32)
    want = np.asarray(jb(jnp.asarray(x)))
    with torch.no_grad():
        got = pb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layers", [2, 3])
def test_decode_from_ids_pixels(layers):
    jvae = jv.VQGanVAE(dim=16, layers=layers, codebook_size=256, use_vgg_and_gan=False, rngs=nnx.Rngs(6))
    _perturb_norms(jvae)
    pvae = pv.VQGanVAE(dim=16, layers=layers, codebook_size=256)
    unused = load_jax_state(pvae, jax_params(jvae))
    # only the encode side (not ported yet) is left over
    assert unused and all(k.startswith(("enc_dec.encoders.", "quantizer.project_in")) for k in unused)
    ids = np.random.RandomState(7).randint(0, 256, size=(2, 4, 4))
    want = np.asarray(jvae.decode_from_ids(jnp.asarray(ids)))
    with torch.no_grad():
        got = pvae.decode_from_ids(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, 4 * 2**layers, 4 * 2**layers, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_encode_side_raises_not_ported():
    vae = pv.VQGanVAE(dim=16, layers=2, codebook_size=256)
    with pytest.raises(NotImplementedError, match="A4"):
        vae.encode(torch.zeros(1, 16, 16, 3))
    with pytest.raises(NotImplementedError, match="A10"):
        pv.VQGanVAE(dim=16, layers=2, codebook_size=256, use_vgg_and_gan=True)
