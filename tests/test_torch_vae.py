"""Port parity: the VAE tokenizer, encode and decode, and the LFQ and FSQ
quantizers (`muse_maskgit_pytorch_tpu_torch/models/vqgan_vae.py`,
`quantizers.py`) against the JAX modules with bridged weights. Feature maps
and pixels agree to 1e-4 (f32 convolutions summed in different orders).

Ids from the whole encode are held to the near-tie rule: the two sides'
latents differ by that rounding, so an id may differ only where its
quantizer input lies within 1e-5 of a decision boundary (an LFQ latent
within 1e-5 of 0, an FSQ value within 1e-5 of a rounding midpoint, an
EMA-VQ code scoring within 1e-5 of the best in f64, see
`tests/test_torch_vq.py`). Quantizers fed the same input give equal ids.
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
from muse_maskgit_pytorch_tpu_torch.ops.vq import score_gap
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state

TOL = dict(atol=1e-4, rtol=1e-4)
NEAR_TIE = 1e-5


def jax_params(module):
    return jax.tree.map(np.asarray, nnx.state(module, (nnx.Param, nnx.BatchStat)).to_pure_dict())


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


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
    pl = pq.LFQ(dim=dim, codebook_size=256, device="cpu")
    assert load_jax_state(pl, jax_params(jl)) == []
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
    pvae = pv.VQGanVAE(use_vgg_and_gan=False, dim=16, layers=layers, codebook_size=256, device="cpu")
    assert load_jax_state(pvae, jax_params(jvae)) == []
    ids = np.random.RandomState(7).randint(0, 256, size=(2, 4, 4))
    want = np.asarray(jvae.decode_from_ids(jnp.asarray(ids)))
    with torch.no_grad():
        got = pvae.decode_from_ids(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, 4 * 2**layers, 4 * 2**layers, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_encode_side_raises_not_ported():
    """The encode side's training is ported (ROADMAP A10): what raised here
    now matches the JAX module on the same weights and inputs: LFQ's
    training losses (`train=True`), EMA-VQ's codebook update in the call
    (`update_stats=True` with a `VQDraws`), and a VAE built with its GAN
    towers (`use_vgg_and_gan=True`, the discriminator bridged)."""
    from muse_maskgit_pytorch_tpu_torch.models.quantizers import VQDraws

    img = np.random.RandomState(20).rand(2, 16, 16, 3).astype(np.float32)
    jvae = jv.VQGanVAE(dim=16, layers=2, codebook_size=256, use_vgg_and_gan=False, rngs=nnx.Rngs(21))
    vae = pv.VQGanVAE(dim=16, layers=2, codebook_size=256, use_vgg_and_gan=False, device="cpu")
    load_jax_state(vae, jax_params(jvae))
    _, _, jaux = jvae.encode(jnp.asarray(img), train=True)
    with torch.no_grad():
        _, _, aux = vae.encode(torch.from_numpy(img), train=True)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) != 0.0

    kw = dict(codebook_size=64, lookup_free_quantization=False, vq_kwargs=dict(codebook_dim=8))
    jvq = jv.VQGanVAE(dim=16, layers=2, use_vgg_and_gan=False, rngs=nnx.Rngs(22), **kw)
    vq_vae = pv.VQGanVAE(dim=16, layers=2, use_vgg_and_gan=False, device="cpu", **kw)
    load_jax_state(vq_vae, jax_params(jvq))
    key = jax.random.PRNGKey(23)
    jvq.encode(jnp.asarray(img), train=True, rng=key, update_stats=True)
    draws = VQDraws(torch.from_numpy(np.array(jax.random.randint(key, (64,), 0, 2 * 4 * 4))))
    with torch.no_grad():
        vq_vae.encode(torch.from_numpy(img), train=True, rng=draws, update_stats=True)
    for name in ("codebook", "cluster_size", "embed_avg"):
        want = np.asarray(getattr(jvq.quantizer, name)[...])
        np.testing.assert_allclose(getattr(vq_vae.quantizer, name).numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()))

    jgan = jv.VQGanVAE(dim=16, layers=2, codebook_size=256, use_vgg_and_gan=True, rngs=nnx.Rngs(24))
    gan = pv.VQGanVAE(dim=16, layers=2, codebook_size=256, use_vgg_and_gan=True, device="cpu")
    assert load_jax_state(gan, jax_params(jgan)) == []
    with torch.no_grad():
        logits = gan.discr(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(logits, np.asarray(jgan.discr(jnp.asarray(img))), **TOL)


@pytest.mark.parametrize("size", [8, 9], ids=["even", "odd"])
def test_strided_conv_matches_flax_explicit_padding(size):
    js = jv._StridedConv(6, 4, rngs=nnx.Rngs(8))
    js.conv.bias[...] = jnp.asarray(np.linspace(-0.5, 0.5, 4, dtype=np.float32))
    ps = pv._StridedConv(6, 4)
    assert load_jax_state(ps, jax_params(js)) == []
    x = np.random.RandomState(9).randn(2, size, size + 1, 6).astype(np.float32)
    want = np.asarray(js(jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(ps(nchw(x)))
    assert got.shape == want.shape == (2, size // 2, (size + 1) // 2, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_resblock():
    jb = jv.ResBlock(32, rngs=nnx.Rngs(10))
    _perturb_norms(jb)
    pb = pv.ResBlock(32)
    assert load_jax_state(pb, jax_params(jb)) == []
    x = np.random.RandomState(11).randn(2, 5, 5, 32).astype(np.float32)
    want = np.asarray(jb(jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(pb(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "layers, kw",
    [(2, {}), (3, dict(num_resnet_blocks=(1, 0, 2), first_conv_kernel_size=3))],
    ids=["default", "resnet-blocks-per-layer"],
)
def test_encoder(layers, kw):
    je = jv.ResnetEncDec(16, layers=layers, rngs=nnx.Rngs(12), **kw)
    _perturb_norms(je)
    pe = pv.ResnetEncDec(16, layers=layers, **kw)
    assert load_jax_state(pe, jax_params(je)) == []
    x = np.random.RandomState(13).rand(2, 16, 16, 3).astype(np.float32)
    want = np.asarray(je.encode(jnp.asarray(x)))
    with torch.no_grad():
        got = pe.encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16 >> layers, 16 >> layers, 16 << (layers - 1))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dim", [8, 24], ids=["no_projection", "projection"])
def test_lfq_forward_ids_exact(dim):
    jl = jq.LFQ(dim=dim, codebook_size=256, rngs=nnx.Rngs(14))
    pl = pq.LFQ(dim=dim, codebook_size=256, device="cpu")
    load_jax_state(pl, jax_params(jl))
    x = np.random.RandomState(15).randn(2, 4, 4, dim).astype(np.float32)
    jout, jids, jaux = jl(jnp.asarray(x), train=False)
    with torch.no_grad():
        out, ids, aux = pl(torch.from_numpy(x))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    assert float(aux) == float(jaux) == 0.0
    # with `train` the entropy and commitment losses, as in JAX
    _, jids, jaux = jl(jnp.asarray(x), train=True)
    with torch.no_grad():
        _, ids, aux = pl(torch.from_numpy(x), train=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize(
    "levels, dim",
    [((8, 6, 5), 24), ((2, 3, 4, 5), 24), ((2, 3, 4, 5), 4)],
    ids=["8-6-5", "2-3-4-5", "2-3-4-5-no_projection"],
)
def test_fsq_matches_jax(levels, dim):
    jf = jq.FSQ(dim=dim, levels=levels, rngs=nnx.Rngs(16))
    pf = pq.FSQ(dim=dim, levels=levels, device="cpu")
    assert load_jax_state(pf, jax_params(jf)) == []
    x = 2 * np.random.RandomState(17).randn(2, 5, 5, dim).astype(np.float32)
    jout, jids, _ = jf(jnp.asarray(x), train=False)
    with torch.no_grad():
        out, ids, aux = pf(torch.from_numpy(x))
    assert ids.dtype == torch.int32 and float(aux) == 0.0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    all_ids = np.arange(pf.codebook_size).reshape(-1, 1)
    with torch.no_grad():
        codes = pf.indices_to_codes(torch.from_numpy(all_ids)).numpy()
    np.testing.assert_allclose(codes, np.asarray(jf.indices_to_codes(jnp.asarray(all_ids))), atol=1e-6)


def _boundary_margin(vae, fmap):
    """Per token, how far the port's quantizer input lies from changing its
    id: min |z| (LFQ), the distance to a rounding midpoint (FSQ), or the f64
    score gap to the runner-up code (EMA-VQ)."""
    q = vae.quantizer
    with torch.no_grad():
        z = q.project_in(fmap) if q.has_projections else fmap
        if isinstance(q, pq.LFQ):
            return z.abs().amin(dim=-1)
        if isinstance(q, pq.FSQ):
            shifted = q._bound(z) + q._half_width(z.device)
            return (shifted - shifted.floor() - 0.5).abs().amin(dim=-1)
        zq = pq.l2norm(z.reshape(-1, q.codebook_dim)).double()
        scores = 2.0 * zq @ q.codebook.double().T
        top2 = scores.topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).reshape(z.shape[:-1])


@pytest.mark.parametrize(
    "kw",
    [{}, dict(lookup_free_quantization=False), dict(fsq_levels=(8, 8, 4))],
    ids=["lfq", "ema_vq", "fsq"],
)
def test_encode_decode_slice(kw):
    """images -> encode -> ids -> decode_from_ids at small width (dim 16,
    layers 2, K 256); EMA-VQ at the default vq_kwargs (codebook_dim 256,
    cosine)."""
    jvae = jv.VQGanVAE(dim=16, layers=2, codebook_size=256, use_vgg_and_gan=False, rngs=nnx.Rngs(18), **kw)
    _perturb_norms(jvae)
    pvae = pv.VQGanVAE(use_vgg_and_gan=False, dim=16, layers=2, codebook_size=256, device="cpu", **kw)
    assert load_jax_state(pvae, jax_params(jvae)) == []
    assert pvae.codebook_size == 256
    img = np.random.RandomState(19).rand(2, 16, 16, 3).astype(np.float32)
    jfmap, jids, jaux = jvae.encode(jnp.asarray(img))
    with torch.no_grad():
        fmap, ids, aux = pvae.encode(torch.from_numpy(img))
        enc = pvae.enc_dec.encode(torch.from_numpy(img))
    jids = np.array(jids)
    assert ids.shape == jids.shape == (2, 4, 4) and ids.dtype == torch.int32
    margin = _boundary_margin(pvae, enc).numpy()
    differ = ids.numpy() != jids
    assert not (differ & (margin > NEAR_TIE)).any(), "ids differ away from a near-tie"
    if isinstance(pvae.quantizer, pq.VectorQuantizeEMA):
        zq = pq.l2norm(pvae.quantizer.project_in(enc).reshape(-1, 256))
        for side in (ids.numpy(), jids):
            gap = score_gap(zq, pvae.quantizer.codebook, torch.from_numpy(side.reshape(-1)),
                            torch.zeros(256))
            assert (gap <= NEAR_TIE).all()
    same = ~differ
    np.testing.assert_allclose(fmap.numpy()[same], np.asarray(jfmap)[same], **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4, atol=1e-6)
    want = np.asarray(jvae.decode_from_ids(jnp.asarray(jids)))
    with torch.no_grad():
        got = pvae.decode_from_ids(torch.from_numpy(jids)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_vq_kwargs_defaults_and_prefix_routing():
    vae = pv.VQGanVAE(dim=16, layers=2, codebook_size=64, lookup_free_quantization=False, device="cpu")
    q = vae.quantizer
    assert isinstance(q, pq.VectorQuantizeEMA)
    assert (q.codebook_dim, q.decay, q.commitment_weight, q.kmeans_init, q.use_cosine_sim) == (256, 0.8, 1.0, True, True)
    vae = pv.VQGanVAE(
        dim=16, layers=2, codebook_size=64, lookup_free_quantization=False, device="cpu",
        vq_kwargs=dict(decay=0.5), vq_codebook_dim=8, vq_use_cosine_sim=False, encdec_first_conv_kernel_size=3,
    )
    q = vae.quantizer
    assert (q.codebook_dim, q.decay, q.use_cosine_sim) == (8, 0.5, False)
    assert vae.enc_dec.encoders[0].kernel_size == (3, 3)
    with pytest.raises(TypeError, match="unknown kwargs"):
        pv.VQGanVAE(dim=16, layers=2, bogus=1, device="cpu")
