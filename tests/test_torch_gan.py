"""Port parity of the VQ-GAN's GAN side (`muse_maskgit_pytorch_tpu_torch/
models/vqgan_vae.py`, `models/vgg.py`) against the JAX modules with bridged
weights: the losses, `LayerNormChan`, the `Discriminator` (its padded 4x4
head too), `VGG16`, the R1 penalty and its double backward, the adaptive
weight, and `VQGanVAE.forward`'s generator and discriminator losses with
their gradients, each parameter group differentiated on its own as the
trainer does. CPU, f32, toy sizes (dim 32, 2 layers, 32px; the VAEs' tower
is the small stand-in of `tests/torch_gan_pairs.py` on both sides).

Tolerances: losses 1e-5 relative; gradients 1e-4 of each leaf's largest
entry; the adaptive weight 1e-4 relative; the penalty 1e-5 relative and its
gradient 1e-4 of each leaf's max. With LFQ the gradients upstream of the
quantizer are held to 5e-4: LFQ's entropy term (a softmax at inverse
temperature 100) puts each side's f32 gradient there about 1e-4 of the
leaf's max away from an f64 evaluation of the same loss, which
`test_lfq_encoder_gradients_are_as_close_to_f64_as_jax` measures.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import vgg as jvgg
from muse_maskgit_pytorch_tpu.models import vqgan_vae as jv
from muse_maskgit_pytorch_tpu.training.trainers import _DISCR, _GEN, _VGG
from muse_maskgit_pytorch_tpu_torch.models import vgg as vgg_module
from muse_maskgit_pytorch_tpu_torch.models import vqgan_vae as pv
from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16
from muse_maskgit_pytorch_tpu_torch.models.maskgit import MaskGit
from muse_maskgit_pytorch_tpu_torch.models.transformer import MaskGitTransformer
from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import module_state_bytes
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, load_jax_state
from muse_maskgit_pytorch_tpu_torch.utils.msgpack_codec import unpackb
from tests.torch_gan_pairs import PTower, build_pair, images, jax_state, leaf_close, torch_grads_by_jax_path

LOSS_RTOL = 1e-5
GRAD_REL, LFQ_ENCODER_GRAD_REL = 1e-4, 5e-4
ENCODER_SIDE = ("enc_dec.encoders.", "quantizer.project_in.")
VQ_KW = dict(lookup_free_quantization=False, vq_kwargs=dict(codebook_dim=8))


def _split(jvae):
    return nnx.split(jvae, _DISCR, _VGG, _GEN, ...)


def _groups(vae):
    named = [(n, p) for n, p in vae.named_parameters() if not n.startswith("_vgg.")]
    gen = [(n, p) for n, p in named if not n.startswith("discr.")]
    discr = [(n, p) for n, p in named if n.startswith("discr.")]
    return gen, discr


def _compare_grads(pvae, names, grads, jgrads, lfq=False):
    got = torch_grads_by_jax_path(pvae, names, grads)
    want = flatten_tree(jax.tree.map(np.asarray, jgrads.to_pure_dict()))
    assert want
    for key, w in want.items():
        rel = LFQ_ENCODER_GRAD_REL if lfq and key.startswith(ENCODER_SIDE) else GRAD_REL
        leaf_close(got[key], w, rel, key)


# -- losses, LayerNormChan ------------------------------------------------------


@pytest.mark.parametrize("name", ["hinge_discr_loss", "hinge_gen_loss", "bce_discr_loss", "bce_gen_loss"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gan_losses_match_jax(name, dtype):
    rs = np.random.RandomState(0)
    fake, real = (2 * rs.randn(2, 5, 5, 1)).astype(np.float32), (2 * rs.randn(2, 5, 5, 1)).astype(np.float32)
    args = (fake, real) if "discr" in name else (fake,)
    want = getattr(jv, name)(*(jnp.asarray(a, dtype) for a in args))
    got = getattr(pv, name)(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_safe_div_and_layernorm_chan_match_jax():
    np.testing.assert_allclose(float(pv.safe_div(torch.tensor(2.0), torch.tensor(0.0))), float(jv.safe_div(2.0, 0.0)))
    jl = jv.LayerNormChan(6, rngs=nnx.Rngs(0))
    jl.gamma[...] = jnp.asarray(np.linspace(0.5, 1.5, 6, dtype=np.float32))
    pl = pv.LayerNormChan(6)
    assert load_jax_state(pl, jax_state(jl)) == []
    x = np.random.RandomState(1).randn(2, 3, 3, 6).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(pl(torch.from_numpy(x)).numpy(), np.asarray(jl(jnp.asarray(x))), atol=1e-5)


# -- the towers ------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(32, 32), (16, 24), (8, 8)], ids=["32px", "16x24", "8px-padded-head"])
def test_discriminator_matches_jax(hw):
    dims = (16, 16, 32, 64)
    jd = jv.Discriminator(dims, rngs=nnx.Rngs(2))
    pd = pv.Discriminator(dims, device="cpu")
    assert load_jax_state(pd, jax_state(jd)) == []
    x = images(3, 2, *hw, 3)
    want = np.asarray(jd(jnp.asarray(x)))
    with torch.no_grad():
        got = pd(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[-1] == 1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_vgg16_matches_jax():
    """The whole tower at 32px, batch 2 (the last pools skipped below
    2x2), with the JAX tower's weights (the port's built on the meta device
    and filled by the bridge: its own random init is not compared)."""
    with torch.device("meta"):
        tower = VGG16(device="meta")
    tower = tower.to_empty(device="cpu")
    jt = jvgg.VGG16(rngs=nnx.Rngs(4))
    assert load_jax_state(tower, jax_state(jt)) == []
    x = images(5, 2, 32, 32, 3)
    want = np.asarray(jt(jnp.asarray(x)))
    with torch.no_grad():
        got = tower(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4096) and (got >= 0).all()
    leaf_close(got, want, 1e-4, "vgg16 features")


def test_vgg_tower_is_built_lazily_once_frozen_and_never_saved(monkeypatch):
    built = []

    def fake_vgg16(**kw):
        built.append(kw)
        return PTower()

    monkeypatch.setattr(vgg_module, "VGG16", fake_vgg16)
    vae = pv.VQGanVAE(dim=16, layers=2, codebook_size=64, vgg_dtype=torch.bfloat16, device="cpu")
    assert vae._vgg is None
    tower = vae.vgg
    assert vae.vgg is tower and len(built) == 1 and built[0]["dtype"] == torch.bfloat16
    assert torch.equal(built[0]["generator"].get_state(), torch.Generator().manual_seed(0).get_state())
    assert not any(p.requires_grad for p in tower.parameters())
    assert "_vgg" in dict(vae.named_children())
    assert "_vgg" not in unpackb(module_state_bytes(vae, exclude=("_vgg",)))


# -- the R1 penalty and its double backward ----------------------------------------


def test_gradient_penalty_and_its_double_backward_match_jax():
    # two channels a GroupNorm group: with one, a conv bias before the norm
    # cancels and its gradient is rounding noise on both sides
    dims = (32, 32, 64)
    jd = jv.Discriminator(dims, rngs=nnx.Rngs(6))
    pd = pv.Discriminator(dims, device="cpu")
    load_jax_state(pd, jax_state(jd))
    img = images(7, 2, 16, 16, 3)
    graphdef, params, rest = nnx.split(jd, nnx.Param, ...)

    def jax_gp(params):
        return jv.gradient_penalty(jnp.asarray(img), nnx.merge(graphdef, params, rest))

    want, jgrads = jax.value_and_grad(jax_gp)(params)
    names = [n for n, _ in pd.named_parameters()]
    gp = pv.gradient_penalty(torch.from_numpy(img), pd)
    params = [p for _, p in pd.named_parameters()]
    # the last bias shifts the logits by a constant: no input gradient
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, torch.autograd.grad(gp, params, allow_unused=True))]
    np.testing.assert_allclose(float(gp), float(want), rtol=LOSS_RTOL)
    got = torch_grads_by_jax_path(pd, names, grads)
    for key, w in flatten_tree(jax.tree.map(np.asarray, jgrads.to_pure_dict())).items():
        leaf_close(got[key], w, GRAD_REL, key)


# -- the VAE's generator and discriminator losses ----------------------------------

GEN_CASES = {
    "lfq": dict(),
    "ema_vq": VQ_KW,
    "lfq-bce-l2": dict(use_hinge_loss=False, l2_recon_loss=True),
    "ema_vq-grayscale": dict(channels=1, **VQ_KW),
}


@pytest.fixture(scope="module", params=list(GEN_CASES))
def gen_case(request):
    kw = GEN_CASES[request.param]
    jvae, pvae = build_pair(codebook_size=64, **kw)
    img = images(8, 2, 32, 32, kw.get("channels", 3))
    return request.param, jvae, pvae, img


def test_generator_loss_and_gradients_match_jax(gen_case):
    case, jvae, pvae, img = gen_case
    graphdef, d, v, g, rest = _split(jvae)

    def loss_fn(g):
        model = nnx.merge(graphdef, d, v, g, rest)
        return model(jnp.asarray(img), return_loss=True, train=True, update_stats=False)

    want, jgrads = jax.value_and_grad(loss_fn)(g)
    gen, discr = _groups(pvae)
    loss = pvae(torch.from_numpy(img), return_loss=True, train=True, update_stats=False)
    grads = torch.autograd.grad(loss, [p for _, p in gen])
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    _compare_grads(pvae, [n for n, _ in gen], grads, jgrads, lfq=case.startswith("lfq"))
    # the phase leaves nothing on the discriminator or the tower
    assert all(p.grad is None for _, p in discr) and all(p.grad is None for p in pvae.vgg.parameters())


@pytest.mark.parametrize("penalty", [True, False], ids=["penalty", "no-penalty"])
def test_discriminator_loss_and_gradients_match_jax(gen_case, penalty):
    case, jvae, pvae, img = gen_case
    graphdef, d, v, g, rest = _split(jvae)

    def loss_fn(d):
        model = nnx.merge(graphdef, d, v, g, rest)
        return model(jnp.asarray(img), return_discr_loss=True, add_gradient_penalty=penalty, train=False)

    want, jgrads = jax.value_and_grad(loss_fn)(d)
    gen, discr = _groups(pvae)
    loss = pvae(torch.from_numpy(img), return_discr_loss=True, add_gradient_penalty=penalty, train=False)
    grads = torch.autograd.grad(loss, [p for _, p in discr])
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    _compare_grads(pvae, [n for n, _ in discr], grads, jgrads)
    assert all(p.grad is None for _, p in gen)


def _port_adaptive_weight(pvae, img, monkeypatch):
    seen = []
    safe_div = pv.safe_div
    monkeypatch.setattr(pv, "safe_div", lambda a, b, eps=1e-8: seen.append(safe_div(a, b, eps)) or seen[-1])
    pvae(torch.from_numpy(img), return_loss=True, train=True, update_stats=False)
    monkeypatch.setattr(pv, "safe_div", safe_div)
    assert len(seen) == 1
    return float(seen[0])


def test_adaptive_weight_matches_jax_and_the_recompute_form(gen_case, monkeypatch):
    """The port takes both gradients from the loss's graph; JAX recomputes
    the towers on `recon_of_w(w)`. Both forms agree, on the port and
    against JAX."""
    case, jvae, pvae, img = gen_case
    channels = img.shape[-1]
    x = jnp.asarray(img)
    fmap, _, _ = jvae.encode(x, train=True, update_stats=False)
    h = jvae.enc_dec.decode_trunk_fn(fmap)
    bias = jvae.enc_dec.final_conv.bias[...]
    vgg_in = (lambda t: jnp.repeat(t, 3, axis=-1)) if channels == 1 else (lambda t: t)
    feats = jvae.vgg(vgg_in(x))
    gen_loss = jv.hinge_gen_loss if jvae.use_hinge_loss else jv.bce_gen_loss

    def recon_of_w(w):
        return jnp.einsum("bhwc,co->bhwo", h, w[0, 0]) + bias

    w = jvae.enc_dec.final_conv.kernel[...]
    g_p = jax.grad(lambda w: jnp.mean(jnp.square(feats - jvae.vgg(vgg_in(recon_of_w(w))))))(w)
    g_g = jax.grad(lambda w: gen_loss(jvae.discr(recon_of_w(w))))(w)
    want = float(jnp.clip(jv.safe_div(jnp.linalg.norm(g_p), jnp.linalg.norm(g_g)), max=1e4))

    got = _port_adaptive_weight(pvae, img, monkeypatch)
    np.testing.assert_allclose(got, want, rtol=1e-4)

    # the recompute form on the port: the towers on a 1x1 conv of the
    # detached trunk output by a fresh copy of the last kernel
    t = torch.from_numpy(img)
    with torch.no_grad():
        fm, _, _ = pvae.encode(t, train=True, update_stats=False)
        hidden = pvae.enc_dec.decode_trunk(fm)
        real = pvae.vgg(t.repeat(1, 1, 1, 3) if channels == 1 else t)
    conv = pvae.enc_dec.final_conv
    w_copy = conv.weight.detach().clone().requires_grad_(True)

    def recon(w):
        r = torch.nn.functional.conv2d(hidden, w, conv.bias.detach()).permute(0, 2, 3, 1)
        return r.repeat(1, 1, 1, 3) if channels == 1 else r

    (p_grad,) = torch.autograd.grad(((real - pvae.vgg(recon(w_copy))) ** 2).mean(), w_copy)
    port_gen = pv.hinge_gen_loss if pvae.use_hinge_loss else pv.bce_gen_loss
    (g_grad,) = torch.autograd.grad(port_gen(pvae.discr(recon(w_copy)[..., :channels])), w_copy)
    recompute = float(pv.safe_div(p_grad.norm(), g_grad.norm()).clamp(max=1e4))
    np.testing.assert_allclose(got, recompute, rtol=1e-5)


def test_lfq_encoder_gradients_are_as_close_to_f64_as_jax():
    """Why LFQ's encoder-side gradients get 5e-4: against the port's loss in
    f64, JAX's f32 gradient and the port's are each about 1e-4 of the
    leaf's max away (the entropy's softmax at inverse temperature 100); the
    port is held to twice JAX's distance, and the decoder to 1e-5."""
    jvae, pvae = build_pair(codebook_size=64)
    img = images(9, 2, 32, 32, 3)
    graphdef, d, v, g, rest = _split(jvae)

    def loss_fn(g):
        return nnx.merge(graphdef, d, v, g, rest)(jnp.asarray(img), return_loss=True, train=True, update_stats=False)

    jgrads = flatten_tree(jax.tree.map(np.asarray, jax.grad(loss_fn)(g).to_pure_dict()))
    gen, _ = _groups(pvae)
    names = [n for n, _ in gen]
    loss = pvae(torch.from_numpy(img), return_loss=True, train=True, update_stats=False)
    got = torch_grads_by_jax_path(pvae, names, torch.autograd.grad(loss, [p for _, p in gen]))
    # f64: the port computes in its inputs' type but for the quantizer's
    # cast to f32, which the f64 reference skips
    p64 = copy.deepcopy(pvae).double()
    real_float = torch.Tensor.float
    try:
        torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else real_float(t)
        gen64 = [p for n, p in p64.named_parameters() if n in names]
        loss64 = p64(torch.from_numpy(img).double(), return_loss=True, train=True, update_stats=False)
        grads64 = torch.autograd.grad(loss64, gen64)
    finally:
        torch.Tensor.float = real_float
    ref = torch_grads_by_jax_path(pvae, names, [t.float() for t in grads64])
    for key, w in jgrads.items():
        scale = np.abs(ref[key]).max()
        port_err = np.abs(got[key] - ref[key]).max() / scale
        jax_err = np.abs(w - ref[key]).max() / scale
        if key.startswith(ENCODER_SIDE):
            assert port_err <= max(2 * jax_err, 1e-5), (key, port_err, jax_err)
        else:
            assert port_err <= 1e-5 and jax_err <= 1e-5, (key, port_err, jax_err)


# -- options: remat, bf16 towers, stripping ----------------------------------------


def test_encdec_remat_gives_the_same_loss_and_gradients():
    _, plain = build_pair(codebook_size=64, **VQ_KW)
    _, remat = build_pair(codebook_size=64, encdec_remat=True, **VQ_KW)
    assert remat.enc_dec.remat and not plain.enc_dec.remat
    img = torch.from_numpy(images(10, 2, 32, 32, 3))
    out = []
    for vae in (plain, remat):
        gen, _ = _groups(vae)
        loss = vae(img, return_loss=True, train=True, update_stats=False)
        out.append((loss, torch.autograd.grad(loss, [p for _, p in gen])))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("penalty", [True, False], ids=["penalty", "no-penalty"])
def test_bf16_discriminator_against_f32(penalty):
    """`discr_dtype=torch.bfloat16` (params f32, convolutions in bf16,
    GroupNorms and losses f32) against the same tower in f32: the
    discriminator loss within 2e-2 relative; the gradient over all its
    parameters at cosine >= 0.98 and within 0.2 of its norm (bf16 keeps 8
    bits; measured at this size: cosine 0.992 and 0.13 of the norm with the
    penalty's double backward, 0.994 and 0.11 without)."""
    _, f32 = build_pair(codebook_size=64, **VQ_KW)
    bf16 = copy.deepcopy(f32)
    for m in bf16.discr.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.bfloat16
    built = pv.VQGanVAE(dim=32, layers=2, codebook_size=64, discr_dtype=torch.bfloat16, device="cpu", **VQ_KW)
    assert all(m.compute_dtype == torch.bfloat16 for m in built.discr.modules() if hasattr(m, "compute_dtype"))
    img = torch.from_numpy(images(11, 2, 32, 32, 3))
    res = []
    for vae in (f32, bf16):
        _, discr = _groups(vae)
        loss = vae(img, return_discr_loss=True, add_gradient_penalty=penalty, train=False)
        grads = torch.autograd.grad(loss, [p for _, p in discr])
        res.append((loss, torch.cat([g.reshape(-1) for g in grads])))
    assert res[1][0].dtype == torch.float32
    np.testing.assert_allclose(float(res[1][0]), float(res[0][0]), rtol=2e-2)
    (_, want), (_, got) = res
    assert float(got @ want / (got.norm() * want.norm())) >= 0.98
    assert float((got - want).norm() / want.norm()) <= 0.2


def test_bf16_encoder_decoder_matches_jax_bf16():
    """`dtype=torch.bfloat16` against JAX's `dtype=jnp.bfloat16` (enc / dec
    convolutions in bf16, GroupNorms and the last 1x1 conv f32): the
    reconstructions within 2e-2 of their largest pixel."""
    kw = dict(dim=32, layers=2, codebook_size=64, use_vgg_and_gan=False, **VQ_KW)
    jvae = jv.VQGanVAE(dtype=jnp.bfloat16, rngs=nnx.Rngs(12), **kw)
    pvae = pv.VQGanVAE(dtype=torch.bfloat16, device="cpu", **kw)
    assert load_jax_state(pvae, jax_state(jvae)) == []
    img = images(13, 2, 32, 32, 3)
    want = np.asarray(jvae(jnp.asarray(img), train=False))
    with torch.no_grad():
        got = pvae(torch.from_numpy(img), train=False)
    assert got.dtype == torch.float32
    leaf_close(got.numpy(), want, 2e-2, "bf16 reconstruction")


def test_copy_for_eval_and_maskgit_clone_strip_the_towers():
    _, vae = build_pair(codebook_size=64)
    ref_discr, ref_vgg = vae.discr, vae._vgg
    clone = vae.copy_for_eval()
    assert clone.discr is None and clone._vgg is None and not clone.use_vgg_and_gan
    assert vae.discr is ref_discr and vae._vgg is ref_vgg and vae.use_vgg_and_gan
    assert not any(n.startswith(("discr.", "_vgg.")) for n, _ in clone.named_parameters())
    for a, b in zip(clone.enc_dec.parameters(), vae.enc_dec.parameters()):
        assert torch.equal(a, b) and a is not b
    transformer = MaskGitTransformer(
        num_tokens=64, dim=16, seq_len=64, depth=1, dim_head=16, heads=1, text_embed_dim=8, device="cpu"
    )
    model = MaskGit(image_size=32, transformer=transformer, vae=vae, device="cpu")
    assert model.vae.discr is None and model.vae._vgg is None and not model.vae.use_vgg_and_gan
    assert vae.discr is ref_discr  # the caller's VAE keeps its towers
    with pytest.raises(ValueError, match="discriminator"):
        clone(torch.rand(1, 32, 32, 3), return_discr_loss=True)
