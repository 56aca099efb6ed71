"""Port parity of the MaskGit training objective: K2's gradient
(`ops.attention._QKNormAttention`), the training masks of `utils.sampling`,
the losses of `models.transformer` and `MaskGit.forward` against the JAX
package's `MaskGit.__call__`, at toy size on the CPU in f32.

Both sides get the same weights (bridged) and the same draws: the JAX call
takes a key, and `jax_draws` (tests/torch_surface_pairs.py) rebuilds from
that key the eight draws that `MaskGit.__call__` takes from
`jax.random.split(rng, 8)`, as a `TrainDraws` for the port. Tolerances: the loss to 1e-5 relative; each gradient leaf to
1e-4 of that leaf's largest |g| (both sides compute in f32 and differ in
summation order only; the JAX side attends through `xla_attention` on the
CPU, the port through K2's plain version, the same function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from muse_maskgit_pytorch_tpu.models import t5 as jt5
from muse_maskgit_pytorch_tpu.models.transformer import cross_entropy_ignore_index as jax_ce
from muse_maskgit_pytorch_tpu.models.transformer import sigmoid_bce as jax_bce
from muse_maskgit_pytorch_tpu.ops.attention import qknorm_attend as jax_qknorm
from muse_maskgit_pytorch_tpu.utils import sampling as jsamp
from muse_maskgit_pytorch_tpu_torch.models import t5 as pt5
from muse_maskgit_pytorch_tpu_torch.models.maskgit import TrainDraws
from muse_maskgit_pytorch_tpu_torch.models.transformer import cross_entropy_ignore_index, sigmoid_bce
from muse_maskgit_pytorch_tpu_torch.ops import attention as port_attention
from muse_maskgit_pytorch_tpu_torch.utils import sampling as psamp
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import flatten_tree, load_jax_state, to_jax_state
from tests.torch_surface_pairs import B, IMAGE, TEXT_DIM, VOCAB, build_pair, jax_draws, jax_params, text_inputs

LOSS_RTOL = 1e-5
GRAD_FRAC = 1e-4

TRAIN_T5 = "test/torch-train-t5"
_T5 = dict(d_model=TEXT_DIM, d_ff=48, num_heads=2, d_kv=16, num_layers=2, gated=True)
jt5.T5_CONFIGS.setdefault(TRAIN_T5, jt5.T5Config(**_T5))
pt5.T5_CONFIGS.setdefault(TRAIN_T5, pt5.T5Config(**_T5))

TRAINABLE = nnx.All(nnx.Param, nnx.Not(nnx.PathContains("vae")), nnx.Not(nnx.PathContains("cond_vae")))


def jax_loss_and_grads(jm, args, key, **kw):
    graphdef, params, rest = nnx.split(jm, TRAINABLE, ...)

    def f(p):
        return nnx.merge(graphdef, p, rest)(*args, rng=key, **kw)

    loss, grads = jax.value_and_grad(f)(params)
    return float(loss), flatten_tree(grads.to_pure_dict())


def port_grads(pm) -> dict:
    """The port's gradients in the JAX layout and names (`to_jax_state` of
    the module with each parameter's data swapped for its gradient; a
    parameter without one has a zero gradient, as in JAX)."""
    params = list(pm.parameters())
    saved = [p.data for p in params]
    try:
        for p in params:
            p.data = p.grad if p.grad is not None else torch.zeros_like(p)
        return flatten_tree(to_jax_state(pm))
    finally:
        for p, d in zip(params, saved):
            p.data = d


def port_loss_and_grads(pm, args, draws, **kw):
    pm.zero_grad(set_to_none=True)
    loss = pm(*args, draws=draws, **kw)
    loss.backward()
    return loss.item(), port_grads(pm)


def assert_grads_close(got: dict, want: dict):
    assert want, "no gradients to compare"
    for key, g in want.items():
        tol = GRAD_FRAC * float(np.abs(g).max())
        np.testing.assert_allclose(got[key], g, rtol=0, atol=tol, err_msg=key)


def find_key(pred, b, n, start=0):
    """The first PRNG key (from `start`) whose draws satisfy `pred`."""
    for s in range(start, start + 200):
        key = jax.random.PRNGKey(s)
        if pred(jax_draws(key, b, n)):
            return key
    raise AssertionError("no key found")


# -- K2's gradient ------------------------------------------------------------

QK_B, QK_N, QK_H, QK_D = 2, 20, 2, 16
QK_NAMES = ("q", "k", "v", "null_k", "null_v", "q_scale", "k_scale")


def _qk_inputs(seed, m, mask_kind):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    arrays = [f(QK_B, QK_N, QK_H, QK_D), f(QK_B, m, QK_H, QK_D), f(QK_B, m, QK_H, QK_D), f(QK_H, QK_D),
              f(QK_H, QK_D), 1 + 0.1 * f(QK_D), 1 + 0.1 * f(QK_D)]
    mask = None
    if mask_kind != "none":
        mask = rs.rand(QK_B, m) > 0.4
        if mask_kind == "row_masked":
            mask[0] = False  # row 0 attends the null position only
    return arrays, mask, f(QK_B, QK_N, QK_H, QK_D)


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize(
    "m, mask_kind", [(QK_N, "none"), (12, "partial"), (12, "row_masked")], ids=["self", "cross-mask", "row-masked"]
)
def test_k2_gradients_match_jax(impl, m, mask_kind):
    arrays, mask, cot = _qk_inputs(7 * m + len(mask_kind), m, mask_kind)
    kw = dict(impl=impl, interpret=True) if impl == "flash" else dict(impl=impl)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(*xs):
        return jnp.sum(jax_qknorm(*xs, mask=jmask, **kw) * jnp.asarray(cot))

    want = jax.grad(f, argnums=tuple(range(7)))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_attention.qknorm_attend(*ts, mask=None if mask is None else torch.from_numpy(mask))
    assert type(out.grad_fn).__name__ == "_QKNormAttentionBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(QK_NAMES, ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=GRAD_FRAC * np.abs(w).max(), err_msg=name)


def test_k2_without_gradients_saves_nothing():
    arrays, mask, _ = _qk_inputs(3, 12, "partial")
    ts = [torch.from_numpy(a) for a in arrays]
    ts[0].requires_grad_()
    with torch.no_grad():
        out = port_attention.qknorm_attend(*ts, mask=torch.from_numpy(mask))
    assert out.grad_fn is None
    plain = port_attention.qknorm_attend_plain(*(t.detach() for t in ts), mask=torch.from_numpy(mask))
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


# -- the training masks and losses --------------------------------------------


def test_batch_random_mask_and_subset_match_jax():
    key = jax.random.PRNGKey(3)
    b, n = 4, 37
    counts = jnp.asarray([1, 5, 20, 37])
    want = np.asarray(jsamp.batch_random_mask(key, b, n, counts))
    scores = torch.from_numpy(np.array(jax.random.uniform(key, (b, n))))
    got = psamp.batch_random_mask(scores, torch.from_numpy(np.array(counts)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum(-1).tolist() == [1, 5, 20, 37]

    k2 = jax.random.PRNGKey(4)
    for prob in (0.1, 0.5, 0.9):
        sub = np.asarray(jsamp.get_mask_subset_prob(k2, jnp.asarray(want), prob))
        got_sub = psamp.get_mask_subset_prob(got, prob, torch.from_numpy(np.array(jax.random.uniform(k2, (b, n)))))
        np.testing.assert_array_equal(got_sub.numpy(), sub)


def test_prob_mask_like_and_uniform():
    key = jax.random.PRNGKey(5)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (6, 3))))
    np.testing.assert_array_equal(
        psamp.prob_mask_like((6, 3), 0.4, u=u).numpy(), np.asarray(jsamp.prob_mask_like(key, (6, 3), 0.4))
    )
    assert bool(psamp.prob_mask_like((2, 2), 1.0).all()) and not bool(psamp.prob_mask_like((2, 2), 0.0).any())
    a = psamp.uniform((3, 4), torch.Generator().manual_seed(1))
    assert torch.equal(a, psamp.uniform((3, 4), torch.Generator().manual_seed(1))) and 0 <= a.min() and a.max() < 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gumbel_sample_in_the_logits_dtype_matches_jax(dtype):
    key = jax.random.PRNGKey(6)
    rs = np.random.RandomState(6)
    logits = jnp.asarray(rs.randn(8, 50).astype(np.float32)).astype(dtype)
    want = np.asarray(jsamp.gumbel_sample(key, logits, temperature=0.7))
    noise = jsamp.gumbel_noise(key, logits.shape, logits.dtype)
    tdt = getattr(torch, dtype)
    got = psamp.gumbel_sample(
        torch.from_numpy(np.array(logits.astype(jnp.float32))).to(tdt), 0.7,
        noise=torch.from_numpy(np.array(noise.astype(jnp.float32))).to(tdt),
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_losses_match_jax(dtype):
    rs = np.random.RandomState(8)
    logits = rs.randn(3, 10, 40).astype(np.float32)
    labels = rs.randint(0, 40, (3, 10)).astype(np.int32)
    labels[rs.rand(3, 10) < 0.4] = -1
    jl = jnp.asarray(logits).astype(dtype)
    want, wgrad = jax.value_and_grad(lambda x: jax_ce(x, jnp.asarray(labels), -1))(jl)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(getattr(torch, dtype)).requires_grad_()
    got = cross_entropy_ignore_index(tl, torch.from_numpy(labels).long(), -1)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    wgrad = np.asarray(wgrad.astype(jnp.float32))
    np.testing.assert_allclose(tl.grad.float().numpy(), wgrad, rtol=0, atol=GRAD_FRAC * np.abs(wgrad).max() + (
        0 if dtype == "float32" else 2 ** -9 * np.abs(wgrad).max()))  # bf16: the grad's own rounding
    # every label ignored: 0, not a division by zero
    assert cross_entropy_ignore_index(tl, torch.full((3, 10), -1), -1).item() == 0.0

    bl = rs.randn(3, 10).astype(np.float32)
    blabels = (rs.rand(3, 10) < 0.5).astype(np.float32)
    want = float(jax_bce(jnp.asarray(bl).astype(dtype), jnp.asarray(blabels)))
    got = sigmoid_bce(torch.from_numpy(bl).to(getattr(torch, dtype)), torch.from_numpy(blabels)).item()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


# -- MaskGit.forward against MaskGit.__call__ ---------------------------------

PAIRS = {
    "plain": dict(vae=True),
    "self_cond": dict(vae=True, self_cond=True),
    "superres": dict(vae=True, cond_image_size=8),
    "no_mask": dict(vae=True, no_mask_token_prob=0.3),
    "token": dict(vae=False, critic="token", critic_loss_weight=0.7),
    "self_critic": dict(vae=False, critic="self", self_cond=True, critic_loss_weight=0.7),
    "texts": dict(vae=False, t5_name=TRAIN_T5),
}


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(name):
        if name not in built:
            built[name] = build_pair(**PAIRS[name])
        return built[name]

    return get


@pytest.fixture(scope="module")
def tiny_t5():
    jm = jt5.T5Encoder(jt5.get_config(TRAIN_T5), rngs=nnx.Rngs(9))
    pm = pt5.T5Encoder(pt5.get_config(TRAIN_T5), device="cpu")
    assert load_jax_state(pm, jax_params(jm)) == []
    jt5.set_model(TRAIN_T5, jm)
    pt5.set_model(TRAIN_T5, pm)


def _dropped(d):
    return bool((d.keep_u < 0.5).any() and (d.keep_u >= 0.5).any())


def _coin(taken):
    return lambda d: (float(d.self_cond_u) < 0.9) == taken


# name: (pair, input kind, key predicate, extra call arguments)
CASES = {
    "ids": ("plain", "ids", None, {}),
    "ids-cfg_dropout": ("plain", "ids", _dropped, {}),
    "ids-no_dropout": ("plain", "ids", None, dict(cond_drop_prob=0.0)),
    "images": ("plain", "images", None, {}),
    "images-rect_grid": ("plain", "images_rect", None, {}),
    "ids-grid": ("plain", "grid", None, {}),
    "ids-rect_grid": ("plain", "rect_grid", None, {}),
    "no_mask_token_prob": ("no_mask", "ids", None, {}),
    "self_cond-on": ("self_cond", "images", _coin(True), {}),
    "self_cond-off": ("self_cond", "ids", _coin(False), {}),
    "superres-auto": ("superres", "images", _dropped, {}),
    "superres-cond_ids": ("superres", "ids_cond", None, {}),
    "token_critic": ("token", "ids", _dropped, {}),
    "token_critic-temperature": ("token", "ids", None, dict(sample_temperature=0.3)),
    "self_critic": ("self_critic", "ids", _coin(True), {}),
    "train_only_generator": ("token", "ids", None, dict(train_only_generator=True)),
    "texts": ("texts", "ids_texts", None, {}),
}


def _case_inputs(kind, seed):
    rs, te, mask = text_inputs(seed)
    jkw, pkw = {}, {}
    if kind in ("images", "images_rect"):  # images_rect: 16 x 32 pixels, a 4 x 8 token grid
        w = IMAGE if kind == "images" else 2 * IMAGE
        x = rs.uniform(size=(B, IMAGE, w, 3)).astype(np.float32)
    elif kind in ("ids", "ids_cond", "ids_texts"):
        x = rs.randint(0, VOCAB, (B, 16)).astype(np.int32)
    elif kind == "grid":
        x = rs.randint(0, VOCAB, (B, 4, 4)).astype(np.int32)
    else:  # rect_grid: a 4 x 8 grid, off the trained 4 x 4
        x = rs.randint(0, VOCAB, (B, 4, 8)).astype(np.int32)
    if kind == "ids_cond":
        cond = rs.randint(0, VOCAB, (B, 2, 2)).astype(np.int32)
        jkw["cond_token_ids"], pkw["cond_token_ids"] = jnp.asarray(cond), torch.from_numpy(cond)
    if kind == "ids_texts":
        # the JAX T5 cannot run inside `jax.value_and_grad` (its module state
        # is of another trace level): JAX gets its embeddings, the port the texts
        texts = ["a red cube", "two small green spheres on a table"]
        jkw["text_embeds"], jkw["text_mask"] = jt5.t5_encode_text_with_mask(texts, name=TRAIN_T5)
        pkw["texts"] = texts
    else:
        jkw.update(text_embeds=jnp.asarray(te), text_mask=jnp.asarray(mask))
        pkw.update(text_embeds=torch.from_numpy(te), text_mask=torch.from_numpy(mask))
    n = int(np.prod(x.shape[1:3])) // (16 if x.dtype == np.float32 else 1)
    return x, jkw, pkw, n


@pytest.mark.parametrize("case", list(CASES))
def test_maskgit_loss_and_grads_match_jax(pairs, tiny_t5, case):
    pair, kind, pred, extra = CASES[case]
    jm, pm = pairs(pair)
    x, jkw, pkw, n = _case_inputs(kind, len(case))
    key = find_key(pred, B, n) if pred else jax.random.PRNGKey(len(case))
    want, wgrads = jax_loss_and_grads(jm, (jnp.asarray(x),), key, **jkw, **extra)
    got, pgrads = port_loss_and_grads(pm, (torch.from_numpy(x),), jax_draws(key, B, n), **pkw, **extra)
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_grads_close(pgrads, wgrads)


def test_maskgit_forward_refusals(pairs):
    _, pm = pairs("plain")
    te = torch.zeros(B, 6, TEXT_DIM)
    with pytest.raises(ValueError, match="non-square"):
        pm(torch.zeros(B, 8, dtype=torch.long), text_embeds=te)
    with pytest.raises(ValueError, match="divisible"):
        pm(torch.zeros(B, 18, 16, 3), text_embeds=te)
    _, sr = pairs("superres")
    with pytest.raises(ValueError, match="auto-resize"):
        sr(torch.zeros(B, 16, dtype=torch.long), text_embeds=te)
    _, tc = pairs("token")
    with pytest.raises(ValueError, match="sampling-path"):
        tc.transformer(torch.zeros(B, 16, dtype=torch.long), text_embeds=te, labels=torch.zeros(B, 16), skip_head=True)


def test_draws_from_a_generator_are_seeded(pairs):
    _, pm = pairs("token")
    ids = torch.randint(0, VOCAB, (B, 16), generator=torch.Generator().manual_seed(0))
    te = torch.randn(B, 6, TEXT_DIM, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = pm(ids, text_embeds=te, generator=torch.Generator().manual_seed(2))
        b = pm(ids, text_embeds=te, generator=torch.Generator().manual_seed(2))
        c = pm(ids, text_embeds=te, generator=torch.Generator().manual_seed(3))
    assert a.item() == b.item() and a.item() != c.item()
    d = TrainDraws.draw(B, 16, VOCAB, critic=True, generator=torch.Generator().manual_seed(2))
    assert d.gumbel.shape == (B, 16, VOCAB) and d.self_cond_u.device.type == "cpu"
