"""Port parity: the attention ops' plain PyTorch versions
(`muse_maskgit_pytorch_tpu_torch/ops/attention.py`) against the JAX package.

K2: `qknorm_attend_plain` against JAX `qknorm_attend` -- its Pallas kernel
in interpret mode (`impl="flash"`) and its XLA version (`impl="xla"`).
K4: the port's `attend`, both impls on the CPU, against JAX
`attend(impl="flash", interpret=True)` and `xla_attention`, at the JAX
tests' shapes, in value and in gradient. f32 tolerance 1e-4: at scale 8
the scores of these inputs reach ~200, where f32 rounds them by ~1e-5, and
that moves the outputs by a few 1e-5; gradients 5e-3 as in the JAX tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu.ops.attention import attend as jax_attend
from muse_maskgit_pytorch_tpu.ops.attention import qknorm_attend as jax_qknorm
from muse_maskgit_pytorch_tpu.ops.attention import xla_attention as jax_xla_attention
from muse_maskgit_pytorch_tpu_torch.ops import attention as port

B, N, H, D = 2, 16, 2, 16


def _inputs(seed, m, mask_kind):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    arrays = dict(
        q=f(B, N, H, D), k=f(B, m, H, D), v=f(B, m, H, D),
        null_k=f(H, D), null_v=f(H, D),
        q_scale=1 + 0.1 * f(D), k_scale=1 + 0.1 * f(D),
    )
    mask = None
    if mask_kind == "partial":
        mask = rs.rand(B, m) > 0.4
    elif mask_kind == "row_masked":
        mask = rs.rand(B, m) > 0.4
        mask[0] = False  # only the null position is attendable in row 0
    return arrays, mask


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize(
    "m, mask_kind",
    [(N, "none"), (8, "none"), (8, "partial"), (8, "row_masked"), (N, "partial")],
    ids=["self", "cross", "cross-mask", "cross-row-masked", "self-mask"],
)
def test_plain_matches_jax(impl, m, mask_kind):
    arrays, mask = _inputs(10 * m + len(mask_kind), m, mask_kind)
    kw = dict(impl=impl, interpret=True) if impl == "flash" else dict(impl=impl)
    want = jax_qknorm(
        *(jnp.asarray(arrays[n]) for n in ("q", "k", "v", "null_k", "null_v", "q_scale", "k_scale")),
        mask=None if mask is None else jnp.asarray(mask),
        **kw,
    )
    got = port.qknorm_attend(
        *(torch.from_numpy(arrays[n]) for n in ("q", "k", "v", "null_k", "null_v", "q_scale", "k_scale")),
        mask=None if mask is None else torch.from_numpy(mask),
    )
    assert got.shape == (B, N, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if mask_kind == "row_masked":
        # a fully masked row attends to the null position only
        np.testing.assert_allclose(
            got[0].numpy(), np.broadcast_to(arrays["null_v"], (N, H, D)), atol=1e-6
        )


def test_strided_kv_views_match_contiguous():
    # the model passes k and v as column slices of one to_kv output
    arrays, mask = _inputs(5, 8, "partial")
    kv = torch.from_numpy(np.concatenate([arrays["k"], arrays["v"]], axis=-1))
    k_view, v_view = kv[..., :D], kv[..., D:]
    args = [torch.from_numpy(arrays[n]) for n in ("null_k", "null_v", "q_scale", "k_scale")]
    q = torch.from_numpy(arrays["q"])
    a = port.qknorm_attend(q, k_view, v_view, *args, mask=torch.from_numpy(mask))
    b = port.qknorm_attend(q, k_view.contiguous(), v_view.contiguous(), *args, mask=torch.from_numpy(mask))
    assert torch.equal(a, b)


def test_cpu_wrapper_does_not_launch():
    arrays, _ = _inputs(1, N, "none")
    before = port.qknorm_attend.launches
    port.qknorm_attend(*(torch.from_numpy(arrays[n]) for n in arrays))
    assert port.qknorm_attend.launches == before


@pytest.mark.parametrize("masked", [False, True])
def test_xla_attention_matches_jax(masked):
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(B, H, n, D).astype(np.float32) for n in (N, 8, 8))
    mask = rs.rand(B, 8) > 0.3 if masked else None
    want = jax_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), scale=8.0,
    )
    got = port.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask), scale=8.0,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- bf16: the plain versions against the Pallas kernels' own arithmetic -----
#
# The distance each Pallas kernel keeps in bf16 from its f32 oracle, held
# here to the limits that chip_smoke.py's [k2] / [k4] checks and the `cuda`
# tests hold the CUDA kernels to (`ops/attention.py`). Measured on these
# inputs: K2 <= 1e-2 from `_qknorm_xla`, K4 <= 8e-3 from the f32 attention
# (no row here is fully masked: there the Pallas wrapper's padding counts).
K2_BF16_FROM_F32, K4_BF16_FROM_F32 = port.K2_BF16_FROM_F32, port.K4_BF16_FROM_F32


def _bf16_spacing(x):
    """The gap between neighbouring bf16 values at |x| (float32's gap x 2^16)."""
    return np.spacing(np.abs(np.asarray(x, np.float32))) * 2.0**16


@pytest.mark.parametrize(
    "n, h, d, m, mask_kind",
    [(16, 2, 16, 8, "partial"), (64, 2, 64, 65, "partial"), (40, 2, 64, 130, "row_masked"), (64, 8, 64, 257, "none")],
    ids=["d16-cross-mask", "d64-ragged-mask", "d64-row-masked", "d64-kv257"],
)
def test_plain_bf16_matches_pallas_kernel(n, h, d, m, mask_kind):
    rs = np.random.RandomState(m + d)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    b = 1 if m > 200 else 2
    arrays = dict(q=f(b, n, h, d), k=f(b, m, h, d), v=f(b, m, h, d), null_k=f(h, d), null_v=f(h, d))
    scales = dict(q_scale=1 + 0.1 * f(d), k_scale=1 + 0.1 * f(d))
    mask = None if mask_kind == "none" else rs.rand(b, m) > 0.4
    if mask_kind == "row_masked":
        mask[0] = False
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays.values()] + [jnp.asarray(a) for a in scales.values()]
    targs = [torch.from_numpy(a).bfloat16() for a in arrays.values()] + [torch.from_numpy(a) for a in scales.values()]
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    want = np.asarray(jax_qknorm(*jargs, mask=jmask, impl="flash", interpret=True).astype(jnp.float32))
    oracle = np.asarray(jax_qknorm(*jargs, mask=jmask, impl="xla").astype(jnp.float32))
    rounded = port.qknorm_attend_plain(*targs, mask=tmask, round_to=torch.bfloat16)
    assert rounded.dtype == torch.bfloat16
    # rounding where `_qknorm_kernel` rounds: one bf16 step of the output apart
    # (f32 sums in another order can flip a rounding of P or of the output)
    np.testing.assert_allclose(rounded.float().numpy(), want, atol=_bf16_spacing(np.abs(want).max()), rtol=0)
    # the f32 plain version, and the JAX oracle, from the Pallas kernel
    plain = port.qknorm_attend_plain(*targs, mask=tmask).float().numpy()
    assert np.abs(want - oracle).max() <= K2_BF16_FROM_F32
    np.testing.assert_allclose(plain, want, atol=K2_BF16_FROM_F32, rtol=0)
    if mask_kind == "row_masked":
        null_v = targs[4].float().expand(n, h, d).numpy()
        np.testing.assert_array_equal(rounded[0].float().numpy(), null_v)


@pytest.mark.parametrize(
    "d, m, masked", [(64, 65, True), (32, 300, False), (64, 257, False)], ids=["d64-ragged-mask", "d32-kv300", "d64-kv257"]
)
def test_attend_plain_bf16_matches_pallas_kernel(d, m, masked):
    arrays = list(_qkv(m + d, b=2, h=2, n=40, m=m, d=d))
    for i in (0, 1):  # qk-normed queries and keys at scale 8, as the models attend
        arrays[i] = arrays[i] / np.linalg.norm(arrays[i], axis=-1, keepdims=True)
    mask = np.random.RandomState(d).rand(2, m) > 0.3 if masked else None
    (jq_, jk, jv_, jm), (q, k, v, tm) = _both(arrays, mask)
    bf = lambda t: t.astype(jnp.bfloat16)  # noqa: E731
    want = np.asarray(jax_attend(bf(jq_), bf(jk), bf(jv_), mask=jm, scale=8.0, impl="flash", interpret=True), np.float32)
    got = port.attend(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask=tm, scale=8.0, impl="flash")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=K4_BF16_FROM_F32, rtol=0)
    # rounding where `_flash_kernel` rounds: one bf16 step of the output apart
    # (m <= its 512-key block, so its running max is the row max)
    rounded = port.attend_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask=tm, scale=8.0, round_to=torch.bfloat16)
    assert rounded.dtype == torch.bfloat16
    np.testing.assert_allclose(rounded.float().numpy(), want, atol=_bf16_spacing(np.abs(want).max()), rtol=0)


# -- K4: the public attend op -------------------------------------------------


def _qkv(seed, b=2, h=4, n=48, m=67, d=64):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, length, d).astype(np.float32) for length in (n, m, m))


def _both(arrays, mask):
    j = [jnp.asarray(a) for a in arrays] + [None if mask is None else jnp.asarray(mask)]
    t = [torch.from_numpy(a) for a in arrays] + [None if mask is None else torch.from_numpy(mask)]
    return j, t


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize(
    "shape, mask_p, scale",
    [
        (dict(), None, None),
        (dict(), None, 8.0),
        (dict(m=33), 0.6, 8.0),
        (dict(n=16, m=300, d=32), 0.8, 8.0),
    ],
    ids=["no_mask", "no_mask-scale8", "mask", "multiblock-kv300-d32"],
)
def test_attend_matches_jax(impl, shape, mask_p, scale):
    arrays = _qkv(len(shape) * 10 + (mask_p is not None), **shape)
    b, m = arrays[1].shape[0], arrays[1].shape[2]
    mask = None
    if mask_p is not None:
        mask = np.random.RandomState(1).rand(b, m) < mask_p
        mask[:, 0] = True
    (jq_, jk, jv_, jm), (q, k, v, tm) = _both(arrays, mask)
    want_flash = np.asarray(jax_attend(jq_, jk, jv_, mask=jm, scale=scale, impl="flash", interpret=True, block_k=128))
    want_xla = np.asarray(jax_xla_attention(jq_, jk, jv_, mask=jm, scale=scale if scale else None))
    got = port.attend(q, k, v, mask=tm, scale=scale, impl=impl)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_flash, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-4, rtol=1e-4)


def test_attend_bf16():
    arrays = _qkv(3, n=32, m=32)
    (jq_, jk, jv_, _), (q, k, v, _) = _both(arrays, None)
    bf = lambda t: t.astype(jnp.bfloat16)  # noqa: E731
    want = jax_attend(bf(jq_), bf(jk), bf(jv_), scale=8.0, impl="flash", interpret=True)
    # the inputs rounded to bf16 on both sides
    ref_bf = np.asarray(jax_xla_attention(*(bf(t).astype(jnp.float32) for t in (jq_, jk, jv_)), scale=8.0))
    got = port.attend(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale=8.0, impl="flash")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the port computes in f32 and rounds once: one bf16 rounding apart
    np.testing.assert_allclose(got.float().numpy(), ref_bf, atol=2e-2, rtol=0)
    # the Pallas kernel also rounds p to bf16 before P.v
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=5e-2, rtol=0)


def test_attend_gradients_match_jax():
    arrays = _qkv(4, b=1, h=2, n=24, m=24, d=32)
    mask = np.ones((1, 24), bool)
    mask[:, -5:] = False
    (jq_, jk, jv_, jm), (q, k, v, tm) = _both(arrays, mask)
    cot = np.random.RandomState(5).randn(*arrays[0].shape).astype(np.float32)

    def loss(q, k, v):
        return (jax_attend(q, k, v, mask=jm, scale=8.0, impl="flash", interpret=True) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jq_, jk, jv_)
    want_xla = jax.grad(
        lambda q, k, v: (jax_xla_attention(q, k, v, mask=jm, scale=8.0) * cot).sum(), argnums=(0, 1, 2)
    )(jq_, jk, jv_)
    for impl in ("flash", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (port.attend(*leaves, mask=tm, scale=8.0, impl=impl) * torch.from_numpy(cot)).sum().backward()
        for t, w, wx in zip(leaves, want, want_xla):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-3, rtol=5e-3)
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(wx), atol=5e-3, rtol=5e-3)


def test_attend_fully_masked_row_averages_real_keys():
    """A row whose keys are all masked averages v over its m real keys, as
    `xla_attention` defines it. The JAX Pallas wrapper pads kv to its block
    with zero rows that it counts too (a JAX-side fault, ROADMAP queue 3):
    its row is the sum over m real keys divided by the padded length."""
    arrays = _qkv(6, b=2, h=2, n=8, m=40, d=32)
    mask = np.ones((2, 40), bool)
    mask[1] = False
    (jq_, jk, jv_, jm), (q, k, v, tm) = _both(arrays, mask)
    got = port.attend(q, k, v, mask=tm, impl="flash").numpy()
    np.testing.assert_allclose(got[1], np.broadcast_to(arrays[2][1].mean(axis=1, keepdims=True), got[1].shape), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_xla_attention(jq_, jk, jv_, mask=jm)), atol=1e-5, rtol=1e-5)
    jax_flash = np.asarray(jax_attend(jq_, jk, jv_, mask=jm, impl="flash", interpret=True))
    m_pad = 128  # block_k = min(512, round_up(40, 128))
    np.testing.assert_allclose(jax_flash[1], got[1] * 40 / m_pad, atol=1e-5)


def test_attend_dispatch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, n=8, m=8, d=32))
    before = port.attend.launches
    assert torch.equal(port.attend(q, k, v), port.xla_attention(q, k, v))  # auto is xla on the CPU
    port.attend(q, k, v, impl="flash")
    assert port.attend.launches == before  # the CPU runs the plain version
    with pytest.raises(ValueError, match="impl"):
        port.attend(q, k, v, impl="pallas")
