"""Port parity: K2's plain PyTorch version
(`muse_maskgit_pytorch_tpu_torch/ops/attention.py::qknorm_attend_plain`)
against the JAX package's `qknorm_attend` -- its Pallas kernel in interpret
mode (`impl="flash"`) and its XLA version (`impl="xla"`) -- on the same f32
inputs. Tolerance 1e-5: the same f32 math, summed in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
