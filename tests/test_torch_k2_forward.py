"""K2's f32 forward kernel (`qknorm_fwd_f32` in
`muse_maskgit_pytorch_tpu_torch/csrc/qknorm_attention.cu`) restated in plain
PyTorch, step for step, against the JAX package at toy size on the CPU.

The kernel holds q^ = q / |q| q_scale scale once per block and normalises
each raw 64-key tile as it lands, k^ = k / |k| k_scale (rounded as the plain
version rounds it); the score is taken in base 2, x = (q^ . k^ + bias) log2e.
An online softmax in base 2 over the tiles, seeded with the null position
(m0 = s0 log2e, l0 = 1, acc0 = nv), gives the output acc / l and the row
logsumexp in nats, m ln 2 + log l, which the backward reads.
`_tiled_forward` below is that algebra; the card tests
(`tests/test_torch_cuda_kernels.py`) hold the kernel itself to the plain
version.

Tolerances: the output within 1e-5 of JAX's `_qknorm_xla` and of
`qknorm_attend(impl="flash", interpret=True)` (the Pallas kernel in
interpret mode), all f32: the two differ in rounding order only (the
online softmax over tiles, base 2 in place of e). lse within 1e-5 of
logsumexp([s0, s + bias]) taken in f64. JAX's Pallas kernel takes no
m = 0 (its grid divides by the padded key count), so that case holds to
`_qknorm_xla` alone, and to null_v. The kernel also skips a tile whose
keys are all masked for its batch row: such a tile adds exactly 0 to l and
to acc and leaves the row max as it is, so the restatement need not.
Heads are independent, so most cases take one (the Pallas kernel in
interpret mode costs time per head and batch row).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu.ops.attention import _qknorm_xla
from muse_maskgit_pytorch_tpu.ops.attention import qknorm_attend as jax_qknorm
from muse_maskgit_pytorch_tpu_torch.ops.attention import NEG_INF

LOG2E, LN2 = 1.4426950408889634, math.log(2.0)
TILE = 64  # keys a tile, as the kernel streams them

# (b, n, m, h, mask): a partial query block (129 of 128 + 128) against a
# partial key tile (130 = 2 x 64 + 2); a partial mask over three tiles; a
# row with every key masked (null_v); no keys; one query
CASES = {
    "n129-m130": (2, 129, 130, 1, None),
    "partial-mask": (1, 40, 150, 2, "partial"),
    "row-masked": (2, 33, 70, 1, "row"),
    "m0": (2, 20, 0, 2, None),
    "n1": (2, 1, 70, 1, "partial"),
}


def _inputs(case):
    b, n, m, h, mask_kind = CASES[case]
    rs = np.random.RandomState(7 + 11 * len(case))
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    arrays = [f(b, n, h, 64), f(b, m, h, 64), f(b, m, h, 64), f(h, 64), f(h, 64), 1 + 0.1 * f(64), 1 + 0.1 * f(64)]
    mask = None
    if mask_kind is not None:
        mask = rs.rand(b, m) > 0.4
        if mask_kind == "row":
            mask[1] = False  # row 1 attends the null position only
    bias = np.zeros((b, m), np.float32) if mask is None else np.where(mask, 0.0, NEG_INF).astype(np.float32)
    return arrays, mask, bias


def _tiled_forward(q, k, v, nk, nv, qs, ks, bias, scale=8.0, tile=TILE):
    """The kernel's forward, (out (b, n, h, d), lse (b, h, n)), all f32."""

    def r_of(t):
        return torch.rsqrt((t * t).sum(-1, keepdim=True) + 1e-12)

    qh = q * r_of(q) * (qs * scale)  # q^
    nkh = nk * r_of(nk) * ks
    mrow = torch.einsum("bnhd,hd->bhn", qh, nkh) * LOG2E  # the null score, base 2
    lrow = torch.ones_like(mrow)
    acc = nv[None, :, None, :].expand(q.shape[0], -1, q.shape[1], -1).clone()  # (b, h, n, d)
    for k0 in range(0, k.shape[1], tile):
        kt, vt = k[:, k0 : k0 + tile], v[:, k0 : k0 + tile]
        kh = kt * r_of(kt) * ks  # k^ of the tile, normalised as it lands
        x = (torch.einsum("bnhd,bmhd->bhnm", qh, kh) + bias[:, None, None, k0 : k0 + tile]) * LOG2E
        m_new = torch.maximum(mrow, x.amax(-1))
        alpha = torch.exp2(mrow - m_new)
        p = torch.exp2(x - m_new[..., None])
        lrow = lrow * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhnm,bmhd->bhnd", p, vt)
        mrow = m_new
    out = (acc / lrow[..., None]).transpose(1, 2)
    return out, mrow * LN2 + torch.log(lrow)


def _lse_f64(q, k, nk, qs, ks, bias, scale=8.0):
    """logsumexp([s0, s + bias]) over each row, in f64."""
    q, k, nk, qs, ks, bias = (np.asarray(t, np.float64) for t in (q, k, nk, qs, ks, bias))

    def norm(t):
        return t / np.sqrt((t * t).sum(-1, keepdims=True) + 1e-12)

    qn, kn, nkn = norm(q) * qs * scale, norm(k) * ks, norm(nk) * ks
    s = np.einsum("bnhd,bmhd->bhnm", qn, kn) + bias[:, None, None, :]
    full = np.concatenate([np.einsum("bnhd,hd->bhn", qn, nkn)[..., None], s], -1)
    top = full.max(-1, keepdims=True)
    return (top + np.log(np.exp(full - top).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_algebra_matches_jax(case):
    arrays, mask, bias = _inputs(case)
    b, n, m, h, _ = CASES[case]
    out, lse = _tiled_forward(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(bias))
    assert out.shape == (b, n, h, 64) and out.dtype == torch.float32 and lse.shape == (b, h, n)
    jx = [jnp.asarray(a) for a in arrays]
    want = [np.asarray(_qknorm_xla(*jx, jnp.asarray(bias), 8.0))]
    if m > 0:
        jmask = None if mask is None else jnp.asarray(mask)
        want.append(np.asarray(jax_qknorm(*jx, mask=jmask, impl="flash", interpret=True)))
    for w in want:
        np.testing.assert_allclose(out.numpy(), w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), _lse_f64(*arrays[:2], arrays[3], *arrays[5:], bias), rtol=0, atol=1e-5)
    null_rows = [0, 1] if m == 0 else [] if mask is None else list(np.flatnonzero(~mask.any(axis=1)))
    for row in null_rows:  # every key off: the null position only
        np.testing.assert_allclose(out[row].numpy(), np.broadcast_to(arrays[4], (n, h, 64)), rtol=0, atol=1e-6)
