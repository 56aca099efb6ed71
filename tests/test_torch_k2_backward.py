"""K2's backward in plain PyTorch (`ops.attention.qknorm_attend_backward_plain`,
the formulas the port's CUDA backward computes) against `jax.vjp` of the JAX
package's `_qknorm_xla`, the function JAX's `_qknorm_bwd` differentiates, at
toy size on the CPU.

Tolerances: f32 against JAX to 1e-4 of each gradient's largest |entry| (both
compute in f32 and differ in summation order only); f64 against autograd
through `_qknorm_plain` to 1e-10 of it (the same function, differentiated two
ways); the bf16 `round_to` form against the f32 form within
`K2_BWD_BF16_FROM_F32`. Where m = 0 the exact dq, d null_k and the scales'
gradients are 0 (the null position takes all of the softmax), so those are
held to an absolute 1e-5 instead: each side's value is rounding noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_maskgit_pytorch_tpu.ops.attention import _qknorm_xla
from muse_maskgit_pytorch_tpu_torch.ops import attention as port_attention
from muse_maskgit_pytorch_tpu_torch.ops.attention import K2_BWD_BF16_FROM_F32

GRAD_FRAC = 1e-4
NAMES = ("q", "k", "v", "null_k", "null_v", "q_scale", "k_scale")
ZERO_WITHOUT_KEYS = ("q", "null_k", "q_scale", "k_scale")

# (b, n, m, h, mask): self; cross with a partial mask; a row with every key
# masked; no keys at all; n != m over three heads
CASES = {
    "self": (2, 20, 20, 3, None),
    "cross-mask": (2, 20, 12, 2, "partial"),
    "row-masked": (3, 17, 12, 2, "row"),
    "m0": (2, 9, 0, 2, None),
    "n-ne-m": (2, 9, 23, 3, "partial"),
}


def _inputs(case, d=16, seed=0, cases=CASES):
    b, n, m, h, mask_kind = cases[case]
    rs = np.random.RandomState(seed + 13 * len(case))
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    arrays = [f(b, n, h, d), f(b, m, h, d), f(b, m, h, d), f(h, d), f(h, d), 1 + 0.1 * f(d), 1 + 0.1 * f(d)]
    mask = None
    if mask_kind is not None:
        mask = rs.rand(b, m) > 0.4
        if mask_kind == "row":
            mask[1] = False  # row 1 attends the null position only
    return arrays, mask, f(b, n, h, d)


def _bias(mask, b, m):
    return np.zeros((b, m), np.float32) if mask is None else np.where(mask, 0.0, port_attention.NEG_INF).astype(np.float32)


@jax.jit
def _jax_vjp(xs, bias, cot):
    return jax.vjp(lambda *a: _qknorm_xla(*a, bias, 8.0), *xs)[1](cot)


def _assert_leaves_close(got, want, frac, case, cases=CASES):
    for name, a, w in zip(NAMES, got, want):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        assert a.shape == w.shape, name
        if a.size == 0:
            continue
        if cases[case][2] == 0 and name in ZERO_WITHOUT_KEYS:
            np.testing.assert_allclose(a, 0.0, rtol=0, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(w, 0.0, rtol=0, atol=1e-5, err_msg=name)
            continue
        np.testing.assert_allclose(a, w, rtol=0, atol=frac * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_plain_matches_jax_vjp(case):
    arrays, mask, cot = _inputs(case)
    b, _, m, _, _ = CASES[case]
    want = _jax_vjp(tuple(jnp.asarray(a) for a in arrays), jnp.asarray(_bias(mask, b, m)), jnp.asarray(cot))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = port_attention.qknorm_attend_backward_plain(
        torch.from_numpy(cot), *(torch.from_numpy(a) for a in arrays), mask=tmask, scale=8.0
    )
    assert [t.dtype for t in got] == [torch.float32] * 7
    _assert_leaves_close([t.numpy() for t in got], [np.asarray(w) for w in want], GRAD_FRAC, case)
    if mask is not None and not mask.any(axis=1).all():
        # a fully masked row: no gradient reaches q through the keys, and its
        # whole output gradient goes to null_v
        row = int(np.flatnonzero(~mask.any(axis=1))[0])
        assert np.abs(got[0][row].numpy()).max() < 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_backward_plain_matches_autograd_f64(case):
    arrays, mask, cot = _inputs(case, seed=1)
    ts = [torch.from_numpy(a).double() for a in arrays]
    tmask = None if mask is None else torch.from_numpy(mask)
    leaves = [t.clone().requires_grad_() for t in ts]
    out = port_attention.qknorm_attend_plain(*leaves, mask=tmask)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(cot).double(), allow_unused=True)
    want = [torch.zeros_like(t) if w is None else w for t, w in zip(ts, want)]
    got = port_attention.qknorm_attend_backward_plain(torch.from_numpy(cot).double(), *ts, mask=tmask)
    assert [t.dtype for t in got] == [torch.float64] * 7
    for name, a, w in zip(NAMES, got, want):
        if a.numel():
            torch.testing.assert_close(a, w, rtol=0, atol=1e-10 * max(w.abs().max().item(), 1.0), msg=name)


@pytest.mark.parametrize("case", ["cross-mask", "row-masked", "n-ne-m"])
def test_backward_plain_bf16_rounding_within_limit(case):
    # the kernel's roundings (q^, k^, P, dS and the bf16 gradients) keep the
    # bf16 backward within K2_BWD_BF16_FROM_F32 of the f32 one; d 64, as the
    # kernel takes it
    arrays, mask, cot = _inputs(case, d=64, seed=2)
    ts = [torch.from_numpy(a) for a in arrays]
    ts = [t.bfloat16() if i < 5 else t for i, t in enumerate(ts)]
    g = torch.from_numpy(cot).bfloat16()
    tmask = None if mask is None else torch.from_numpy(mask)
    exact = port_attention.qknorm_attend_backward_plain(g, *ts, mask=tmask)
    rounded = port_attention.qknorm_attend_backward_plain(g, *ts, mask=tmask, round_to=torch.bfloat16)
    assert [t.dtype for t in rounded] == [torch.bfloat16] * 5 + [torch.float32] * 2
    assert any(not torch.equal(a, b) for a, b in zip(rounded, exact))
    for name, a, w in zip(NAMES, rounded, exact):
        w = w.float()
        torch.testing.assert_close(a.float(), w, rtol=0, atol=K2_BWD_BF16_FROM_F32 * w.abs().max().item(), msg=name)


def test_backward_wrapper_on_cpu_is_the_plain_version():
    # CPU tensors: the public wrapper and the autograd route run the plain
    # backward, launch nothing, and need neither the output nor its logsumexp
    arrays, mask, cot = _inputs("cross-mask")
    ts = [torch.from_numpy(a) for a in arrays]
    tmask = torch.from_numpy(mask)
    g = torch.from_numpy(cot)
    before = port_attention.qknorm_attend_backward.launches
    got = port_attention.qknorm_attend_backward(g, *ts, None, None, mask=tmask)
    want = port_attention.qknorm_attend_backward_plain(g, *ts, mask=tmask)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    leaves = [t.clone().requires_grad_() for t in ts]
    routed = torch.autograd.grad(port_attention.qknorm_attend(*leaves, mask=tmask), leaves, g)
    assert all(torch.equal(a, w) for a, w in zip(routed, want))
    assert port_attention.qknorm_attend_backward.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        port_attention.qknorm_attend_with_lse(*ts, mask=tmask)


# The f32 backward kernels' split (`qknorm_bwd_keys_f32` then
# `qknorm_bwd_queries_f32`), restated in plain PyTorch: ragged n and m across
# the 64-key tiles, a fully masked row, no keys
SPLIT_CASES = {
    "ragged": (2, 70, 130, 2, "partial"),
    "row-masked": (3, 65, 64, 2, "row"),
    "m0": (2, 9, 0, 2, None),
}


def _unit(t):
    r = torch.rsqrt((t * t).sum(-1, keepdim=True) + 1e-12)
    return t * r, r


def _split_backward(g, q, k, v, nk, nv, qs, ks, bias, scale=8.0, tile=64):
    """Per 64-key tile: S and dP once, dV and dK^ from P and dS, and the
    tile's r_q dQ^ = (dS r_q) k^ as a partial; on the query side only: the
    partials summed in key order, D = rowsum(g out), the null column, and
    q's norm as dq = w' - u (u . w') with w' = r_q dQ^ q_scale scale."""
    qsc, (uq, rq), (uk, rk), (unk, rnk) = qs * scale, _unit(q), _unit(k), _unit(nk)
    kh, nkh = uk * ks, unk * ks
    s_full = torch.einsum("bnhd,bmhd->bhnm", uq * qsc, kh) + bias[:, None, None, :]
    s0 = torch.einsum("bnhd,hd->bhn", uq * qsc, nkh)
    lse = torch.logsumexp(torch.cat([s0[..., None], s_full], -1), -1)  # the forward's
    out = torch.einsum("bhnm,bmhd->bnhd", torch.exp(s_full - lse[..., None]), v)
    out = out + torch.exp(s0 - lse).transpose(1, 2)[..., None] * nv
    dd = torch.einsum("bnhd,bnhd->bhn", g, out)
    r_q = rq[..., 0].transpose(1, 2)  # (b, h, n)
    dv, dk_u, parts = torch.zeros_like(v), torch.zeros_like(k), []
    for k0 in range(0, k.shape[1], tile):
        sl = slice(k0, k0 + tile)
        s = r_q[..., None] * torch.einsum("bnhd,bmhd->bhnm", q, kh[:, sl] * qsc) + bias[:, None, None, sl]
        p = torch.exp(s - lse[..., None])
        ds_r = p * (torch.einsum("bnhd,bmhd->bhnm", g, v[:, sl]) - dd[..., None]) * r_q[..., None]
        dv[:, sl] = torch.einsum("bhnm,bnhd->bmhd", p, g)
        dk_u[:, sl] = torch.einsum("bhnm,bnhd->bmhd", ds_r, q)
        parts.append(torch.einsum("bhnm,bmhd->bnhd", ds_r, kh[:, sl]))
    acc = torch.zeros_like(q)
    for part in parts:
        acc = acc + part
    p0 = torch.exp(s0 - lse)
    ds0 = p0 * (torch.einsum("bnhd,hd->bhn", g, nv) - dd)
    w2 = acc + (rq[..., 0] * ds0.transpose(1, 2))[..., None] * nkh
    w1 = w2 * qsc
    dq = w1 - uq * (uq * w1).sum(-1, keepdim=True)
    dkh, dnkh = dk_u * qsc, torch.einsum("bhn,bnhd->hd", ds0, uq * qsc)
    wk, wn = dkh * ks, dnkh * ks
    dk = rk * (wk - uk * (uk * wk).sum(-1, keepdim=True))
    dnk = rnk * (wn - unk * (unk * wn).sum(-1, keepdim=True))
    dqs = scale * (w2 * q).sum((0, 1, 2))
    dks = (dkh * uk).sum((0, 1, 2)) + (dnkh * unk).sum(0)
    return dq, dk, dv, dnk, torch.einsum("bhn,bnhd->hd", p0, g), dqs, dks


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_f32_kernel_split_matches_jax_vjp(case):
    b, _, m, _, _ = SPLIT_CASES[case]
    arrays, mask, cot = _inputs(case, d=64, seed=3, cases=SPLIT_CASES)
    bias = _bias(mask, b, m)
    want = _jax_vjp(tuple(jnp.asarray(a) for a in arrays), jnp.asarray(bias), jnp.asarray(cot))
    ts = [torch.from_numpy(a) for a in arrays]
    got = _split_backward(torch.from_numpy(cot), *ts, torch.from_numpy(bias))
    _assert_leaves_close([t.numpy() for t in got], [np.asarray(w) for w in want], GRAD_FRAC, case, SPLIT_CASES)


# The bf16 split route (`qknorm_bwd_queries_bf16`, then `qknorm_bwd_keys_bf16`,
# n > 256), restated in plain PyTorch on bf16-valued inputs: ragged n over
# three 128-query blocks and ragged m over two 128-key blocks, a fully
# masked row, no keys
BF16_SPLIT_CASES = {
    "ragged": (2, 300, 130, 2, "partial"),
    "row-masked": (3, 260, 70, 2, "row"),
    "m0": (2, 270, 0, 2, None),
}


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _through_norm(dt_hat, u, r, s):
    w = dt_hat * s
    return r * (w - u * (u * w).sum(-1, keepdim=True))


def _bf16_split_backward(g, q, k, v, nk, nv, qs, ks, bias, scale=8.0, block=128, tile=64):
    """q^ and k^ rounded to bf16 where the kernels round them (f32 norm
    and scale first); the forward's output rounded to bf16 for D =
    rowsum(g out). The queries kernel, per 128-query block and 64-key tile:
    S and dP recomputed, dS rounded, dQ^ summed in key order, then dS_0 nk^
    and q's norm; the keys kernel, per 128-key block and 64-query tile: P
    and dS rounded, dV and dK^ summed in query order, then k's norm. Each
    block's rows of the scale and null gradients are summed over its rows,
    then the blocks in (batch, block) order. dq, dk, dv, d null_k, d null_v
    come out in bf16, as the kernels write them."""
    b, n, h, _ = q.shape
    m = k.shape[1]
    qsc = qs * scale
    (uq, rq), (uk, rk), (unk, rnk) = _unit(q), _unit(k), _unit(nk)
    qh, kh, nkh = _bf16(uq * qsc), _bf16(uk * ks), unk * ks
    s0 = torch.einsum("bnhd,hd->bhn", qh, nkh)
    s_full = torch.einsum("bnhd,bmhd->bhnm", qh, kh) + bias[:, None, None, :]
    lse = torch.logsumexp(torch.cat([s0[..., None], s_full], -1), -1)  # the forward's
    out = torch.einsum("bhnm,bmhd->bnhd", torch.exp(s_full - lse[..., None]), v)
    out = _bf16(out + torch.exp(s0 - lse).transpose(1, 2)[..., None] * nv)
    dd = torch.einsum("bnhd,bnhd->bhn", g, out)
    p0 = torch.exp(s0 - lse)
    ds0 = p0 * (torch.einsum("bnhd,hd->bhn", g, nv) - dd)

    def tile_terms(qr, kr):  # P and dS of query rows qr against keys kr
        p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", qh[:, qr], kh[:, kr]) + bias[:, None, None, kr] - lse[..., qr, None])
        dp = torch.einsum("bnhd,bmhd->bhnm", g[:, qr], v[:, kr])
        return p, p * (dp - dd[..., qr, None])

    # the queries kernel
    dqh = torch.zeros_like(q)
    dqs_rows, dnv_rows, dnk_rows = [], [], []
    for q0 in range(0, n, block):
        qr = slice(q0, q0 + block)
        acc = torch.zeros_like(q[:, qr])
        for k0 in range(0, m, tile):
            _, ds = tile_terms(qr, slice(k0, k0 + tile))
            acc = acc + torch.einsum("bhnm,bmhd->bnhd", _bf16(ds), kh[:, k0 : k0 + tile])
        dqh[:, qr] = acc + ds0[..., qr].transpose(1, 2)[..., None] * nkh
        dqs_rows.append((dqh[:, qr] * uq[:, qr]).sum(1))  # (b, h, d): a row a (batch, block, head)
        dnv_rows.append(torch.einsum("bhn,bnhd->bhd", p0[..., qr], g[:, qr]))
        dnk_rows.append(torch.einsum("bhn,bnhd->bhd", ds0[..., qr], qh[:, qr]))
    # the keys kernel
    dv, dkh, dks_rows = torch.zeros_like(v), torch.zeros_like(k), []
    for k0 in range(0, m, block):
        kr = slice(k0, k0 + block)
        for q0 in range(0, n, tile):
            p, ds = tile_terms(slice(q0, q0 + tile), kr)
            dv[:, kr] += torch.einsum("bhnm,bnhd->bmhd", _bf16(p), g[:, q0 : q0 + tile])
            dkh[:, kr] += torch.einsum("bhnm,bnhd->bmhd", _bf16(ds), qh[:, q0 : q0 + tile])
        dks_rows.append((dkh[:, kr] * uk[:, kr]).sum(1))

    def in_order(rows):  # blocks in (batch, block) order, each row's sum first
        total = torch.zeros(rows[0].shape[1:])
        for bi in range(b):
            for r in rows:
                total = total + r[bi]
        return total

    dnkh = in_order(dnk_rows)  # (h, d)
    dqs = scale * in_order(dqs_rows).sum(0)
    dks = in_order(dks_rows).sum(0) + (dnkh * unk).sum(0) if m else (dnkh * unk).sum(0)
    dq = _bf16(_through_norm(dqh, uq, rq, qsc))
    dk = _bf16(_through_norm(dkh, uk, rk, ks))
    dnk = _bf16(_through_norm(dnkh, unk, rnk, ks))
    return dq, dk, _bf16(dv), dnk, _bf16(in_order(dnv_rows)), dqs, dks


@pytest.mark.parametrize("case", list(BF16_SPLIT_CASES))
def test_bf16_kernel_split_matches_jax_vjp(case):
    b, _, m, _, _ = BF16_SPLIT_CASES[case]
    arrays, mask, cot = _inputs(case, d=64, seed=5, cases=BF16_SPLIT_CASES)
    arrays, cot = [_bf16(torch.from_numpy(a)).numpy() for a in arrays], _bf16(torch.from_numpy(cot)).numpy()
    bias = _bias(mask, b, m)
    want = _jax_vjp(tuple(jnp.asarray(a) for a in arrays), jnp.asarray(bias), jnp.asarray(cot))
    got = _bf16_split_backward(torch.from_numpy(cot), *[torch.from_numpy(a) for a in arrays], torch.from_numpy(bias))
    _assert_leaves_close([t.numpy() for t in got], [np.asarray(w) for w in want], K2_BWD_BF16_FROM_F32, case, BF16_SPLIT_CASES)
