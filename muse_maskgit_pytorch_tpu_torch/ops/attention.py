"""Attention: K2, the fused qk-norm attention of the models, and K4, the
plain flash attention of the public `attend` op.

Counterpart of `muse_maskgit_pytorch_tpu/ops/attention.py`. Its two Pallas
kernels are replaced on Hopper by CUDA kernels (see each source for what
bounds it on the H100 and how its design answers that):

  * `_qknorm_kernel` by `csrc/qknorm_attention.cu`, behind `qknorm_attend`;
    `qknorm_attend_plain` is the same function in plain PyTorch (the math of
    the JAX package's `_qknorm_xla`). Unlike the JAX package there is no
    crossover to a library attention below some kv length: every attention
    of the models goes through this function. Its gradient
    (`_QKNormAttention`) is the port's own kernel,
    `csrc/qknorm_attention_bwd.cu` behind `qknorm_attend_backward`, fed the
    row logsumexp that the forward saves; JAX's `_qknorm_bwd` is XLA's vjp
    of `_qknorm_xla`, no Pallas kernel. `qknorm_attend_backward_plain` is
    its plain version, the flash backward's formulas written out.
  * `_flash_kernel` by `csrc/flash_attention.cu`, behind
    `attend(impl="flash")`; `attend_plain` is its plain version
    (`xla_attention` in f32). No model path calls it, as in JAX; its
    gradient recomputes through the plain version.

The bf16 paths of both share one Hopper flash-attention core,
`csrc/attention_core.cuh`. Each wrapper launches its kernel for CUDA tensors
and runs the plain version for CPU tensors; K2's forward does so as the
operator `muse_torch::qknorm_attend` (`ops/_library.py`), so a traced
program keeps the choice for the device it runs on.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from muse_maskgit_pytorch_tpu_torch.ops import _build, _library

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64
FLASH_HEAD_DIMS = (32, 64)

# Max abs error allowed to a bf16 attention kernel, for the checks only
# (chip_smoke.py and the tests): against its plain version with `round_to=
# torch.bfloat16`, one bf16 step of outputs of order 1; against the f32 plain
# version, the distance each Pallas kernel keeps in bf16 from its f32 oracle
# (tests/test_torch_attention.py measures K2 <= 1e-2, K4 <= 8e-3 and holds
# the Pallas kernels to these limits).
BF16_VS_ROUNDED = 2e-2
K2_BF16_FROM_F32 = 2e-2
K4_BF16_FROM_F32 = 2e-2
# The same for K2's bf16 backward, as a fraction of each gradient's largest
# |entry|: against the f32 plain backward on the same bf16 inputs, the
# distance its rounding of q^, k^, P and dS and of the bf16 gradients keeps
# (the plain `round_to` form measures 0.002-0.007 at the train and super-res
# shapes); against the `round_to` form, which rounds at the same places, a
# few bf16 steps of the gradients (one step is 2^-8 of an entry).
K2_BWD_BF16_FROM_F32 = 2e-2
K2_BWD_BF16_VS_ROUNDED = 1e-2


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention, layout (b, h, n, d); mask: bool (b, m) over kv
    positions (counterpart of the JAX package's `xla_attention`)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    sim = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :], NEG_INF)
    attn = sim.softmax(dim=-1)
    return torch.einsum("bhij,bhjd->bhid", attn, v)


def key_mask_bias(mask: Optional[torch.Tensor], b: int, m: int, device) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(mask.to(device=device, dtype=torch.bool), zero, NEG_INF).reshape(b, m)


def qknorm_attend_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    null_k: torch.Tensor,
    null_v: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 8.0,
    round_to: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of `qknorm_attend` (same arguments): f32
    l2-norms (eps 1e-12), learned scales, the null position first in the
    softmax, additive key bias 0 / -1e30 from the mask. Computes in f32
    (f64 for f64 inputs).

    `round_to` (e.g. torch.bfloat16) rounds where the JAX package's
    `_qknorm_kernel` rounds: q^ and k^ after the f32 norm and scale, and
    P = exp(s - row max) before P v, the softmax sum and the null term
    staying unrounded. Only the checks use it."""
    bias = key_mask_bias(mask, k.shape[0], k.shape[1], q.device)
    return _qknorm_plain(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale, round_to)


def _qknorm_plain(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale, round_to=None):
    """`qknorm_attend_plain` with the key mask given as its additive (b, m)
    f32 bias (or None)."""
    acc = torch.promote_types(q.dtype, torch.float32)

    def norm(t):
        t = t.to(acc)
        return t * torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + 1e-12)

    qn = norm(q) * (q_scale.to(acc) * scale)
    kn = norm(k) * k_scale.to(acc)
    nkn = norm(null_k) * k_scale.to(acc)  # (h, d)
    if round_to is not None:
        qn, kn = qn.to(round_to).to(acc), kn.to(round_to).to(acc)
    sim = torch.einsum("bnhd,bmhd->bhnm", qn, kn)
    if bias is not None:
        sim = sim + bias[:, None, None, :]
    s0 = torch.einsum("bnhd,hd->bhn", qn, nkn)[..., None]  # null position
    if round_to is None:
        attn = torch.cat([s0, sim], dim=-1).softmax(dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn[..., 1:], v.to(acc))
        out = out + attn[..., :1].transpose(1, 2) * null_v.to(acc)[None, None]
        return out.to(q.dtype)
    full = torch.cat([s0, sim], dim=-1)
    p = torch.exp(full - full.amax(dim=-1, keepdim=True))
    pv = p[..., 1:].to(round_to).to(acc)
    out = torch.einsum("bhnm,bmhd->bnhd", pv, v.to(acc))
    out = out + p[..., :1].transpose(1, 2) * null_v.to(acc)[None, None]
    return (out / p.sum(dim=-1)[..., None].transpose(1, 2)).to(q.dtype)


def qknorm_attend_backward_plain(
    g: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    null_k: torch.Tensor,
    null_v: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 8.0,
    round_to: Optional[torch.dtype] = None,
):
    """Plain PyTorch version of K2's backward: the gradients of
    `qknorm_attend`'s output against the output gradient `g` (b, n, h, d),
    as (dq, dk, dv, d null_k, d null_v, d q_scale, d k_scale), each in its
    input's dtype. The flash formulas written out, with no autograd.

    `round_to` (e.g. torch.bfloat16) rounds where the kernel rounds: q^ and
    k^ after the f32 norm and scale, P before P^T g, and dS before dS k^ and
    dS^T q^, with the row terms, the null column and every sum in f32, and
    D = g . out taken from the output the bf16 forward returns; the null
    key's and value's gradients come out in `round_to` (the kernel writes
    them in the inputs' dtype) before the cast to their own dtype. Only the
    checks use it."""
    bias = key_mask_bias(mask, k.shape[0], k.shape[1], q.device)
    return _qknorm_backward_plain(g, q, k, v, null_k, null_v, q_scale, k_scale, bias, scale, round_to)


def _qknorm_backward_plain(g, q, k, v, null_k, null_v, q_scale, k_scale, bias, scale, round_to=None):
    """`qknorm_attend_backward_plain` with the key mask as its (b, m) bias.

    Per (batch, head), with u = t / |t| and r = 1 / |t| for each of q, k and
    the null key: q^ = u_q q_scale scale, k^ = u_k k_scale; P = softmax over
    [null, keys]; D = rowsum(g out); dP = g [nv; v]^T; dS = P (dP - D);
    dv = P^T g; dq^ = dS [nk^; k^]; dk^ = dS^T q^; through each norm
    dt = r (w - u (u . w)) with w = dt^ times its scale; the scales'
    gradients sum dt^ u. The key bias gets no gradient."""
    acc = torch.promote_types(q.dtype, torch.float32)
    rnd = (lambda t: t.to(round_to).to(acc)) if round_to is not None else (lambda t: t)

    def unit(t):
        t = t.to(acc)
        r = torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + 1e-12)
        return t * r, r

    def through_norm(dt_hat, u, r, s):
        w = dt_hat * s
        return r * (w - u * (u * w).sum(dim=-1, keepdim=True))

    uq, rq = unit(q)
    uk, rk = unit(k)
    unk, rnk = unit(null_k)  # (h, d)
    qsc, ksc = q_scale.to(acc) * scale, k_scale.to(acc)
    qn, kn, nkn = rnd(uq * qsc), rnd(uk * ksc), unk * ksc
    gf, vf, nvf = g.to(acc), v.to(acc), null_v.to(acc)

    s = torch.einsum("bnhd,bmhd->bhnm", qn, kn)
    if bias is not None:
        s = s + bias.to(acc)[:, None, None, :]
    s0 = torch.einsum("bnhd,hd->bhn", qn, nkn)
    lse = torch.logsumexp(torch.cat([s0[..., None], s], dim=-1), dim=-1)  # (b, h, n)
    p, p0 = torch.exp(s - lse[..., None]), torch.exp(s0 - lse)
    dp, dp0 = torch.einsum("bnhd,bmhd->bhnm", gf, vf), torch.einsum("bnhd,hd->bhn", gf, nvf)
    if round_to is None:
        # D = g . out taken as sum P dP over the null and the keys, the form
        # of the softmax's vjp: a row with every key masked gets dS = 0 exactly
        dd = (p * dp).sum(dim=-1) + p0 * dp0
    else:
        out = _qknorm_plain(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale, round_to).to(acc)
        dd = torch.einsum("bnhd,bnhd->bhn", gf, out)
    ds = p * (dp - dd[..., None])
    ds0 = p0 * (dp0 - dd)

    dv = torch.einsum("bhnm,bnhd->bmhd", rnd(p), gf)
    dnv = torch.einsum("bhn,bnhd->hd", p0, gf)
    dqn = torch.einsum("bhnm,bmhd->bnhd", rnd(ds), kn) + torch.einsum("bhn,hd->bnhd", ds0, nkn)
    dkn = torch.einsum("bhnm,bnhd->bmhd", rnd(ds), qn)
    dnkn = torch.einsum("bhn,bnhd->hd", ds0, qn)

    dq = through_norm(dqn, uq, rq, qsc)
    dk = through_norm(dkn, uk, rk, ksc)
    dnk = through_norm(dnkn, unk, rnk, ksc)
    dnk, dnv = rnd(dnk), rnd(dnv)
    dqs = scale * (dqn * uq).sum(dim=(0, 1, 2))
    dks = (dkn * uk).sum(dim=(0, 1, 2)) + (dnkn * unk).sum(dim=0)
    grads = (dq, dk, dv, dnk, dnv, dqs, dks)
    return tuple(t.to(x.dtype) for t, x in zip(grads, (q, k, v, null_k, null_v, q_scale, k_scale)))


def _lib() -> ctypes.CDLL:
    lib = _build.load("qknorm_attention")
    fn = lib.muse_qknorm_attn_launch
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p] * 10 + [i] * 4 + [ll] * 6 + [f, i, p]
        fn.restype = ctypes.c_int
        lib.muse_qknorm_attn_error_string.argtypes = [ctypes.c_int]
        lib.muse_qknorm_attn_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """TMA and the 16-byte loads of the bf16 kernels need 16-byte aligned
    rows: a copy where a view starts off that."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _heads_contiguous(t: torch.Tensor) -> torch.Tensor:
    """The kernels walk batch and sequence by stride; (h, d) must be dense,
    and rows 16-byte aligned (base and strides)."""
    d = t.shape[-1]
    dense = t.stride(-1) == 1 and t.stride(-2) == d
    step = 16 // t.element_size()
    if not (dense and t.stride(0) % step == 0 and t.stride(1) % step == 0):
        t = t.contiguous()
    return _aligned(t)


def _qknorm_check(q, k, v, null_k, null_v, q_scale, k_scale, bias):
    """K2's contract on the card, checked at every launch: the public
    wrapper, the gradient route and the operator (which a traced program or
    `torch.ops.muse_torch.qknorm_attend` reaches without the wrapper) all
    pass here."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qknorm_attend takes f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if q.dim() != 4 or q.shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {KERNEL_HEAD_DIM}, got q {tuple(q.shape)}")
    b, n, h, d = q.shape
    m = k.shape[1] if k.dim() == 4 else -1
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if null_k.shape != (h, d) or null_v.shape != (h, d) or q_scale.numel() != d or k_scale.numel() != d:
        raise ValueError(f"null_k / null_v must be ({h}, {d}) and q_scale / k_scale ({d},)")
    if bias is not None and (bias.shape != (b, m) or bias.dtype != torch.float32):
        raise ValueError(f"the key bias must be ({b}, {m}) f32, got {tuple(bias.shape)} {bias.dtype}")
    others = (k, v, null_k, null_v, q_scale, k_scale) + ((bias,) if bias is not None else ())
    if q.device.type != "cuda" or any(t.device != q.device for t in others):
        raise ValueError("qknorm_attend: K2 takes all its inputs on one CUDA device")


def _qknorm_launch(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale: float, with_lse: bool = False):
    """Launch K2 on CUDA tensors, checked by `_qknorm_check`. With
    `with_lse`, returns (out, lse): lse (b, h, n) f32 is each row's
    logsumexp over the null position and the keys, for the backward."""
    _qknorm_check(q, k, v, null_k, null_v, q_scale, k_scale, bias)
    b, n, h, d = q.shape
    m = k.shape[1]
    q, k, v = _heads_contiguous(q), _heads_contiguous(k), _heads_contiguous(v)
    nk = null_k.to(q.dtype).contiguous()
    nv = null_v.to(q.dtype).contiguous()
    qs = q_scale.to(torch.float32).contiguous()
    ks = k_scale.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _lib()
    err = lib.muse_qknorm_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        qs.data_ptr(), ks.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), lse.data_ptr() if with_lse else None, b, n, m, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), 1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib.muse_qknorm_attn_error_string, err, "qknorm_attend")
    qknorm_attend.launches += 1
    return (out, lse) if with_lse else out


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.muse_qknorm_attn_bwd_launch
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p] * 19 + [i] * 4 + [ll] * 8 + [f, i, p]
        fn.restype = ctypes.c_int
        for name in ("muse_qknorm_attn_bwd_workspace", "muse_qknorm_attn_bwd_clocks", "muse_qknorm_attn_bwd_clock_rows"):
            getattr(lib, name).argtypes = [i] * 5
            getattr(lib, name).restype = ll
        lib.muse_qknorm_attn_bwd_one_pass.argtypes = [i, i]
        lib.muse_qknorm_attn_bwd_one_pass.restype = i
        lib.muse_qknorm_attn_bwd_error_string.argtypes = [i]
        lib.muse_qknorm_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    return _bind_bwd(_build.load("qknorm_attention_bwd"))


def _align256(x: int) -> int:
    return (x + 255) & ~255


def _qknorm_backward_launch(g, q, k, v, null_k, null_v, q_scale, k_scale, bias, out, lse, scale: float):
    """Launch K2's backward on CUDA tensors: `out` and `lse` are what the
    forward returned with `with_lse`. Returns the seven gradients, each in
    its input's dtype."""
    return _backward_call(_bwd_lib(), g, q, k, v, null_k, null_v, q_scale, k_scale, bias, out, lse, scale)


def _backward_call(lib, g, q, k, v, null_k, null_v, q_scale, k_scale, bias, out, lse, scale: float, workspace=None):
    """The gradients from one launch of `lib`'s backward. Two allocations:
    dq, dk, dv and the kernel's workspace share one buffer (`workspace`,
    where given, is the workspace instead); the four small gradients have
    their own, so that a parameter's `.grad` does not keep the large one
    alive."""
    b, n, h, d = q.shape
    m = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"K2's backward kernel runs on CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2's backward takes f32 or bf16, got {q.dtype}")
    if d != KERNEL_HEAD_DIM or g.shape != q.shape or out.shape != q.shape or k.shape != (b, m, h, d) or v.shape != k.shape:
        raise ValueError(f"K2's backward: g {tuple(g.shape)}, q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if lse.shape != (b, h, n) or lse.dtype != torch.float32:
        raise ValueError(f"K2's backward: lse {tuple(lse.shape)} {lse.dtype}, expected ({b}, {h}, {n}) f32")
    for t in (g, k, v, null_k, null_v, q_scale, k_scale, out, lse):
        if t.device != q.device:
            raise ValueError("K2's backward: all inputs must be on one device")
    if b * n == 0:  # no query: every gradient is zero, and nothing is launched
        return tuple(torch.zeros_like(x) for x in (q, k, v, null_k, null_v, q_scale, k_scale))
    dt, dev, es = q.dtype, q.device, q.element_size()
    small = torch.empty(2 * h * d * es + 2 * d * 4, dtype=torch.uint8, device=dev)
    dnk = small[: h * d * es].view(dt).view(h, d)
    dnv = small[h * d * es : 2 * h * d * es].view(dt).view(h, d)
    dqs, dks = small[2 * h * d * es :].view(torch.float32).view(2, d)
    nq, nkv = _align256(b * n * h * d * es), _align256(b * m * h * d * es)
    g, q, k, v = (_heads_contiguous(t.to(dt)) for t in (g, q, k, v))
    out, lse = _aligned(out.contiguous()), lse.contiguous()
    nk = null_k.to(dt).contiguous()
    nv = null_v.to(dt).contiguous()
    qs = q_scale.to(torch.float32).contiguous()
    ks = k_scale.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.contiguous()
    dtype = 1 if dt == torch.bfloat16 else 0
    ws = nq + 2 * nkv
    extra = lib.muse_qknorm_attn_bwd_workspace(b, n, m, h, dtype) if workspace is None else 0
    buf = torch.empty(ws + extra, dtype=torch.uint8, device=dev)
    dq = buf[: b * n * h * d * es].view(dt).view(b, n, h, d)
    dk = buf[nq : nq + b * m * h * d * es].view(dt).view(b, m, h, d)
    dv = buf[nq + nkv : nq + nkv + b * m * h * d * es].view(dt).view(b, m, h, d)
    err = lib.muse_qknorm_attn_bwd_launch(
        g.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        nk.data_ptr(), nv.data_ptr(), qs.data_ptr(), ks.data_ptr(), bias.data_ptr() if bias is not None else None,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dnk.data_ptr(), dnv.data_ptr(), dqs.data_ptr(), dks.data_ptr(),
        buf.data_ptr() + ws if workspace is None else workspace.data_ptr(), b, n, m, h,
        g.stride(0), g.stride(1), q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), dtype, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib.muse_qknorm_attn_bwd_error_string, err, "qknorm_attend_backward")
    qknorm_attend_backward.launches += 1
    return (dq, dk, dv, dnk.to(null_k.dtype), dnv.to(null_v.dtype), dqs.to(q_scale.dtype), dks.to(k_scale.dtype))


def _backward_one_pass(n: int, dtype: torch.dtype) -> bool:
    """Whether K2's backward takes its one-pass kernel for n queries of
    this dtype (else the bf16 split route, or the f32 route's key-stationary
    kernel and query side); the kernel's library decides."""
    return bool(_bwd_lib().muse_qknorm_attn_bwd_one_pass(n, 1 if dtype == torch.bfloat16 else 0))


BACKWARD_PARTS = (
    "q-side loads", "prologue", "key tile wait + k^", "tile pairs", "halves, dv, dk", "dq epilogue", "reduction",
)
# the bf16 split route's kernels, as their thread 0 sees them
BACKWARD_SPLIT_PARTS = ("prologue", "ready waits", "products", "exponentials and dS", "epilogue", "normalising")
BACKWARD_TIMING_FLAGS = ("-DQKNORM_BWD_TIMING",)
_CLOCK_SLOTS = 10  # a block's int64 clock slots in that build: start, end, SM, the parts
_SPLIT_ROWS = 128  # rows (queries or keys) a block of the bf16 split route owns
_timing_bwd_lib = None


def _clock_stats(clocks: torch.Tensor, names) -> dict:
    start, end = clocks[:, 0], clocks[:, 1]
    events = sorted([(int(t), 1) for t in start] + [(int(t), -1) for t in end])
    live = most = 0
    for _, step in events:
        live += step
        most = max(most, live)
    return dict(
        parts={name: clocks[:, 3 + i].double().mean().item() for i, name in enumerate(names)},
        block_ns=(end - start).double().mean().item(),
        span_ns=int(end.max() - start.min()),
        concurrent=most,
    )


def backward_part_clocks(g, q, k, v, null_k, null_v, q_scale, k_scale, out, lse, mask=None, scale: float = 8.0):
    """Diagnostic: where the bf16 backward kernels' time goes. Runs the
    `-DQKNORM_BWD_TIMING` build once on bf16 CUDA inputs (arguments as
    `qknorm_attend_backward`) and returns, for each kernel that keeps clocks
    (the one-pass kernel at n <= 256; `qknorm_bwd_queries_bf16` and
    `qknorm_bwd_keys_bf16` above), by its name: averaged over its blocks, the
    SM clocks of each part (`BACKWARD_PARTS`, `BACKWARD_SPLIT_PARTS`) as
    the timed threads saw them (`parts`), and from the global timer the mean
    block's ns (`block_ns`), the kernel's span (`span_ns`) and the most
    blocks resident at once (`concurrent`). The instrumented build is
    slower than the kernel by its clock reads, and counts as a launch of
    the backward."""
    global _timing_bwd_lib
    if q.dtype != torch.bfloat16:
        raise ValueError("backward_part_clocks times the bf16 kernels")
    if _timing_bwd_lib is None:
        _timing_bwd_lib = _bind_bwd(ctypes.CDLL(str(_build.build("qknorm_attention_bwd", BACKWARD_TIMING_FLAGS))))
    lib = _timing_bwd_lib
    b, n, h, _ = q.shape
    m = k.shape[1]
    bias = key_mask_bias(mask, b, m, q.device)
    ws = torch.empty(lib.muse_qknorm_attn_bwd_workspace(b, n, m, h, 1), dtype=torch.uint8, device=q.device)
    _backward_call(lib, g, q, k, v, null_k, null_v, q_scale, k_scale, bias, out, lse, scale, workspace=ws)
    at, rows = lib.muse_qknorm_attn_bwd_clocks(b, n, m, h, 1), lib.muse_qknorm_attn_bwd_clock_rows(b, n, m, h, 1)
    clocks = ws[at : at + rows * _CLOCK_SLOTS * 8].view(torch.int64).view(rows, _CLOCK_SLOTS).cpu()
    if _backward_one_pass(n, q.dtype):
        return {"qknorm_bwd_onepass_bf16": _clock_stats(clocks, BACKWARD_PARTS)}
    q_rows = b * h * -(-n // _SPLIT_ROWS)
    stats = {"qknorm_bwd_queries_bf16": _clock_stats(clocks[:q_rows], BACKWARD_SPLIT_PARTS)}
    if m > 0:
        stats["qknorm_bwd_keys_bf16"] = _clock_stats(clocks[q_rows:], BACKWARD_SPLIT_PARTS)
    return stats


def qknorm_attend_backward(
    g: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    null_k: torch.Tensor,
    null_v: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 8.0,
):
    """K2's backward: the gradients (dq, dk, dv, d null_k, d null_v,
    d q_scale, d k_scale) of `qknorm_attend` at these inputs against the
    output gradient g, given the forward's output and row logsumexp
    (`qknorm_attend_with_lse`). The kernel for CUDA tensors;
    `qknorm_attend_backward_plain` for CPU tensors, which needs neither
    `out` nor `lse`."""
    if q.device.type == "cpu":
        return qknorm_attend_backward_plain(g, q, k, v, null_k, null_v, q_scale, k_scale, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"qknorm_attend_backward: unsupported device {q.device}")
    bias = key_mask_bias(mask, k.shape[0], k.shape[1], q.device)
    return _qknorm_backward_launch(g, q, k, v, null_k, null_v, q_scale, k_scale, bias, out, lse, scale)


qknorm_attend_backward.launches = 0


class _QKNormAttention(torch.autograd.Function):
    """K2 under a gradient. CUDA tensors: K2's forward, which also writes
    the row logsumexp, then K2's backward kernel from the saved output and
    logsumexp. CPU tensors: the plain version and the plain backward. The
    key bias gets no gradient; the backward is not itself differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, null_k, null_v, q_scale, k_scale, bias, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, null_k, null_v, q_scale, k_scale, bias, None, None)
            return _qknorm_plain(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale)
        out, lse = _qknorm_launch(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, null_k, null_v, q_scale, k_scale, bias, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *inputs, bias, out, lse = ctx.saved_tensors
        if g.device.type == "cpu":
            grads = _qknorm_backward_plain(g, *inputs, bias, ctx.scale)
        else:
            grads = _qknorm_backward_launch(g, *inputs, bias, out, lse, ctx.scale)
        return (*grads, None, None)


def qknorm_attend_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    null_k: torch.Tensor,
    null_v: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 8.0,
):
    """K2's forward as the gradient route runs it on CUDA tensors: (out,
    lse), lse (b, h, n) f32 the row logsumexp that `qknorm_attend_backward`
    reads. No graph is kept."""
    if q.device.type != "cuda":
        raise ValueError(f"qknorm_attend_with_lse runs K2 on CUDA tensors, got {q.device}")
    bias = key_mask_bias(mask, k.shape[0], k.shape[1], q.device)
    with torch.no_grad():
        return _qknorm_launch(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale, with_lse=True)


def _qknorm_cpu(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale):
    return _qknorm_plain(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale).contiguous()


def _qknorm_cuda(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale):
    return _qknorm_launch(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale)


def _qknorm_fake(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale):
    return q.new_empty(q.shape)


# K2's forward without the row logsumexp: the CPU implementation is the
# plain version; the gradient route (`_QKNormAttention`) launches the
# forward with the logsumexp itself
_qknorm_op = _library.define(
    "qknorm_attend(Tensor q, Tensor k, Tensor v, Tensor null_k, Tensor null_v, Tensor q_scale, "
    "Tensor k_scale, Tensor? bias, float scale) -> Tensor",
    _qknorm_cpu,
    _qknorm_cuda,
    _qknorm_fake,
)


def qknorm_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    null_k: torch.Tensor,
    null_v: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 8.0,
) -> torch.Tensor:
    """Fused qk-l2norm attention with a learned null KV pair.

    q: (b, n, h, d), k/v: (b, m, h, d) raw projections (strided views are
    read in place); null_k/null_v: (h, d); q_scale/k_scale: (d,);
    mask: bool (b, m) over the real kv positions (the null position is
    always attendable). Returns (b, n, h, d) in q's dtype.

    Where gradients are on and an input needs one, the call goes through
    `_QKNormAttention` (K2 forward with the row logsumexp, K2's backward
    kernel); else it is the operator `muse_torch::qknorm_attend`
    (`ops/_library.py`): K2 alone on CUDA tensors, nothing saved, and the
    plain version on CPU tensors. Every launch of K2's forward counts in
    `qknorm_attend.launches`."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qknorm_attend: unsupported device {q.device}")
    inputs = (q, k, v, null_k, null_v, q_scale, k_scale)
    bias = key_mask_bias(mask, q.shape[0], k.shape[1], q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _QKNormAttention.apply(*inputs, bias, float(scale))
    return _qknorm_op(*inputs, bias, float(scale))


qknorm_attend.launches = 0


# -- K4: plain flash attention behind the public `attend` op ------------------


def attend_plain(
    q,
    k,
    v,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    round_to: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K4's plain version: `xla_attention` computed in f32 (f64 for f64
    inputs) and returned in q's dtype, as the kernel keeps its statistics
    and sums in f32. A row whose keys are all masked averages v over its m
    keys. K4's backward recomputes through it, as JAX's `_flash_bwd` does
    through XLA.

    `round_to` (e.g. torch.bfloat16) rounds where the JAX package's
    `_flash_kernel` rounds: q * scale (its wrapper scales q in q's dtype)
    and P = exp(s - row max) before P v, the softmax sum staying unrounded.
    Only the checks use it."""
    acc = torch.promote_types(q.dtype, torch.float32)
    if round_to is None:
        return xla_attention(q.to(acc), k.to(acc), v.to(acc), mask=mask, scale=scale).to(q.dtype)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qs = (q.to(acc) * scale).to(round_to).to(acc)
    sim = torch.einsum("bhid,bhjd->bhij", qs, k.to(acc))
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.exp(sim - sim.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhij,bhjd->bhid", p.to(round_to).to(acc), v.to(acc))
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _flash_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.muse_flash_attn_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 5 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.muse_flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.muse_flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def _flash_forward(q, k, v, mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Launch K4 on CUDA tensors (b, h, n, d) / (b, h, m, d)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash kernel takes f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    b, h, n, d = q.shape
    m = k.shape[2]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dim {FLASH_HEAD_DIMS}, got {d}")
    if k.shape != (b, h, m, d) or v.shape != (b, h, m, d) or m == 0:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attend: all inputs must be on one device")
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    bias = key_mask_bias(mask, b, m, q.device)
    out = torch.empty_like(q)
    lib = _flash_lib()
    err = lib.muse_flash_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), b, h, n, m, d, float(scale), 1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib.muse_flash_attn_error_string, err, "attend")
    attend.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """K4 forward (the plain version for CPU tensors); the backward
    recomputes through the plain version, as JAX's `_flash_bwd` does."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        if q.device.type == "cpu":
            return attend_plain(q, k, v, mask, scale)
        return _flash_forward(q, k, v, mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = attend_plain(q, k, v, mask, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention dispatch (the JAX package's public `attend`).

    q (b, h, n, d), k/v (b, h, m, d); mask: optional bool (b, m), True = the
    key may be attended; scale: default d ** -0.5. impl: "xla" is
    `xla_attention`; "flash" is K4 (f32 or bf16, d 32 or 64) on CUDA
    tensors and its plain version on CPU tensors; "auto" is "flash" for CUDA
    tensors and "xla" for CPU tensors."""
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "xla"
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if impl == "xla":
        return xla_attention(q, k, v, mask=mask, scale=scale)
    if impl != "flash":
        raise ValueError(f"unknown attention impl {impl!r}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attend: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, mask, scale)


attend.launches = 0
