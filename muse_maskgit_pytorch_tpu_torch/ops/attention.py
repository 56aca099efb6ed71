"""Attention: K2, the fused qk-norm attention of the models, and K4, the
plain flash attention of the public `attend` op.

Counterpart of `muse_maskgit_pytorch_tpu/ops/attention.py`. Its two Pallas
kernels are replaced on Hopper by CUDA kernels (see each source for what
bounds it on the H100 and how its design answers that):

  * `_qknorm_kernel` by `csrc/qknorm_attention.cu`, behind `qknorm_attend`;
    `qknorm_attend_plain` is the same function in plain PyTorch (the math of
    the JAX package's `_qknorm_xla`). Unlike the JAX package there is no
    crossover to a library attention below some kv length: every attention
    of the models goes through this function. Its gradient, as JAX's
    `_qknorm_bwd` takes it, recomputes through the plain version
    (`_QKNormAttention`).
  * `_flash_kernel` by `csrc/flash_attention.cu`, behind
    `attend(impl="flash")`; `attend_plain` is its plain version
    (`xla_attention` in f32). No model path calls it, as in JAX; its
    gradient recomputes through the plain version.

The bf16 paths of both share one Hopper flash-attention core,
`csrc/attention_core.cuh`. Each wrapper launches its kernel for CUDA tensors
and runs the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from muse_maskgit_pytorch_tpu_torch.ops import _build

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("qknorm_attention")
    fn = lib.muse_qknorm_attn_launch
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 4 + [ll] * 6 + [f, i, p]
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


def _qknorm_launch(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale: float) -> torch.Tensor:
    """Launch K2 on CUDA tensors (checked by `qknorm_attend`)."""
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
    lib = _lib()
    err = lib.muse_qknorm_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        qs.data_ptr(), ks.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), b, n, m, h,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), 1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib.muse_qknorm_attn_error_string, err, "qknorm_attend")
    qknorm_attend.launches += 1
    return out


class _QKNormAttention(torch.autograd.Function):
    """K2 forward (the plain version for CPU tensors); the backward
    recomputes through the plain version and takes its vjp, as JAX's
    `_qknorm_bwd` takes the vjp of `_qknorm_xla`. The key bias gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, null_k, null_v, q_scale, k_scale, bias, scale):
        ctx.save_for_backward(q, k, v, null_k, null_v, q_scale, k_scale, bias)
        ctx.scale = scale
        if q.device.type == "cpu":
            return _qknorm_plain(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale)
        return _qknorm_launch(q, k, v, null_k, null_v, q_scale, k_scale, bias, scale)

    @staticmethod
    def backward(ctx, g):
        *inputs, bias = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in inputs]
            out = _qknorm_plain(*inputs, bias, ctx.scale)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)


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
    `_QKNormAttention` (K2 forward, backward through the plain version);
    else K2 runs alone and nothing is saved."""
    inputs = (q, k, v, null_k, null_v, q_scale, k_scale)
    b, n, h, d = q.shape
    m = k.shape[1]
    wants_grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    if q.device.type == "cpu":
        if wants_grad:
            return _QKNormAttention.apply(*inputs, key_mask_bias(mask, b, m, q.device), float(scale))
        return qknorm_attend_plain(*inputs, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"qknorm_attend: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qknorm_attend takes f32 or bf16, got {q.dtype}")
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {KERNEL_HEAD_DIM}, got {d}")
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    for t in inputs[1:]:
        if t.device != q.device:
            raise ValueError("qknorm_attend: all inputs must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    bias = key_mask_bias(mask, b, m, q.device)
    if wants_grad:
        return _QKNormAttention.apply(*inputs, bias, float(scale))
    return _qknorm_launch(*inputs, bias, scale)


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
