"""K2: fused qk-norm attention with a learned null key/value per head.

Counterpart of `muse_maskgit_pytorch_tpu/ops/attention.py`. Its Pallas kernel
`_qknorm_kernel` is replaced on Hopper by the CUDA kernel in
`csrc/qknorm_attention.cu` (see there for what bounds it on the H100 and
how its design answers that); `qknorm_attend_plain` is the same function in
plain PyTorch (the math of the JAX package's `_qknorm_xla`).

`qknorm_attend` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; the two take the same arguments. Unlike the JAX
package there is no crossover to a library attention below some kv length:
every attention of the models goes through this function. Forward only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from muse_maskgit_pytorch_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64


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


def _mask_bias(mask: Optional[torch.Tensor], b: int, m: int, device) -> Optional[torch.Tensor]:
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
) -> torch.Tensor:
    """Plain PyTorch version of `qknorm_attend` (same arguments): f32
    l2-norms (eps 1e-12), learned scales, the null position first in the
    softmax, additive key bias 0 / -1e30 from the mask. Computes in f32
    (f64 for f64 inputs)."""
    b, m = k.shape[:2]
    acc = torch.promote_types(q.dtype, torch.float32)
    bias = _mask_bias(mask, b, m, q.device)

    def norm(t):
        t = t.to(acc)
        return t * torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + 1e-12)

    qn = norm(q) * (q_scale.to(acc) * scale)
    kn = norm(k) * k_scale.to(acc)
    nkn = norm(null_k) * k_scale.to(acc)  # (h, d)
    sim = torch.einsum("bnhd,bmhd->bhnm", qn, kn)
    if bias is not None:
        sim = sim + bias[:, None, None, :]
    s0 = torch.einsum("bnhd,hd->bhn", qn, nkn)[..., None]  # null position
    attn = torch.cat([s0, sim], dim=-1).softmax(dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn[..., 1:], v.to(acc))
    out = out + attn[..., :1].transpose(1, 2) * null_v.to(acc)[None, None]
    return out.to(q.dtype)


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


def _heads_contiguous(t: torch.Tensor) -> torch.Tensor:
    """The kernels walk batch and sequence by stride; (h, d) must be dense,
    and the bf16 kernel reads element pairs, so pairs must be 4-byte aligned."""
    d = t.shape[-1]
    dense = t.stride(-1) == 1 and t.stride(-2) == d
    aligned = t.data_ptr() % 4 == 0 and t.stride(0) % 2 == 0 and t.stride(1) % 2 == 0
    if not (dense and aligned):
        t = t.contiguous()
    return t


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
    always attendable). Returns (b, n, h, d) in q's dtype."""
    if q.device.type == "cpu":
        return qknorm_attend_plain(q, k, v, null_k, null_v, q_scale, k_scale, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"qknorm_attend: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qknorm_attend takes f32 or bf16, got {q.dtype}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {KERNEL_HEAD_DIM}, got {d}")
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    for t in (k, v, null_k, null_v, q_scale, k_scale):
        if t.device != q.device:
            raise ValueError("qknorm_attend: all inputs must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    bias = _mask_bias(mask, b, m, q.device)
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


qknorm_attend.launches = 0
