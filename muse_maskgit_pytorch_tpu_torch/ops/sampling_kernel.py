"""K1: fused top-k / gumbel sampler for the MaskGit decode loop.

Counterpart of `muse_maskgit_pytorch_tpu/ops/sampling_kernel.py`, whose
Pallas kernel `_sample_kernel` this replaces on Hopper with the CUDA kernel
in `csrc/sampling_kernel.cu` (see there for what bounds it on the H100 and
how its design answers that). Per row of (rows, V) logits: optional CFG
combine, a top-k threshold by 10 rounds of value bisection, the logsumexp of
the unfiltered row, gumbel noise (injected, or Philox4x32-10 keyed on
(seed, row)), the first-index argmax of `l / max(temp, 1e-10) + g` over
`l >= threshold`, and the softmax probability of the chosen id.

`fused_topk_gumbel_sample` launches the kernel for CUDA tensors and runs
`fused_topk_gumbel_sample_plain` (the same function in plain PyTorch, with
the same arguments) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from muse_maskgit_pytorch_tpu_torch.ops import _build

NEG_INF = -1e30
# 10 rounds pin the top-k threshold to a rank slack of V / 2^10 (64 of
# k = 6554 at V = 65536); the count is part of the sampling contract, so the
# port keeps the JAX package's value for token parity
BISECT_ITERS = 10

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a * b for a u32 constant and an int64
    tensor holding u32 values, without overflowing int64."""
    t = a * (b & 0xFFFF)  # < 2^48
    u = a * (b >> 16)  # < 2^48
    low = ((u & 0xFFFF) << 16) + t
    return ((u >> 16) + (low >> 32)) & _U32, low & _U32


def philox4x32_10(x0, x1, x2, x3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding u32
    counter words and keys; returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, x0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _U32
        k1 = (k1 + _PHILOX_W1) & _U32
    return x0, x1, x2, x3


def philox_gumbel(seed: int, rows: int, V: int, device=None) -> torch.Tensor:
    """(rows, V) f32 gumbel noise from the kernel's Philox4x32-10 stream:
    key (seed, row), counter (column // 4, 0, 0, 0), output word column % 4,
    top 23 bits -> u = bits * 2^-23 + 2^-24 (strictly below 1, unlike the
    TPU kernel's 24-bit form, which rounds to 1.0 and gives g = +inf),
    g = -log(-log(u))."""
    groups = (V + 3) // 4
    x0 = torch.arange(groups, device=device, dtype=torch.int64).expand(rows, groups)
    zero = torch.zeros_like(x0)
    k1 = torch.arange(rows, device=device, dtype=torch.int64)[:, None]
    words = philox4x32_10(x0, zero, zero, zero, int(seed) & _U32, k1)
    bits = torch.stack(words, dim=-1).reshape(rows, groups * 4)[:, :V]
    u = (bits >> 9).to(torch.float32) * (1.0 / (1 << 23)) + (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def topk_threshold_plain(l: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, 1) top-k threshold of f32 rows by value bisection that keeps
    count(l >= lo) >= k; the kernel's exact f32 operations."""
    lo = l.amin(dim=-1, keepdim=True)
    hi = l.amax(dim=-1, keepdim=True)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = (l >= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return lo


def fused_topk_gumbel_sample_plain(
    logits: torch.Tensor,
    k: int,
    temperature: float,
    seed: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    cfg_pair: bool = False,
    cond_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same f32 operations in the
    same order (so the threshold is bit-identical), with the same noise."""
    l = logits.float()
    if cfg_pair:
        rows = l.shape[0] // 2
        cond, null = l[:rows], l[rows:]
        l = null + (cond - null) * cond_scale
    rows, V = l.shape
    thresh = topk_threshold_plain(l, k)
    row_max = l.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(l - row_max).sum(dim=-1, keepdim=True)) + row_max
    if noise is not None:
        g = noise[:rows].float()
    else:
        g = philox_gumbel(int(seed.reshape(-1)[0]), rows, V, device=l.device)
    # a (rows, 1) tensor, not a python scalar: CUDA would turn division by a
    # host scalar into a multiply by its reciprocal, which rounds differently
    temp = torch.full((rows, 1), max(float(temperature), 1e-10), device=l.device)
    z = torch.where(l >= thresh, l / temp + g, NEG_INF)
    idx = torch.argmax(z, dim=-1)
    chosen = l.gather(1, idx[:, None])
    prob = torch.exp(chosen - lse)[:, 0]
    return idx.to(torch.int32), prob


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    # -fmad=false: the CFG combine must round its multiply before the add,
    # as the plain version and the JAX kernel do
    lib = _build.load("sampling_kernel", extra_flags=["-fmad=false"])
    fn = lib.muse_sample_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, f, f, i, i, p]
        fn.restype = ctypes.c_int
        lib.muse_sample_error_string.argtypes = [ctypes.c_int]
        lib.muse_sample_error_string.restype = ctypes.c_char_p
    return lib


def fused_topk_gumbel_sample(
    logits: torch.Tensor,
    k: int,
    temperature: float,
    seed: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    cfg_pair: bool = False,
    cond_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample one id per row.

    logits: (rows, V) f32 or bf16, or (2 * rows, V) with `cfg_pair` (cond
    rows then null rows, combined as `null + (cond - null) * cond_scale`).
    temperature: host float. seed: int32 tensor of one element on the
    logits' device (the kernel reads it there, so the host never waits).
    noise: optional (rows, V) gumbel noise that replaces the Philox stream.
    Returns (idx int32 (rows,), prob f32 (rows,))."""
    if logits.device.type == "cpu":
        return fused_topk_gumbel_sample_plain(
            logits, k, temperature, seed, noise, cfg_pair, cond_scale
        )
    if logits.device.type != "cuda":
        raise ValueError(f"fused_topk_gumbel_sample: unsupported device {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be f32 or bf16, got {logits.dtype}")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (rows, V), got {tuple(logits.shape)}")
    logits = logits.contiguous()
    rows, V = logits.shape
    if cfg_pair:
        if rows % 2:
            raise ValueError("cfg_pair needs an even number of logits rows")
        rows //= 2
    if not 1 <= k <= V:
        raise ValueError(f"k={k} outside [1, {V}]")
    if seed.device != logits.device or seed.dtype != torch.int32 or seed.numel() < 1:
        raise ValueError("seed must be an int32 tensor on the logits' device")
    if noise is not None:
        if noise.device != logits.device or noise.shape[-1] != V or noise.shape[0] < rows:
            raise ValueError(f"noise {tuple(noise.shape)} does not cover ({rows}, {V})")
        noise = noise[:rows].to(torch.float32).contiguous()
    seed = seed.reshape(-1)[:1].contiguous()
    idx = torch.empty(rows, dtype=torch.int32, device=logits.device)
    prob = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lib = _lib()
    err = lib.muse_sample_launch(
        logits.data_ptr(),
        noise.data_ptr() if noise is not None else None,
        seed.data_ptr(),
        idx.data_ptr(),
        prob.data_ptr(),
        rows,
        V,
        int(k),
        float(temperature),
        float(cond_scale),
        1 if logits.dtype == torch.bfloat16 else 0,
        1 if cfg_pair else 0,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(lib.muse_sample_error_string, err, "fused_topk_gumbel_sample")
    fused_topk_gumbel_sample.launches += 1
    return idx, prob


fused_topk_gumbel_sample.launches = 0
