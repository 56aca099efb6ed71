"""K1: fused top-k / gumbel sampler for the MaskGit decode loop.

Counterpart of `muse_maskgit_pytorch_tpu/ops/sampling_kernel.py`, whose
Pallas kernel `_sample_kernel` this replaces on Hopper with the CUDA kernel
in `csrc/sampling_kernel.cu`. Per row of (rows, V) logits: optional CFG
combine, the top-k threshold of 10 rounds of value bisection, the logsumexp
of the unfiltered row, gumbel noise (injected, or Philox4x32-10 keyed on
(seed, row_offset + row)), the first-index argmax of `l / max(temp, 1e-10) + g` over
`l >= threshold`, and the softmax probability of the chosen id.

By bytes the kernel needs 0.32 ms for the main path's step 0 (1.07 GB of
bf16 logits at 3.35 TB/s); it takes about 1.1 ms there (NVIDIA H100 80GB
HBM3, 700 W), bound by the instructions an SM spends on a row, not by HBM.
It makes three passes over a row instead of one per bisection round: the
ten rounds only compare against the 1023 node values of a tree that the
row's (min, max) fix, so one pass counts every logit into a 1024-bin
histogram over those values and the rounds become look-ups in its suffix
sum (`topk_threshold_histogram_plain` is that algorithm in plain PyTorch,
equal bit for bit to the bisection `topk_threshold_plain`). One persistent
block on each SM walks the rows; a bf16 row streams from HBM by 1-D bulk
copies into a ring of 16 KB chunks in shared memory while the row before it
draws its noise, which only the columns at or above the threshold need.
See the header of `csrc/sampling_kernel.cu`; `sample_part_clocks` reports
where a row's clocks go.

`fused_topk_gumbel_sample` launches the kernel for CUDA tensors and runs
`fused_topk_gumbel_sample_plain` (the same function in plain PyTorch, with
the same arguments) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

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


def philox_gumbel(seed: int, rows: int, V: int, device=None, row_offset: int = 0) -> torch.Tensor:
    """(rows, V) f32 gumbel noise from the kernel's Philox4x32-10 stream:
    key (seed, row_offset + row), counter (column // 4, 0, 0, 0), output word column % 4,
    top 23 bits -> u = bits * 2^-23 + 2^-24 (strictly below 1, unlike the
    TPU kernel's 24-bit form, which rounds to 1.0 and gives g = +inf),
    g = -log(-log(u))."""
    groups = (V + 3) // 4
    x0 = torch.arange(groups, device=device, dtype=torch.int64).expand(rows, groups)
    zero = torch.zeros_like(x0)
    k1 = torch.arange(row_offset, row_offset + rows, device=device, dtype=torch.int64)[:, None] & _U32
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


def topk_threshold_histogram_plain(l: torch.Tensor, k: int) -> torch.Tensor:
    """`topk_threshold_plain` in the form the kernel computes it: one
    counting pass in place of one per round, the same (rows, 1) result bit
    for bit.

    The bisection only compares against the mids of a depth-10 tree that
    (min, max) fix. Level by level (the bisection's f32 operations), the
    tree's 1024 leaf intervals have lower ends E[0..1023], sorted, with the
    mid of node j at depth d at E[(2 j + 1) << (9 - d)]. Each logit is
    counted into the bin g with E[g] <= x < E[g + 1]; the suffix sum S[m]
    of the bins is count(l >= E[m]), and the ten rounds are ten look-ups."""
    rows = l.shape[0]
    lo = l.amin(dim=-1, keepdim=True)  # (rows, 2^d) interval ends at depth d
    hi = l.amax(dim=-1, keepdim=True)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        lo, hi = torch.stack([lo, mid], dim=-1), torch.stack([mid, hi], dim=-1)
        lo, hi = lo.reshape(rows, -1), hi.reshape(rows, -1)
    E = lo.contiguous()  # (rows, 1024)
    bins = 1 << BISECT_ITERS
    # the largest g with E[g] <= x (E[0] is the row minimum, so g >= 0)
    g = torch.searchsorted(E, l.contiguous(), right=True) - 1
    hist = torch.zeros(rows, bins, dtype=torch.int64, device=l.device)
    hist.scatter_add_(1, g, torch.ones_like(g))
    S = hist.flip(-1).cumsum(-1).flip(-1)
    leaf = torch.zeros(rows, 1, dtype=torch.int64, device=l.device)
    for d in range(BISECT_ITERS):
        m = (2 * leaf + 1) << (BISECT_ITERS - 1 - d)
        leaf = 2 * leaf + (S.gather(1, m) >= k).long()
    return E.gather(1, leaf)


def fused_topk_gumbel_sample_plain(
    logits: torch.Tensor,
    k: int,
    temperature: float,
    seed: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    cfg_pair: bool = False,
    cond_scale: Union[float, torch.Tensor] = 1.0,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same f32 operations in the
    same order (so the threshold is bit-identical), with the same noise.
    `cond_scale` is a host float or a one-element f32 tensor, as for the
    kernel."""
    l = logits.float()
    if cfg_pair:
        rows = l.shape[0] // 2
        cond, null = l[:rows], l[rows:]
        if isinstance(cond_scale, torch.Tensor):
            cond_scale = cond_scale.reshape(1, 1).float()
        l = null + (cond - null) * cond_scale
    rows, V = l.shape
    thresh = topk_threshold_plain(l, k)
    row_max = l.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(l - row_max).sum(dim=-1, keepdim=True)) + row_max
    if noise is not None:
        g = noise[:rows].float()
    else:
        g = philox_gumbel(int(seed.reshape(-1)[0]), rows, V, device=l.device, row_offset=row_offset)
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


# -fmad=false: the CFG combine must round its multiply before the add, as the
# plain version and the JAX kernel do
FLAGS = ["-fmad=false"]
# the diagnostic build that also reports the clocks of each part of a row
TIMING_FLAGS = [*FLAGS, "-DSAMPLER_TIMING"]
PARTS = (
    "await copies",
    "min/max",
    "tree",
    "pass B",
    "threshold",
    "pass C marks",
    "pass C list",
    "pass C scores",
    "row end",
)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.muse_sample_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, f, p, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.muse_sample_error_string.argtypes = [ctypes.c_int]
        lib.muse_sample_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(_build.load("sampling_kernel", extra_flags=FLAGS))


_timing_lib: Optional[ctypes.CDLL] = None


def sample_part_clocks(logits: torch.Tensor, k: int, temperature: float, seed: torch.Tensor) -> dict:
    """Diagnostic: where the kernel's time on a row goes. Runs the
    `-DSAMPLER_TIMING` build of the kernel on (rows, V) CUDA logits (Philox
    noise, no cfg_pair) and returns SM clocks per row for each of `PARTS`, as
    the first thread of block 0 saw them, averaged over that block's rows.
    The instrumented build is a few percent slower than the kernel; it is
    not counted as a launch and nothing on a model's path calls it."""
    global _timing_lib
    if logits.device.type != "cuda" or logits.dim() != 2:
        raise ValueError("sample_part_clocks needs (rows, V) logits on a CUDA device")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be f32 or bf16, got {logits.dtype}")
    if _timing_lib is None:
        _timing_lib = _bind(ctypes.CDLL(str(_build.build("sampling_kernel", TIMING_FLAGS))))
    logits = logits.contiguous()
    rows, V = logits.shape
    idx = torch.empty(rows, dtype=torch.int32, device=logits.device)
    prob = torch.zeros(rows + len(PARTS), dtype=torch.float32, device=logits.device)
    err = _timing_lib.muse_sample_launch(
        logits.data_ptr(),
        None,
        seed.reshape(-1)[:1].contiguous().data_ptr(),
        idx.data_ptr(),
        prob.data_ptr(),
        rows,
        V,
        int(k),
        float(temperature),
        None,
        1 if logits.dtype == torch.bfloat16 else 0,
        0,
        0,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(_timing_lib.muse_sample_error_string, err, "sample_part_clocks")
    blocks = min(rows, torch.cuda.get_device_properties(logits.device).multi_processor_count)
    rows_of_block0 = -(-rows // blocks)
    return {name: c / rows_of_block0 for name, c in zip(PARTS, prob[rows:].tolist())}


def fused_topk_gumbel_sample(
    logits: torch.Tensor,
    k: int,
    temperature: float,
    seed: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    cfg_pair: bool = False,
    cond_scale: Union[float, torch.Tensor] = 1.0,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample one id per row.

    logits: (rows, V) f32 or bf16, or (2 * rows, V) with `cfg_pair` (cond
    rows then null rows, combined as `null + (cond - null) * cond_scale`).
    temperature: host float. seed: int32 tensor of one element on the
    logits' device (the kernel reads it there, so the host never waits).
    cond_scale: a host float, or a one-element f32 tensor on the logits'
    device that the kernel reads there, as it reads the seed (a host float
    is written to such a tensor first); only `cfg_pair` reads it.
    noise: optional (rows, V) gumbel noise that replaces the Philox stream.
    row_offset: the Philox stream's first row (a data-parallel rank that
    samples rows of a global batch passes the global index of its first).
    Returns (idx int32 (rows,), prob f32 (rows,))."""
    if logits.device.type == "cpu":
        return fused_topk_gumbel_sample_plain(
            logits, k, temperature, seed, noise, cfg_pair, cond_scale, row_offset
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
    scale = None
    if cfg_pair:
        if isinstance(cond_scale, torch.Tensor):
            if cond_scale.device != logits.device or cond_scale.dtype != torch.float32 or cond_scale.numel() != 1:
                raise ValueError("cond_scale must be a float or a one-element f32 tensor on the logits' device")
            scale = cond_scale.reshape(1).contiguous()
        else:
            scale = torch.full((1,), float(cond_scale), dtype=torch.float32, device=logits.device)
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
        scale.data_ptr() if scale is not None else None,
        1 if logits.dtype == torch.bfloat16 else 0,
        1 if cfg_pair else 0,
        int(row_offset),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(lib.muse_sample_error_string, err, "fused_topk_gumbel_sample")
    fused_topk_gumbel_sample.launches += 1
    return idx, prob


fused_topk_gumbel_sample.launches = 0
