"""The token transformer's normalisation: LayerNorm, and GEGLU with the
LayerNorm that follows it, each in one launch.

No TPU kernel stands behind these: the JAX package leaves its LayerNorm and
GEGLU (`muse_maskgit_pytorch_tpu/models/transformer.py`) to XLA, which fuses
them. In PyTorch the same code is a chain of small kernels over f32
intermediates, so on Hopper both functions are the CUDA kernels of
`csrc/trunk_norm.cu` (see there for what bounds them on the H100 and how
the design answers that). `layer_norm_plain` and `geglu_layer_norm_plain`
are the models' composite code itself: gamma-only LayerNorm, f32 statistics,
eps 1e-5, the result in the input's dtype; GEGLU as `gate * gelu(x)` (erf
GELU) in the input's dtype.

`layer_norm` and `geglu_layer_norm` take the composite code where gradients
are on and an input needs one (counted in `.composite`; PyTorch's autograd
gives the backward). Otherwise each is an operator (`ops/_library.py`),
`muse_torch::layer_norm` / `muse_torch::geglu_layer_norm`: the kernel on
CUDA tensors, counted in `.launches`, and the plain version on CPU tensors,
so a traced program launches the kernel where it runs on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from muse_maskgit_pytorch_tpu_torch.ops import _build, _library

EPS = 1e-5
_MAX_SMEM = 232448  # a block's shared memory on sm_90 (`csrc/trunk_norm.cu` MAX_SMEM)
_ROWS_PER_BLOCK = 4  # `csrc/trunk_norm.cu` WARPS: a row of shared memory each

# For the checks only (the tests and chip_smoke.py): the kernel against its
# plain version in bf16 is one bf16 step of the result apart, but where the
# row's statistics show. The two take the row's f32 mean and variance in
# different orders: their means differ by a few f32 roundings of the row's
# mean |v| (v the values normalised), which `(v - mean) * rstd * gamma`
# carries whole into a result near 0, where a bf16 step is small. This
# allows 2^-20 of mean |v| there, some hundreds of times what f32 sums of a
# few thousand terms differ by. In f32 the two differ only by those sums.
STATS_ROUNDING = 2.0**-20
F32_RTOL = F32_ATOL = 1e-5


def bf16_mismatch(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor, gamma: torch.Tensor) -> float:
    """The largest |got - want| over its allowance (at most 1 passes): one
    bf16 step of |want| plus `STATS_ROUNDING` of the row's mean |v| carried
    by its rstd and gamma; v (rows, d) the values normalised (GEGLU's
    `gate * gelu(x)` in bf16), want the plain version's result."""
    v = v.float()
    rstd = torch.rsqrt(v.var(dim=-1, keepdim=True, unbiased=False) + EPS)
    stats = STATS_ROUNDING * v.abs().mean(dim=-1, keepdim=True) * rstd * gamma.float().abs()
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0**-126))) - 7)
    return float(((got.float() - w).abs() / (step + stats)).max())


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Gamma-only LayerNorm over the last dim: f32 mean and biased
    variance, `(x - mean) * rsqrt(var + 1e-5) * gamma`, in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    normed = (x32 - mean) * torch.rsqrt(var + EPS)
    return (normed * gamma).to(x.dtype)


def geglu_layer_norm_plain(h: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """h (..., 2 d) read as `[x | gate]`: `layer_norm_plain(gate * gelu(x),
    gamma)`, the GEGLU product in h's dtype."""
    x, gate = h.chunk(2, dim=-1)
    return layer_norm_plain(gate * F.gelu(x), gamma)


def _lib() -> ctypes.CDLL:
    lib = _build.load("trunk_norm")
    fn = lib.muse_trunk_norm_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.muse_trunk_norm_error_string.argtypes = [ctypes.c_int]
        lib.muse_trunk_norm_error_string.restype = ctypes.c_char_p
    return lib


def _slot(nbytes: int) -> int:
    return (nbytes + 31) // 16 * 16


def _norm_check(x: torch.Tensor, gamma: torch.Tensor, geglu: bool) -> int:
    """The kernel's contract, checked at every launch (the public wrappers
    and the operators, which a traced program reaches without them, both
    pass here); returns the normalised width d."""
    what = "geglu_layer_norm" if geglu else "layer_norm"
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes f32 or bf16, got {x.dtype}")
    if x.dim() == 0 or (geglu and x.shape[-1] % 2):
        raise ValueError(f"{what} takes rows of {'an even width' if geglu else 'any width'}, got {tuple(x.shape)}")
    d = x.shape[-1] // 2 if geglu else x.shape[-1]
    if gamma.shape != (d,):
        raise ValueError(f"{what}: gamma must be ({d},), got {tuple(gamma.shape)}")
    if x.device.type != "cuda" or gamma.device != x.device:
        raise ValueError(f"{what}: the kernel takes its inputs on one CUDA device")
    if d == 0 or _ROWS_PER_BLOCK * _slot(x.shape[-1] * x.element_size()) > _MAX_SMEM:
        raise ValueError(f"{what}: the kernel takes widths whose row fits in shared memory, got d {d} in {x.dtype}")
    if x.numel() // x.shape[-1] >= 2**31:
        raise ValueError(f"{what}: the kernel takes fewer than 2**31 rows")
    return d


def _launch(x: torch.Tensor, gamma: torch.Tensor, geglu: bool) -> torch.Tensor:
    """Launch the kernel on CUDA tensors, checked by `_norm_check`."""
    d = _norm_check(x, gamma, geglu)
    width = x.shape[-1]
    rows = x.reshape(-1, width)  # a view where the leading dims share one stride
    if rows.stride(-1) != 1 or (rows.shape[0] > 1 and rows.stride(0) < width):
        rows = rows.contiguous()
    out = torch.empty(x.shape[:-1] + (d,), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    gamma = gamma.to(torch.float32).contiguous()
    lib = _lib()
    err = lib.muse_trunk_norm_launch(
        rows.data_ptr(), rows.stride(0), gamma.data_ptr(), out.data_ptr(), rows.shape[0], d, int(geglu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib.muse_trunk_norm_error_string, err, "geglu_layer_norm" if geglu else "layer_norm")
    (geglu_layer_norm if geglu else layer_norm).launches += 1
    return out


def _layer_norm_cuda(x, gamma):
    return _launch(x, gamma, geglu=False)


def _layer_norm_fake(x, gamma):
    return x.new_empty(x.shape)


def _geglu_cuda(h, gamma):
    return _launch(h, gamma, geglu=True)


def _geglu_fake(h, gamma):
    return h.new_empty(h.shape[:-1] + (h.shape[-1] // 2,))


_layer_norm_op = _library.define(
    "layer_norm(Tensor x, Tensor gamma) -> Tensor", layer_norm_plain, _layer_norm_cuda, _layer_norm_fake
)
_geglu_op = _library.define(
    "geglu_layer_norm(Tensor h, Tensor gamma) -> Tensor", geglu_layer_norm_plain, _geglu_cuda, _geglu_fake
)


def _records_grad(*inputs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Gamma-only LayerNorm over the last dim of x (f32 statistics, eps
    1e-5), in x's dtype; gamma (d,).

    Under autograd (gradients on and an input needing one) the composite
    code, counted in `layer_norm.composite`; otherwise the operator
    `muse_torch::layer_norm`: the kernel on CUDA tensors, counted in
    `layer_norm.launches`, the plain version on CPU tensors."""
    if _records_grad(x, gamma):
        layer_norm.composite += 1
        return layer_norm_plain(x, gamma)
    return _layer_norm_op(x, gamma)


layer_norm.launches = 0
layer_norm.composite = 0


def geglu_layer_norm(h: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """`layer_norm(gate * gelu(x), gamma)` for h (..., 2 d) read as
    `[x | gate]` (a FeedForward's `proj_in` output), in h's dtype; gamma
    (d,).

    Under autograd the composite code, counted in
    `geglu_layer_norm.composite`; otherwise the operator
    `muse_torch::geglu_layer_norm`: the kernel on CUDA tensors, counted in
    `geglu_layer_norm.launches`, the plain version on CPU tensors."""
    if _records_grad(h, gamma):
        geglu_layer_norm.composite += 1
        return geglu_layer_norm_plain(h, gamma)
    return _geglu_op(h, gamma)


geglu_layer_norm.launches = 0
geglu_layer_norm.composite = 0
