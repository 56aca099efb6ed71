"""K3: nearest-codebook search, fused distance + argmax.

Counterpart of `muse_maskgit_pytorch_tpu/ops/vq.py`. Its Pallas kernel
`_vq_kernel` is replaced on Hopper by the CUDA kernel in
`csrc/vq_search.cu` (see there for what bounds it on the H100 and how its
design answers that); `nearest_code_plain` is the same function in plain
PyTorch (the math of the JAX package's `nearest_code_xla`).

Score convention: `score = 2 * x @ c.T - cb_sq` with `cb_sq = |c|^2` by
default, so the argmax is the euclidean nearest code; for cosine search pass
l2-normalised x and codebook with `cb_sq = 0`. Ties go to the lowest code
index, as `jnp.argmax` and the Pallas kernel resolve them.

`nearest_code`, the operator `muse_torch::nearest_code`
(`ops/_library.py`), launches the kernel for CUDA tensors and runs the
plain version for CPU tensors. The result is an argmax, so nothing here is
differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from muse_maskgit_pytorch_tpu_torch.ops import _build, _library

KERNEL_MAX_DIM = 256
_ROWS_PER_BLOCK = 128  # csrc/vq_search.cu BM
_CODES_PER_TILE = 128  # csrc/vq_search.cu BN
_PLAIN_CHUNK_ELEMS = 1 << 27  # score-matrix elements per chunk of the plain version (512 MB f32)


def _scores(x: torch.Tensor, codebook: torch.Tensor, cb_sq: torch.Tensor) -> torch.Tensor:
    return 2.0 * (x @ codebook.T) - cb_sq[None, :]


def _row_chunks(n: int, k: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(k, 1))
    return (slice(i, min(i + step, n)) for i in range(0, n, step))


@torch.no_grad()
def nearest_code_plain(
    x: torch.Tensor, codebook: torch.Tensor, cb_sq: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x (n, d), codebook (K, d) -> int32 (n,) argmax-score ids, in f32. The
    (n, K) score matrix is formed a chunk of rows at a time."""
    x, codebook = x.float(), codebook.float()
    cb_sq = (codebook * codebook).sum(dim=-1) if cb_sq is None else cb_sq.float()
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for rows in _row_chunks(x.shape[0], codebook.shape[0]):
        out[rows] = _scores(x[rows], codebook, cb_sq).argmax(dim=-1).int()
    return out


@torch.no_grad()
def score_gap(
    x: torch.Tensor, codebook: torch.Tensor, ids: torch.Tensor, cb_sq: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per row, the f64 score of the row's best code less that of code `ids`
    (>= 0; 0 where `ids` is the exact argmax). f32 searches that sum the
    d-term dot in different orders may pick different codes only where this
    gap is within their rounding error."""
    x, codebook = x.double(), codebook.double()
    cb_sq = (codebook * codebook).sum(dim=-1) if cb_sq is None else cb_sq.double()
    gap = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    for rows in _row_chunks(x.shape[0], codebook.shape[0]):
        s = _scores(x[rows], codebook, cb_sq)
        gap[rows] = s.amax(dim=-1) - s.gather(1, ids[rows].long()[:, None])[:, 0]
    return gap


def _lib() -> ctypes.CDLL:
    lib = _build.load("vq_search")
    fn = lib.muse_vq_search_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        lib.muse_vq_search_error_string.argtypes = [ctypes.c_int]
        lib.muse_vq_search_error_string.restype = ctypes.c_char_p
    return lib


def _k_splits(n: int, k: int, device: torch.device) -> int:
    """Codebook splits per row tile: the kernel runs one block per SM, so
    split the codebook until the row tiles times the splits fill the SMs."""
    row_tiles = -(-n // _ROWS_PER_BLOCK)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-k // _CODES_PER_TILE), sms // row_tiles))


def _nearest_check(x, codebook, cb_sq):
    """K3's contract on the card, checked at every launch: the public
    wrapper and the operator (which a traced program or
    `torch.ops.muse_torch.nearest_code` reaches without the wrapper) both
    pass here."""
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and codebook {tuple(codebook.shape)} must be (n, d), (K, d)")
    d = x.shape[1]
    k = codebook.shape[0]
    if d % 4 or d > KERNEL_MAX_DIM or k == 0:
        raise ValueError(f"the CUDA kernel takes d a multiple of 4 up to {KERNEL_MAX_DIM} and K > 0, got d {d}, K {k}")
    if cb_sq is not None and cb_sq.shape != (k,):
        raise ValueError(f"cb_sq must be ({k},), got {tuple(cb_sq.shape)}")
    if x.device.type != "cuda" or codebook.device != x.device or (cb_sq is not None and cb_sq.device != x.device):
        raise ValueError("nearest_code: K3 takes all its inputs on one CUDA device")


def _nearest_cuda(x, codebook, cb_sq):
    """Launch K3, checked by `_nearest_check`."""
    _nearest_check(x, codebook, cb_sq)
    n, d = x.shape
    k = codebook.shape[0]
    x = x.float().contiguous()
    codebook = codebook.float().contiguous()
    cb_sq = (codebook * codebook).sum(dim=-1) if cb_sq is None else cb_sq.float().contiguous()
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    keys = torch.empty(n, dtype=torch.int64, device=x.device)  # packed (score, ~id) per row
    lib = _lib()
    err = lib.muse_vq_search_launch(
        x.data_ptr(), codebook.data_ptr(), cb_sq.data_ptr(), keys.data_ptr(), out.data_ptr(),
        n, k, d, _k_splits(n, k, x.device), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib.muse_vq_search_error_string, err, "nearest_code")
    nearest_code.launches += 1
    return out


def _nearest_cpu(x, codebook, cb_sq):
    return nearest_code_plain(x, codebook, cb_sq)


def _nearest_fake(x, codebook, cb_sq):
    return x.new_empty(x.shape[0], dtype=torch.int32)


_nearest_op = _library.define(
    "nearest_code(Tensor x, Tensor codebook, Tensor? cb_sq) -> Tensor", _nearest_cpu, _nearest_cuda, _nearest_fake
)


def nearest_code(
    x: torch.Tensor, codebook: torch.Tensor, cb_sq: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Fused distance + argmax. x (n, d), codebook (K, d), optional cb_sq
    (K,) -> int32 (n,) ids. Inputs are read as f32, as the JAX kernel casts
    them; the kernel takes d a multiple of 4, at most 256.

    The call is the operator `muse_torch::nearest_code` (`ops/_library.py`):
    the kernel on CUDA tensors, counted in `nearest_code.launches`, and the
    plain version on CPU tensors."""
    x, codebook = x.detach(), codebook.detach()
    cb_sq = cb_sq.detach() if cb_sq is not None else None
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nearest_code: unsupported device {x.device}")
    return _nearest_op(x, codebook, cb_sq)


nearest_code.launches = 0
