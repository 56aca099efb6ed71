"""Names by which the per-layer metrics find their work in a trace.

Matrix products and convolutions are found by the PyTorch operator above
the launch (`Trace.kernels` carries the chain of operators); where the
profiler linked no operator, by the kernel's own name. The port's kernels
are launched through `ctypes`, under no operator, and are found by name:
K1 is `sample_kernel`, K2's forward `flash_core_kernel<64, true>` (bf16;
K4 is the `false` instance) or `qknorm_fwd_f32`, K2's backward
`qknorm_bwd_*`.
"""

import re

MATMUL_OPS = frozenset({"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul", "aten::linear"})
CONV_OPS = frozenset({
    "aten::convolution", "aten::_convolution", "aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
    "aten::convolution_backward",
})
K1 = re.compile(r"\bsample_kernel\b")
K2_FWD = re.compile(r"flash_core_kernel<\s*64,\s*true\s*>|qknorm_fwd_f32")
K2_BWD = re.compile(r"qknorm_bwd_")
# by name, where no operator was linked
_CONV_NAMES = re.compile(r"conv|fprop|dgrad|wgrad|cudnn", re.I)
_GEMM_NAMES = re.compile(r"gemm|nvjet|cutlass|s16816|s1688|xmma", re.I)


def ours(name: str) -> bool:
    return bool(K1.search(name) or K2_FWD.search(name) or K2_BWD.search(name))


def is_conv(name: str, chain) -> bool:
    if ours(name):
        return False
    if chain:
        return any(op in CONV_OPS for op in chain)
    return bool(_CONV_NAMES.search(name))


def is_matmul(name: str, chain) -> bool:
    if ours(name) or is_conv(name, chain):
        return False
    if chain:
        return any(op in MATMUL_OPS for op in chain)
    return bool(_GEMM_NAMES.search(name))


def is_glue(name: str, chain) -> bool:
    return not (ours(name) or is_conv(name, chain) or is_matmul(name, chain))
