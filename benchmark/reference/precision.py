"""The reference's matrix products in a stated precision.

"f32": IEEE float32 (TF32 off), what the configurations state for the
reference. The controls, one step below what a configuration states:
"tf32" for its float32 parts (T5, the VAE), "fp8" for its bfloat16 parts
(the transformers): both operands rounded to float8 e4m3 under a
per-tensor scale, the product summed in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to e4m3 under a per-tensor scale; the gradient passes
    straight through, so a backward multiplies by the rounded operands."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t.detach())


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS's and cuDNN's TF32 as asked, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(x: torch.Tensor, weight: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    if mode == "fp8":
        return F.linear(_fp8(x), _fp8(weight))
    with tf32(mode == "tf32"):
        return F.linear(x, weight)


def conv(x, weight, bias, stride, padding, transposed: bool = False, mode: str = "f32"):
    with tf32(mode == "tf32"):
        if transposed:
            return F.conv_transpose2d(x, weight, bias, stride=stride, padding=padding)
        return F.conv2d(x, weight, bias, stride=stride, padding=padding)
