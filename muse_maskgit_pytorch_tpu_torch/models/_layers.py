"""Parameter layers with the JAX package's initialisers and dtype rules.

Random init follows flax's defaults so a randomly initialised port has the
activation and logit scales the JAX model has: lecun-normal (truncated
normal, std sqrt(1/fan_in) / 0.8796...) for Linear and Conv kernels, normal
with std 1/sqrt(features) for embeddings, zeros for biases. `Linear`,
`Conv2d` and `ConvTranspose2d` keep their weights in f32 and, like flax's
layers with `dtype=...`, cast the input, weight and bias to their compute
dtype on each call; a convolution without one computes in the promoted type
of its input and weight (flax's `dtype=None`: f32 for f32 weights).

An f32 convolution on the card runs in IEEE f32, as JAX's f32 convolutions
do, whatever `torch.backends.cudnn.allow_tf32` says (PyTorch's default lets
cuDNN use TF32, 10-bit mantissas): `conv_ieee` turns TF32 off around the
forward and, through hooks on PyTorch's own autograd nodes, around its
backward and the backward's own backward (a discriminator's R1 penalty
differentiates a convolution's gradient).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2], as in jax.nn.initializers
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Linear(nn.Linear):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        bias: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        lecun_normal_(self.weight, in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def reset_parameters(self) -> None:
        """Initialised in __init__ with the JAX initialiser instead."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Embedding(nn.Embedding):
    def __init__(self, num: int, dim: int, *, generator: Optional[torch.Generator] = None):
        super().__init__(num, dim)
        with torch.no_grad():
            self.weight.normal_(0.0, dim ** -0.5, generator=generator)

    def reset_parameters(self) -> None:
        """Initialised in __init__ with the JAX initialiser instead."""


def _compute_dtype(layer, x: torch.Tensor) -> torch.dtype:
    return layer.compute_dtype or torch.promote_types(x.dtype, layer.weight.dtype)


_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved: Optional[bool] = None


def _ieee_enter(*_):
    """cuDNN's TF32 off while any thread is between an enter and its exit
    (the flag is global to the process; the last exit restores the caller's
    setting)."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = torch.backends.cudnn.allow_tf32
            if _tf32_saved:
                torch.backends.cudnn.allow_tf32 = False
        _tf32_users += 1


def _ieee_exit():
    global _tf32_users
    with _tf32_lock:
        _tf32_users -= 1
        if _tf32_users == 0 and _tf32_saved:
            torch.backends.cudnn.allow_tf32 = True


@contextlib.contextmanager
def _cudnn_ieee():
    _ieee_enter()
    try:
        yield
    finally:
        _ieee_exit()


def _hold_ieee(node) -> None:
    """Run autograd node `node` (a convolution's backward) with cuDNN's TF32
    off. The node stays PyTorch's own, so the engine still asks it for only
    the gradients this backward needs. Under `create_graph` its gradients'
    nodes (the convolution's double backward) are held the same way when it
    has run."""

    def after(grad_inputs, _):
        _ieee_exit()
        for nxt in {t.grad_fn for t in grad_inputs if t is not None and t.grad_fn is not None}:
            if nxt.name().startswith("ConvolutionBackward"):
                _hold_ieee(nxt)

    node.register_prehook(_ieee_enter)
    node.register_hook(after)


def conv_ieee(x, w, b, stride, padding, transposed: bool = False, output_padding=(0, 0)) -> torch.Tensor:
    """A 2-D convolution (transposed: its transpose), dilation 1, one group.
    f32 on the card: in IEEE f32, its forward here and its backward through
    `_hold_ieee`; else PyTorch's op alone, which has no TF32 to avoid."""
    args = (x, w, b, list(stride), list(padding), [1, 1], transposed, list(output_padding), 1)
    if not (x.dtype == torch.float32 and x.is_cuda):
        return torch.ops.aten.convolution(*args)
    with _cudnn_ieee():
        y = torch.ops.aten.convolution(*args)
    if y.grad_fn is not None:
        _hold_ieee(y.grad_fn)
    return y


class Conv2d(nn.Conv2d):
    """NCHW convolution with flax's lecun-normal kernel and zero bias.

    `kernel` is an int or (kh, kw); `padding` is symmetric along each axis:
    flax's `padding=p` or `((p, p), (p, p))` (or (ph, pw) for
    `((ph, ph), (pw, pw))`), at any stride (for a 4x4 kernel at stride 2
    and p 1 both give floor(h / 2)). `bias=False` is flax's
    `use_bias=False`."""

    def __init__(
        self, cin: int, cout: int, kernel, padding=0, stride=1, *, bias: bool = True,
        dtype: Optional[torch.dtype] = None, generator=None,
    ):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype
        kh, kw = self.kernel_size
        lecun_normal_(self.weight, cin * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def reset_parameters(self) -> None:
        """Initialised in __init__ with the JAX initialiser instead."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self, x)
        b = self.bias.to(dt) if self.bias is not None else None
        return conv_ieee(x.to(dt), self.weight.to(dt), b, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Stride-2, 4x4 transposed convolution equal to flax's
    `ConvTranspose(padding="SAME", transpose_kernel=False)`: for kernel 4 and
    stride 2, lax pads the dilated input by (2, 2), which is PyTorch's
    symmetric `padding=1` (output 2x the input at even and odd sizes); the
    flax kernel (kh, kw, in, out) is this module's weight (in, out, kh, kw)
    flipped in space (the weight bridge does the flip)."""

    def __init__(self, cin: int, cout: int, *, dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__(cin, cout, 4, stride=2, padding=1)
        self.compute_dtype = dtype
        lecun_normal_(self.weight, cin * 16, generator)
        nn.init.zeros_(self.bias)

    def reset_parameters(self) -> None:
        """Initialised in __init__ with the JAX initialiser instead."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self, x)
        return conv_ieee(
            x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding, True, self.output_padding
        )
