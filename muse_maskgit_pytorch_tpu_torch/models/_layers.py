"""Parameter layers with the JAX package's initialisers and dtype rules.

Random init follows flax's defaults so a randomly initialised port has the
activation and logit scales the JAX model has: lecun-normal (truncated
normal, std sqrt(1/fan_in) / 0.8796...) for Linear and Conv kernels, normal
with std 1/sqrt(features) for embeddings, zeros for biases. `Linear` keeps
its weight in f32 and, like `nnx.Linear(dtype=...)`, casts both the input
and the weight to its compute dtype.
"""

from __future__ import annotations

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


class Conv2d(nn.Conv2d):
    """NCHW convolution with flax's lecun-normal kernel and zero bias."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int = 0, *, generator=None):
        super().__init__(cin, cout, kernel, padding=padding)
        lecun_normal_(self.weight, cin * kernel * kernel, generator)
        nn.init.zeros_(self.bias)

    def reset_parameters(self) -> None:
        """Initialised in __init__ with the JAX initialiser instead."""


class ConvTranspose2d(nn.ConvTranspose2d):
    """Stride-2, 4x4 transposed convolution equal to flax's
    `ConvTranspose(padding="SAME", transpose_kernel=False)`: for kernel 4 and
    stride 2, lax pads the dilated input by (2, 2), which is PyTorch's
    symmetric `padding=1` (output 2x the input at even and odd sizes); the
    flax kernel (kh, kw, in, out) is this module's weight (in, out, kh, kw)
    flipped in space (the weight bridge does the flip)."""

    def __init__(self, cin: int, cout: int, *, generator=None):
        super().__init__(cin, cout, 4, stride=2, padding=1)
        lecun_normal_(self.weight, cin * 16, generator)
        nn.init.zeros_(self.bias)

    def reset_parameters(self) -> None:
        """Initialised in __init__ with the JAX initialiser instead."""
