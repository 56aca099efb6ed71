"""InceptionV3 pool3 feature extractor, the standard FID tower (counterpart
of `muse_maskgit_pytorch_tpu/models/inception.py`).

torchvision's `inception_v3` from the stem through `Mixed_7c` and the global
average pool: (b, 2048) "pool3" features, inference only, no aux head and
no fc. The attribute names are torchvision's (`Conv2d_1a_3x3`, ...,
`Mixed_7c`, `branch*`), so `utils.convert.load_torchvision_inception_v3`
walks the module tree against a torchvision state dict; each `BasicConv2d`
holds the JAX module's leaves (`conv` and the four BatchNorm statistics
`bn_scale`, `bn_bias`, `bn_mean`, `bn_var`), so `utils.from_jax` bridges a
JAX `InceptionV3` by path.

BatchNorm runs in inference mode from the stored statistics, written as the
JAX module writes it, `(x - mean) * (rsqrt(var + 1e-3) * scale) + bias`,
and is not folded into the convolution (folding changes the rounding). The
average pools are 3x3, stride 1, padding 1, counting the padding (9 in
every window); the max pools 3x3, stride 2, no padding.

Images are NHWC in [-1, 1] (`utils.eval.make_inception_extractor` resizes
and rescales from [0, 1]); the convolutions run NCHW inside, through
`models._layers.Conv2d`, so f32 stays IEEE f32 on the card. Any spatial
size >= 75 works. Without weight files the tower is random-init, as in the
JAX package: its scores order models but match no published number.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d
from muse_maskgit_pytorch_tpu_torch.utils.helpers import resolve_device

BN_EPS = 1e-3


def _avg_pool_3x3_s1_pad1(x: torch.Tensor) -> torch.Tensor:
    """torch's AvgPool2d(3, stride=1, padding=1), padding counted (the
    torchvision inception default): the zero-padded window's sum / 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, inference) + ReLU, as
    torchvision's `BasicConv2d`. The statistics are parameters, frozen, as
    they are `nnx.Param`s in the JAX module."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0, *, generator=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, padding=padding, stride=stride, bias=False, generator=generator)
        self.bn_scale = nn.Parameter(torch.ones(cout), requires_grad=False)
        self.bn_bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.bn_mean = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.bn_var = nn.Parameter(torch.ones(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        x = self.conv(x)
        inv = torch.rsqrt(self.bn_var + BN_EPS)
        x = (x - self.bn_mean[:, None, None]) * (inv * self.bn_scale)[:, None, None] + self.bn_bias[:, None, None]
        return F.relu(x)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, *, generator=None):
        super().__init__()
        g = dict(generator=generator)
        self.branch1x1 = BasicConv2d(cin, 64, 1, **g)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, **g)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, **g)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, **g)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, **g)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1, **g)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1_pad1(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, *, generator=None):
        super().__init__()
        g = dict(generator=generator)
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2, **g)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, **g)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, **g)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, *, generator=None):
        super().__init__()
        g, c7 = dict(generator=generator), channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1, **g)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1, **g)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), **g)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), **g)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1, **g)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), **g)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), **g)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), **g)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3), **g)
        self.branch_pool = BasicConv2d(cin, 192, 1, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1_pad1(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, *, generator=None):
        super().__init__()
        g = dict(generator=generator)
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, **g)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, **g)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, **g)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), **g)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), **g)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, *, generator=None):
        super().__init__()
        g = dict(generator=generator)
        self.branch1x1 = BasicConv2d(cin, 320, 1, **g)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, **g)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), **g)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), **g)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, **g)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1, **g)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), **g)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), **g)
        self.branch_pool = BasicConv2d(cin, 192, 1, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool_3x3_s1_pad1(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """torchvision's inception_v3, stem through Mixed_7c and the global
    average pool (FID's pool3 features); no aux head, no fc. Input: NHWC in
    [-1, 1]."""

    FEATURE_DIM = 2048

    def __init__(self, *, generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        g = dict(generator=generator)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, **g)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, **g)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, **g)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, **g)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, **g)
        self.Mixed_5b = InceptionA(192, 32, **g)
        self.Mixed_5c = InceptionA(256, 64, **g)
        self.Mixed_5d = InceptionA(288, 64, **g)
        self.Mixed_6a = InceptionB(288, **g)
        self.Mixed_6b = InceptionC(768, 128, **g)
        self.Mixed_6c = InceptionC(768, 160, **g)
        self.Mixed_6d = InceptionC(768, 160, **g)
        self.Mixed_6e = InceptionC(768, 192, **g)
        self.Mixed_7a = InceptionD(768, **g)
        self.Mixed_7b = InceptionE(1280, **g)
        self.Mixed_7c = InceptionE(2048, **g)
        self.eval().requires_grad_(False)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) in [-1, 1] -> (b, 2048) pool3 features."""
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool_3x3_s2(x)
        for block in (
            self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
            self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b, self.Mixed_7c,
        ):
            x = block(x)
        return x.mean(dim=(2, 3))  # global average pool -> (b, 2048)
