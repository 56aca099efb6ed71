"""VGG16 perceptual feature extractor, configuration D (counterpart of
`muse_maskgit_pytorch_tpu/models/vgg.py`).

The torchvision tower the reference uses with its classifier cut by its
last two modules: the output is the post-ReLU 4096-d fc2 feature of raw
[0, 1] images (no ImageNet normalisation). Images are NHWC as in the JAX
package; the convolutions run NCHW inside. The flatten between the features
and fc1 is the CHW order of torchvision, which the JAX module follows too.
Without weight files the tower is random-init, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d, Linear
from muse_maskgit_pytorch_tpu_torch.utils.helpers import resolve_device

# configuration "D": conv widths, "M" a 2x2 max pool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(nn.Module):
    """`dtype` is the compute dtype (weights stay f32); None computes in
    the input's promoted type, f32 for f32 images."""

    def __init__(self, *, dtype: Optional[torch.dtype] = None, generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        convs, cin = [], 3
        for v in VGG16_CFG:
            if v != "M":
                convs.append(Conv2d(cin, v, 3, padding=1, dtype=dtype, generator=generator))
                cin = v
        self.convs = nn.ModuleList(convs)
        fc_dtype = dtype or torch.float32
        self.fc1 = Linear(512 * 7 * 7, 4096, bias=True, dtype=fc_dtype, generator=generator)
        self.fc2 = Linear(4096, 4096, bias=True, dtype=fc_dtype, generator=generator)
        self.to(device)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> NCHW; a pool is skipped once the map is below 2x2, as
        the JAX module skips it (a tiny image would leave an empty map)."""
        convs = iter(self.convs)
        for v in VGG16_CFG:
            if v != "M":
                x = F.relu(next(convs)(x))
            elif x.shape[2] >= 2 and x.shape[3] >= 2:
                x = F.max_pool2d(x, 2)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (b, h, w, 3) in [0, 1] -> (b, 4096) post-ReLU fc2 features."""
        x = self.features(x.permute(0, 3, 1, 2))
        x = F.adaptive_avg_pool2d(x, 7).reshape(x.shape[0], -1)  # NCHW: the CHW flatten
        x = F.relu(self.fc1(x))
        return F.relu(self.fc2(x))
