"""Plain reference of the VQ-GAN decoder from token ids (f32, TF32 off):
lookup-free codes (the id's bits, most significant first, as +-1), the
projection to the latent width, a GLU res block (two 3x3 convolutions to
twice the width, GLU and GroupNorm(16, eps 1e-6) after each, a 1x1
convolution, residual), transposed 4x4 stride-2 convolutions up with
leaky ReLU (0.1), and a 1x1 convolution to pixels; NHWC out, then the
served quantisation `uint8(clamp(x, 0, 1) * 255 + 0.5)`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import conv, linear

P = "enc_dec."


def codes(w: dict, ids: torch.Tensor, codebook_size: int, mode: str) -> torch.Tensor:
    bits = int(math.log2(codebook_size))
    shifts = torch.arange(bits - 1, -1, -1, device=ids.device)
    c = ((ids[..., None].long() >> shifts) & 1).float() * 2.0 - 1.0
    return linear(c, w["quantizer.project_out.weight"], mode)


def decode_ids(w: dict, ids: torch.Tensor, codebook_size: int, mode: str = "f32") -> torch.Tensor:
    """ids (B, fh, fw) -> f32 pixels (B, H, W, 3)."""
    x = codes(w, ids, codebook_size, mode).permute(0, 3, 1, 2)
    i = 0
    while f"{P}decoder_trunk.{i}.conv1.weight" in w or f"{P}decoder_trunk.{i}.conv.weight" in w:
        p = f"{P}decoder_trunk.{i}."
        if p + "conv1.weight" in w:
            h = F.glu(conv(x, w[p + "conv1.weight"], w[p + "conv1.bias"], 1, 1, mode=mode), dim=1)
            h = F.group_norm(h, 16, w[p + "norm1.weight"], w[p + "norm1.bias"], 1e-6)
            h = F.glu(conv(h, w[p + "conv2.weight"], w[p + "conv2.bias"], 1, 1, mode=mode), dim=1)
            h = F.group_norm(h, 16, w[p + "norm2.weight"], w[p + "norm2.bias"], 1e-6)
            x = conv(h, w[p + "conv3.weight"], w[p + "conv3.bias"], 1, 0, mode=mode) + x
        else:
            x = F.leaky_relu(conv(x, w[p + "conv.weight"], w[p + "conv.bias"], 2, 1, transposed=True, mode=mode), 0.1)
        i += 1
    x = conv(x, w[P + "final_conv.weight"], w[P + "final_conv.bias"], 1, 0, mode=mode)
    return x.permute(0, 2, 3, 1)


def to_uint8(pixels: torch.Tensor) -> torch.Tensor:
    return (pixels.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
