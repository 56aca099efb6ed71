"""VQ-GAN VAE tokenizer, decode side (counterpart of
`muse_maskgit_pytorch_tpu/models/vqgan_vae.py`).

Public layouts are the JAX package's: token grids (b, h', w') and NHWC
images (b, h, w, c). The convolutions run NCHW inside through
`F.conv2d` / `F.conv_transpose2d`, as the JAX package leaves them to XLA
(no Pallas kernel). GroupNorm uses flax's eps 1e-6, LeakyReLU slope 0.1.
The encoder, the discriminator and the GAN losses are not ported yet
(ROADMAP A4, A10).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d, ConvTranspose2d
from muse_maskgit_pytorch_tpu_torch.models.quantizers import LFQ
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, not_ported

GROUPNORM_EPS = 1e-6


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


class GroupNorm(nn.GroupNorm):
    """flax `nnx.GroupNorm` defaults: eps 1e-6, scale and bias."""

    def __init__(self, chan: int, groups: int):
        super().__init__(groups, chan, eps=GROUPNORM_EPS)


class GLUResBlock(nn.Module):
    def __init__(self, chan: int, groups: int = 16, *, generator=None):
        super().__init__()
        self.conv1 = Conv2d(chan, chan * 2, 3, padding=1, generator=generator)
        self.norm1 = GroupNorm(chan, groups)
        self.conv2 = Conv2d(chan, chan * 2, 3, padding=1, generator=generator)
        self.norm2 = GroupNorm(chan, groups)
        self.conv3 = Conv2d(chan, chan, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        h = self.norm1(F.glu(self.conv1(x), dim=1))
        h = self.norm2(F.glu(self.conv2(h), dim=1))
        return self.conv3(h) + x


class _UpConv(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, *, generator=None):
        super().__init__()
        self.conv = ConvTranspose2d(dim_in, dim_out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return leaky_relu(self.conv(x))


class ResnetEncDec(nn.Module):
    """Decoder half of the symmetric conv pyramid: GLUResBlocks and
    transpose-conv ups, built back to front like the JAX module, then a
    1x1 `final_conv` to pixels."""

    def __init__(
        self,
        dim: int,
        *,
        channels: int = 3,
        layers: int = 4,
        layer_mults: Optional[Sequence[int]] = None,
        num_resnet_blocks: Union[int, Tuple[int, ...]] = 1,
        resnet_groups: int = 16,
        first_conv_kernel_size: int = 5,
        generator=None,
    ):
        super().__init__()
        if dim % resnet_groups:
            raise ValueError("dim must be divisible by resnet_groups")
        self.layers = layers
        layer_mults = list(default(layer_mults, [2**t for t in range(layers)]))
        if len(layer_mults) != layers:
            raise ValueError("layer_mults must have one entry per layer")
        dims = (dim, *[dim * mult for mult in layer_mults])
        self.encoded_dim = dims[-1]
        if not isinstance(num_resnet_blocks, (tuple, list)):
            num_resnet_blocks = (*((0,) * (layers - 1)), num_resnet_blocks)
        if len(num_resnet_blocks) != layers:
            raise ValueError("num_resnet_blocks must have one entry per layer")
        # the encoder side (first conv of `first_conv_kernel_size`, strided
        # convs, ResBlocks) waits for ROADMAP A4
        decoders = []
        for (dim_in, dim_out), n_res in zip(zip(dims[:-1], dims[1:]), num_resnet_blocks):
            decoders.insert(0, _UpConv(dim_out, dim_in, generator=generator))
            for _ in range(n_res):
                decoders.insert(0, GLUResBlock(dim_out, groups=resnet_groups, generator=generator))
        self.decoder_trunk = nn.ModuleList(decoders)
        self.final_conv = Conv2d(dim, channels, 1, generator=generator)

    def get_encoded_fmap_size(self, image_size: int) -> int:
        return image_size // (2**self.layers)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> NHWC pixels."""
        x = x.permute(0, 3, 1, 2)
        for dec in self.decoder_trunk:
            x = dec(x)
        return self.final_conv(x).permute(0, 2, 3, 1)


class VQGanVAE(nn.Module):
    def __init__(
        self,
        *,
        dim: int,
        channels: int = 3,
        layers: int = 4,
        lookup_free_quantization: bool = True,
        codebook_size: int = 65536,
        fsq_levels: Optional[tuple] = None,
        lfq_kwargs: Optional[dict] = None,
        use_vgg_and_gan: bool = False,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        super().__init__()
        if use_vgg_and_gan:
            raise not_ported("the VGG and discriminator towers (VAE training)", "A10")
        if fsq_levels is not None or not lookup_free_quantization:
            raise not_ported("FSQ and EMA-VQ quantizers", "A10")
        encdec_kwargs = {}
        for key in list(kwargs):
            if key.startswith("encdec_"):
                encdec_kwargs[key[len("encdec_"):]] = kwargs.pop(key)
        if kwargs:
            raise TypeError(f"unknown kwargs: {sorted(kwargs)}")
        lfq_kwargs = dict(diversity_gamma=4.0) | (lfq_kwargs or {})

        self.channels = channels
        self.codebook_size = codebook_size
        self.dim_divisor = 2**layers
        self.enc_dec = ResnetEncDec(
            dim=dim, channels=channels, layers=layers, generator=generator, **encdec_kwargs
        )
        self.quantizer = LFQ(
            dim=self.enc_dec.encoded_dim,
            codebook_size=codebook_size,
            generator=generator,
            **lfq_kwargs,
        )

    @property
    def encoded_dim(self) -> int:
        return self.enc_dec.encoded_dim

    def get_encoded_fmap_size(self, image_size: int) -> int:
        return self.enc_dec.get_encoded_fmap_size(image_size)

    def encode(self, img: torch.Tensor):
        raise not_ported("VQGanVAE.encode", "A4")

    def decode(self, fmap: torch.Tensor) -> torch.Tensor:
        return self.enc_dec.decode(fmap)

    def decode_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (b, h', w') -> images (b, h, w, c)."""
        return self.decode(self.quantizer.indices_to_codes(ids))
