"""VQ-GAN VAE tokenizer, inference (counterpart of
`muse_maskgit_pytorch_tpu/models/vqgan_vae.py`): `encode` images to token
ids and `decode_from_ids` back, with any of the three quantizers (LFQ,
EMA-VQ, FSQ).

Public layouts are the JAX package's: token grids (b, h', w') and NHWC
images (b, h, w, c). The convolutions run NCHW inside through
`F.conv2d` / `F.conv_transpose2d`, as the JAX package leaves them to XLA
(no Pallas kernel). GroupNorm uses flax's eps 1e-6, LeakyReLU slope 0.1.
The discriminator, the VGG tower and the GAN losses are not ported yet
(ROADMAP A10).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d, ConvTranspose2d
from muse_maskgit_pytorch_tpu_torch.models.quantizers import FSQ, LFQ, VectorQuantizeEMA
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, not_ported, resolve_device

GROUPNORM_EPS = 1e-6


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


class GroupNorm(nn.GroupNorm):
    """flax `nnx.GroupNorm` defaults: eps 1e-6, scale and bias."""

    def __init__(self, chan: int, groups: int):
        super().__init__(groups, chan, eps=GROUPNORM_EPS)


class ResBlock(nn.Module):
    def __init__(self, chan: int, groups: int = 16, *, generator=None):
        super().__init__()
        self.conv1 = Conv2d(chan, chan, 3, padding=1, generator=generator)
        self.norm1 = GroupNorm(chan, groups)
        self.conv2 = Conv2d(chan, chan, 3, padding=1, generator=generator)
        self.norm2 = GroupNorm(chan, groups)
        self.conv3 = Conv2d(chan, chan, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        h = leaky_relu(self.norm1(self.conv1(x)))
        h = leaky_relu(self.norm2(self.conv2(h)))
        return self.conv3(h) + x


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


class _StridedConv(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, *, generator=None):
        super().__init__()
        self.conv = Conv2d(dim_in, dim_out, 4, padding=1, stride=2, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return leaky_relu(self.conv(x))


class _UpConv(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, *, generator=None):
        super().__init__()
        self.conv = ConvTranspose2d(dim_in, dim_out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return leaky_relu(self.conv(x))


class ResnetEncDec(nn.Module):
    """Symmetric conv pyramid: a first conv, then stride-2 downs with
    ResBlocks on the encoder side; GLUResBlocks and transpose-conv ups,
    built back to front like the JAX module, then a 1x1 `final_conv` to
    pixels on the decoder side."""

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
        encoders = [
            Conv2d(
                channels, dim, first_conv_kernel_size, padding=first_conv_kernel_size // 2,
                generator=generator,
            )
        ]
        decoders = []
        for (dim_in, dim_out), n_res in zip(zip(dims[:-1], dims[1:]), num_resnet_blocks):
            encoders.append(_StridedConv(dim_in, dim_out, generator=generator))
            decoders.insert(0, _UpConv(dim_out, dim_in, generator=generator))
            for _ in range(n_res):
                encoders.append(ResBlock(dim_out, groups=resnet_groups, generator=generator))
                decoders.insert(0, GLUResBlock(dim_out, groups=resnet_groups, generator=generator))
        self.encoders = nn.ModuleList(encoders)
        self.decoder_trunk = nn.ModuleList(decoders)
        self.final_conv = Conv2d(dim, channels, 1, generator=generator)

    def get_encoded_fmap_size(self, image_size: int) -> int:
        return image_size // (2**self.layers)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC pixels -> NHWC latents."""
        x = x.permute(0, 3, 1, 2)
        for enc in self.encoders:
            x = enc(x)
        return x.permute(0, 2, 3, 1)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> NHWC pixels."""
        x = x.permute(0, 3, 1, 2)
        for dec in self.decoder_trunk:
            x = dec(x)
        return self.final_conv(x).permute(0, 2, 3, 1)


def _take_prefixed(prefix: str, kwargs: dict) -> dict:
    """Pop every `prefix`-named entry of kwargs, with the prefix cut off
    (the JAX package's `groupby_prefix_and_trim`)."""
    return {key[len(prefix):]: kwargs.pop(key) for key in list(kwargs) if key.startswith(prefix)}


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
        vq_kwargs: Optional[dict] = None,
        lfq_kwargs: Optional[dict] = None,
        use_vgg_and_gan: bool = False,
        generator: Optional[torch.Generator] = None,
        device="cuda",
        **kwargs,
    ):
        super().__init__()
        device = resolve_device(device)
        if use_vgg_and_gan:
            raise not_ported("the VGG and discriminator towers (VAE training)", "A10")
        vq_kwargs = dict(
            codebook_dim=256,
            decay=0.8,
            commitment_weight=1.0,
            kmeans_init=True,
            use_cosine_sim=True,
        ) | (vq_kwargs or {})
        lfq_kwargs = dict(diversity_gamma=4.0) | (lfq_kwargs or {})
        vq_kwargs |= _take_prefixed("vq_", kwargs)
        encdec_kwargs = _take_prefixed("encdec_", kwargs)
        if kwargs:
            raise TypeError(f"unknown kwargs: {sorted(kwargs)}")
        if fsq_levels is not None:
            codebook_size = math.prod(int(n) for n in fsq_levels)

        self.channels = channels
        self.codebook_size = codebook_size
        self.dim_divisor = 2**layers
        self.enc_dec = ResnetEncDec(
            dim=dim, channels=channels, layers=layers, generator=generator, **encdec_kwargs
        )
        encoded_dim = self.enc_dec.encoded_dim
        if fsq_levels is not None:
            self.quantizer = FSQ(dim=encoded_dim, levels=tuple(fsq_levels), generator=generator, device=device)
        elif lookup_free_quantization:
            self.quantizer = LFQ(
                dim=encoded_dim, codebook_size=codebook_size, generator=generator, device=device, **lfq_kwargs
            )
        else:
            self.quantizer = VectorQuantizeEMA(
                dim=encoded_dim, codebook_size=codebook_size, generator=generator, device=device, **vq_kwargs
            )
        self.to(device)

    @property
    def encoded_dim(self) -> int:
        return self.enc_dec.encoded_dim

    # -- persistence: the JAX package's msgpack file (`utils.checkpoint`) ----

    def save(self, path) -> None:
        """Write a file the JAX package's `VQGanVAE.load` reads (the VGG
        tower is never saved, as in the JAX package)."""
        from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import save_module

        save_module(self, path, exclude=("_vgg",))

    def load(self, path) -> List[str]:
        """Load a file of either package's `VQGanVAE.save`; returns the
        leaves that the port has no place for (a discriminator's)."""
        from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import load_module

        return load_module(self, path, exclude=("_vgg",))

    def get_encoded_fmap_size(self, image_size: int) -> int:
        return self.enc_dec.get_encoded_fmap_size(image_size)

    def encode(
        self,
        img: torch.Tensor,
        train: bool = False,
        rng=None,
        update_stats: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """img (b, h, w, c) in [0, 1] -> (quantized fmap (b, h', w', d),
        int32 ids (b, h', w'), aux loss). `train`, `rng` and `update_stats`
        belong to training (ROADMAP A10); the quantizers raise on them."""
        if img.dim() != 4:
            raise ValueError(f"encode takes NHWC images, got shape {tuple(img.shape)}")
        fmap = self.enc_dec.encode(img)
        if isinstance(self.quantizer, VectorQuantizeEMA):
            return self.quantizer(fmap, train=train, rng=rng, update_stats=update_stats)
        if update_stats:
            raise not_ported("codebook statistics updates", "A10")
        return self.quantizer(fmap, train=train)

    def decode(self, fmap: torch.Tensor) -> torch.Tensor:
        return self.enc_dec.decode(fmap)

    def decode_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (b, h', w') -> images (b, h, w, c)."""
        if isinstance(self.quantizer, VectorQuantizeEMA):
            fmap = self.quantizer.get_codes_from_indices(ids)
        else:  # LFQ and FSQ share the indices_to_codes contract
            fmap = self.quantizer.indices_to_codes(ids)
        return self.decode(fmap)
