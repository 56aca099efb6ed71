"""VQ-GAN VAE tokenizer (counterpart of
`muse_maskgit_pytorch_tpu/models/vqgan_vae.py`): `encode` images to token
ids and `decode_from_ids` back, with any of the three quantizers (LFQ,
EMA-VQ, FSQ), and the GAN training losses: `forward(img, return_loss=True)`
(reconstruction, VGG perceptual, quantizer and adaptively weighted
generator losses) and `forward(img, return_discr_loss=True)` (hinge or BCE
discriminator loss with the R1-style gradient penalty).

Public layouts are the JAX package's: token grids (b, h', w') and NHWC
images (b, h, w, c). The convolutions run NCHW inside through
`F.conv2d` / `F.conv_transpose2d`, as the JAX package leaves them to XLA
(no Pallas kernel). GroupNorm uses flax's eps 1e-6 and computes in f32,
LeakyReLU slope 0.1. JAX's nested `jax.grad` closures become
`torch.autograd.grad`: the penalty differentiates the discriminator's
input gradient (`create_graph=True`), and the adaptive weight takes the
gradients of the perceptual and generator losses with respect to the last
decoder kernel from the loss's own graph, where JAX recomputes the towers
on a copy of that layer (the same value and gradient).
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from muse_maskgit_pytorch_tpu_torch.models._layers import Conv2d, ConvTranspose2d
from muse_maskgit_pytorch_tpu_torch.models.quantizers import FSQ, LFQ, VectorQuantizeEMA
from muse_maskgit_pytorch_tpu_torch.utils.helpers import default, exists, resolve_device

GROUPNORM_EPS = 1e-6


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def safe_div(numer: torch.Tensor, denom: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return numer / denom.clamp(min=eps)


# -- GAN losses: f32 whatever the towers' compute dtype ------------------------


def hinge_discr_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return (F.relu(1 + fake.float()) + F.relu(1 - real.float())).mean()


def hinge_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    return -fake.float().mean()


def _log(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return torch.log(t + eps)


def bce_discr_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    fake, real = fake.float(), real.float()
    return (-_log(1 - torch.sigmoid(fake)) - _log(torch.sigmoid(real))).mean()


def bce_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    return (-_log(torch.sigmoid(fake.float()))).mean()


def _penalty(images: torch.Tensor, logits: torch.Tensor, weight: float) -> torch.Tensor:
    """weight * mean over the batch of (||d logits.sum() / d images||_2 - 1)^2,
    differentiable (`create_graph`) for the discriminator's update."""
    (grads,) = torch.autograd.grad(logits.float().sum(), images, create_graph=True)
    grads = grads.reshape(grads.shape[0], -1).float()
    return weight * ((grads.norm(dim=1) - 1) ** 2).mean()


def gradient_penalty(images: torch.Tensor, discr_fn, weight: float = 10.0) -> torch.Tensor:
    """R1-style penalty of the JAX package's `gradient_penalty`: the input
    gradient of `discr_fn(images).sum()`, by a double backward."""
    images = images.detach().requires_grad_(True)
    return _penalty(images, discr_fn(images), weight)


class LayerNormChan(nn.Module):
    """Channel LayerNorm of NHWC maps over the last axis: biased variance,
    gamma only (the JAX package keeps it for inventory; no model uses it)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var.clamp(min=self.eps)) * self.gamma


class GroupNorm(nn.GroupNorm):
    """flax `nnx.GroupNorm` defaults: eps 1e-6, scale and bias; computes in
    the promoted type of the input and its f32 scale (flax promotes a bf16
    input so)."""

    def __init__(self, chan: int, groups: int):
        super().__init__(groups, chan, eps=GROUPNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt), self.bias.to(dt), self.eps)


class ResBlock(nn.Module):
    def __init__(self, chan: int, groups: int = 16, *, dtype=None, generator=None):
        super().__init__()
        self.conv1 = Conv2d(chan, chan, 3, padding=1, dtype=dtype, generator=generator)
        self.norm1 = GroupNorm(chan, groups)
        self.conv2 = Conv2d(chan, chan, 3, padding=1, dtype=dtype, generator=generator)
        self.norm2 = GroupNorm(chan, groups)
        self.conv3 = Conv2d(chan, chan, 1, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        h = leaky_relu(self.norm1(self.conv1(x)))
        h = leaky_relu(self.norm2(self.conv2(h)))
        return self.conv3(h) + x


class GLUResBlock(nn.Module):
    def __init__(self, chan: int, groups: int = 16, *, dtype=None, generator=None):
        super().__init__()
        self.conv1 = Conv2d(chan, chan * 2, 3, padding=1, dtype=dtype, generator=generator)
        self.norm1 = GroupNorm(chan, groups)
        self.conv2 = Conv2d(chan, chan * 2, 3, padding=1, dtype=dtype, generator=generator)
        self.norm2 = GroupNorm(chan, groups)
        self.conv3 = Conv2d(chan, chan, 1, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        h = self.norm1(F.glu(self.conv1(x), dim=1))
        h = self.norm2(F.glu(self.conv2(h), dim=1))
        return self.conv3(h) + x


class _StridedConv(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, *, dtype=None, generator=None):
        super().__init__()
        self.conv = Conv2d(dim_in, dim_out, 4, padding=1, stride=2, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return leaky_relu(self.conv(x))


class _UpConv(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, *, dtype=None, generator=None):
        super().__init__()
        self.conv = ConvTranspose2d(dim_in, dim_out, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return leaky_relu(self.conv(x))


class ResnetEncDec(nn.Module):
    """Symmetric conv pyramid: a first conv, then stride-2 downs with
    ResBlocks on the encoder side; GLUResBlocks and transpose-conv ups,
    built back to front like the JAX module, then a 1x1 `final_conv` to
    pixels on the decoder side (f32 always: its kernel is the one the
    adaptive weight differentiates). `dtype` is the convolutions' compute
    dtype; `remat` recomputes each layer's activations in the backward
    (`torch.utils.checkpoint`, the JAX package's `jax.checkpoint`)."""

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
        dtype=None,
        remat: bool = False,
        generator=None,
    ):
        super().__init__()
        self.remat = remat
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
                dtype=dtype, generator=generator,
            )
        ]
        decoders = []
        kw = dict(dtype=dtype, generator=generator)
        for (dim_in, dim_out), n_res in zip(zip(dims[:-1], dims[1:]), num_resnet_blocks):
            encoders.append(_StridedConv(dim_in, dim_out, **kw))
            decoders.insert(0, _UpConv(dim_out, dim_in, **kw))
            for _ in range(n_res):
                encoders.append(ResBlock(dim_out, groups=resnet_groups, **kw))
                decoders.insert(0, GLUResBlock(dim_out, groups=resnet_groups, **kw))
        self.encoders = nn.ModuleList(encoders)
        self.decoder_trunk = nn.ModuleList(decoders)
        self.final_conv = Conv2d(dim, channels, 1, generator=generator)

    def get_encoded_fmap_size(self, image_size: int) -> int:
        return image_size // (2**self.layers)

    def _run(self, layers, x: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            if self.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False)
            else:
                x = layer(x)
        return x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC pixels -> NHWC latents."""
        return self._run(self.encoders, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> the NCHW input of `final_conv`."""
        return self._run(self.decoder_trunk, x.permute(0, 3, 1, 2))

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> NHWC pixels."""
        return self.final_conv(self.decode_trunk(x)).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """PatchGAN discriminator: NHWC images -> NHWC logit maps. `dtype` is
    the convolutions' compute dtype (weights f32); the GroupNorms compute
    in f32."""

    def __init__(
        self,
        dims: Sequence[int],
        channels: int = 3,
        groups: int = 16,
        init_kernel_size: int = 5,
        dtype=None,
        *,
        generator=None,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, generator=generator)
        self.init_conv = Conv2d(channels, dims[0], init_kernel_size, padding=init_kernel_size // 2, **kw)
        convs, norms = [], []
        for dim_in, dim_out in zip(dims[:-1], dims[1:]):
            convs.append(Conv2d(dim_in, dim_out, 4, padding=1, stride=2, **kw))
            norms.append(GroupNorm(dim_out, groups))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        dim = dims[-1]
        self.to_logits_conv1 = Conv2d(dim, dim, 1, **kw)
        self.to_logits_conv2 = Conv2d(dim, 1, 4, **kw)  # VALID
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.init_conv(x.permute(0, 3, 1, 2)))
        for conv, norm in zip(self.convs, self.norms):
            x = leaky_relu(norm(conv(x)))
        x = leaky_relu(self.to_logits_conv1(x))
        # a map below the 4x4 head is padded at its end so the head still
        # gives one logit, as in the JAX module
        ph, pw = max(0, 4 - x.shape[2]), max(0, 4 - x.shape[3])
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph))
        return self.to_logits_conv2(x).permute(0, 2, 3, 1)


def _take_prefixed(prefix: str, kwargs: dict) -> dict:
    """Pop every `prefix`-named entry of kwargs, with the prefix cut off
    (the JAX package's `groupby_prefix_and_trim`)."""
    return {key[len(prefix):]: kwargs.pop(key) for key in list(kwargs) if key.startswith(prefix)}


class VQGanVAE(nn.Module):
    """The JAX `VQGanVAE`'s constructor: `dtype` is the encoder / decoder's
    compute dtype, `vgg_dtype` and `discr_dtype` the towers' (None: f32);
    `use_vgg_and_gan` (default True, as in JAX) builds the discriminator
    after the encoder, decoder and quantizer, and the VGG tower lazily on
    first use (`vgg`, random init from a fixed seed) unless one is given as
    `vgg` or by `set_vgg`. `encdec_remat=True` recomputes the encoder and
    decoder layers in the backward."""

    def __init__(
        self,
        *,
        dim: int,
        channels: int = 3,
        layers: int = 4,
        l2_recon_loss: bool = False,
        use_hinge_loss: bool = True,
        vgg: Optional[nn.Module] = None,
        lookup_free_quantization: bool = True,
        codebook_size: int = 65536,
        fsq_levels: Optional[tuple] = None,
        vq_kwargs: Optional[dict] = None,
        lfq_kwargs: Optional[dict] = None,
        use_vgg_and_gan: bool = True,
        discr_layers: int = 4,
        dtype: Optional[torch.dtype] = None,
        vgg_dtype: Optional[torch.dtype] = None,
        discr_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device="cuda",
        **kwargs,
    ):
        super().__init__()
        device = resolve_device(device)
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
            dim=dim, channels=channels, layers=layers, dtype=dtype, generator=generator, **encdec_kwargs
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

        self.vgg_dtype = vgg_dtype
        self.l2_recon_loss = l2_recon_loss
        self.use_hinge_loss = use_hinge_loss
        self.use_vgg_and_gan = use_vgg_and_gan
        self._vgg = None
        self.discr = None
        if use_vgg_and_gan:
            if exists(vgg):
                self.set_vgg(vgg)
            dims = (dim, *[dim * 2**t for t in range(discr_layers)])
            self.discr = Discriminator(dims, channels=channels, dtype=discr_dtype, generator=generator, device=device)
        self.to(device)

    @property
    def encoded_dim(self) -> int:
        return self.enc_dec.encoded_dim

    @property
    def vgg(self) -> nn.Module:
        """The perceptual tower: the one given, else a random-init `VGG16`
        built on first use (no weight files here, as in the JAX package),
        frozen."""
        if self._vgg is None:
            from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16

            device = self.enc_dec.final_conv.weight.device
            self.set_vgg(VGG16(dtype=self.vgg_dtype, generator=torch.Generator().manual_seed(0), device=device))
        return self._vgg

    def set_vgg(self, vgg: nn.Module) -> None:
        """Use `vgg` as the perceptual tower; it is frozen (no gradient)."""
        self._vgg = vgg.requires_grad_(False)

    def copy_for_eval(self) -> "VQGanVAE":
        """A deep copy with the discriminator and the VGG tower stripped."""
        return _strip_towers(copy.deepcopy(self, {id(t): None for t in (self.discr, self._vgg) if t is not None}))

    # -- persistence: the JAX package's msgpack file (`utils.checkpoint`) ----

    def save(self, path) -> None:
        """Write a file the JAX package's `VQGanVAE.load` reads (the VGG
        tower is never saved, as in the JAX package)."""
        from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import save_module

        save_module(self, path, exclude=("_vgg",))

    def load(self, path) -> List[str]:
        """Load a file of either package's `VQGanVAE.save`; returns the
        leaves that the port has no place for (a discriminator's, when this
        VAE was built with `use_vgg_and_gan=False`)."""
        from muse_maskgit_pytorch_tpu_torch.utils.checkpoint import load_module

        return load_module(self, path, exclude=("_vgg",))

    def get_encoded_fmap_size(self, image_size: int) -> int:
        return self.enc_dec.get_encoded_fmap_size(image_size)

    # -- core codec ----------------------------------------------------------

    def encode(
        self,
        img: torch.Tensor,
        train: bool = False,
        rng=None,
        update_stats: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """img (b, h, w, c) in [0, 1] -> (quantized fmap (b, h', w', d),
        int32 ids (b, h', w'), aux loss). `train` adds the quantizer's
        training losses; `update_stats` (default `train`) and `rng` (a
        `VQDraws` or a CPU generator) drive EMA-VQ's codebook updates in the
        call, so pass `update_stats=False` inside a differentiated loss."""
        if img.dim() != 4:
            raise ValueError(f"encode takes NHWC images, got shape {tuple(img.shape)}")
        fmap = self.enc_dec.encode(img)
        if isinstance(self.quantizer, VectorQuantizeEMA):
            return self.quantizer(fmap, train=train, rng=rng, update_stats=update_stats)
        return self.quantizer(fmap, train=train)

    @torch.no_grad()
    def update_quantizer_stats(self, img: torch.Tensor, rng=None) -> None:
        """EMA-VQ's codebook update for a batch (nothing for LFQ and FSQ),
        outside the gradient; `rng` as for `encode`."""
        if isinstance(self.quantizer, VectorQuantizeEMA):
            self.quantizer.update_from_input(self.enc_dec.encode(img), rng=rng)

    def decode(self, fmap: torch.Tensor) -> torch.Tensor:
        return self.enc_dec.decode(fmap)

    def decode_from_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (b, h', w') -> images (b, h, w, c)."""
        if isinstance(self.quantizer, VectorQuantizeEMA):
            fmap = self.quantizer.get_codes_from_indices(ids)
        else:  # LFQ and FSQ share the indices_to_codes contract
            fmap = self.quantizer.indices_to_codes(ids)
        return self.decode(fmap)

    # -- losses ----------------------------------------------------------------

    def forward(
        self,
        img: torch.Tensor,
        return_loss: bool = False,
        return_discr_loss: bool = False,
        return_recons: bool = False,
        add_gradient_penalty: bool = True,
        apply_adaptive_weight: bool = True,
        train: bool = True,
        rng=None,
        update_stats: Optional[bool] = None,
    ):
        """img (b, h, w, c) in [0, 1] -> the reconstruction; with
        `return_loss` the autoencoder loss, with `return_discr_loss` the
        discriminator's (its R1 penalty with `add_gradient_penalty`), each
        with the reconstruction too under `return_recons`. The defaults are
        the JAX module's (`train=True`: the quantizer's training losses and,
        unless `update_stats=False`, EMA-VQ's codebook update)."""
        b, height, width, channels = img.shape
        for name, size in (("height", height), ("width", width)):
            if size % self.dim_divisor:
                raise ValueError(f"{name} must be divisible by {self.dim_divisor}")
        if channels != self.channels:
            raise ValueError(f"images have {channels} channels, the VAE {self.channels}")
        if return_loss and return_discr_loss:
            raise ValueError("return_loss and return_discr_loss are exclusive")

        # the discriminator's loss takes no gradient through the VAE
        with torch.no_grad() if return_discr_loss else contextlib.nullcontext():
            fmap, _, commit_loss = self.encode(img, train=train, rng=rng, update_stats=update_stats)
            # the decoder split, so the adaptive weight reaches the last kernel
            hidden = self.enc_dec.decode_trunk(fmap)
            recon = self.enc_dec.final_conv(hidden).permute(0, 2, 3, 1)

        if not return_loss and not return_discr_loss:
            return recon

        if return_discr_loss:
            if self.discr is None:
                raise ValueError("the discriminator must exist to train it (use_vgg_and_gan=True)")
            discr_loss_fn = hinge_discr_loss if self.use_hinge_loss else bce_discr_loss
            fake_logits = self.discr(recon)
            if add_gradient_penalty:
                # one forward of the real images serves the loss and the penalty
                img = img.detach().requires_grad_(True)
            real_logits = self.discr(img)
            loss = discr_loss_fn(fake_logits, real_logits)
            if add_gradient_penalty:
                loss = loss + _penalty(img, real_logits, 10.0)
            return (loss, recon) if return_recons else loss

        # -- the autoencoder's loss
        if self.l2_recon_loss:
            recon_loss = ((recon - img) ** 2).mean()
        else:
            recon_loss = (recon - img).abs().mean()
        if not self.use_vgg_and_gan:
            return (recon_loss, recon) if return_recons else recon_loss

        # perceptual loss of raw [0, 1] images, grayscale repeated to 3 channels
        img_vgg_in, recon_vgg_in = img, recon
        if channels == 1:
            img_vgg_in, recon_vgg_in = img.repeat(1, 1, 1, 3), recon.repeat(1, 1, 1, 3)
        img_vgg_feats = self.vgg(img_vgg_in)
        recon_vgg_feats = self.vgg(recon_vgg_in)
        perceptual_loss = ((img_vgg_feats.float() - recon_vgg_feats.float()) ** 2).mean()

        gen_loss_fn = hinge_gen_loss if self.use_hinge_loss else bce_gen_loss
        gen_loss = gen_loss_fn(self.discr(recon))

        # adaptive weight = ||d perceptual / d w_last|| / ||d gen / d w_last||, clamped
        if apply_adaptive_weight:
            w_last = self.enc_dec.final_conv.weight
            if not (torch.is_grad_enabled() and w_last.requires_grad):
                raise ValueError("the adaptive weight differentiates the loss: call with gradients enabled")
            (g_p,) = torch.autograd.grad(perceptual_loss, w_last, retain_graph=True)
            (g_g,) = torch.autograd.grad(gen_loss, w_last, retain_graph=True)
            adaptive_weight = safe_div(g_p.norm(), g_g.norm()).clamp(max=1e4).detach()
        else:
            adaptive_weight = 1.0

        loss = recon_loss + perceptual_loss + commit_loss + adaptive_weight * gen_loss
        return (loss, recon) if return_recons else loss


def _strip_towers(vae: VQGanVAE) -> VQGanVAE:
    """`vae` without its discriminator and VGG tower, as JAX's
    `copy_for_eval` leaves a clone."""
    vae.discr = None
    vae._vgg = None
    vae.use_vgg_and_gan = False
    return vae
