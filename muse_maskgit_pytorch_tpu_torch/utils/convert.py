"""One-time weight converters (counterpart of
`muse_maskgit_pytorch_tpu/utils/convert.py`): Hugging Face T5 -> the port's
`T5Encoder`, torchvision VGG16 -> `VGG16`, torchvision inception_v3 ->
`InceptionV3`.

Everything is read from memory or from local files: nothing here downloads
or calls torchvision. A converter takes a state dict, or `weights_path`, a
local file (`torch.load(..., weights_only=True)`, or safetensors for a
`.safetensors` file); with neither it raises. `load_hf_t5_weights` takes an
in-memory `transformers.T5EncoderModel` or a local directory, read with
`local_files_only=True`. `transformers` and `safetensors` are imported only
by the calls that need them (the card's machine has neither).

The port's layers keep torch's layouts, so a torchvision or Hugging Face
weight is copied as it is (no transposes, unlike the JAX package's
converters); the VGG classifier's flatten is the CHW order of torchvision.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def _copy(dst: torch.Tensor, src, key: str) -> None:
    src = src.detach() if isinstance(src, torch.Tensor) else torch.as_tensor(np.asarray(src))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: source shape {tuple(src.shape)} != port shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.dtype))


def _read_state_dict(state_dict: Optional[Mapping] = None, weights_path=None, what: str = "weights") -> Mapping:
    """`state_dict` as it is, else the tensors of the local file
    `weights_path`; raises when neither is given or the file is missing."""
    if state_dict is not None:
        return state_dict
    if weights_path is None:
        raise ValueError(
            f"{what}: pass state_dict= or weights_path= (a local torch or safetensors file); "
            "nothing is downloaded"
        )
    path = Path(weights_path)
    if not path.is_file():
        raise FileNotFoundError(f"{what}: weight file not found: {path}")
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        return load_file(str(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def load_hf_t5_weights(model, name_or_path) -> None:
    """Fill a `models.t5.T5Encoder` from a Hugging Face `T5EncoderModel`:
    an in-memory model, or a local directory (or a name already in the
    local Hugging Face cache), read with `local_files_only=True`."""
    if isinstance(name_or_path, (str, Path)):
        from transformers import T5EncoderModel

        hf = T5EncoderModel.from_pretrained(str(name_or_path), local_files_only=True)
    else:
        hf = name_or_path
    sd = hf.state_dict()

    pairs = [(model.token_emb.weight, "shared.weight")]
    for i, block in enumerate(model.blocks):
        p = f"encoder.block.{i}.layer"
        attn, ff = block.attn, block.ff
        pairs += [
            (block.ln1.weight, f"{p}.0.layer_norm.weight"),
            (attn.q.weight, f"{p}.0.SelfAttention.q.weight"),
            (attn.k.weight, f"{p}.0.SelfAttention.k.weight"),
            (attn.v.weight, f"{p}.0.SelfAttention.v.weight"),
            (attn.o.weight, f"{p}.0.SelfAttention.o.weight"),
            (block.ln2.weight, f"{p}.1.layer_norm.weight"),
            (ff.wo.weight, f"{p}.1.DenseReluDense.wo.weight"),
        ]
        if attn.rel_bias is not None:
            pairs.append((attn.rel_bias.weight, f"{p}.0.SelfAttention.relative_attention_bias.weight"))
        if ff.gated:
            pairs += [
                (ff.wi_0.weight, f"{p}.1.DenseReluDense.wi_0.weight"),
                (ff.wi_1.weight, f"{p}.1.DenseReluDense.wi_1.weight"),
            ]
        else:
            pairs.append((ff.wi.weight, f"{p}.1.DenseReluDense.wi.weight"))
    pairs.append((model.final_norm.weight, "encoder.final_layer_norm.weight"))
    for dst, key in pairs:
        _copy(dst, sd[key], key)


def load_torchvision_vgg16(model, state_dict: Optional[Mapping] = None, weights_path=None) -> None:
    """Fill a `models.vgg.VGG16` from torchvision vgg16 weights (a state
    dict or a local file): `features.{i}` in order onto the 13
    convolutions, `classifier.{0,3}` onto fc1 / fc2."""
    sd = _read_state_dict(state_dict, weights_path, "torchvision vgg16")
    conv_indices = sorted({int(k.split(".")[1]) for k in sd if k.startswith("features.") and k.endswith(".weight")})
    if len(conv_indices) != len(model.convs):
        raise ValueError(f"vgg16: {len(conv_indices)} conv weights in the state dict, the model has {len(model.convs)}")
    for conv, idx in zip(model.convs, conv_indices):
        _copy(conv.weight, sd[f"features.{idx}.weight"], f"features.{idx}.weight")
        _copy(conv.bias, sd[f"features.{idx}.bias"], f"features.{idx}.bias")
    for fc, idx in ((model.fc1, 0), (model.fc2, 3)):
        _copy(fc.weight, sd[f"classifier.{idx}.weight"], f"classifier.{idx}.weight")
        _copy(fc.bias, sd[f"classifier.{idx}.bias"], f"classifier.{idx}.bias")


def _basic_convs(model: nn.Module) -> Dict[str, nn.Module]:
    """Every `BasicConv2d` of an `InceptionV3` by its torchvision prefix
    (the attribute names are torchvision's, so the module path is the state
    dict's prefix)."""
    from muse_maskgit_pytorch_tpu_torch.models.inception import BasicConv2d

    return {name: m for name, m in model.named_modules() if isinstance(m, BasicConv2d)}


def load_torchvision_inception_v3(model, state_dict: Optional[Mapping] = None, weights_path=None) -> None:
    """Fill a `models.inception.InceptionV3` from torchvision inception_v3
    weights (a state dict or a local file): each of the 94 `BasicConv2d`
    units takes `{prefix}.conv.weight` and its BatchNorm's weight, bias,
    running_mean and running_var. `AuxLogits.*` and `fc.*` are ignored:
    pool3 features never reach them."""
    sd = _read_state_dict(state_dict, weights_path, "torchvision inception_v3")
    units = _basic_convs(model)
    if len(units) != 94:
        raise ValueError(f"expected 94 BasicConv2d units, found {len(units)}")
    for path, unit in units.items():
        for dst, leaf in (
            (unit.conv.weight, "conv.weight"),
            (unit.bn_scale, "bn.weight"),
            (unit.bn_bias, "bn.bias"),
            (unit.bn_mean, "bn.running_mean"),
            (unit.bn_var, "bn.running_var"),
        ):
            _copy(dst, sd[f"{path}.{leaf}"], f"{path}.{leaf}")
