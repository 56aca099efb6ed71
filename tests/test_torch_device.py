"""The port's public modules are built on the GPU unless the caller asks for
the CPU: without CUDA, a module built without `device="cpu"` raises, and
with it every parameter and buffer lies on the CPU. Whether a card exists is
decided inside each test (the no-card case is forced with monkeypatch, so
the tests mean the same on a machine with a GPU)."""

import pytest
import torch

from muse_maskgit_pytorch_tpu_torch.models.t5 import T5Config
from muse_maskgit_pytorch_tpu_torch import (
    FSQ,
    LFQ,
    Discriminator,
    MaskGit,
    MaskGitTransformer,
    Muse,
    T5Encoder,
    Transformer,
    VectorQuantizeEMA,
    VQGanVAE,
)

_T = dict(num_tokens=64, dim=16, seq_len=16, depth=1, dim_head=16, heads=1, text_embed_dim=8)


def _maskgit(**kw):
    transformer = MaskGitTransformer(device="cpu", **_T)
    vae = VQGanVAE(dim=16, layers=2, codebook_size=64, device="cpu")
    return MaskGit(image_size=16, transformer=transformer, vae=vae, **kw)


def _muse(**kw):
    base = _maskgit(device="cpu")
    superres = _maskgit(device="cpu", cond_image_size=8)
    return Muse(base, superres, **kw)


PUBLIC = {
    "MaskGit": _maskgit,
    "MaskGit super-res": lambda **kw: _maskgit(cond_image_size=8, **kw),
    "Muse": _muse,
    "T5Encoder": lambda **kw: T5Encoder(T5Config(16, 32, 2, 8, 1, True, vocab_size=64), **kw),
    "MaskGitTransformer": lambda **kw: MaskGitTransformer(**_T, **kw),
    "Transformer": lambda **kw: Transformer(**_T, **kw),
    "VQGanVAE": lambda **kw: VQGanVAE(dim=16, layers=2, codebook_size=64, **kw),
    "Discriminator": lambda **kw: Discriminator((16, 16, 32), **kw),
    "LFQ": lambda **kw: LFQ(dim=8, codebook_size=64, **kw),
    "FSQ": lambda **kw: FSQ(dim=8, levels=(8, 5, 5), **kw),
    "VectorQuantizeEMA": lambda **kw: VectorQuantizeEMA(dim=8, codebook_size=32, codebook_dim=4, **kw),
}


@pytest.mark.parametrize("name", PUBLIC)
def test_default_device_is_the_gpu_and_raises_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PUBLIC[name]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PUBLIC[name](device="cuda")


@pytest.mark.parametrize("name", PUBLIC)
def test_cpu_build_on_request(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = PUBLIC[name](device="cpu")
    tensors = list(module.parameters()) + list(module.buffers())
    assert tensors and all(t.device.type == "cpu" for t in tensors)

