from muse_maskgit_pytorch_tpu_torch.models.maskgit import MaskGit  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.quantizers import FSQ, LFQ, VectorQuantizeEMA  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.transformer import (  # noqa: F401
    MaskGitTransformer,
    Transformer,
)
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import VQGanVAE  # noqa: F401
