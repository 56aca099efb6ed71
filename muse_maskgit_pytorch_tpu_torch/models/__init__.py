from muse_maskgit_pytorch_tpu_torch.models.maskgit import MaskGit, Muse, TrainDraws, vaes_share_weights  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.quantizers import FSQ, LFQ, VectorQuantizeEMA, VQDraws  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.t5 import T5Encoder, t5_encode_text  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.transformer import (  # noqa: F401
    MaskGitTransformer,
    SelfCritic,
    TokenCritic,
    Transformer,
)
from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import Discriminator, VQGanVAE  # noqa: F401
