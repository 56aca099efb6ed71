from muse_maskgit_pytorch_tpu_torch.models.maskgit import MaskGit, Muse, TrainDraws, vaes_share_weights  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.quantizers import FSQ, LFQ, VectorQuantizeEMA, VQDraws  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.t5 import (  # noqa: F401
    DEFAULT_T5_NAME,
    MAX_LENGTH,
    T5Encoder,
    get_encoded_dim,
    t5_encode_text,
    t5_encode_text_with_mask,
)
from muse_maskgit_pytorch_tpu_torch.models.transformer import (  # noqa: F401
    Attention,
    FeedForward,
    LayerNorm,
    MaskGitTransformer,
    SelfCritic,
    TokenCritic,
    Transformer,
    TransformerBlocks,
)
from muse_maskgit_pytorch_tpu_torch.models.vgg import VGG16  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.models.vqgan_vae import Discriminator, ResnetEncDec, VQGanVAE  # noqa: F401
