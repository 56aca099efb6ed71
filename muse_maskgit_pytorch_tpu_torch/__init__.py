"""PyTorch / CUDA port of `muse_maskgit_pytorch_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package imports
torch and numpy only. Ported so far: the sampling path from prompts to
images (`Muse(base, superres)(texts)`: the frozen T5 text encoder, the 256px
base stage and the 512px super-res stage of `MaskGit.generate`, handed over
as pixels or as token ids, with every sampling surface of the JAX package:
guidance ramps and per-row scales, negative prompts, any resolution, token
critics, editing and re-ranking), and the VQ-GAN tokenizer's inference
(`VQGanVAE.encode` to token ids and `decode_from_ids` back, with the LFQ,
EMA-VQ and FSQ quantizers) and its GAN training (`VQGanVAETrainer`: the
`Discriminator` with the R1 penalty, the `VGG16` perceptual loss, the
adaptive weight, LFQ's losses, EMA-VQ's k-means init and codebook updates,
the image folder dataset); serving (`GeneratePipeline`, `GenerateServer`)
and module checkpoints in the JAX package's file format, read and written
without JAX (`MaskGit.load` / `save`, `utils.checkpoint`); and training
(`MaskGit.forward`, the masked-token loss, with K2's gradient, and
`MaskGitTrainer`: Adam / AdamW, schedule, EMA, accumulation, train-state
checkpoints with exact resume, token shards); and evaluation (streaming FID
over the `InceptionV3` or `VGG16` tower: `FeatureStats`, `fid_score`,
`make_inception_extractor`, with the torchvision and Hugging Face weight
converters of `utils.convert` reading local files only, and
`utils.metrics.profile_trace`); and data-parallel and FSDP training and
serving over a `torch.distributed` process group (`parallel`: the JAX
package's mesh functions, both trainers' `mesh=` / `shard_state=`,
`GeneratePipeline(mesh=)`). The example command lines are
`muse_maskgit_pytorch_tpu_torch.examples.<name>`, each run with
`python -m`. Their four hand-written CUDA kernels (`ops.sampling_kernel`,
`ops.attention`, `ops.vq`) are built from `csrc/` on first use. The public
modules below take `device=` and are built on the GPU ("cuda") unless the
caller asks for the CPU. See ROADMAP.md for what is still to come.
"""

from muse_maskgit_pytorch_tpu_torch.models import (  # noqa: F401
    FSQ,
    VGG16,
    Discriminator,
    LFQ,
    MaskGit,
    MaskGitTransformer,
    Muse,
    SelfCritic,
    T5Encoder,
    TokenCritic,
    TrainDraws,
    Transformer,
    VectorQuantizeEMA,
    VQDraws,
    VQGanVAE,
    t5_encode_text,
    vaes_share_weights,
)
from muse_maskgit_pytorch_tpu_torch.utils.eval import (  # noqa: F401
    FeatureStats,
    compute_feature_stats,
    fid_score,
    frechet_distance,
    make_inception_extractor,
    make_vgg_extractor,
)
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.serving import GeneratePipeline  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.serving_http import GenerateServer  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.training import (  # noqa: F401
    MaskGitTrainer,
    PreemptionGuard,
    VQGanVAETrainer,
    ShardLoader,
    ema_init,
    ema_update,
    lr_schedule,
    write_shard,
)
