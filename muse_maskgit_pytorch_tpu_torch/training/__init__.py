"""Training: `VQGanVAETrainer`, `MaskGitTrainer` and their optimizer, EMA,
image dataset and data helpers, preemption guard and native token-shard
loader."""

from muse_maskgit_pytorch_tpu_torch.training.data import (  # noqa: F401
    DataLoader,
    ImageDataset,
    cycle,
    make_grid,
    prefetch_iterator,
    save_image,
    split_dataset,
)
from muse_maskgit_pytorch_tpu_torch.training.ema import ema_init, ema_update  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.training.optim import Adam, clip_by_global_norm, global_norm, lr_schedule  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.training.preemption import PreemptionGuard  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.training.shard_loader import ShardLoader, read_shard_header, write_shard  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.training.trainers import MaskGitTrainer, VQGanVAETrainer  # noqa: F401
