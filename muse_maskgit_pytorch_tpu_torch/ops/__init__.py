"""Hand-written Hopper kernels of the port, each beside its plain version."""

from muse_maskgit_pytorch_tpu_torch.ops.attention import attend, xla_attention  # noqa: F401
from muse_maskgit_pytorch_tpu_torch.ops.vq import nearest_code, nearest_code_plain  # noqa: F401
