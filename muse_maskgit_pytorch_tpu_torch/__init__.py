"""PyTorch / CUDA port of `muse_maskgit_pytorch_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package imports
torch and numpy only. Ported so far: the base-stage sampling path,
`MaskGit.generate` from text embeddings to 256px images, with its two
hand-written CUDA kernels (`ops.sampling_kernel`, `ops.attention`) built
from `csrc/` on first use. See ROADMAP.md for what is still to come.
"""

from muse_maskgit_pytorch_tpu_torch.models import (  # noqa: F401
    LFQ,
    MaskGit,
    MaskGitTransformer,
    Transformer,
    VQGanVAE,
)
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state  # noqa: F401
