"""Helpers, sampling and masking functions, checkpoints, conversion and
evaluation (counterpart of `muse_maskgit_pytorch_tpu/utils/`). The
package exports what the JAX package's `utils` exports."""

from muse_maskgit_pytorch_tpu_torch.utils.helpers import (  # noqa: F401
    accum_log,
    cast_tuple,
    default,
    exists,
    group_by_key_prefix,
    group_dict_by_key,
    groupby_prefix_and_trim,
    pair,
)
from muse_maskgit_pytorch_tpu_torch.utils.sampling import (  # noqa: F401
    NOISE_SCHEDULES,
    batch_random_mask,
    cosine_schedule,
    get_mask_subset_prob,
    gumbel_noise,
    gumbel_sample,
    linear_schedule,
    log,
    mask_by_topk_scores,
    prob_mask_like,
    top_k,
    uniform,
)
