"""glue_ms_per_step.<cells> (ms): device time of everything that is no matrix
product and no K2 kernel (forward `flash_core_kernel<64, true>`,
`qknorm_fwd_f32`; backward `qknorm_bwd_*`; see `benchmark/kernels.py`) per
traced step: the loss's f32 passes over the logits, the trunk's elementwise
work, the optimizer's and the EMA's `_foreach_` kernels, copies."""

from benchmark import kernels


def read(r):
    s = r.trace.seconds(kernels.is_glue)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
