"""glue_ms_per_img.<cells> (ms): device time of everything that is no matrix
product, no convolution (see `benchmark/kernels.py`) and none of K1
(`sample_kernel`) and K2 (`flash_core_kernel<64, true>`, `qknorm_fwd_f32`),
per image of the traced batches: the trunk's and the decode loop's
elementwise work, casts, norms, copies."""

from benchmark import kernels


def read(r):
    s = r.trace.seconds(kernels.is_glue)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
