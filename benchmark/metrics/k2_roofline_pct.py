"""k2_roofline_pct.<cells> (%): the sum over K2's forward launches in the traced
batches of each launch's least time (the larger of 4 n (keys on + 1) d a
head at 989 TFLOP/s and its bytes at 3.35 TB/s, `flops.k2_forward`), over
the summed device time of the kernels named `flash_core_kernel<64, true>`
or `qknorm_fwd_f32`."""

from benchmark import kernels


def read(r):
    s = r.trace.seconds(lambda name, chain: bool(kernels.K2_FWD.search(name)))
    bound = r.layer.get("k2_bound_s")
    return 100.0 * bound / s if s > 0 and bound else None
