"""k2_bwd_roofline_pct (%): the sum over the traced steps' K2 backward calls
of each call's least time (10 n (keys on + 1) d a head at 989 TFLOP/s, or
its bytes at 3.35 TB/s, `flops.k2_backward`) over the summed device time of
the kernels named `qknorm_bwd_*` (one pass at n <= 256; the split route's
queries, keys, sum_rows and reduce kernels above)."""

from benchmark import kernels


def read(r):
    s = r.trace.seconds(lambda name, chain: bool(kernels.K2_BWD.search(name)))
    bound = r.layer.get("k2_bwd_bound_s")
    return 100.0 * bound / s if s > 0 and bound else None
