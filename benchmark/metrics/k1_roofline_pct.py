"""k1_roofline_pct, k1_roofline_pct.<cells> (%): the sum over K1's launches in the traced batches of
each launch's least time (its logits read once and a token and probability
written a row, at 3.35 TB/s, `flops.k1_launch`), over the summed device time
of the kernels named `sample_kernel`."""

from benchmark import kernels


def read(r):
    s = r.trace.seconds(lambda name, chain: bool(kernels.K1.search(name)))
    bound = r.layer.get("k1_bound_s")
    return 100.0 * bound / s if s > 0 and bound else None
