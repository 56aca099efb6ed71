"""trunk_glue_ms_per_img.<cells> (ms): device time of the glue kernels (no
matrix product, convolution, K1 or K2: `benchmark/kernels.py`) launched
inside the program's `muse.trunk` span (a decode step's trunk, vocab head
and CFG combine: casts, norms, GEGLU, the combine) per image of the traced
batches. A program without the span reads nothing."""

from benchmark import kernels


def read(r):
    s = r.trace.seconds(lambda name, chain: "muse.trunk" in chain and kernels.is_glue(name, chain))
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
