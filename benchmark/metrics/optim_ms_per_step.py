"""optim_ms_per_step.<cells> (ms): device time of every kernel launched
inside the program's `muse.optimizer` span (the gradients' reduce and
divide, the global norm, the clip and Adam) or its `muse.ema` span (the
moving average) per traced step. A program without the spans reads
nothing."""


def read(r):
    s = r.trace.seconds(lambda name, chain: "muse.optimizer" in chain or "muse.ema" in chain)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
