"""t5_ms_per_img.<cells> (ms): device time of the kernels launched inside
the program's `muse.t5` span (the frozen T5 encoder of the prompts) per
image of the traced batches. Read from each kernel's chain of host events;
a program without the span reads nothing."""


def read(r):
    s = r.trace.seconds(lambda name, chain: "muse.t5" in chain)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
