"""forward_ms_per_step.<cells> (ms): device time of every kernel launched
inside the program's `muse.forward` span (a micro-batch's `MaskGit`
forward: the trunk, the no-grad self-conditioning pass, the vocab head and
the loss) per traced step. The backward's kernels are launched by the
autograd engine's own thread, under no span of the step, and are not
counted. A program without the span reads nothing."""


def read(r):
    s = r.trace.seconds(lambda name, chain: "muse.forward" in chain)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
