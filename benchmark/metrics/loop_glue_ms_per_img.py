"""loop_glue_ms_per_img.<cells> (ms): device time of the glue kernels (see
`benchmark/kernels.py`) launched inside the program's `muse.step` span
and outside its `muse.trunk` span (the decode loop's own work: the remask
or compact candidate selection, the sampler's surroundings, the ids and
scores update) per image of the traced batches. A program without the
spans reads nothing."""

from benchmark import kernels


def read(r):
    def loop(name, chain):
        return "muse.step" in chain and "muse.trunk" not in chain and kernels.is_glue(name, chain)

    s = r.trace.seconds(loop)
    return 1000.0 * s / r.trace.units if s > 0 and r.trace.units else None
