"""device_idle_pct.<cells> (%): 1 - the union of the device's activity intervals over
all streams (kernels, copies, sets) / the traced window on the host's clock.
The traced window holds whole requests or steps only."""


def read(r):
    if r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
