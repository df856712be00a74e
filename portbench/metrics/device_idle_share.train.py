"""The share of the profiled steps' wall time in which no operation ran
on the device: one minus the union of the device intervals over the
window, in %."""


def read(r):
    if not r.trace.ops or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
