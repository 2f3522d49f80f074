"""The device's idle share (%) of the profiled stretch: one minus the union
of its device activities' intervals over the stretch's wall time."""

from benchmark.yardstick.readers import Reading


def read(r: Reading):
    busy = r.trace.busy_s()
    if r.trace.window_s <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / r.trace.window_s)
