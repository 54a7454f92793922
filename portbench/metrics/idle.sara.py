"""Percent of the traced steps' wall time in which the device ran nothing:
1 - busy / wall, busy the union of the device's kernel, copy and set
intervals in the profiler's trace."""


def read(run):
    if run.busy_s is None or run.traced_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)
