"""Milliseconds a primal-dual iteration: the backward steps' host-clock
seconds (each ending in a device sync) over their iterations."""


def read(run):
    s, n = sum(run.spans.get("backward", [])), run.counters.get("pd_iters", 0)
    return 1e3 * s / n if n else None
