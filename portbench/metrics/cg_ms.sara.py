"""Milliseconds a CG iteration: the forward steps' host-clock seconds (each
ending in a device sync) over their iterations."""


def read(run):
    s, n = sum(run.spans.get("forward", [])), run.counters.get("cg_iters", 0)
    return 1e3 * s / n if n else None
