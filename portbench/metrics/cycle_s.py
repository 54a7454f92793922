"""Window wall time over the whole major cycles completed in it (host clock)."""


def read(run):
    return run.window_s / run.steps if run.steps else None
