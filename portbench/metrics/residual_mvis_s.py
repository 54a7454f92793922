"""Visibilities times whole residuals completed, over the window's seconds, in
millions a second (host clock)."""


def read(run):
    nvis = run.counters.get("nvis")
    return nvis * run.steps / run.window_s / 1e6 if nvis and run.steps else None
