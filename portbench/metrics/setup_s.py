"""Seconds from process start to the first timed step (host clock)."""


def read(run):
    return run.setup_s
