"""Percent of its roofline: the least time of the window's K1 work (the
work counted by ``roofline.py``) over the device seconds of its kernels in
the profiler's trace."""

from portbench.roofline import roofline_percent


def read(run):
    ops, nbytes = run.counts.get("k1", (0, 0))
    return roofline_percent(ops, nbytes, run.families.get("k1", 0.0))
