"""A cell's files at a tiny size, for runs on the CPU: the configuration
cut to a 10-antenna array at 64^2, the mixes to a few samples, the limits
as committed."""

from __future__ import annotations

import argparse
import time

from portbench import harness


def tiny_spec(workload: str) -> dict:
    spec = harness.cell_spec(harness.load_manifest(), workload)
    cfg = spec["config"]
    cfg.update(nant=10, ntime=12, nx=64, nx_psf=128, nsrc=4, nchan=4, nband=2)
    cfg["solver"].update(pd_maxit=30, cg_maxit=20)
    spec["traffic"].update(sample_pixels=12, models=3, model_extra_pixels=3)
    return spec


def tiny_run(workload: str, seed: int = 2**31 + 17, seconds: float = 0.2, trace: int = 0, spec=None,
             with_control: bool = False):
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    return harness.run_cell(args, time.perf_counter(), device="cpu", look_for_chip=False,
                            spec=spec or tiny_spec(workload), with_control=with_control)
