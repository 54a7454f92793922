"""The control on the card: the plain reference computed in the next lower
precision (TF32 products, bfloat16 transform operands) in the program's
place comes out not correct against the committed limits, in every cell, at
a size a test run holds. The cells' own size is measured by
``portbench/control.py`` (PERF.md)."""

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_spec

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products exist only there")
    import argparse
    import time

    spec = tiny_spec(cell)
    spec["config"].update(nant=24, ntime=40, nx=256, nx_psf=512)
    args = argparse.Namespace(workload=cell, seed=2**31 + 5, seconds=0.5, trace=0)
    rc, res = harness.run_cell(args, time.perf_counter(), spec=spec, with_control=True)
    assert rc == 0 and res["correct"], res["checks"]
    ok, checks = harness.judge(res["control"], spec["limits"])
    assert not ok, checks
