"""The 16-band cell ``meerkat_l_1k16.sara`` on the CPU, and the counters of
the port's band loops.

The cell's run keeps its 16 one-channel bands and SARA's nine bases and cuts
the rest (10 antennas, 12 samples, 64^2); it runs in a process of its own,
as the benchmark does, since this suite's process loads JAX. It must be
``correct`` under the committed limits, and each fault the check reads at a
run's size must not be."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELL = "meerkat_l_1k16.sara"
MAN = harness.load_manifest()
LAYER_LISTS = ("cycle_s", "pd_ms.sara", "cg_ms.sara", "residual_s.sara", "idle.sara")

RUN = """
import argparse, json, sys, time
sys.path.insert(0, %r)
import torch
torch.set_num_threads(2)
from portbench import harness
spec = harness.cell_spec(harness.load_manifest(), %r)
spec["config"].update(nant=10, ntime=12, nx=64, nx_psf=128, nsrc=4, nchan=16)
spec["config"]["solver"].update(pd_maxit=30, cg_maxit=20)
spec["traffic"].update(sample_pixels=12)
args = argparse.Namespace(workload=%r, seed=2**31 + 17, seconds=0.2, trace=0)
rc, res = harness.run_cell(args, time.perf_counter(), device="cpu", look_for_chip=False, spec=spec,
                           with_control=True)
print(json.dumps(dict(rc=rc, res=res, config=spec["config"])))
""" % (str(ROOT), CELL, CELL)


@pytest.fixture(scope="module")
def tiny():
    out = subprocess.run([sys.executable, "-c", RUN], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_tiny_16_band_run_is_correct(tiny):
    cfg, res = tiny["config"], tiny["res"]
    assert cfg["nband"] == cfg["nchan"] == 16 and len(cfg["solver"]["bases"].split(",")) == 9
    assert tiny["rc"] == 0 and res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {k: c["limit"] for k, c in res["checks"].items()} == harness.cell_spec(MAN, CELL)["limits"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_each_fault_of_a_tiny_16_band_run_is_not_correct(tiny, fault):
    readings = tiny["res"]["faults"][fault]
    assert not harness.judge(readings, harness.cell_spec(MAN, CELL)["limits"])[0], readings


def test_the_manifest_lists_the_cell_on_one_chip():
    cell = {w["name"]: w for w in MAN["workloads"]}[CELL]
    assert cell["config"] == "meerkat_l_1k16" and cell["traffic"] == "sara" and cell["chips"] == 1
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (CELL in m.get("workloads", [CELL])) == (m["name"] in LAYER_LISTS + ("setup_s",)), m["name"]
    entry = {c["name"]: c for c in MAN["configs"]}["meerkat_l_1k16"]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert set(entry["reduced"]) <= set(cfg["source_values"]) and cfg["nband"] == 16
    limits = harness.cell_spec(MAN, CELL)["limits"]
    assert sorted(limits) == sorted(harness.cell_spec(MAN, "meerkat_l_2k.sara")["limits"])


def _solver(nband=16, nx=64):
    from pfb_imaging_tpu_torch.deconv.presets import make_sara

    nxp = 2 * nx
    rng = np.random.default_rng(5)
    psf = np.zeros((nband, nxp, nxp))
    psf[:, 0, 0] = 1.0
    psf[:, :3, :3] += 0.1 * rng.random((nband, 3, 3))
    abspsfhat = np.abs(np.fft.rfft2(psf))[:, None]
    geometry = dict(nx=nx, ny=nx, nx_psf=nxp, ny_psf=nxp)
    zeros = np.zeros((nband, nx, nx))
    opts = dict(bases="self,db1,db2,db3,db4,db5,db6,db7,db8", nlevels=2, pd_maxit=1, pd_tol=0.0, cg_maxit=3,
                hess_norm=1.2, verbosity=0)
    solver = make_sara(abspsfhat, np.ones(nband), geometry, zeros, zeros, opts, device="cpu")
    solver.first(torch.as_tensor(rng.standard_normal((nband, nx, nx))))
    solver.forward(None)
    return solver


def test_the_band_loops_count_their_bands():
    from torch_recorder import recording

    from pfb_imaging_tpu_torch.utils import profiling

    off = _solver().backward(0.01).clone()
    solver = _solver()
    with recording() as pd:
        on = solver.backward(0.01).clone()  # one PD iteration
    with recording() as hess:
        solver.hess.dot(on)  # one Hessian application
    assert solver.backward_alg.niter_last == 1
    # the dual update's band sum and the stop test's (its three terms'
    # per-band reductions, then their band sum); the gradient's Hessian;
    # Psi's synthesis of the iteration's 2 vn - v
    assert pd["counters"] == {"band.sum": 2 * 16, "band.dots": 3 * 16, "hess.band": 16, "psi.extrap": 1}
    assert hess["counters"] == {"hess.band": 16}
    assert torch.equal(on, off) and bool(on.abs().sum() > 0)
    assert not profiling.enabled() and profiling.take()["counters"] == {}
