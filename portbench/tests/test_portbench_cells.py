"""Every cell's set-up, steps and check at a tiny size on the CPU, and the
check seeing ``correct`` come out false with the timed path broken
underneath, once for each fault a cell can have: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, and an answer altered where it is produced. (No cell spans chips, so
none can leave out an exchange between them.) The limits are the committed
ones."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_run, tiny_spec

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_at_a_tiny_size_is_correct(cell):
    rc, res = tiny_run(cell)
    assert rc == 0 and res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in harness.reported_metrics(harness.load_manifest(), cell, False)}
    assert set(res["metrics"]) == names and all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(cell):
    rc, res = tiny_run(cell, trace=1)
    assert rc == 0 and res["correct"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    # a CPU run has no device trace: the device readers return nothing
    for name, m in res["metrics"].items():
        assert not name.startswith(("idle.", "b1_", "b2_", "k1_", "k2_")), name


@pytest.mark.parametrize("cell", CELLS)
def test_the_faults_read_at_a_runs_size_are_not_correct(cell):
    rc, res = tiny_run(cell, with_control=True)
    assert rc == 0 and res["correct"] and set(res["faults"]) == {"unchanged", "half", "altered"}
    for fault, readings in res["faults"].items():
        assert not harness.judge(readings, tiny_spec(cell)["limits"])[0], (fault, readings)


def test_a_traced_run_keeps_the_spans_of_its_window_alone():
    timer = harness.Timer(harness.Run(traced=True), lambda: None)
    with timer.span("a"):
        pass
    timer.recording = False
    with timer.span("a"):
        pass
    assert len(timer.run.spans["a"]) == 1


def _residual_fault(monkeypatch, fault):
    import pfb_imaging_tpu_torch.core.imager as TI

    orig = TI.residual_from_parts_multiband
    armed = {"on": False}

    def broken(dt, keys, model, *a, **kw):
        out = orig(dt, keys, model, *a, **kw)
        if not armed["on"]:
            return out
        if fault == "unchanged":  # the state (DIRTY) handed back untouched
            return torch.stack([torch.as_tensor(np.asarray(dt.group(k).read("DIRTY")), dtype=out.dtype)
                                for k in keys])
        if fault == "half":  # half the bands left out, their mean taken from the rest
            out = out.clone()
            half = out.shape[0] // 2
            out[half:] = out[:half].mean(0, keepdim=True)
            return out
        return out * (1.0 + 1e-3)  # an answer altered where it is made

    monkeypatch.setattr(TI, "residual_from_parts_multiband", broken)
    return armed


def _arm_after_setup(monkeypatch, armed, kind_cls):
    setup = kind_cls.setup

    def armed_setup(self):
        setup(self)
        armed["on"] = True

    monkeypatch.setattr(kind_cls, "setup", armed_setup)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_residual_faults_are_not_correct(monkeypatch, fault):
    from portbench import cells

    armed = _residual_fault(monkeypatch, fault)
    _arm_after_setup(monkeypatch, armed, cells.Residual)
    rc, res = tiny_run("meerkat_l_2k.residual")
    assert rc == 0 and not res["correct"] and res["failed"] == res["attempted"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_major_cycle_faults_are_not_correct(monkeypatch, fault):
    from pfb_imaging_tpu_torch.deconv import pfb

    from portbench import cells

    armed = {"on": False}
    backward = pfb.PFBSolver.backward

    def broken(self, lam):
        x0 = self._model.clone()
        x = backward(self, lam)
        if not armed["on"]:
            return x
        if fault == "unchanged":  # the model handed back as it came in
            self._model = x0
        elif fault == "half":
            x = x.clone()
            half = x.shape[0] // 2
            x[half:] = x[:half].mean(0, keepdim=True)
            self._model = x
        return self._model

    if fault == "altered":  # the cycle's answer, the residual, altered where it is made
        _residual_fault(monkeypatch, "altered")["on"] = True
    else:
        monkeypatch.setattr(pfb.PFBSolver, "backward", broken)
    _arm_after_setup(monkeypatch, armed, cells.MajorCycle)
    rc, res = tiny_run("meerkat_l_2k.sara")
    assert rc == 0 and not res["correct"] and res["failed"] == res["attempted"], res["checks"]
