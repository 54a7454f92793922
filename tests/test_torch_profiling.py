"""The port's profiling and bring-up utilities (counterparts of
``tests/test_utils.py``'s profiling and debug tests): the in-program
recorder and its clock, the profiler trace with the program's spans in it,
the device's idle time inside host intervals, the spans a cell's steps
record, the graph text and operation count of a function, memory
telemetry, the NaN/Inf trap and the host-sync guard."""

import json
import math
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch_recorder import recording

from pfb_imaging_tpu_torch.ops.hessian import hessian_psf
from pfb_imaging_tpu_torch.utils import profiling
from pfb_imaging_tpu_torch.utils.debug import assert_no_host_sync, bringup_checks
from pfb_imaging_tpu_torch.utils.profiling import (cost_analysis, device_memory_stats, idle_within, lowering_text,
                                                   memory_line, merge_intervals, span, trace)

torch.set_num_threads(1)


@pytest.fixture
def recorder():
    """The recorder, empty and off before and after the test."""
    with recording():
        profiling.disable()
        yield profiling


def _spans_in(prof, name):
    """(start, end) ns of the kineto events called ``name``."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.name() == name]


def test_phase_timer(recorder):
    """The recorder: off, a span is one shared object that records and
    allocates nothing; on, spans nest (parent index, thread id) and
    counters add; ``take`` hands them back in start order and clears."""
    assert span("a") is span("b")

    def spans(n):
        for _ in range(n):
            with span("x"):
                pass

    spans(10)
    tracemalloc.start()
    try:
        spans(10_000)
        allocated = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert allocated < 2048
    recorder.count("n")
    assert recorder.take() == {"spans": [], "counters": {}}

    recorder.enable()
    with span("outer"):
        with span("inner"):
            time.sleep(0.002)
        with span("inner"):
            pass
    with span("outer2"):
        t = threading.Thread(target=spans, args=(1,))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    recorder.count("bytes", 5)
    recorder.count("bytes", 7)
    recorder.disable()
    got = recorder.take()
    names = [s.name for s in got["spans"]]
    assert names == ["outer", "inner", "inner", "outer2", "x"]
    outer, in1, in2, outer2, x = got["spans"]
    assert outer.parent is None and in1.parent == 0 and in2.parent == 0 and outer2.parent is None
    assert x.parent is None and x.tid != outer2.tid == outer.tid == threading.get_native_id()
    assert outer.start_ns <= in1.start_ns < in1.end_ns <= in2.start_ns <= in2.end_ns <= outer.end_ns
    assert in1.end_ns - in1.start_ns >= 2_000_000
    assert got["counters"] == {"bytes": 12}
    assert recorder.take() == {"spans": [], "counters": {}}

    recorder.enable()
    with span("open"):
        first = recorder.take()
        with span("child"):
            pass
    second = recorder.take()
    assert first["spans"][0].end_ns is None
    assert [s.name for s in second["spans"]] == ["child"] and second["spans"][0].parent is None


def test_a_span_is_on_the_profilers_clock(recorder):
    """A span around a ``record_function`` range under the CPU profiler
    holds that range's kineto interval."""
    from torch.profiler import ProfilerActivity, profile, record_function

    recorder.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("host"):
            time.sleep(0.001)
            with record_function("probe_range"):
                time.sleep(0.002)
            time.sleep(0.001)
    (host,) = recorder.take()["spans"]
    ((s, e),) = _spans_in(prof, "probe_range")
    assert host.start_ns <= s < e <= host.end_ns
    assert (e - s) >= 2_000_000 and (host.end_ns - host.start_ns) - (e - s) < 50_000_000


def test_trace_writes_chrome_trace(tmp_path, recorder):
    """The Chrome trace holds the host's ops and, as complete events on the
    same time base, the program's spans and counters; the recorder is left
    off as it was."""
    from torch.profiler import record_function

    with trace(str(tmp_path / "tr")):
        with span("block"):
            with record_function("probe_range"):
                (torch.ones(64, dtype=torch.float64) * 2.0).sum()
        profiling.count("things", 3)
    assert span("a") is span("b") and recorder.take() == {"spans": [], "counters": {}}  # off, and emptied
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)
    (block,) = [e for e in events if e.get("cat") == "program" and e["ph"] == "X"]
    (probe,) = [e for e in events if e.get("name") == "probe_range"]
    assert block["name"] == "block" and block["tid"] == probe["tid"] and block["args"]["parent"] is None
    assert block["ts"] <= probe["ts"] and probe["ts"] + probe["dur"] <= block["ts"] + block["dur"]
    (things,) = [e for e in events if e.get("cat") == "program" and e["ph"] == "C"]
    assert things["name"] == "things" and things["args"] == {"things": 3}


def test_idle_within_busy_intervals():
    """The device's idle time inside host intervals: their union's length
    less the part the merged busy intervals cover."""
    busy = merge_intervals([(10, 20), (15, 30), (40, 50), (45, 46), (60, 70)])
    assert busy == [[10, 30], [40, 50], [60, 70]]
    assert idle_within(busy, []) == 0
    assert idle_within(busy, [(0, 10)]) == 10
    assert idle_within(busy, [(12, 28)]) == 0
    assert idle_within(busy, [(25, 45)]) == 10  # 30..40
    assert idle_within(busy, [(0, 100)]) == 100 - 40
    assert idle_within(busy, [(25, 45), (35, 65)]) == 10 + 10  # the union 25..65: 30..40, 50..60
    assert idle_within([], [(3, 8), (5, 9)]) == 6


def _top_level(spans, prefix):
    """Seconds of the spans named ``prefix``... with no ancestor so named."""
    def nested(s):
        while s.parent is not None:
            s = spans[s.parent]
            if s.name.startswith(prefix):
                return True
        return False

    return sum(s.end_ns - s.start_ns for s in spans if s.name.startswith(prefix) and not nested(s)) / 1e9


def test_a_cells_steps_record_their_spans(recorder):
    """The spans of the benchmark's two step kinds at a tiny size on the
    CPU, the recorder on from before set-up: planning (each ``plan_idg``
    phase, the multiband plan inside the residual's cache miss, counted),
    the power method, CG and PD with one stop test an iteration, and the
    residual's host part at every call. The host's time to queue a PD
    iteration and set-up's planning seconds come out finite."""
    from portbench import cells, harness
    from portbench.tests.tiny import tiny_spec

    def kind_of(cell, seed):
        spec = tiny_spec(cell)
        return cells.STEP_KINDS[spec["traffic"]["step"]](spec["config"], spec["traffic"], seed, torch.device("cpu"),
                                                         harness.Timer(harness.Run(), lambda: None))

    kind = kind_of("meerkat_l_2k.residual", 2**31 + 5)
    recorder.enable()
    try:
        t0 = time.time_ns()
        kind.setup()
        setup_s = (time.time_ns() - t0) / 1e9
        for i in range(3):
            kind.step(i)
    finally:
        kind.cleanup()
    got = recorder.take()
    spans, names = got["spans"], [s.name for s in got["spans"]]
    counters = dict(got["counters"])
    assert counters.pop("plan.native", 0) + counters.pop("plan.numpy", 0) > 0  # the host planner's calls
    # one partition: the plan made once, then taken by the multiband route at every call
    assert counters == {"residual.plan_miss": 1, "residual.multiband_parts": 1 + 3}
    assert names.count("plan.multiband") == 1
    for part in ("", ".lookup", ".upload", ".launch", ".dirty"):
        assert names.count("residual" + part) == 1 + 3, part  # the warm call in set-up, then the steps
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.name.startswith(("residual.", "plan.idg.")):  # a plan is made on a cache miss in the lookup
            want = "residual.lookup" if s.name == "residual.plan" else s.name.rsplit(".", 1)[0]
            assert spans[s.parent].name == want, s
    assert spans[spans[names.index("plan.multiband")].parent].name == "residual.plan"
    for phase in ("geometry", "bucket", "taper", "upload"):
        assert f"plan.idg.{phase}" in names
    assert 0 < _top_level(spans, "plan.") < setup_s

    kind = kind_of("meerkat_l_2k.sara", 7)
    try:
        kind.setup()
        recorder.take()
        kind.step(0)
    finally:
        kind.cleanup()
    spans = recorder.take()["spans"]
    names = [s.name for s in spans]
    (pd,), (cg,) = [[s for s in spans if s.name == n] for n in ("pd", "cg")]
    stops = [s for s in spans if s.name == "pd.stop"]
    assert len(stops) == kind.counters["pd_iters"] and all(spans[s.parent] is pd for s in stops)
    assert names.count("cg.stop") == kind.counters["cg_iters"]
    host_ms = ((pd.end_ns - pd.start_ns) - sum(s.end_ns - s.start_ns for s in stops)) / 1e6 / len(stops)
    assert 0 < host_ms < math.inf
    assert "power" not in names and names.count("residual") == 1  # hess_norm cached; one residual a step


@pytest.mark.gpu
def test_a_span_holds_the_device_gap_on_the_card(recorder):
    """On the card, the spans and the device's trace share one clock: a
    span around a host sleep between two kernels lies in the device's idle
    gap between them (the device idles for all of it but 2 ms), and the
    gap's ends lie within 1 ms of the span's (the median of 7: a launch
    the profiler holds up moves one). CUPTI's stamps wander on the host's
    Unix-epoch clock by a few hundred microseconds (a kernel has read up
    to 133 us before the host launched it), so a tighter bound would test
    the wander, not whether the clock is shared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device's trace has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    x = torch.ones(1 << 20, device=dev)
    x.mul_(1.0)
    x.add_(0.0)  # both kernels loaded before the trace
    torch.cuda.synchronize(dev)
    recorder.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.add_(0.0)  # the profiler's first launch asks for its buffers (~1.5 ms)
        for _ in range(7):
            x.mul_(1.0)
            torch.cuda.synchronize(dev)
            with span("sleep"):
                time.sleep(0.02)
            x.add_(0.0)
        torch.cuda.synchronize(dev)
    sleeps = recorder.take()["spans"]
    busy = profiling.device_busy(prof)
    assert len(sleeps) == 7 and len(busy) >= 9
    ms = 1_000_000
    leads, lags = [], []
    for s in sleeps:
        assert idle_within(busy, [(s.start_ns, s.end_ns)]) >= (s.end_ns - s.start_ns) - 2 * ms
        leads.append(s.start_ns - max(b[1] for b in busy if b[1] <= s.start_ns + 2 * ms))
        lags.append(min(b[0] for b in busy if b[0] >= s.end_ns - 2 * ms) - s.end_ns)
    assert abs(float(np.median(leads))) < ms and abs(float(np.median(lags))) < ms, (leads, lags)


def test_lowering_text_and_cost_analysis():
    """The aten graph of a function at given shapes, and its operations: a
    matmul's 2 m n k, and FFTW's count for the PSF Hessian's rfft2/irfft2
    (2.5 N log2 n per axis for each real transform)."""
    f = lambda a, b: (a @ b).sum()  # noqa: E731
    a, b = torch.ones(8, 16, dtype=torch.float64), torch.ones(16, 4, dtype=torch.float64)
    txt = lowering_text(f, a, b)
    assert "aten.mm" in txt and "aten.sum" in txt
    ca = cost_analysis(f, a, b)
    assert ca["flops"] == 2 * 8 * 16 * 4
    x, ph = torch.ones(2, 16, 16, dtype=torch.float64), torch.ones(2, 32, 17, dtype=torch.float64)
    ca = cost_analysis(hessian_psf, x, ph, 32, 32)
    one = int(2.5 * 2 * 32 * 32 * 2 * math.log2(32))
    assert ca["by_op"] == {"aten._fft_r2c": one, "aten._fft_c2r": one} and ca["flops"] == 2 * one


def test_device_memory_stats_and_line():
    stats = device_memory_stats()
    assert len(stats) >= 1 and {"device", "bytes_in_use", "peak_bytes_in_use", "bytes_limit"} <= set(stats[0])
    if not torch.cuda.is_available():
        assert stats == [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}]
    assert memory_line().startswith("pid=") and "rss_peak=" in memory_line()


def test_bringup_nan_trap_raises_at_the_op_and_leaves_nothing():
    x = torch.tensor([1.0, 3.0], dtype=torch.float64)
    with pytest.raises(FloatingPointError, match="aten.log"):
        with bringup_checks():
            y = x * 2.0  # finite: no raise
            torch.log(x - 2.0)  # negative argument -> NaN
    assert _get_current_dispatch_mode() is None
    assert torch.isnan(torch.log(x - 2.0)).any()  # no raise after the block
    with bringup_checks():
        torch.empty(1000)  # uninitialised memory is not a result
        torch.tensor([1.0]) / 0.0  # Inf passes unless infs=True
    with pytest.raises(FloatingPointError, match="Inf in the output of aten.div"):
        with bringup_checks(nans=False, infs=True):
            torch.tensor([1.0]) / 0.0
    assert _get_current_dispatch_mode() is None
    assert np.isfinite(y.numpy()).all()


def test_assert_no_host_sync():
    """On the card a synchronising op inside the block raises; without a
    card the block runs unchecked."""
    if torch.cuda.is_available():
        x = torch.ones(4, device="cuda")
        with pytest.raises(RuntimeError):
            with assert_no_host_sync():
                float(x.sum())
        assert torch.cuda.get_sync_debug_mode() == 0
        return
    with assert_no_host_sync():
        assert float(torch.ones(4).sum()) == 4.0
