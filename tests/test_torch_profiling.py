"""The port's profiling and bring-up utilities (counterparts of
``tests/test_utils.py``'s profiling and debug tests): phase timers, the
profiler trace, the graph text and operation count of a function, memory
telemetry, the NaN/Inf trap and the host-sync guard."""

import json
import math
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from pfb_imaging_tpu_torch.ops.hessian import hessian_psf
from pfb_imaging_tpu_torch.utils.debug import assert_no_host_sync, bringup_checks
from pfb_imaging_tpu_torch.utils.profiling import (PhaseTimer, cost_analysis, device_memory_stats, lowering_text,
                                                   memory_line, trace)

torch.set_num_threads(1)


def test_phase_timer():
    t = PhaseTimer()
    with t("a"):
        time.sleep(0.01)
    with t("b"):
        time.sleep(0.02)
    assert t.totals["b"] > t.totals["a"] > 0
    lines = []
    t.report(lines.append)
    assert any("accounted" in ln for ln in lines)


def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        (torch.ones(64, dtype=torch.float64) * 2.0).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)


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
