"""Tracing and per-phase timing (port of pfb_imaging_tpu/utils/profiling.py).

  * ``PhaseTimer``: accumulating wall-clock phase timers with a
    fraction-of-total report (a copy);
  * ``trace``: ``torch.profiler`` around a block, writing a Chrome/Perfetto
    trace;
  * ``lowering_text`` / ``cost_analysis``: the aten graph of a function at
    given argument shapes (``torch.fx``) and its operation count
    (``torch.utils.flop_counter``), the counterparts of the StableHLO text
    and XLA's cost analysis;
  * ``device_memory_stats`` / ``memory_line``: device memory telemetry for
    progress lines.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from pathlib import Path

import torch


class PhaseTimer:
    """Accumulating named phase timers.

    Usage::
        t = PhaseTimer()
        with t("grid"): ...
        with t("fft"): ...
        t.report(log.info)
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t

    def report(self, emit=print) -> None:
        ttot = time.time() - self._t0
        emit(f"timing breakdown (fraction of {ttot:.3f}s):")
        acc = 0.0
        for name, v in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            emit(f"  {name:<14} {v / ttot:.3f}")
            acc += v
        emit(f"  {'accounted':<14} {acc / ttot:.3f}")


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a block (CPU, and CUDA when there is a
    card); the trace goes to ``logdir/trace.json`` (Chrome/Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def lowering_text(fn, *args, **kwargs) -> str:
    """The aten-level graph of ``fn`` at the given arguments' shapes
    (``torch.fx`` tracing through the dispatcher)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(lambda *a: fn(*a, **kwargs))(*args).code


def _fft_flops(in_shape, dim, *_, out_shape=None, **__) -> int:
    """FFTW's count for a transform over ``dim``: 5 N log2(n) flops per
    complex transform of N points of length n along each axis, half of it
    for a real input or output (the larger of in and out sizes)."""
    big = max(math.prod(in_shape), math.prod(out_shape))
    return int(2.5 * big * sum(math.log2(max(in_shape[d], out_shape[d], 2)) for d in dim))


def _fft_c2c_flops(in_shape, dim, *_, out_shape=None, **__) -> int:
    return int(5.0 * math.prod(in_shape) * sum(math.log2(max(in_shape[d], 2)) for d in dim))


def cost_analysis(fn, *args, **kwargs) -> dict:
    """Operations of one call of ``fn`` on these arguments:
    ``torch.utils.flop_counter`` (matmuls, convolutions, attention) plus
    FFTW's count for FFTs; ``flops`` the total, ``by_op`` per aten op."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    mapping = {aten._fft_r2c: _fft_flops, aten._fft_c2r: _fft_flops, aten._fft_c2c: _fft_c2c_flops}
    counter = FlopCounterMode(display=False, custom_mapping=mapping)
    with counter:
        fn(*args, **kwargs)
    by_op = {str(k): int(v) for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()), "by_op": by_op}


def device_memory_stats() -> list[dict]:
    """Per-device memory telemetry: one dict per CUDA device with
    bytes_in_use / peak_bytes_in_use (the caching allocator's) and
    bytes_limit (the card's memory); without a card, one ``"cpu"`` entry
    whose figures are None."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i}", "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                    "bytes_limit": torch.cuda.get_device_properties(i).total_memory})
    return out


def memory_line() -> str:
    """One-line memory telemetry for the commands' progress logs: host peak RSS
    plus device memory where there is a card."""
    parts = [f"pid={os.getpid()}"]
    try:
        import resource

        parts.append(f"rss_peak={resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}GB")
    except ImportError:
        pass
    for d in device_memory_stats():
        if d.get("bytes_in_use"):
            parts.append(f"hbm={d['bytes_in_use'] / 2**30:.2f}GB")
        if d.get("peak_bytes_in_use"):
            parts.append(f"hbm_peak={d['peak_bytes_in_use'] / 2**30:.2f}GB")
    return " ".join(parts)
