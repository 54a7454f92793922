"""The port's in-program tracer, and its profiling utilities (the
counterparts of pfb_imaging_tpu/utils/profiling.py).

  * the recorder: ``span(name)`` (a context manager) and ``count(name, n)``
    at the program's layer boundaries, off by default (``enable`` /
    ``disable``; ``take`` hands back what was recorded and clears it). Off,
    a span costs one flag read and allocates nothing. On, a span records
    its name, its host start and end, the index of the span enclosing it
    on the same thread and the thread's id. It is the port's one report of
    what it did: kernel launches (``launch.<kernel>``), collectives
    (``collective.<kind>`` and ``.bytes``), routes taken and the phases of
    every command are counters and spans here. A span never syncs the device:
    it measures host time, and where the host waits, the wait is a span of
    its own. Stamps are ``time.time_ns()``, the Unix-epoch nanoseconds on
    which ``torch.profiler`` (kineto) stamps host and device events, so a
    span lies on the device trace as it is (CUPTI's device stamps wander on
    that clock by a few hundred microseconds);
  * ``trace``: ``torch.profiler`` around a block with the recorder on,
    writing one Chrome/Perfetto trace with the program's spans beside the
    host's and the device's events;
  * ``idle_within``: the device's idle time inside host intervals, from its
    busy intervals;
  * ``lowering_text`` / ``cost_analysis``: the aten graph of a function at
    given argument shapes (``torch.fx``) and its operation count
    (``torch.utils.flop_counter``), the counterparts of the StableHLO text
    and XLA's cost analysis;
  * ``device_memory_stats`` / ``memory_line``: device memory telemetry for
    progress lines.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch


class Span(NamedTuple):
    """A recorded span: host nanoseconds on the profiler's clock (``end_ns``
    None while it is open), the index of its parent in the same ``take``
    (None at a thread's top level) and the thread's system id (the ``tid``
    of the profiler's host events)."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    tid: int


_ON = False
_SPANS: list = []  # [name, start_ns, end_ns, parent record, tid], in start order
_COUNTS: dict = {}
_LOCK = threading.Lock()
_LOCAL = threading.local()


class _Off:
    """The span handed out while the recorder is off: one shared object."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.rec = [self.name, time.time_ns(), None, stack[-1] if stack else None, threading.get_native_id()]
        _SPANS.append(self.rec)
        stack.append(self.rec)

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _LOCAL.stack.pop()
        return False


def span(name: str):
    """A context manager recording the host time of its block as ``name``
    while the recorder is on."""
    return _On(name) if _ON else _OFF


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if _ON:
        with _LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + n


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def take() -> dict:
    """The spans (a list of :class:`Span`, in start order) and counters
    recorded since the last ``take``, which are then cleared. A span still
    open is handed back with ``end_ns`` None; one whose parent was taken
    earlier has parent None."""
    global _SPANS, _COUNTS
    with _LOCK:
        recs, counts = _SPANS, _COUNTS
        _SPANS, _COUNTS = [], {}
    index = {id(r): i for i, r in enumerate(recs)}
    spans = [Span(r[0], r[1], r[2], None if r[3] is None else index.get(id(r[3])), r[4]) for r in recs]
    return {"spans": spans, "counters": counts}


def merge_intervals(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end] pairs."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_within(busy, intervals) -> float:
    """The device's idle time inside the union of host ``intervals``: their
    length less the part the ``busy`` intervals (the device's work, sorted
    and disjoint, as :func:`merge_intervals` gives them) cover. Units are
    the inputs'."""
    starts = [b[0] for b in busy]
    idle = 0
    for s, e in merge_intervals(intervals):
        covered = 0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
        idle += (e - s) - covered
    return idle


def device_busy(prof) -> list:
    """The device's busy intervals (ns, merged) in a ``torch.profiler``
    trace: its kernels, copies and sets, not the host ranges it mirrors."""
    cuda = torch.autograd.DeviceType.CUDA
    return merge_intervals((e.start_ns(), e.start_ns() + e.duration_ns())
                           for e in prof.profiler.kineto_results.events()
                           if e.device_type() == cuda and not e.is_user_annotation())


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a block (CPU, and CUDA when there is a
    card) with the recorder on; the trace goes to ``logdir/trace.json``
    (Chrome/Perfetto) with the program's spans as complete events of
    category ``program`` on their threads (on the card each with the
    device's idle microseconds inside it) and its counters as counter
    events at the block's end. What the recorder holds at the block's end
    is taken (``take``), and it is left on or off as it was."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    Path(logdir).mkdir(parents=True, exist_ok=True)
    was_on = _ON
    enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        if not was_on:
            disable()
    end_ns = time.time_ns()
    rec = take()
    path = Path(logdir) / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    busy = device_busy(prof) if cuda else None
    pid = os.getpid()
    for i, s in enumerate(rec["spans"]):
        stop = s.end_ns if s.end_ns is not None else end_ns
        args = {"index": i, "parent": s.parent}
        if busy is not None:
            args["device_idle_us"] = idle_within(busy, [(s.start_ns, stop)]) / 1e3
        doc["traceEvents"].append({"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": s.tid,
                                   "ts": (s.start_ns - base) / 1e3, "dur": (stop - s.start_ns) / 1e3,
                                   "args": args})
    for name, value in rec["counters"].items():
        doc["traceEvents"].append({"ph": "C", "cat": "program", "name": name, "pid": pid,
                                   "ts": (end_ns - base) / 1e3, "args": {name: value}})
    path.write_text(json.dumps(doc))


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
