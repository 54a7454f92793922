"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration under ``configs/``, its traffic mix
under ``traffic/`` (a data file whose ``step`` names one of the generator's
step kinds in ``cells.py``), its limits under ``limits/``, and one reader a
metric under ``metrics/``. A later cell, configuration, mix or metric is a
new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in the process that prints
# the result: JAX, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pfb_imaging_tpu")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    each module's name compared up to its first dot, as a whole word."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(manifest: dict, workload: str, here: Path = HERE) -> dict:
    """The cell's entry, configuration, traffic mix and limits."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {', '.join(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return dict(cell=cell, config=json.loads((ROOT / cfg_entry["file"]).read_text()),
                traffic=json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text()),
                limits=json.loads((here / "limits" / f"{workload}.json").read_text()))


def reported_metrics(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` off) or per-layer metrics
    (``trace`` on): those that list the cell. (Every per-layer metric here
    lists its cells.)"""
    group = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What the metric readers read: the window's length and steps, the
    spans (host-clock seconds, each ending in a device sync when traced) and
    counters of the window's steps, and, when traced, the work counts of the
    kernels in the steps the profiler covered after the window, their wall
    time, and the device trace's busy seconds and kernel seconds by family
    in them."""

    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    spans: dict = dataclasses.field(default_factory=lambda: defaultdict(list))
    counters: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    counts: dict = dataclasses.field(default_factory=dict)
    busy_s: float | None = None
    traced_s: float = 0.0
    traced_steps: int = 0
    families: dict = dataclasses.field(default_factory=dict)
    traced: bool = False


class Timer:
    """Spans of the window's steps: host-clock seconds of a named part of a
    step, ending in a device sync, kept in a traced run while ``recording``
    (the spans of an untraced run are not read, and it does not sync)."""

    def __init__(self, run: Run, sync):
        self.run, self.sync, self.recording = run, sync, True

    def span(self, name: str):
        timer = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                if timer.run.traced and timer.recording:
                    timer.sync()
                    timer.run.spans[name].append(time.perf_counter() - self.t0)
                return False

        return _Span()


def io_written() -> dict:
    """Bytes this process handed to write() (``wchar``) and caused to be
    written to storage (``write_bytes``) so far, where the system tells."""
    try:
        rows = dict(line.split(": ") for line in Path("/proc/self/io").read_text().splitlines())
    except OSError:
        return {}
    return {k: int(rows[k]) for k in ("wchar", "write_bytes") if k in rows}


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the card, printed beside the
    rooflines' peaks (a card set below 700 W runs slower under load)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, lines): each reading beside its limit; a reading that is not
    finite, is missing or exceeds its limit is not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(args, t_start: float, device: str = "cuda", look_for_chip: bool = True, spec: dict | None = None,
             with_control: bool = False) -> tuple:
    """One run. Returns (exit code, result dict or None). ``look_for_chip``
    off and ``device`` "cpu" let the tests drive a run at a tiny size; a
    ``spec`` given replaces the cell's files; ``with_control`` adds the
    control's readings (the reference in the lower precision in the
    program's place) under ``control``, and each fault's under ``faults``."""
    import torch

    from . import cells, roofline
    from .devtrace import read_trace

    manifest = load_manifest()
    spec = spec or cell_spec(manifest, args.workload)
    chips = spec["cell"]["chips"]
    if look_for_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"no card: this cell needs {chips} CUDA device(s), torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3, None
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    run = Run(traced=bool(args.trace))
    timer = Timer(run, sync)
    kind = cells.STEP_KINDS[spec["traffic"]["step"]](spec["config"], spec["traffic"], args.seed, dev, timer)
    try:
        kind.setup()
        sync()
        run.setup_s = time.perf_counter() - t_start
        run.spans.clear()  # set-up's warm steps are not the window's
        t0 = time.perf_counter()
        while True:
            kind.step(run.steps)
            run.steps += 1
            if time.perf_counter() - t0 >= args.seconds:
                break
        sync()
        run.window_s = time.perf_counter() - t0
        run.counters.update(kind.counters)  # the window's, before any traced step
        breakdown = None
        if run.traced:
            # the profiler covers the mix's ``trace_steps`` further steps,
            # apart from the window whose spans the readers take; on the card
            # it records the device's activity and the CUDA calls alone
            timer.recording = False
            acts = [torch.profiler.ProfilerActivity.CUDA if on_card else torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts) as prof:
                t1 = time.perf_counter()
                for _ in range(int(spec["traffic"].get("trace_steps", 1))):
                    kind.step(run.steps + run.traced_steps)
                    run.traced_steps += 1
                sync()
                run.traced_s = time.perf_counter() - t1
            tr = read_trace(prof)
            run.families, breakdown = tr["families"], tr["breakdown"]
            run.busy_s = tr["busy_s"] if on_card else None  # no device number from a CPU run
            run.counts = kind.work_counts(run.traced_steps)
            del prof
        memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
        t_trace = time.perf_counter()
        answers = kind.answers()
        kind.free_program()
        readings, per_step = kind.check(answers)
        control = kind.control() if with_control else None
        t_check = time.perf_counter()
        peaks = dict(tf32_flops=roofline.TF32_FLOPS, hbm_bytes_per_s=roofline.HBM_BYTES_PER_S,
                     card=card_line() if on_card else None)
        steps_s = dict(window=run.window_s / run.steps, traced=run.traced_s / run.traced_steps if run.traced_steps
                       else None)
        print("portbench run: " + json.dumps(dict(setup_s=run.setup_s, window_s=run.window_s, steps=run.steps,
                                                  step_s=steps_s, traced_steps=run.traced_steps,
                                                  check_s=t_check - t_trace, written=io_written(), peaks=peaks,
                                                  **kind.diagnostics())), file=sys.stderr)
        # each fault's readings at this size, judged against the same reference
        faults = {f: kind.check(kind.faulted(answers, f))[0] for f in cells.FAULTS} if with_control else None
    finally:
        kind.cleanup()
    found = forbidden_loaded()
    if found:
        print(f"forbidden modules loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 4, None
    correct, checks = judge(readings, spec["limits"])
    failed = sum(not judge(p, {k: v for k, v in spec["limits"].items() if k in p})[0] for p in per_step)
    if not correct and not failed:
        failed = run.steps + run.traced_steps  # a set-up number failed: every step stands on it
    metrics = {}
    for m in reported_metrics(manifest, args.workload, run.traced):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if on_card else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if on_card else "cpu", "count": chips,
                  "memory_peak_bytes": memory_peak}
    if run.traced:
        device_rec.update(busy_s=run.busy_s, window_s=run.traced_s)
    result = {"correct": bool(correct), "attempted": run.steps + run.traced_steps, "failed": failed,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control is not None:
        result["control"], result["faults"] = control, faults
    result["checks"] = checks
    return 0, result
