"""Reading a ``torch.profiler`` trace of the window from its raw events:
the device's busy seconds (the union of its intervals, as
``chip_smoke.device_busy_ms`` takes it), each kernel family's device
seconds, the device operations that took most time (as
``chip_smoke.top_device_ops``), and the longest idle gaps, each named by
the innermost host call traced across it (on the card, a CUDA runtime
call) or else by the device operation that ends it."""

from __future__ import annotations

import bisect
from collections import defaultdict

# kernel families of the roofline metrics: a kernel whose name holds the
# key belongs to the family (K1 is its chunk sums and its assembly)
FAMILIES = (("b1", "patches_from_vals"), ("b2", "vals_from_patches"), ("k1", "idg_assemble"),
            ("k1", "idg_chunk_sums"), ("k2", "idg_extract"))
TOP = 10
# idle gaps named, the longest first, and host operations looked back
# through for the one running across a gap
GAPS = 500
SCAN = 4096


def read_trace(prof) -> dict:
    """busy_s, families {family: device s}, breakdown {device_ops, idle_gaps}."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == cuda and not e.is_user_annotation():  # the device's own work, not mirrored host ranges
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif kind == cpu:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    dev.sort()
    busy, merged = 0, []
    for s, t, name in dev:
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                busy += t - merged[-1][1]
                merged[-1][1] = t
        else:
            busy += t - s
            merged.append([s, t, name])
    by_name: dict = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) / 1e9
    families: dict = defaultdict(float)
    for name, sec in by_name.items():
        fam = next((f for f, key in FAMILIES if key in name.lower()), None)
        if fam is not None:
            families[fam] += sec
    device_ops = sorted(([n[:80], sec] for n, sec in by_name.items()), key=lambda r: -r[1])[:TOP]
    gaps = sorted(((merged[i][1], merged[i + 1][0], merged[i + 1][2]) for i in range(len(merged) - 1)
                   if merged[i + 1][0] > merged[i][1]), key=lambda g: g[0] - g[1])[:GAPS]
    host.sort()
    starts = [h[0] for h in host]
    idle: dict = defaultdict(float)
    for g0, g1, after in gaps:
        # the innermost host call across the gap's middle is the one that
        # started last among those still running
        mid, name = (g0 + g1) // 2, f"before:{after[:72]}"
        i = bisect.bisect_right(starts, mid) - 1
        for h in host[max(0, i - SCAN) : i + 1][::-1]:
            if h[1] >= mid:
                name = f"host:{h[2][:72]}"
                break
        idle[name] += (g1 - g0) / 1e9
    idle_gaps = sorted(([n, sec] for n, sec in idle.items()), key=lambda r: -r[1])[:TOP]
    return dict(busy_s=busy / 1e9, families=dict(families),
                breakdown={"device_ops": device_ops, "idle_gaps": idle_gaps})
