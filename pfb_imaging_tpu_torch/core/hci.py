"""``hci``: high-cadence snapshot imaging (port of pfb_imaging_tpu/core/hci.py).

One dirty image per (time, frequency chunk) into a stacked CUBE written
chunk by chunk (a killed run keeps what it wrote), with optional synthetic
transient injection, per-frame RMS flags and per-scan products. Host
planning runs in a thread pool a few tasks ahead of the device's gridding.
IDG (B1; B2 for an injection) is the operator wherever its envelope covers
``epsilon``, planned in the device's type (the card's IDG is f32-only);
otherwise the classic ES w-stacking gridder. As in the JAX package there is
no fallback when the IDG planner refuses a snapshot: its error propagates.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import real_dtype, resolve_device, to_device, to_host
from ..models.transients import transient_spectrum
from ..ops import gridder as classic
from ..ops import gridder_idg as idg
from ..utils.logging import get_logger
from ..utils.store import TreeStore

log = get_logger("HCI")

# telemetry of the last ``hci`` call (read by chip_smoke.py)
HCI_STATS: dict = {}


def hci(xds_path, output_store, nx: int = 128, cell_rad: float | None = None, freq_chunks: int = 1,
        epsilon: float = 1e-7, do_wgridding: bool = True, inject_transient: dict | None = None,
        rms_flag_level: float | None = None, gridder: str = "auto", plan_threads: int = 4,
        per_scan_products: bool = False, *, device="cuda"):
    """Snapshot dirty cubes per (scan, frequency chunk). Writes CUBE (ntime,
    freq_chunks, nx, nx), WSUMS, TIMES, FREQS and FLAGS (and scan####/DIRTY
    + WSUM with ``per_scan_products``) to ``output_store``; returns it."""
    dev = resolve_device(device)
    rdt = real_dtype(dev)
    t_start = time.perf_counter()
    xds = TreeStore(xds_path)
    cell = cell_rad or xds.attrs["cell_rad"]
    keys = xds.groups()
    ntime = len(keys)
    freqs_all = np.asarray(xds.group(keys[0]).read("FREQ"))
    splits = np.array_split(np.arange(freqs_all.size), freq_chunks)

    use_idg = gridder == "idg" or (gridder == "auto" and epsilon >= idg.IDG_MIN_EPS)
    planner = idg.plan_idg if use_idg else classic.plan_wgridder

    out = TreeStore(output_store, mode="w")
    out.create_chunked("CUBE", (ntime, freq_chunks, nx, nx), np.float64, (1, 1, nx, nx))
    wsums = np.zeros((ntime, freq_chunks))
    times = np.zeros(ntime)
    flags = np.zeros((ntime, freq_chunks), dtype=np.uint8)
    plan_seconds = []

    def _prepare(t, c):
        t0 = time.perf_counter()
        chans = splits[c]
        g = xds.group(keys[t])
        uvw = np.asarray(g.read("UVW"))
        freqs = np.asarray(g.read("FREQ"))[chans]
        vis = np.asarray(g.read("VIS"))[:, chans]
        wgt = np.asarray(g.read("WEIGHT"))[:, chans]
        mask = np.asarray(g.read("MASK"))[:, chans]
        plan = planner(uvw, freqs, nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=epsilon, do_wgridding=do_wgridding,
                       divide_by_n=False, dtype=rdt, device=dev)
        plan_seconds.append(time.perf_counter() - t0)
        return t, c, g.attrs.get("time", float(t)), freqs, vis, wgt, mask, plan

    tasks = [(t, c) for t in range(ntime) for c in range(freq_chunks) if splits[c].size]
    scan_dirty = np.zeros((ntime, nx, nx)) if per_scan_products else None
    window = max(2, min(plan_threads, 4))
    with ThreadPoolExecutor(max_workers=max(1, plan_threads)) as pool:
        pending, ti = deque(), 0
        while ti < len(tasks) or pending:
            while ti < len(tasks) and len(pending) < window:
                pending.append(pool.submit(_prepare, *tasks[ti]))
                ti += 1
            t, c, tval, freqs, vis, wgt, mask, plan = pending.popleft().result()
            times[t] = tval
            vis_t = torch.from_numpy(np.asarray(vis)).to(dev)
            if inject_transient is not None:
                # the transient at its pixel, degridded and scaled by its spectrum
                ds = transient_spectrum(times[t : t + 1], freqs, **{
                    k: v for k, v in inject_transient.items() if k not in ("xfrac", "yfrac")})[0]
                img = torch.zeros((nx, nx), dtype=rdt, device=dev)
                img[int(inject_transient.get("xfrac", 0.5) * nx), int(inject_transient.get("yfrac", 0.5) * nx)] = 1.0
                base = idg.dirty2vis_idg(plan, img) if use_idg else classic.dirty2vis(plan, img)
                vis_t = vis_t + base * to_device(ds, dev, rdt)[None, :]
            wgt_t, mask_t = to_device(wgt, dev, rdt), to_device(mask, dev, rdt)
            if use_idg:
                dirty = idg.vis2dirty_idg(plan, vis_t.real, wgt=wgt_t * mask_t, vis_im=vis_t.imag)
            else:
                dirty = classic.vis2dirty(plan, vis_t, wgt=wgt_t, mask=mask_t)
            dirty = to_host(dirty).astype(np.float64)
            wsum_tc = float(wgt[mask.astype(bool)].sum())
            out.write_chunk("CUBE", (t, c), (dirty / max(wsum_tc, 1e-300))[None, None])
            wsums[t, c] = wsum_tc
            if scan_dirty is not None:
                scan_dirty[t] += dirty

    if rms_flag_level is not None:
        rms_all = np.asarray(out.read("CUBE")).std(axis=(2, 3))
        med = np.median(rms_all[rms_all > 0])
        flags = (rms_all > rms_flag_level * med).astype(np.uint8)

    out.write("WSUMS", wsums)
    out.write("TIMES", times)
    out.write("FREQS", freqs_all)
    out.write("FLAGS", flags)
    out.set_attrs(nx=nx, ny=nx, cell_rad=cell, ntime=ntime, nfreq_chunks=freq_chunks)
    if per_scan_products:
        for t in range(ntime):
            sg = out.group(f"scan{t:04d}")
            sg.write("DIRTY", scan_dirty[t])
            sg.write("WSUM", np.asarray([wsums[t].sum()]))
            sg.set_attrs(time=float(times[t]))
    HCI_STATS.clear()
    HCI_STATS.update(route="idg" if use_idg else "stack", tasks=len(tasks), plan_seconds=sum(plan_seconds),
                     seconds=time.perf_counter() - t_start)
    log.info("hci cube %s written", output_store)
    return out
