#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pfb_imaging_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as a JSON line; any failed check raises and the run
exits non-zero:
  1. device  — card name, ``nvidia-smi`` name and power limit, kernel build
               (nvcc, sm_90a) and its seconds;
  2. kernels — the CUDA kernels B1 (patches_from_vals) and B2
               (vals_from_patches) against their plain PyTorch versions for
               S in {16, 24, 32} at ng = 4096: f64 plain (rel Linf <= 2e-6),
               f32 plain (<= 1e-5), and the adjoint identity (<= 1e-5);
  3. accuracy — the port's f32 ``vis2dirty_idg`` at 256^2, 100k vis and
               epsilon 1e-7 against a direct f64 DFT on the card, within the
               plan's ``delivered_accuracy`` budgets;
  4. main_path — a synthetic 64-antenna array (2016 baselines x 500 times,
               4 bands x 4 channels over 856-1712 MHz, 16M visibilities),
               a seeded point-source sky plus noise summed directly on the
               card, DIRTY and PSF gridded by the port, a .dt tree in the
               imager's schema, then ``deconv(niter=3, epsilon=1e-7)`` in f32
               at 2048^2 with a 4096^2 PSF. Launch counters are zeroed right
               before ``deconv`` and must have risen after it; the rms must
               fall. B1/B2 are also held against their f64 plain versions
               (rel Linf <= 2e-6) on the first band's plan at its own ng;
  5. profile — at the main path's shapes, CUDA-event ms of the PSF Hessian
               matvec, Psi.dot/hdot and the dual update, then 20 primal-dual
               and 20 CG iterations on the host clock and under
               ``torch.profiler``: device busy ms and idle share per loop.
Then the kernel summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
LIGHTSPEED = 299792458.0
REPLACES = {
    "patches_from_vals": "pfb_imaging_tpu/ops/idg_fused.py:253",
    "vals_from_patches": "pfb_imaging_tpu/ops/idg_fused.py:329",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_linf(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fitted_wc(S: int, dev, dtype):
    """A production taper-DFT factor W diag(c) as (2, S, S): the 2048^2
    plan's fit at the tier's epsilon."""
    import torch

    from pfb_imaging_tpu_torch.ops.gridder_idg import fit_taper

    half = S // 2
    eps = 1e-5 if S == 16 else 1e-7
    nbig = {16: 3600, 24: 3600, 32: 3072}[S]
    c, _, _ = fit_taper(S, half, 2048 / (2.0 * nbig) + 0.01, 0.1, tol=0.25 * eps)
    w = np.exp(-2j * np.pi * np.outer(np.arange(S), np.arange(S)) / S) * c[None, :]
    return torch.as_tensor(np.stack([w.real, w.imag]), device=dev).to(dtype)


def phase_kernels(dev, ng: int = 4096):
    """B1/B2 against their plain versions in f64 and f32, and the adjoint."""
    import torch

    from pfb_imaging_tpu_torch.ops import idg_fused as F

    out = {}
    for S in (16, 24, 32):
        rng = np.random.default_rng(S)
        tfac, half = 2 * np.pi / S, S // 2
        k0 = (S - half) // 2
        scal = np.stack([
            tfac * (k0 + half * rng.random((ng, F.G))), 0.005 * rng.standard_normal((ng, F.G)),
            tfac * (k0 + half * rng.random((ng, F.G))), 0.005 * rng.standard_normal((ng, F.G)),
        ])
        sc = torch.as_tensor(scal, device=dev).float()
        va = torch.as_tensor(rng.standard_normal((2, ng, F.G)), device=dev).float()
        wu = fitted_wc(S, dev, torch.float32)
        wv = wu.flip(-1).contiguous()
        y = torch.as_tensor(rng.standard_normal((2, ng, S, S)), device=dev).float()
        p = F.patches_from_vals(sc, va, wu, wv, S)
        v = F.vals_from_patches(y, sc, wu, wv, S)
        torch.cuda.synchronize()
        d64 = [a.double() for a in (sc, va, wu, wv, y)]
        p64 = F.patches_from_vals_ref(d64[0], d64[1], d64[2], d64[3], S)
        v64 = F.vals_from_patches_ref(d64[4], d64[0], d64[2], d64[3], S)
        p32 = F.patches_from_vals_ref(sc, va, wu, wv, S)
        v32 = F.vals_from_patches_ref(y, sc, wu, wv, S)
        lhs = float((p.double() * d64[4]).sum())
        rhs = float((d64[1] * v.double()).sum())
        rec = dict(
            S=S, ng=ng,
            b1_rel_vs_f64=rel_linf(p.double(), p64), b2_rel_vs_f64=rel_linf(v.double(), v64),
            b1_rel_vs_f32=rel_linf(p, p32), b2_rel_vs_f32=rel_linf(v, v32),
            b1_max_abs_err=float((p.double() - p64).abs().max()), b2_max_abs_err=float((v.double() - v64).abs().max()),
            adjoint_rel=abs(lhs - rhs) / abs(lhs),
            b1_ms=cuda_ms(lambda: F.patches_from_vals(sc, va, wu, wv, S), 20),
            b1_plain_ms=cuda_ms(lambda: F.patches_from_vals_ref(sc, va, wu, wv, S), 5),
            b2_ms=cuda_ms(lambda: F.vals_from_patches(y, sc, wu, wv, S), 20),
            b2_plain_ms=cuda_ms(lambda: F.vals_from_patches_ref(y, sc, wu, wv, S), 5),
        )
        emit({"phase": "kernels", **rec})
        require(rec["b1_rel_vs_f64"] <= 2e-6 and rec["b2_rel_vs_f64"] <= 2e-6, f"S={S} kernel vs f64 plain")
        require(rec["b1_rel_vs_f32"] <= 1e-5 and rec["b2_rel_vs_f32"] <= 1e-5, f"S={S} kernel vs f32 plain")
        require(rec["adjoint_rel"] <= 1e-5, f"S={S} adjoint identity")
        out[S] = rec
    return out


def bench_coords(rng, nrow: int, nchan: int):
    """The TPU bench's layout: uvw uniform within +-16 km, w compressed x0.01."""
    uvw = rng.uniform(-16000, 16000, (nrow, 3))
    uvw[:, 2] *= 0.01
    return uvw, np.linspace(1.0e9, 1.1e9, nchan)


def dft_dirty(uvw, freq, vis, nx: int, cell: float, dev, chunk: int = 1024):
    """Direct f64 adjoint DFT on the card: dirty = sum Re(V e^{+2 pi i phase}),
    phase = (u l - v m - w (n-1)) nu / c (the pinned convention, no 1/n)."""
    import torch

    c = (torch.arange(nx, device=dev, dtype=torch.float64) - nx // 2) * cell
    ll, mm = torch.meshgrid(c, c, indexing="ij")
    lmn = torch.stack([ll.ravel(), -mm.ravel(), -(torch.sqrt(1.0 - ll**2 - mm**2) - 1.0).ravel()])
    u = torch.as_tensor(uvw, device=dev, dtype=torch.float64)
    v = torch.as_tensor(vis, device=dev)
    acc = torch.zeros(nx * nx, dtype=torch.float64, device=dev)
    for f, nu in enumerate(freq):
        for s in range(0, u.shape[0], chunk):
            ph = (2.0 * np.pi * nu / LIGHTSPEED) * (u[s : s + chunk] @ lmn)
            vv = v[s : s + chunk, f]
            acc += vv.real @ torch.cos(ph) - vv.imag @ torch.sin(ph)
    return acc.reshape(nx, nx)


def phase_accuracy(dev, nrow: int = 50_000, nchan: int = 2, nx: int = 256, eps: float = 1e-7):
    """f32 IDG vis2dirty on the card against a direct f64 DFT on the card."""
    import torch

    from pfb_imaging_tpu_torch.ops.gridder_idg import delivered_accuracy, plan_idg, vis2dirty_idg

    rng = np.random.default_rng(5)
    uvw, freq = bench_coords(rng, nrow, nchan)
    cell = 8e-6 * 1024 / nx
    vis = rng.standard_normal((nrow, nchan)) + 1j * rng.standard_normal((nrow, nchan))
    plan = plan_idg(uvw, freq, nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=eps, device=dev)
    d = vis2dirty_idg(plan, torch.as_tensor(vis.real, device=dev).float(),
                      vis_im=torch.as_tensor(vis.imag, device=dev).float()).double()
    ref = dft_dirty(uvw, freq, vis, nx, cell, dev)
    err = (d - ref).abs() / ref.abs().max()
    q = nx // 4
    budget = delivered_accuracy(plan)
    rec = dict(nx=nx, nvis=nrow * nchan, epsilon=eps, subgrid=plan.S, nbins=plan.nbins,
               rel_linf=float(err.max()), rel_linf_inner=float(err[q:-q, q:-q].max()),
               budget_inner=budget["interior"], budget_edge=budget["edge"], edge_amp=budget["edge_amp"])
    emit({"phase": "accuracy", **rec})
    require(all(np.isfinite([rec["rel_linf"], rec["rel_linf_inner"]])), "accuracy finite")
    require(rec["rel_linf_inner"] < budget["interior"], "interior accuracy within delivered_accuracy")
    require(rec["rel_linf"] < budget["edge"], "edge accuracy within delivered_accuracy")
    return rec


def synth_array(nant: int, ntime: int, seed: int):
    """uvw (ntime*nbl, 3) of a random array: antennas uniform in an 8 km
    disc (baselines within 16 km), hour angles over 8 h at dec -30 deg,
    w compressed x0.01 (the near-coplanar layout of the TPU bench)."""
    rng = np.random.default_rng(seed)
    r = 8000.0 * np.sqrt(rng.random(nant))
    th = 2 * np.pi * rng.random(nant)
    xy = np.stack([r * np.cos(th), r * np.sin(th)], -1)
    a1, a2 = np.triu_indices(nant, 1)
    bx, by = (xy[a1] - xy[a2]).T
    h = np.linspace(-np.pi / 3, np.pi / 3, ntime)[:, None]
    sd, cd = np.sin(np.deg2rad(-30.0)), np.cos(np.deg2rad(-30.0))
    u = np.sin(h) * bx + np.cos(h) * by
    v = -sd * np.cos(h) * bx + sd * np.sin(h) * by
    w = 0.01 * (cd * np.cos(h) * bx - cd * np.sin(h) * by)
    return np.stack([u.ravel(), v.ravel(), w.ravel()], -1)


def sky_vis(uvw_d, freq, srcs, cell: float, nx: int, noise: float, gen):
    """Point-source visibilities summed on the card in f64, plus complex
    Gaussian noise; returned as (re, im) f32 tensors (nrow, nchan)."""
    import torch

    dev = uvw_d.device
    nu = torch.as_tensor(freq, device=dev, dtype=torch.float64) / LIGHTSPEED
    re = torch.zeros((uvw_d.shape[0], len(freq)), dtype=torch.float64, device=dev)
    im = torch.zeros_like(re)
    for p, q, flux in srcs:
        l, m = (p - nx // 2) * cell, (q - nx // 2) * cell
        geo = uvw_d @ torch.tensor([l, -m, -(np.sqrt(1.0 - l * l - m * m) - 1.0)], dtype=torch.float64, device=dev)
        ph = -2.0 * np.pi * geo[:, None] * nu[None, :]
        re += flux * torch.cos(ph)
        im += flux * torch.sin(ph)
    re += noise * torch.randn(re.shape, generator=gen, device=dev, dtype=torch.float64)
    im += noise * torch.randn(im.shape, generator=gen, device=dev, dtype=torch.float64)
    return re.float(), im.float()


def phase_main(dev, workdir: Path, nx: int = 2048, nant: int = 64, ntime: int = 500, nband: int = 4,
               nchan_band: int = 4, niter: int = 3, eps: float = 1e-7, seed: int = 42, nsrc: int = 24):
    """Build a .dt tree on the card with the port's gridding, then deconv."""
    import torch

    from pfb_imaging_tpu_torch.core import deconv as tdeconv
    from pfb_imaging_tpu_torch.core.imager import IDG_MAX_SLOT_FACTOR, PLAN_STATS
    from pfb_imaging_tpu_torch.ops import idg_fused as F
    from pfb_imaging_tpu_torch.ops.gridder_idg import (
        _idg_prepare, hessian_vis_idg, plan_idg, to_group_layout, vis2dirty_idg,
    )

    nx_psf = 2 * nx
    cell = 8e-6 * 1024 / nx
    uvw = synth_array(nant, ntime, seed)
    edges = np.linspace(856e6, 1712e6, nband * nchan_band + 1)
    chans = 0.5 * (edges[:-1] + edges[1:])
    rng = np.random.default_rng(seed)
    srcs = [(int(p), int(q), float(f)) for p, q, f in zip(
        rng.integers(nx // 4, 3 * nx // 4, nsrc), rng.integers(nx // 4, 3 * nx // 4, nsrc), rng.uniform(0.1, 1.0, nsrc))]
    gen = torch.Generator(device=dev).manual_seed(seed)
    nvis = uvw.shape[0] * chans.size
    rec = dict(nx=nx, nx_psf=nx_psf, nband=nband, nrow=uvw.shape[0], nvis=nvis, epsilon=eps, cell_rad=cell)
    emit({"phase": "main_path", "stage": "layout", **rec})

    if workdir.exists():
        shutil.rmtree(workdir)
    dt_path = workdir / "smoke.dt"
    root = tdeconv.TreeStore(dt_path, mode="w")  # the tree format deconv reads
    uvw_d = torch.as_tensor(uvw, device=dev)
    plan_s, grid_s = 0.0, 0.0
    wsum_tot = 0.0
    main_plan = None
    for b in range(nband):
        freq = chans[b * nchan_band : (b + 1) * nchan_band]
        t0 = time.perf_counter()
        # plan_idg raises if the layout needs wplanes or pads slots > 8x
        plan = plan_idg(uvw, freq, nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=eps,
                        max_slot_factor=IDG_MAX_SLOT_FACTOR, device=dev)
        torch.cuda.synchronize()
        plan_s += time.perf_counter() - t0
        vr, vi = sky_vis(uvw_d, freq, srcs, cell, nx, 1.0, gen)
        wgt = torch.ones_like(vr)
        t0 = time.perf_counter()
        dirty = vis2dirty_idg(plan, vr, wgt=wgt, vis_im=vi)
        psf = vis2dirty_idg(plan, torch.ones_like(vr), wgt=wgt, vis_im=torch.zeros_like(vr))
        torch.cuda.synchronize()
        grid_s += time.perf_counter() - t0
        o = (nx_psf - nx) // 2
        pad = torch.zeros((nx_psf, nx_psf), dtype=torch.float64, device=dev)
        pad[o : o + nx, o : o + nx] = psf.double()
        psfhat = torch.fft.rfft2(torch.fft.ifftshift(pad)).to(torch.complex64).cpu().numpy()
        wsum = float(wgt.double().sum())
        wsum_tot += wsum
        node = root.group(f"band{b:04d}_time0000")
        node.write("DIRTY", dirty.double().cpu().numpy())
        node.write("WSUM", np.asarray([wsum]))
        node.set_attrs(freq_out=float(freq.mean()), wsum=wsum, niters=0, time_out=0.0)
        pg = node.group("part0000")
        pg.set_attrs(l0=0.0, m0=0.0, wsum=wsum)
        pg.write("UVW", uvw)
        pg.write("FREQ", freq)
        pg.write("WEIGHT", wgt.cpu().numpy())
        pg.write("MASK", np.ones(tuple(wgt.shape), np.uint8))
        pg.write("PSFHAT", psfhat)
        emit({"phase": "main_path", "stage": "band", "band": b, "S": plan.S, "nbins": plan.nbins,
              "ngroups": plan.ngroups, "slots_per_vis": plan.ngroups * plan.G / (vr.numel()),
              "dirty_peak": float(dirty.max()) / wsum})
        if b == 0:
            main_plan, main_v = plan, (vr, vi, wgt)
        del plan
    root.set_attrs(nx=nx, ny=nx, nx_psf=nx_psf, ny_psf=nx_psf, nband=nband, ntime=1,
                   freq_out=[float(chans[b * nchan_band : (b + 1) * nchan_band].mean()) for b in range(nband)],
                   cell_rad=cell, wsum=wsum_tot, complete=True)

    # gridding throughput and the kernels at the main path's shapes (band 0)
    vr, vi, wgt = main_v
    t0 = time.perf_counter()
    vis2dirty_idg(main_plan, vr, wgt=wgt, vis_im=vi)
    torch.cuda.synchronize()
    mvis_s = vr.numel() / (time.perf_counter() - t0) / 1e6
    p = main_plan
    vals = _idg_prepare(p, vr, vi, wgt)
    pat = F.patches_from_vals(p.scal, vals, p.wcu, p.wcv, p.S)
    back = F.vals_from_patches(pat, p.scal, p.wcu, p.wcv, p.S)
    d64 = [t.double() for t in (p.scal, vals, p.wcu, p.wcv, pat)]
    ref_b1 = F.patches_from_vals_ref(d64[0], d64[1], d64[2], d64[3], p.S)
    ref_b2 = F.vals_from_patches_ref(d64[4], d64[0], d64[2], d64[3], p.S)
    err_b1 = float((pat.double() - ref_b1).abs().max())
    err_b2 = float((back.double() - ref_b2).abs().max())
    rel_b1, rel_b2 = err_b1 / float(ref_b1.abs().max()), err_b2 / float(ref_b2.abs().max())
    del d64, ref_b1, ref_b2
    wgt_g = to_group_layout(p, wgt)
    img = torch.ones((nx, nx), dtype=torch.float32, device=dev)
    timing = dict(
        ng=p.ngroups, S=p.S,
        b1_ms=cuda_ms(lambda: F.patches_from_vals(p.scal, vals, p.wcu, p.wcv, p.S), 10),
        b1_plain_ms=cuda_ms(lambda: F.patches_from_vals_ref(p.scal, vals, p.wcu, p.wcv, p.S), 2),
        b2_ms=cuda_ms(lambda: F.vals_from_patches(pat, p.scal, p.wcu, p.wcv, p.S), 10),
        b2_plain_ms=cuda_ms(lambda: F.vals_from_patches_ref(pat, p.scal, p.wcu, p.wcv, p.S), 2),
        b1_max_abs_err=err_b1, b2_max_abs_err=err_b2, b1_rel_vs_f64=rel_b1, b2_rel_vs_f64=rel_b2,
        patch_scale=float(pat.abs().max()), vals_scale=float(back.abs().max()),
        hessian_vis_ms=cuda_ms(lambda: hessian_vis_idg(p, img, wgt_g), 5),
    )
    emit({"phase": "main_path", "stage": "kernels_at_main_shapes", **timing})
    require(rel_b1 <= 2e-6 and rel_b2 <= 2e-6, "B1/B2 vs f64 plain at the main path's shapes")
    del main_plan, main_v, p, vals, pat, back, vr, vi, wgt, wgt_g, img
    torch.cuda.empty_cache()

    # the main path: counters zeroed right before deconv
    torch.cuda.reset_peak_memory_stats(dev)
    for k in F.LAUNCHES:
        F.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    model, residual = tdeconv.deconv(str(dt_path), niter=niter, epsilon=eps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(F.LAUNCHES)
    for s in tdeconv.CYCLE_STATS:
        emit({"phase": "main_path", "stage": "cycle", **s})
    cyc = tdeconv.CYCLE_STATS
    mfs = model.sum(0)
    peak = np.unravel_index(np.argmax(mfs), mfs.shape)
    near = min(abs(int(peak[0]) - p_) + abs(int(peak[1]) - q_) for p_, q_, _ in srcs)
    summary = dict(
        deconv_seconds=wall, plan_seconds_smoke=plan_s, plan_seconds_deconv=PLAN_STATS["seconds"],
        gridding_seconds=grid_s, gridding_mvis_per_s=mvis_s, max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        launches=launches, model_shape=list(model.shape), model_peak_offset_px=near,
    )
    emit({"phase": "main_path", "stage": "summary", **summary})
    require(len(cyc) == niter, f"{niter} major cycles ran")
    require(all(np.isfinite([s["rms"], s["rmax"]]).all() for s in cyc), "rms and rmax finite")
    require(cyc[-1]["rms"] < cyc[0]["rms"], "final rms below the first")
    require(np.isfinite(model).all() and np.isfinite(residual).all(), "model and residual finite")
    require(model.shape == (nband, nx, nx), "model shape")
    require(launches["patches_from_vals"] > 0 and launches["vals_from_patches"] > 0, "both kernels launched")
    require(near <= 1, "brightest model pixel on a true source")
    phase_profile(dev, dt_path, cyc[-1]["lam"])
    shutil.rmtree(workdir)
    return timing, launches, summary


def device_busy_ms(prof) -> float:
    """Union of the device-side intervals (kernels, copies) of a
    ``torch.profiler`` trace, in ms: the time the card was doing anything."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def top_device_ops(prof, n: int = 6) -> list:
    """The ``n`` kernels with the most device time, as [name, ms, calls]."""
    import torch

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    rows = [(e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return [[k[:60], ms, c] for k, ms, c in sorted(rows, key=lambda r: -r[1])[:n]]


def phase_profile(dev, dt_path: Path, lam: float, iters: int = 20):
    """The steady cycle's parts at the main path's shapes: CUDA-event ms of
    each operator the minor cycle calls, then ``iters`` primal-dual and CG
    iterations timed on the host clock and traced with ``torch.profiler``
    for the device's busy time. The idle share is 1 - busy / unprofiled
    wall time; the profiled wall time is printed beside it."""
    from functools import partial

    import torch

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.core.deconv import TreeStore
    from pfb_imaging_tpu_torch.deconv.pfb import _pfb_grad
    from pfb_imaging_tpu_torch.deconv.presets import make_sara
    from pfb_imaging_tpu_torch.opt.pcg import pcg
    from pfb_imaging_tpu_torch.opt.primal_dual import primal_dual_loop

    dt = TreeStore(dt_path, mode="r")
    a = dt.attrs
    keys = sorted(k for k in dt.groups() if k.startswith("band"))
    nodes = [dt.group(k) for k in keys]
    abspsfhat = np.stack([np.stack([np.abs(np.asarray(n.group(q).read("PSFHAT"))) for q in n.groups()])
                          for n in nodes])
    wsums = np.array([float(np.asarray(n.read("WSUM"))[0]) for n in nodes])
    model = np.stack([np.asarray(n.read("MODEL")) for n in nodes])
    resid = np.stack([np.asarray(n.read("RESIDUAL")) for n in nodes]) / wsums.sum()
    geometry = dict(nx=a["nx"], ny=a["ny"], nx_psf=a["nx_psf"], ny_psf=a["ny_psf"])
    solver = make_sara(abspsfhat, wsums, geometry, model, np.zeros_like(model), dict(hess_norm=a["hess_norm"]),
                       device=dev)
    del abspsfhat
    hess, reg, bwd = solver.hess, solver.reg, solver.backward_alg
    psi = reg.psi
    x = to_device(model, dev, real_dtype(dev))
    r = to_device(resid, dev, real_dtype(dev))
    v = psi.dot(x)
    grad = partial(_pfb_grad, hess.dot, x + r, 1.0)

    def pd():
        primal_dual_loop(x, v, lam, reg.l1weight, bwd.sigma, bwd.tau, grad, psi_dot=psi.dot, psi_hdot=psi.hdot,
                         primal_prox=bwd.primal_prox, dual_update=reg.dual_update_fn, tol=0.0, maxit=iters)

    def cg():
        pcg(hess.dot, r, tol=0.0, maxit=iters, minit=iters)

    rec = dict(
        iters=iters,
        hess_psf_matvec_ms=cuda_ms(lambda: hess.dot(x), 20),
        psi_dot_ms=cuda_ms(lambda: psi.dot(x), 20),
        psi_hdot_ms=cuda_ms(lambda: psi.hdot(v), 20),
        dual_update_ms=cuda_ms(lambda: reg.dual_update_fn(v, v, lam, sigma=bwd.sigma, weight=reg.l1weight), 20),
    )
    for name, fn in (("pd", pd), ("cg", cg)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) * 1e3
        busy = device_busy_ms(prof)
        rec.update({f"{name}_iter_wall_ms": wall / iters, f"{name}_iter_device_busy_ms": busy / iters,
                    f"{name}_idle_share": max(0.0, 1.0 - busy / wall), f"{name}_profiled_wall_ms": wall_prof,
                    f"{name}_top_kernels": top_device_ops(prof)})
        require(busy > 0.0, f"torch.profiler traced device time in the {name} loop")
    emit({"phase": "profile", **rec})
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "pfb_imaging_tpu_torch").is_dir():
        print("chip_smoke: the pfb_imaging_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pfb_imaging_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    t0 = time.perf_counter()
    build.load()
    emit({"phase": "device", "build_seconds": time.perf_counter() - t0, "library": build.library_path().name})

    kern = phase_kernels(dev)
    phase_accuracy(dev)
    timing, launches, _ = phase_main(dev, ROOT / "build" / "chip_smoke")

    kernels = []
    for name, tag in (("patches_from_vals", "b1"), ("vals_from_patches", "b2")):
        kernels.append(dict(
            name=name, route="cuda", source="pfb_imaging_tpu_torch/csrc/idg_fused.cu", replaces=REPLACES[name],
            launches=launches[name], max_abs_err=timing[f"{tag}_max_abs_err"], ms=timing[f"{tag}_ms"],
            plain_ms=timing[f"{tag}_plain_ms"],
            ms_ng4096={S: kern[S][f"{tag}_ms"] for S in kern},
            plain_ms_ng4096={S: kern[S][f"{tag}_plain_ms"] for S in kern},
        ))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
