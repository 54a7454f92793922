#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pfb_imaging_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as a JSON line; any failed check raises and the run
exits non-zero:
  1. device  — card name, ``nvidia-smi`` name and power limit, kernel build
               (one nvcc per csrc/*.cu, sm_90a, started together) and its
               seconds;
  2. kernels — the CUDA kernels B1 (patches_from_vals) and B2
               (vals_from_patches) against their plain PyTorch versions for
               S in {16, 24, 32} at ng = 4096: f64 plain (rel Linf <= 2e-6),
               f32 plain (<= 1e-5), and the adjoint identity (<= 1e-5); then
               B3 (scatter_grid_wstack) at nbig 4096 on random coordinates
               over every tile, W in {6, 8}, nw in {1, 8} (nw = 1: the
               one-plane grid of B5/B6), against its f64 and f32 plain
               versions (rel Linf <= 1e-5), and B4 (gather_grid_wstack) on the
               same plans against its f64 and f32 plain versions (<= 1e-5)
               and against B3 by the adjoint identity (<= 1e-5); then K1
               (idg_chunk_sums + idg_assemble) and K2 (idg_extract) at four
               small plans (chirp S = 16, chirp S = 24 with half 8, wplanes
               S = 32 padded to per-bin capacities, and padded by 4000 groups
               a bin, so that bucket 0 is summed in chunks): each bin twice
               (the same bits), against the plain versions (<= 1e-6 in f32
               and f64), K1 and its chunk sums against the gather-form plain
               version (its own chunks and order of sums: the same bits);
               then P1 (psi_analysis) and P2 (psi_synthesis), Psi.dot/hdot at
               4 x 2048^2 and 2 levels with the deconv's default bases (self,
               db1, db2) and with the sara cells' nine at 4 x 2048^2 and 16 x
               1024^2 (``phase_psi``): each against the plain conv path in f64
               on the card (rel Linf <= 2e-6), two calls the same bits, ms by
               CUDA events beside the byte bound and the plain path's f32 ms;
               P2 on two cubes (``hdot_extrapolated(vn, v)``, PD's 2 vn - v
               formed as it stages) likewise, the same bits as P2 on torch's
               2.0 * vn - v, timed beside that (two torch passes and P2) and
               its bound (2 cubes, x, the scratch written and read); at the
               nine, 2 + 2 launches a primal-dual iteration (P2 on two cubes)
               and one of the dual update's kernel, and no cuDNN or ``cat``
               kernel in Psi's trace nor cuDNN in a PD iteration's; then the
               dual update's kernel (dual_update_21m) on the sara cells'
               cubes, (4, 9, 2077, 2077) and (16, 9, 1053, 1053)
               (``phase_dual_update``): bit for bit the torch composition,
               two calls the same bits, one launch a call, ms by CUDA events
               beside the byte bound (3 cubes and a weight plane) and the
               composition's ms;
  3. accuracy — the port's f32 ``vis2dirty_idg`` at 256^2, 100k vis and
               epsilon 1e-7 against a direct f64 DFT on the card, within the
               plan's ``delivered_accuracy`` budgets; and the f32
               ``vis2dirty_scatter`` (B3) at 256^2, 100k vis, epsilon 1e-5,
               uncompressed w, within 10 epsilon of the same DFT;
  4. main_path — a synthetic 64-antenna array (2016 baselines x 500 times,
               4 bands x 4 channels over 856-1712 MHz, 16M visibilities),
               a seeded point-source sky plus noise summed directly on the
               card, DIRTY and PSF gridded by the port, a .dt tree in the
               imager's schema, then ``deconv(niter=3, epsilon=1e-7)`` in f32
               at 2048^2 with a 4096^2 PSF. Launch counts are zeroed right
               before ``deconv`` and B1/B2's must have risen after it; every
               cycle's residual must take the multiband route; the rms must
               fall. B1/B2 are held against their f64 plain versions (rel
               Linf <= 2e-6) on the first band's plan and at the launch
               shape deconv ran (every band's groups in one launch, on the
               values that launch takes), and the final model's residual by
               the multiband and the per-band route, both timed and traced,
               within ``ROUTE_REL_LIMIT`` of each other. At that launch also
               the multiband Hessian twice (the same bits recorded) and K1/K2
               over every bin of every band (``assembly_kernels``: two
               launches the same bits, within 1e-6 of the plain versions,
               K2 writing every group; ms of K1, its chunk sums, K2 and the
               old torch path; long buckets, chunks, the longest chains);
  5. profile — at the main path's shapes, CUDA-event ms of the PSF Hessian
               matvec, Psi.dot/hdot and the dual update, then 20 primal-dual
               and 20 CG iterations on the host clock and under
               ``torch.profiler``: device busy ms and idle share per loop;
  6. imager — the same array with its own w, 16 channels, 4 bands: a store
               in ``init``'s schema, then ``imager(gridder="pallas")`` in f32
               at 2048^2 (4096^2 PSF) with Briggs weights at epsilon 1e-5.
               Launch counts are zeroed right before ``imager`` and B3's must
               have risen after it; products finite, PSF peak / WSUM = 1
               (1e-4), band 0's brightest pixel on a true source, band 0's
               DIRTY within 2e-5 of the port's f64 stack route, and B3 within
               1e-5 of its f64 plain version at band 0's PSF plan (8192^2),
               its image plan (4096^2) and its PSF plan with uv stretched
               to fill the grid, each with its time, its scratch and the
               peak memory of the call;
  7. degrid — on the imager phase's store and tree: MODEL (the true
               sources) in each band node, ``model2comps``, then
               ``degrid(gridder="pallas", epsilon=1e-5)`` at 2048^2 over the
               16.1M visibilities, counts zeroed right before it: B4 launched,
               MODEL_DATA within 10 epsilon of the noise-free visibilities,
               bin 0 within 2e-5 of the port's f64 classic ``dirty2vis``, B4
               within 1e-5 of its f64 plain version at bin 0's plan; then
               the main phase's array as a store and ``degrid(gridder="auto",
               epsilon=1e-7)``: B2 launched, MODEL_DATA within 1e-5 of the
               noise-free visibilities;
  8. widefield accuracy — f32 wplanes IDG (``w_mode="auto"`` must pick it)
               at 256^2 on 100k visibilities with their own w, against the
               direct f64 DFT both ways (``vis2dirty_idg`` within
               ``delivered_accuracy``, ``dirty2vis_idg`` within its edge
               budget) and the adjoint identity (<= 1e-5), at epsilon 1e-5
               and 1e-7;
  9. widefield — the main phase's array with its own w at 2048^2, 4 bands,
               epsilon 1e-7: a tree on wplanes plans (every band must have
               w_support > 1), B1/B2 at band 0's wplanes plan against their
               plain versions (f64 on its middle 65,536 groups, rel Linf <=
               2e-6), ``deconv(niter=2)`` with its default routing, counts
               zeroed right before it (every cycle on the multiband route,
               no band falling back, rms falling), B1/B2 at that route's
               launch shape (1.2M groups, patch offsets past 2^31; f64 on
               the last 65,536 groups) and K1/K2 with the multiband
               Hessian twice as in the main path, the final model's
               residual by the multiband and the per-band route (both on wplanes IDG plans,
               timed and traced, within ``ROUTE_REL_LIMIT``),
               ``imager(gridder="auto")`` on a store of the array's sky
               visibilities (IDG, every image and PSF plan wplanes), and
               ``degrid(gridder="auto")`` into that store (every bin on
               wplanes IDG, MODEL_DATA within 1e-5 of the noise-free
               visibilities); host planning seconds and peak memory per
               stage;
 10. pipeline — a user's whole run through the port's front end at 2048^2:
               ``core.simulate.simulate_vis_store`` (the simulator's
               64-antenna array, 500 integrations in one partition of
               1,008,000 rows, 16 channels over 856-1712 MHz, 24 seeded
               point sources, noise 1, two linear correlations; the sky by
               the f64 DFT on the card, held to a direct sum over the
               sources within 1e-10 on 4096 rows, the noise rms 1 +- 0.02),
               then ``cli.main``: ``init`` (VIS = (XX + YY) / 2 within
               1e-12, WEIGHT 2), ``imager`` (defaults, the simulator's cell:
               IDG with every plan wplanes, B1), ``sara --niter 2`` (every
               cycle multiband, B1/B2, rms falling), ``restore`` (six finite
               FITS products), ``model2comps`` and ``degrid`` (every bin on
               wplanes IDG, B2, MODEL_DATA reducing the rms), then
               ``imager`` at the CLI's own default cell (IDG: chirp and
               wplanes band plans) and ``sara --niter 1`` on it (the
               multiband route), each step with the counts zeroed right
               before it, its seconds, launches and peak memory; B1/B2 at
               the launch shapes these steps take (band 0's image and 4096^2
               PSF plan at both cells, which degrid's bins share, and each
               sara's multiband launch), each against its f64 plain version
               (rel Linf <= 2e-6);
 11. commands — the JAX CLI's other commands through ``cli.main`` at the
               pipeline's width (its imaged tree, copied before ``sara``):
               ``kclean --niter 2`` (Clark: B1/B2, the MFS rmax falling, the
               model's MFS peak on a source), ``kclean --niter 1 --minor
               hogbom`` on another copy, ``fluxtractor`` on the Clark tree
               with ``--cg-maxit`` sized from one timed ``hessian_vis`` so the
               step takes about 20 s (the mop finite; B1/B2 in its
               residual; its Hessian's scatter on B3, one apply run twice,
               the same bits recorded), ``deconv --preset ista --niter 1`` on a third copy
               (B1/B2, the rms falling), then ``hci --nx 1024 --freq-chunks 4``
               on a 64-scan store of single integrations of the same array and
               sky from the simulator (IDG, one B1 launch a snapshot, the
               time-mean's peak on a source) and a step transient injected by
               a direct ``hci`` call, checked at its pixel; each step's
               seconds, launches and peak memory; B1/B2 against their f64
               plain versions (2e-6) at kclean's band-0 residual plan and at
               one snapshot's plan;
 12. operators — the operators only the JAX tests reach, on the pipeline's
               imaged tree: ``HessPSF`` (ms of ``dot`` and
               ``idot(mode="direct")``; ``idot(mode="psf")``'s batched CG with
               its iterations per band and ||dot(idot(y)) - y|| / ||y|| <=
               1e-3), ``pcg`` with and without the preconditioner hook (each
               stopping before maxit), ``nnls`` (a positive model, its MFS
               peak on the brightest source; FISTA iterations and
               backtracking events), ``Gauss`` and ``Mask`` on 2048^2 cubes,
               ``plan_idg(subgrid=24)`` on band 0's visibilities (counts
               zeroed right before ``vis2dirty_idg`` / ``dirty2vis_idg`` on
               it: B1 and B2 launched; the dirty image within 1e-3 of the
               imager's; B1/B2 within 2e-6 of f64 plain at this plan), an
               S = 24 plan with ``flip_v=False`` and ``hermitian=False`` at
               256^2 against the direct DFT with that sign (within
               ``delivered_accuracy``, adjoint 1e-5), ``bringup_checks``
               around five SARA primal-dual iterations (nothing raised) and
               the host syncs per iteration under
               ``set_sync_debug_mode("warn")``, ``memory_line()`` and the
               PSF Hessian's flops by ``cost_analysis``; at band 0's
               residual plan, ``hessian_vis_idg(beam=, eta=, wsum=)`` (B2,
               B1, K2 and K1 launched; its composition of the port's own
               calls within 1e-6; its device ms by kernel family from
               ``torch.profiler``) and ``vis2dirty_idg`` with a mask
               positional and by keyword (B1 launched; the run with the
               weight times the mask within 1e-7), each of these and
               ``dirty2vis_idg`` run twice; ``PrimalDual`` + ``L1`` on a
               lasso of the cube's size (the soft threshold within 1e-5
               max|b|).
 13. same_bits — with no determinism switch, every call run twice above
               (``hessian_vis_idg(beam, eta, wsum)``, ``vis2dirty_idg(mask)``
               and ``dirty2vis_idg`` at band 0's plan, the multiband Hessian
               at the deconv and widefield launches, fluxtractor's classic
               ``hessian_vis``), five PD iterations at the sara cell's shapes
               with P2 on two cubes against P2 on torch's 2.0 * vn - v, and
               ``sara --niter 2 --pd-maxit 20`` run twice on copies of the
               imaged tree (MODEL and the MFS residual) must give the same
               bits;
 14. parallel — ``parallel/`` on the one card, each part's ranks started
               as child processes (``torch.multiprocessing.spawn``; a rank
               that fails or outlives its timeout fails the smoke): (a) one
               rank on NCCL, ``sara --niter 1 --pd-maxit 100 --use-mesh`` on
               a copy of the pipeline's imaged tree against the same run
               without ``--use-mesh`` (the same CG and PD counts, models
               within 1e-6); (b) two ranks sharing the card over gloo
               (passed explicitly): which collectives gloo takes on CUDA
               tensors, ``imager`` on a 2-rank row mesh over the pipeline's
               store (DIRTY, PSF and WSUM within 1e-5 of the one-process
               tree; B1/B2 within 2e-6 of f64 plain at each rank's band-0
               image and PSF shard plans), then ``sara --niter 1 --pd-maxit
               100 --use-mesh`` on a 2-band mesh on a copy of (a)'s tree
               (both ranks the same rms and model checksum, the model within
               1e-4 of (a)'s; launches and
               the collectives' count and bytes per CG and PD iteration and
               per cycle); (c) two gloo ranks, one band, nx 4096: the
               row-sharded PSF Hessian on an 8192^2 grid against the
               unsharded one on rank 0 (1e-5), ms an apply each, 20 PCG
               iterations. Two ranks share one card: the times are the
               collectives' cost, not scaling.
Then the kernel summary line (every kernel with its launches on its main
path, error, ms, plain ms and bound at the shape those launches take; K1/K2
at the main path's and the widefield multiband launch, over every bin; B1/B2
also at band 0's plan and at the widefield multiband launch and band plan,
with the widefield phase's launches, at the pipeline's launch shapes under
``*_pipeline_*`` keys, at the commands' under ``*_commands_*`` keys and at
the S = 24 plan under ``*_s24_plan``; every kernel's ``launches_pipeline``
and ``launches_commands``, which must be positive for B1/B2, as must their
``launches_operators`` (the S = 24 plan),
``launches_operators_hessian_vis_beam`` and ``launches_parallel`` by part
and rank, with
B1/B2 at rank 0's shard plans under ``*_parallel_*`` keys; P1/P2 last, at
the sara cell's shapes and under ``*_deconv_default`` keys at the deconv's
default bases, with their launches a PD iteration there besides the main
path's; their widefield, pipeline and parallel launches must be positive;
then the dual update's kernel at the sara cells' cubes, with its launches
on the deconv, the widefield deconv, the pipeline, (a) and every rank of
(b)'s band split, all positive), the
``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from portbench.data import LIGHTSPEED, channels, point_sum_vis, sky_vis, synth_array

ROOT = Path(__file__).resolve().parent
# MeerKAT's L band (Hz), the smoke's channels
L_BAND = (856e6, 1712e6)
# published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3
# bandwidth and f32 outside the tensor cores; the bounds in the kernel line
HBM_BYTES_PER_S = 3.35e12
# rel Linf between the multiband and the per-band residual of one model, and
# between deconv's residual and the multiband route's recomputation (f32
# plans on different w grids and group layouts)
ROUTE_REL_LIMIT = 1e-4
F32_FLOPS = 67e12
# dense TF32 on the tensor cores; B1/B2 take three passes (3xTF32)
TF32_FLOPS = 495e12
IDG_TF32_PASSES = 3
REPLACES = {
    "patches_from_vals": "pfb_imaging_tpu/ops/idg_fused.py:253",
    "vals_from_patches": "pfb_imaging_tpu/ops/idg_fused.py:329",
    # B3, and B5/B6 as its one-plane case
    "scatter_grid_wstack": "pfb_imaging_tpu/ops/gridder_pallas.py:353; pfb_imaging_tpu/ops/gridder_pallas.py:144; "
                           "pfb_imaging_tpu/ops/gridder_pallas.py:564",
    "gather_grid_wstack": "pfb_imaging_tpu/ops/gridder_pallas.py:717",
    # the port's own kernels: the JAX functions were XLA ops, not Pallas kernels
    "idg_assemble": "pfb_imaging_tpu/ops/gridder_idg.py:2026 (_assemble_bin)",
    "idg_extract": "pfb_imaging_tpu/ops/gridder_idg.py:2482 (_extract_bin)",
    "psi_analysis": "pfb_imaging_tpu/ops/wavelets.py:114 (conv_general_dilated, through ops/psi.py Psi.dot)",
    "psi_synthesis": "pfb_imaging_tpu/ops/wavelets.py:139 (conv_general_dilated, through ops/psi.py Psi.hdot)",
    "psi_synthesis_ext": "pfb_imaging_tpu/ops/wavelets.py:139 (conv_general_dilated, through ops/psi.py Psi.hdot of "
                         "opt/primal_dual.py's 2.0 * vn - v)",
    "dual_update_21m": "pfb_imaging_tpu/prox/prox_21m.py:33 (dual_update, XLA element-wise ops)",
}
SARA_BASES = ("self",) + tuple(f"db{p}" for p in range(1, 9))
DECONV_BASES = ("self", "db1", "db2")  # the deconv's default (deconv/presets)
# why library_ms is null for K1/K2
ASSEMBLY_NO_LIBRARY = ("no one PyTorch call places patches periodically on a grid: the plain version is a lattice "
                       "index_add_, r^2 shifted adds and a fold (K1), or a periodic extension and a gather (K2)")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_linf(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def rel_linf_np(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


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


def phase_kernels(dev, ngs=(4096, 4097)):
    """B1/B2 against their plain versions in f64 and f32, and the adjoint,
    at each ng of ``ngs`` (4097: a ragged count of groups); timed at the
    first."""
    import torch

    from pfb_imaging_tpu_torch.ops import idg_fused as F

    out = {}
    for S in (16, 24, 32):
        for ng in ngs:
            rng = np.random.default_rng(S if ng == ngs[0] else S + ng)
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
                b1_max_abs_err=float((p.double() - p64).abs().max()),
                b2_max_abs_err=float((v.double() - v64).abs().max()),
                adjoint_rel=abs(lhs - rhs) / abs(lhs),
            )
            if ng == ngs[0]:
                rec.update(
                    b1_ms=cuda_ms(lambda: F.patches_from_vals(sc, va, wu, wv, S), 20),
                    b1_plain_ms=cuda_ms(lambda: F.patches_from_vals_ref(sc, va, wu, wv, S), 5),
                    b2_ms=cuda_ms(lambda: F.vals_from_patches(y, sc, wu, wv, S), 20),
                    b2_plain_ms=cuda_ms(lambda: F.vals_from_patches_ref(y, sc, wu, wv, S), 5),
                )
                out[S] = rec
            emit({"phase": "kernels", **rec})
            require(rec["b1_rel_vs_f64"] <= 2e-6 and rec["b2_rel_vs_f64"] <= 2e-6, f"S={S} ng={ng} kernel vs f64 plain")
            require(rec["b1_rel_vs_f32"] <= 1e-5 and rec["b2_rel_vs_f32"] <= 1e-5, f"S={S} ng={ng} kernel vs f32 plain")
            require(rec["adjoint_rel"] <= 1e-5, f"S={S} ng={ng} adjoint identity")
    return out


def idg_bound(ng: int, S: int, G: int = 128):
    """The least time (ms) for one B1 or B2 call at (ng, S), what bounds it,
    and the bound on the f32 SIMT units: 8 flops per complex MAC of the slot
    contraction (S^2 G per group) and of the taper-DFT products (2 S^3 per
    group), done ``IDG_TF32_PASSES`` times on the tensor cores (3xTF32) or
    once on the SIMT units; the angles (4, ng, G), the values (2, ng, G),
    the patches (2, ng, S, S) and the two (2, S, S) taper factors, each
    moved once, all f32."""
    flops = 8 * ng * (S * S * G + 2 * S**3)
    nbytes = 4 * (4 * ng * G + 2 * ng * G + 2 * ng * S * S + 4 * S * S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = IDG_TF32_PASSES * flops / TF32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), max(t_bytes, flops / F32_FLOPS * 1e3)


def scatter_bound(plan, p0: int, nw: int):
    """The least time (ms) the card could take for one ``scatter_grid_wstack``
    call, and what bounds it: the stream read once (lu, lv, du, dv, w_rel,
    vre, vim: 28 B a visibility), the grids written once, and 5 f32 flops
    (sten*ww, re*s, im*s and two adds) per stencil cell of every
    (visibility, plane) pair of the chunk whose w-weight is not zero."""
    pairs = wstack_pairs(plan, p0, nw)
    nbytes = 28 * plan.nvis + nw * 2 * plan.nbig_x * plan.nbig_y * 4
    flops = 5 * pairs * plan.support**2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), pairs


def call_peak(fn):
    """(fn(), the most device memory the call held above what was allocated
    before it, in bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def scatter_check(plan, vals, p0: int, nw: int, reps: int = 10):
    """B3 on the card against its plain version in f64 and f32 on the same
    values (the sorted stream put in tile order), with times, the bound,
    and the call's peak memory (the grid it returns plus its scratch)."""
    import torch

    from pfb_imaging_tpu_torch.ops import gridder_pallas as GP

    tiles = GP.tiles_for(plan)
    vre, vim = vals[0].index_select(0, tiles.perm), vals[1].index_select(0, tiles.perm)
    out, peak = call_peak(lambda: GP.scatter_grid_wstack(plan, tiles, vre, vim, p0, nw))
    ref64 = GP.scatter_grid_wstack_ref(plan, tiles, vre.double(), vim.double(), p0, nw)
    scale = float(ref64.abs().max())
    err64 = float((out.double() - ref64).abs().max())
    del ref64
    ref32 = GP.scatter_grid_wstack_ref(plan, tiles, vre, vim, p0, nw)
    err32 = float((out - ref32).abs().max())
    del ref32, out
    torch.cuda.empty_cache()
    bound_ms, bound_by, pairs = scatter_bound(plan, p0, nw)
    return dict(
        W=plan.support, nw=nw, p0=p0, plan_nw=plan.nw, nbig=plan.nbig_x, nvis=plan.nvis, nblocks=tiles.nblocks,
        do_wgridding=plan.do_wgridding, pairs=pairs, scale=scale, max_abs_err=err64, rel_vs_f64=err64 / scale,
        rel_vs_f32=err32 / scale, call_peak_bytes=peak, grid_bytes=nw * 2 * plan.nbig_x * plan.nbig_y * 4,
        scratch_bytes=4 * GP.chunk_plan(plan, tiles, p0, nw).scratch,
        ms=cuda_ms(lambda: GP.scatter_grid_wstack(plan, tiles, vre, vim, p0, nw), reps),
        plain_ms=cuda_ms(lambda: GP.scatter_grid_wstack_ref(plan, tiles, vre, vim, p0, nw), 2),
        bound_ms=bound_ms, bound_by=bound_by,
    )


def on_plane(plan, p: int):
    """(nvis,) bool in the plan's sorted stream: the visibilities whose
    w-weight on plane p is not zero (all of them without w-gridding)."""
    import torch

    if not plan.do_wgridding:
        return torch.ones(plan.nvis, dtype=torch.bool, device=plan.w_rel.device)
    return (plan.w_rel.double() - p).abs() < 0.5 * plan.w_support


def wstack_pairs(plan, p0: int, nw: int) -> int:
    """(visibility, plane) pairs of planes p0 .. p0+nw-1 whose w-weight is
    not zero (every visibility once for a plan without w-gridding)."""
    return sum(int(on_plane(plan, p).sum()) for p in range(p0, p0 + nw))


def window_cells(plan, p0: int, nw: int) -> int:
    """Grid cells the gather must read, summed over planes p0 .. p0+nw-1:
    on each plane, the union of the W x W windows (taken mod nbig) of the
    visibilities whose w-weight there is not zero."""
    import torch

    iu = torch.remainder(plan.iu0, plan.nbig_x)
    iv = torch.remainder(plan.iv0, plan.nbig_y)
    cells = 0
    for p in range(p0, p0 + nw):
        sel = on_plane(plan, p)
        start = torch.zeros((plan.nbig_x, plan.nbig_y), dtype=torch.bool, device=iu.device)
        start[iu[sel], iv[sel]] = True
        rows = start.clone()
        for i in range(1, plan.support):
            rows |= start.roll(i, 0)
        cover = rows.clone()
        for j in range(1, plan.support):
            cover |= rows.roll(j, 1)
        cells += int(cover.sum())
    return cells


def gather_bound(plan, p0: int, nw: int):
    """The least time (ms) the card could take for one ``gather_grid_wstack``
    call, and what bounds it: the grid cells some window reads (re, im f32;
    ``window_cells``) read once, 20 B of per-visibility inputs (lu, lv, du,
    dv, w_rel), 16 B of accumulator traffic per visibility (re, im read and
    written), and 4 W^2 + 2 f32 flops (two multiply-adds per stencil cell,
    the w-weighted add) per (visibility, plane) pair of the chunk whose
    w-weight is not zero."""
    pairs, cells = wstack_pairs(plan, p0, nw), window_cells(plan, p0, nw)
    nbytes = cells * 2 * 4 + (20 + 16) * plan.nvis
    flops = (4 * plan.support**2 + 2) * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), pairs, cells


def gather_check(plan, grids, p0: int, nw: int, reps: int = 10):
    """B4 on the card against its plain version in f64 and f32 on the same
    f32 grids (nw, 2, nbig, nbig), with times, the bound, and the call's
    peak memory (the (2, nvis) values it returns)."""
    import torch

    from pfb_imaging_tpu_torch.ops import gridder_pallas as GP

    tiles = GP.tiles_for(plan)
    out, peak = call_peak(lambda: GP.gather_grid_wstack(plan, tiles, grids, p0, nw))
    ref64 = GP.gather_grid_wstack_ref(plan, tiles, grids.double(), p0, nw)
    scale = float(ref64.abs().max())
    err64 = float((out.double() - ref64).abs().max())
    del ref64
    ref32 = GP.gather_grid_wstack_ref(plan, tiles, grids, p0, nw)
    err32 = float((out - ref32).abs().max())
    del ref32, out
    torch.cuda.empty_cache()
    bound_ms, bound_by, pairs, cells = gather_bound(plan, p0, nw)
    return dict(
        W=plan.support, nw=nw, p0=p0, plan_nw=plan.nw, nbig=plan.nbig_x, nvis=plan.nvis, nblocks=tiles.nblocks,
        do_wgridding=plan.do_wgridding, pairs=pairs, window_cells=cells, scale=scale, max_abs_err=err64,
        rel_vs_f64=err64 / scale, rel_vs_f32=err32 / scale, call_peak_bytes=peak,
        ms=cuda_ms(lambda: GP.gather_grid_wstack(plan, tiles, grids, p0, nw), reps),
        plain_ms=cuda_ms(lambda: GP.gather_grid_wstack_ref(plan, tiles, grids, p0, nw), 2),
        bound_ms=bound_ms, bound_by=bound_by,
    )


def gather_adjoint(plan, p0: int, nw: int, gen) -> float:
    """|<B4(grids), v> - <grids, B3(v)>| / |<B4(grids), v>| on one tile plan,
    random f32 grids and values, the sums in f64."""
    import torch

    from pfb_imaging_tpu_torch.ops import gridder_pallas as GP

    tiles = GP.tiles_for(plan)
    dev = tiles.perm.device
    grids = torch.randn((nw, 2, plan.nbig_x, plan.nbig_y), generator=gen, device=dev)
    v = torch.randn((2, plan.nvis), generator=gen, device=dev)
    lhs = float((GP.gather_grid_wstack(plan, tiles, grids, p0, nw).double() * v.double()).sum())
    rhs = float((grids.double() * GP.scatter_grid_wstack(plan, tiles, v[0], v[1], p0, nw).double()).sum())
    return abs(lhs - rhs) / abs(lhs)


def phase_kernels_scatter(dev, nvis: int = 2_000_000):
    """B3 and B4 at nbig 4096 on random coordinates spread over every tile
    and across the grid's wrap, for W in {6, 8} and nw in {1, 8}: nw = 8 is
    a w-stacked chunk, nw = 1 a plan without w-gridding (the one-plane grid
    of B5/B6). Each is held against its f64 and f32 plain versions (rel
    Linf <= 1e-5), and B4 against B3 by the adjoint identity (<= 1e-5)."""
    import torch

    from pfb_imaging_tpu_torch.ops.gridder import _vis2dirty_prepare, plan_wgridder

    out, gathers = [], []
    gen = torch.Generator(device=dev).manual_seed(4)
    freq = np.array([1.0e9, 1.1e9])
    cell = 4e-6
    for W, eps in ((6, 1e-5), (8, 1e-7)):
        rng = np.random.default_rng(W)
        nrow = nvis // freq.size
        # uv over the whole 4096^2 grid (|u| up to 1/(2 cell) wavelengths at
        # the top channel), w over ~+-1.2e5 wavelengths (~20 planes)
        uvw = rng.uniform(-1.0, 1.0, (nrow, 3)) * (LIGHTSPEED / freq.max()) * np.array([0.5 / cell, 0.5 / cell, 1.2e5])
        vis = rng.standard_normal((nrow, freq.size)) + 1j * rng.standard_normal((nrow, freq.size))
        for do_w in (True, False):
            plan = plan_wgridder(uvw, freq, nx=2048, ny=2048, cellx=cell, celly=cell, epsilon=eps,
                                 do_wgridding=do_w, divide_by_n=False, dtype=np.float32, device=dev)
            require(plan.support == W and plan.nbig_x == 4096, f"W={W} plan at nbig 4096")
            vals = _vis2dirty_prepare(plan, torch.as_tensor(vis.real, device=dev), torch.as_tensor(vis.imag, device=dev))
            nw = 8 if do_w else 1
            p0 = max(0, plan.nw // 2 - nw // 2)
            rec = scatter_check(plan, vals, p0, nw)
            emit({"phase": "kernels", "kernel": "scatter_grid_wstack", **rec})
            require(rec["rel_vs_f64"] <= 1e-5, f"B3 W={W} nw={nw} vs f64 plain")
            require(rec["rel_vs_f32"] <= 1e-5, f"B3 W={W} nw={nw} vs f32 plain")
            out.append(rec)
            del vals
            grids = torch.randn((nw, 2, plan.nbig_x, plan.nbig_y), generator=gen, device=dev)
            rec = dict(gather_check(plan, grids, p0, nw), adjoint_rel=gather_adjoint(plan, p0, nw, gen))
            emit({"phase": "kernels", "kernel": "gather_grid_wstack", **rec})
            require(rec["rel_vs_f64"] <= 1e-5, f"B4 W={W} nw={nw} vs f64 plain")
            require(rec["rel_vs_f32"] <= 1e-5, f"B4 W={W} nw={nw} vs f32 plain")
            require(rec["adjoint_rel"] <= 1e-5, f"B4/B3 W={W} nw={nw} adjoint identity")
            gathers.append(rec)
            del plan, grids
            torch.cuda.empty_cache()
    return out, gathers


def bench_coords(rng, nrow: int, nchan: int):
    """The TPU bench's layout: uvw uniform within +-16 km, w compressed x0.01."""
    uvw = rng.uniform(-16000, 16000, (nrow, 3))
    uvw[:, 2] *= 0.01
    return uvw, np.linspace(1.0e9, 1.1e9, nchan)


def dft_dirty(uvw, freq, vis, nx: int, cell: float, dev, chunk: int = 1024, sv: float = -1.0):
    """Direct f64 adjoint DFT on the card: dirty = sum Re(V e^{+2 pi i phase}),
    phase = (u l + sv v m - w (n-1)) nu / c (no 1/n; ``sv`` = -1 is the
    pinned ``flip_v=True``)."""
    import torch

    c = (torch.arange(nx, device=dev, dtype=torch.float64) - nx // 2) * cell
    ll, mm = torch.meshgrid(c, c, indexing="ij")
    lmn = torch.stack([ll.ravel(), sv * mm.ravel(), -(torch.sqrt(1.0 - ll**2 - mm**2) - 1.0).ravel()])
    u = torch.as_tensor(uvw, device=dev, dtype=torch.float64)
    v = torch.as_tensor(vis, device=dev)
    acc = torch.zeros(nx * nx, dtype=torch.float64, device=dev)
    for f, nu in enumerate(freq):
        for s in range(0, u.shape[0], chunk):
            ph = (2.0 * np.pi * nu / LIGHTSPEED) * (u[s : s + chunk] @ lmn)
            vv = v[s : s + chunk, f]
            acc += vv.real @ torch.cos(ph) - vv.imag @ torch.sin(ph)
    return acc.reshape(nx, nx)


def psi_bytes(psi, nband: int, cubes: int = 1, scratch: bool = False) -> int:
    """Bytes a Psi analysis or synthesis of ``nband`` bands must move once:
    the image cube and ``cubes`` packed cubes' coefficients, at 4 bytes each
    (the cube's zero margins are not counted); with ``scratch``, the
    kernels' level scratch written and read once."""
    live = 0
    for b in psi.bases:
        if b == "self":
            live += psi.nx * psi.ny
            continue
        bk = psi._books[b]
        live += sum(3 * cx * cy for cx, cy in zip(bk.cx, bk.cy)) + bk.cx[-1] * bk.cy[-1]
    scr = 0
    if scratch:  # each level's LL but the deepest's, a wavelet basis and band
        from pfb_imaging_tpu_torch.ops.psi import kernel_levels

        scr = sum(lv.ll_x * lv.ll_y for lv in kernel_levels(psi)[:-1]) * sum(b != "self" for b in psi.bases)
    return 4 * nband * (psi.nx * psi.ny + cubes * live + 2 * scr)


def psi_at(dev, bases, nband: int, nx: int, nlevel: int, reps: int, plain_reps: int, seed: int):
    """P1 / P2 of a ``Psi(bases, nlevel)`` at ``nband`` x ``nx``^2 on the
    card: the Psi, its x and cube, and their record (against the plain conv
    path in f64 on the card, two calls the same bits, ms by CUDA events
    beside the byte bound and the plain path's ms in f32, the path the card
    took before the kernels); P2 on two cubes (``hdot_extrapolated(v, v0)``)
    the same, bit for bit P2 on torch's ``2.0 * v - v0``, and timed beside
    that (``passes_hdot_ms``: the two torch passes and P2, as PD ran it
    before)."""
    import torch

    from pfb_imaging_tpu_torch.ops import psi as PS

    psi = PS.Psi(nband, nx, nx, bases=bases, nlevel=nlevel, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((nband, nx, nx), generator=g, device=dev)
    v = torch.randn((nband, psi.nbasis, psi.nymax, psi.nxmax), generator=g, device=dev)
    v0 = torch.randn(v.shape, generator=g, device=dev)
    a, h, e = psi.dot(x), psi.hdot(v), psi.hdot_extrapolated(v, v0)
    rel_dot = rel_linf(a.double(), psi.dot_plain(x.double()))
    rel_hdot = rel_linf(h.double(), psi.hdot_plain(v.double()))
    rel_ext = rel_linf(e.double(), psi.hdot_plain(2.0 * v.double() - v0.double()))
    same = torch.equal(a, psi.dot(x)) and torch.equal(h, psi.hdot(v))
    same_ext = torch.equal(e, psi.hdot_extrapolated(v, v0))
    ext_as_one = torch.equal(e, psi.hdot(2.0 * v - v0))
    del a, h, e
    torch.cuda.empty_cache()
    nbytes, ext_bytes = psi_bytes(psi, nband), psi_bytes(psi, nband, cubes=2, scratch=True)
    rec = dict(nband=nband, nx=nx, nlevel=nlevel, bases=list(bases), nymax=psi.nymax, nxmax=psi.nxmax,
               rel_vs_f64_dot=rel_dot, rel_vs_f64_hdot=rel_hdot, rel_vs_f64_hdot_ext=rel_ext,
               two_calls_identical=same, two_calls_identical_ext=same_ext, ext_same_bits_as_passes=ext_as_one,
               bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bytes_ext=ext_bytes, bound_ms_ext=ext_bytes / HBM_BYTES_PER_S * 1e3,
               dot_ms=cuda_ms(lambda: psi.dot(x), reps), hdot_ms=cuda_ms(lambda: psi.hdot(v), reps),
               hdot_ext_ms=cuda_ms(lambda: psi.hdot_extrapolated(v, v0), reps),
               passes_hdot_ms=cuda_ms(lambda: psi.hdot(2.0 * v - v0), reps),
               plain_dot_ms=cuda_ms(lambda: psi.dot_plain(x), plain_reps),
               plain_hdot_ms=cuda_ms(lambda: psi.hdot_plain(v), plain_reps))
    require(rel_dot <= 2e-6 and rel_hdot <= 2e-6 and rel_ext <= 2e-6,
            f"P1/P2 within 2e-6 of the f64 plain path at {bases} ({rel_dot}, {rel_hdot}, {rel_ext})")
    require(same and same_ext, f"P1/P2: two calls give the same bits at {bases}")
    require(ext_as_one, f"P2 on two cubes: the bits of P2 on 2.0 * vn - v at {bases}")
    del v0
    return psi, x, v, rec


def phase_psi(dev, nband: int = 4, nx: int = 2048, nlevel: int = 2, reps: int = 20, plain_reps: int = 3,
              pd_iters: int = 3, nband_16: int = 16, nx_16: int = 1024) -> dict:
    """P1 / P2 (``Psi.dot`` / ``Psi.hdot`` on the card) at ``nband`` x
    ``nx``^2 and ``nlevel`` levels (``psi_at``), with the deconv's default
    bases (self, db1, db2: phase_main's and the pipeline's sara) and then
    SARA's nine (the 2k sara cell's), and the nine at ``nband_16`` x
    ``nx_16``^2 (the 1k16 cell's; ``cell_1k16`` in the record); at the
    nine, launches over ``pd_iters`` primal-dual iterations (2 + 2 each at
    2 levels, P2 on two cubes), and the kernel names of one Psi pair and of
    one PD iteration under ``torch.profiler``: no cuDNN convolution and no
    ``cat`` in Psi's, no cuDNN in PD's (the stop test's per-band ``stack``s
    stay)."""
    import torch

    from pfb_imaging_tpu_torch.opt.primal_dual import primal_dual_loop
    from pfb_imaging_tpu_torch.prox.prox_21m import dual_update

    *_, default = psi_at(dev, DECONV_BASES, nband, nx, nlevel, reps, plain_reps, seed=16)
    torch.cuda.empty_cache()
    *_, cell_1k16 = psi_at(dev, SARA_BASES, nband_16, nx_16, nlevel, reps, plain_reps, seed=18)
    torch.cuda.empty_cache()
    psi, x, v, rec = psi_at(dev, SARA_BASES, nband, nx, nlevel, reps, plain_reps, seed=17)
    rec["deconv_default"] = default
    rec["cell_1k16"] = cell_1k16
    l1w = torch.ones((psi.nbasis, psi.nymax, psi.nxmax), device=dev)

    def pd(iters, ext=psi.hdot_extrapolated):
        return primal_dual_loop(x, torch.zeros_like(v), 1e-3, l1w, 1.0, 0.5, lambda z: 0.1 * z, psi_dot=psi.dot,
                                psi_hdot=psi.hdot, dual_update=dual_update, tol=0.0, maxit=iters, psi_hdot_ext=ext)

    # five iterations with P2 on two cubes and with torch's 2.0 * vn - v through P2: the same bits
    fused, unfused = pd(5), pd(5, None)
    rec["pd_fused_same_bits"] = bool(torch.equal(fused[0], unfused[0]) and torch.equal(fused[1], unfused[1]))
    del fused, unfused

    zero_counts()
    pd(pd_iters)
    torch.cuda.synchronize()
    launches = read_counts()["launches"]
    rec["launches_pd_iteration"] = {k: launches[k] / pd_iters for k in ("psi_analysis", "psi_synthesis",
                                                                       "psi_synthesis_ext", "dual_update_21m")}
    for what, fn in (("psi", lambda: (psi.dot(x), psi.hdot(v))), ("pd_iteration", lambda: pd(1))):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rec[f"kernels_{what}"] = sorted({e.name for e in prof.events()
                                         if e.device_type == torch.autograd.DeviceType.CUDA})
    emit({"phase": "psi", **rec})
    require(rec["launches_pd_iteration"] == {"psi_analysis": nlevel, "psi_synthesis": 0,
                                             "psi_synthesis_ext": nlevel, "dual_update_21m": 1},
            "Psi's kernels launched nlevel + nlevel times a PD iteration, P2 on two cubes, the dual update's once")
    require(not any("cudnn" in n.lower() or "CatArrayBatchedCopy" in n for n in rec["kernels_psi"]),
            "no cuDNN convolution and no cat in Psi's trace")
    require(not any("cudnn" in n.lower() for n in rec["kernels_pd_iteration"]),
            "no cuDNN convolution in a PD iteration")
    require(rec["pd_fused_same_bits"], "PD with P2 on two cubes: the bits of PD on torch's 2.0 * vn - v")
    return rec


def dual_update_at(dev, shape: tuple, reps: int, plain_reps: int, seed: int) -> dict:
    """PD's dual update (``prox_21m.dual_update``: the kernel
    ``dual_update_21m`` on the card) on coefficient cubes of ``shape``
    (nband, nbasis, nymax, nxmax), with a reweighting-like weight and lam
    at the median |band sum| (both branches of the scale taken): bit for bit
    ``dual_update_plain`` (the torch composition, the path the card took
    before the kernel), two calls the same bits, one launch a call; ms by
    CUDA events beside the byte bound (vp, v and vn whole, the weight plane
    once: 3C + p) and the composition's ms."""
    import torch

    from pfb_imaging_tpu_torch.prox.prox_21m import dual_update, dual_update_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    vp, v = torch.randn(shape, generator=g, device=dev), torch.randn(shape, generator=g, device=dev)
    weight = torch.rand(shape[1:], generator=g, device=dev) + 0.5
    sigma = 0.7
    lam = float((vp + sigma * v).sum(0).abs().median())
    zero_counts()
    k1 = dual_update(vp, v, lam, sigma, weight)
    torch.cuda.synchronize()
    launches = read_counts()["launches"]["dual_update_21m"]
    same = torch.equal(k1, dual_update_plain(vp, v, lam, sigma, weight))
    again = torch.equal(k1, dual_update(vp, v, lam, sigma, weight))
    del k1
    torch.cuda.empty_cache()
    nbytes = (3 * vp.numel() + weight.numel()) * 4
    rec = dict(shape=list(shape), launches_a_call=launches, same_bits_as_plain=same,
               two_calls_identical=again, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               ms=cuda_ms(lambda: dual_update(vp, v, lam, sigma, weight), reps),
               plain_ms=cuda_ms(lambda: dual_update_plain(vp, v, lam, sigma, weight), plain_reps))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    require(launches == 1, f"dual_update_21m launched once a call at {shape}")
    require(same, f"dual_update_21m: the composition's bits at {shape}")
    require(again, f"dual_update_21m: two calls give the same bits at {shape}")
    return rec


def phase_dual_update(dev, reps: int = 20, plain_reps: int = 5) -> dict:
    """The dual update's kernel at the sara cells' cubes (``dual_update_at``):
    the 2k cell's (4, 9, 2077, 2077) and the 1k16 cell's (``cell_1k16``),
    (16, 9, 1053, 1053): nine bases over two levels at 2048^2 and 1024^2."""
    import torch

    rec = dual_update_at(dev, (4, len(SARA_BASES), 2077, 2077), reps, plain_reps, seed=19)
    torch.cuda.empty_cache()
    rec["cell_1k16"] = dual_update_at(dev, (16, len(SARA_BASES), 1053, 1053), reps, plain_reps, seed=20)
    torch.cuda.empty_cache()
    emit({"phase": "dual_update", **rec})
    return rec


def phase_accuracy(dev, nrow: int = 50_000, nchan: int = 2, nx: int = 256, eps: float = 1e-7):
    """f32 IDG vis2dirty on the card against a direct f64 DFT on the card."""
    import torch

    from pfb_imaging_tpu_torch.ops.gridder_idg import delivered_accuracy, plan_idg, vis2dirty_idg

    rng = np.random.default_rng(5)
    uvw, freq = bench_coords(rng, nrow, nchan)
    cell = 8e-6 * 1024 / nx
    vis = rng.standard_normal((nrow, nchan)) + 1j * rng.standard_normal((nrow, nchan))
    plan = plan_idg(uvw, freq, nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=eps, divide_by_n=False, device=dev)
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


def phase_accuracy_pallas(dev, nrow: int = 50_000, nchan: int = 2, nx: int = 256, eps: float = 1e-5):
    """The port's f32 ``vis2dirty_scatter`` (B3) with uncompressed w against
    the direct f64 DFT on the card: rel Linf <= 10 eps."""
    import torch

    from pfb_imaging_tpu_torch.ops.gridder import plan_wgridder
    from pfb_imaging_tpu_torch.ops.gridder_pallas import vis2dirty_scatter

    rng = np.random.default_rng(6)
    uvw = rng.uniform(-16000, 16000, (nrow, 3))
    freq = np.linspace(1.0e9, 1.1e9, nchan)
    cell = 8e-6 * 1024 / nx
    vis = rng.standard_normal((nrow, nchan)) + 1j * rng.standard_normal((nrow, nchan))
    plan = plan_wgridder(uvw, freq, nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=eps, divide_by_n=False,
                         dtype=np.float32, device=dev)
    d = vis2dirty_scatter(plan, torch.as_tensor(vis.real, device=dev).float(),
                          vis_im=torch.as_tensor(vis.imag, device=dev).float()).double()
    ref = dft_dirty(uvw, freq, vis, nx, cell, dev)
    rec = dict(gridder="pallas", nx=nx, nvis=nrow * nchan, epsilon=eps, support=plan.support, nw=plan.nw,
               rel_linf=rel_linf(d, ref))
    emit({"phase": "accuracy", **rec})
    require(np.isfinite(rec["rel_linf"]) and rec["rel_linf"] <= 10 * eps, "pallas vis2dirty within 10 eps of the DFT")
    return rec


def point_sources(nx: int, nsrc: int, seed: int) -> list:
    """``nsrc`` seeded (pixel x, pixel y, flux) sources in the inner half of
    an nx^2 image, fluxes uniform in [0.1, 1)."""
    rng = np.random.default_rng(seed)
    return [(int(p), int(q), float(f)) for p, q, f in zip(
        rng.integers(nx // 4, 3 * nx // 4, nsrc), rng.integers(nx // 4, 3 * nx // 4, nsrc), rng.uniform(0.1, 1.0, nsrc))]


def build_idg_library(src: Path):
    """A ctypes library of another ``idg_fused.cu`` with the same C interface
    (for example the parent commit's, unpacked under the gitignored
    ``build/``), compiled with the tree's nvcc flags into ``build/``."""
    import ctypes

    from pfb_imaging_tpu_torch.kernels import build

    out = ROOT / "build" / "compare_idg" / "libidg_compare.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)], check=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.pfb_patches_from_vals, lib.pfb_vals_from_patches):
        fn.argtypes = [vp, vp, vp, vp, vp, ll, i, vp]
        fn.restype = i
    return lib


def slot_contraction_matmul_ms(p, vals, reps: int = 10) -> float:
    """Yardstick, used nowhere in the port: the slot contraction alone,
    M_g = Zu_g diag(V_g) Zv_g^T, as one batched complex64 ``torch.matmul``
    on Z tensors built beforehand, with TF32 off. It is not B1's function
    (no recurrence, no taper-DFT products)."""
    import torch

    from pfb_imaging_tpu_torch.ops import idg_fused as F

    zu = F._rot_rows(p.scal[0], p.scal[1], p.S, False).permute(1, 0, 2).contiguous()
    bv = (F._rot_rows(p.scal[2], p.scal[3], p.S, False) * torch.complex(vals[0], vals[1])).permute(1, 2, 0).contiguous()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_ms(lambda: torch.matmul(zu, bv), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def idg_turns(lib, p, vals, pat, reps: int = 10) -> dict:
    """B1 and B2 from ``lib`` and from the tree, timed in turns (compared,
    tree, tree, compared) at plan ``p``, with the compared library's rel Linf
    against the tree's kernels."""
    import torch

    from pfb_imaging_tpu_torch.ops import idg_fused as F

    st = torch.cuda.current_stream(pat.device).cuda_stream
    o1, o2 = torch.empty_like(pat), torch.empty_like(vals)
    args1 = (p.scal.data_ptr(), vals.data_ptr(), p.wcu.data_ptr(), p.wcv.data_ptr(), o1.data_ptr(), p.ngroups, p.S, st)
    args2 = (pat.data_ptr(), p.scal.data_ptr(), p.wcu.data_ptr(), p.wcv.data_ptr(), o2.data_ptr(), p.ngroups, p.S, st)

    def compare_b1():
        require(lib.pfb_patches_from_vals(*args1) == 0, "the compared B1 launched")

    def compare_b2():
        require(lib.pfb_vals_from_patches(*args2) == 0, "the compared B2 launched")

    def tree_b1():
        F.patches_from_vals(p.scal, vals, p.wcu, p.wcv, p.S)

    def tree_b2():
        F.vals_from_patches(pat, p.scal, p.wcu, p.wcv, p.S)

    rec = {}
    for tag, compared, tree in (("b1", compare_b1, tree_b1), ("b2", compare_b2, tree_b2)):
        rec[f"{tag}_ms_compare_tree_tree_compare"] = [cuda_ms(f, reps) for f in (compared, tree, tree, compared)]
    rec["b1_compare_vs_tree_rel"] = rel_linf(o1, F.patches_from_vals(p.scal, vals, p.wcu, p.wcv, p.S))
    rec["b2_compare_vs_tree_rel"] = rel_linf(o2, F.vals_from_patches(pat, p.scal, p.wcu, p.wcv, p.S))
    return rec


def build_tree(dev, workdir: Path, uvw, chans, nband: int, nchan_band: int, srcs, nx: int, cell: float, eps: float,
               gen, phase: str):
    """A .dt tree in the imager's schema at ``workdir / "smoke.dt"``, built on
    the card: per band the port's IDG plan (``w_mode="auto"``, the 8x slot
    budget), sky visibilities plus noise, DIRTY and the PSF (its rfft2 padded
    to 2 nx as PSFHAT). Emits each band's plan layout. Returns (planning s,
    gridding s, band 0's plan, band 0's (vr, vi, wgt), the band records)."""
    import torch

    from pfb_imaging_tpu_torch.core.imager import IDG_MAX_SLOT_FACTOR
    from pfb_imaging_tpu_torch.ops.gridder_idg import plan_idg, vis2dirty_idg
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    nx_psf = 2 * nx
    if workdir.exists():
        shutil.rmtree(workdir)
    root = TreeStore(workdir / "smoke.dt", mode="w")  # the tree format deconv reads
    uvw_d = torch.as_tensor(uvw, device=dev)
    plan_s, grid_s, wsum_tot = 0.0, 0.0, 0.0
    main_plan = main_v = None
    bands = []
    for b in range(nband):
        freq = chans[b * nchan_band : (b + 1) * nchan_band]
        t0 = time.perf_counter()
        # plan_idg raises ValueError if the group padding exceeds the budget
        plan = plan_idg(uvw, freq, nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=eps,
                        max_slot_factor=IDG_MAX_SLOT_FACTOR, divide_by_n=False, device=dev)
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
        bands.append({"phase": phase, "stage": "band", "band": b, "S": plan.S, "w_support": plan.w_support,
                      "nbins": plan.nbins, "ngroups": plan.ngroups,
                      "slots_per_vis": plan.ngroups * plan.G / (vr.numel()), "dirty_peak": float(dirty.max()) / wsum})
        emit(bands[-1])
        if b == 0:
            main_plan, main_v = plan, (vr, vi, wgt)
        del plan
    root.set_attrs(nx=nx, ny=nx, nx_psf=nx_psf, ny_psf=nx_psf, nband=nband, ntime=1,
                   freq_out=[float(chans[b * nchan_band : (b + 1) * nchan_band].mean()) for b in range(nband)],
                   cell_rad=cell, wsum=wsum_tot, complete=True)
    return plan_s, grid_s, main_plan, main_v, bands


def idg_kernels_at_plan(p, vals, f64_groups: int | None = None, reps: int = 10, f64_at_end: bool = False):
    """B1 and B2 at plan ``p`` (anything with ``scal``, ``wcu``, ``wcv``,
    ``S`` and ``ngroups``) on group values ``vals``: CUDA-event ms of the
    kernels and of their f32 plain versions over all ng groups, and each
    kernel's error against its f64 plain version on ``f64_groups`` groups
    (all of them when None; groups are independent), the middle ones or,
    with ``f64_at_end``, the last ones, whose patch offsets are the largest.
    Returns (record, B1's patches)."""
    import torch

    from pfb_imaging_tpu_torch.ops import idg_fused as F

    pat = F.patches_from_vals(p.scal, vals, p.wcu, p.wcv, p.S)
    back = F.vals_from_patches(pat, p.scal, p.wcu, p.wcv, p.S)
    n = p.ngroups if f64_groups is None else min(f64_groups, p.ngroups)
    g0 = p.ngroups - n if f64_at_end else (p.ngroups - n) // 2
    sl = slice(g0, g0 + n)
    d64 = [t[:, sl].double().contiguous() for t in (p.scal, vals, pat)]
    w64 = [p.wcu.double(), p.wcv.double()]
    ref_b1 = F.patches_from_vals_ref(d64[0], d64[1], *w64, p.S)
    ref_b2 = F.vals_from_patches_ref(d64[2], d64[0], *w64, p.S)
    err_b1 = float((pat[:, sl].double() - ref_b1).abs().max())
    err_b2 = float((back[:, sl].double() - ref_b2).abs().max())
    rec = dict(
        ng=p.ngroups, S=p.S, f64_groups=[g0, g0 + n],
        b1_ms=cuda_ms(lambda: F.patches_from_vals(p.scal, vals, p.wcu, p.wcv, p.S), reps),
        b1_plain_ms=cuda_ms(lambda: F.patches_from_vals_ref(p.scal, vals, p.wcu, p.wcv, p.S), 2),
        b2_ms=cuda_ms(lambda: F.vals_from_patches(pat, p.scal, p.wcu, p.wcv, p.S), reps),
        b2_plain_ms=cuda_ms(lambda: F.vals_from_patches_ref(pat, p.scal, p.wcu, p.wcv, p.S), 2),
        b1_max_abs_err=err_b1, b2_max_abs_err=err_b2,
        b1_rel_vs_f64=err_b1 / float(ref_b1.abs().max()), b2_rel_vs_f64=err_b2 / float(ref_b2.abs().max()),
        patch_scale=float(pat.abs().max()), vals_scale=float(back.abs().max()),
    )
    del d64, ref_b1, ref_b2, back
    torch.cuda.empty_cache()
    return rec, pat


def multiband_kernels(model, f64_groups: int | None = None, f64_at_end: bool = False, reps: int = 10):
    """B1 and B2 at the launch shape of the multiband residual that the
    main path just ran: its cached multiband plan (every band's groups end
    to end), on the group values its B1 launch takes for ``model``
    (forward patches of each band, B2, each band's weighting), checked and
    timed by :func:`idg_kernels_at_plan`. Returns (record, the plan)."""
    from types import SimpleNamespace

    import torch

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.ops import idg_fused as F
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_bins_to_grid_patches, _weighted_round_trip

    mb = [v for k, v in TI._PLAN_CACHE.items() if k[0] == "multiband"]
    require(len(mb) == 1, "one multiband plan cached by the main path")
    mplan, wgt = mb[0][0], mb[0][1]
    p0 = mplan.plans[0]
    x = to_device(model, p0.device, real_dtype(p0.device))
    pat = torch.empty((2, mplan.nband * mplan.ngroups, p0.S, p0.S), dtype=p0.rdt, device=p0.device)
    for b, p in enumerate(mplan.plans):
        _idg_bins_to_grid_patches(p, x[b], out=pat[:, mplan.band(b)])
    vals = F.vals_from_patches(pat, mplan.scal, p0.wcu, p0.wcv, p0.S)
    del pat
    for b, p in enumerate(mplan.plans):
        vals[:, mplan.band(b)] = _weighted_round_trip(p, vals[:, mplan.band(b)], wgt[b])
    at = SimpleNamespace(scal=mplan.scal, wcu=p0.wcu, wcv=p0.wcv, S=p0.S, ngroups=mplan.nband * mplan.ngroups)
    rec, _ = idg_kernels_at_plan(at, vals, f64_groups=f64_groups, reps=reps, f64_at_end=f64_at_end)
    rec.update(nband=mplan.nband, ng_band=mplan.ngroups, w_support=mplan.w_support, nbins=p0.nbins,
               patch_elements=2 * rec["ng"] * p0.S**2)
    del vals
    torch.cuda.empty_cache()
    return rec, mplan


def assembly_bounds(pairs) -> tuple:
    """The least time (ms) of K1 and of K2 over ``pairs`` ((plan, bin), all
    of one launch shape): bytes, each moved once, over the HBM rate. K1
    reads each group's two S x S f32 planes, the bin's CSR row (4 (nbu nbv
    + 1) bytes) and, where the plan has one, its order entries (4 bytes a
    group), and writes the bin's complex64 grid once; K2 reads the grid and
    the groups' int64 bucket ids and writes their patches. Their operations
    (two f32 adds a patch element for K1, none for K2) take a thousandth of
    that at the f32 rate."""
    from pfb_imaging_tpu_torch.ops.gridder_idg import bucket_csr

    k1 = k2 = 0
    for p, b in pairs:
        gc, grid = p.bin_gcount[b], 8 * p.nbig_x * p.nbig_y
        k1 += 8 * gc * p.S**2 + grid + 4 * (p.nbu * p.nbv + 1) + (4 * gc if bucket_csr(p).order is not None else 0)
        k2 += grid + 8 * gc + 8 * gc * p.S**2
    return k1 / HBM_BYTES_PER_S * 1e3, k2 / HBM_BYTES_PER_S * 1e3


def forward_grid(p, x, b: int):
    """Bin ``b``'s complex (nbig_x, nbig_y) forward uv grid of image ``x``
    at plan ``p``, as the forward computes it before K2."""
    import torch

    from pfb_imaging_tpu_torch import complex_dtype
    from pfb_imaging_tpu_torch.ops.gridder_idg import _screen

    y = x.to(p.rdt).to(complex_dtype(p.rdt)) * torch.complex(p.corr_re, p.corr_im).conj()
    if p.do_wgridding:
        y = y * _screen(p, b, 1.0)
    px0, py0 = p.nbig_x // 2 - p.nx // 2, p.nbig_y // 2 - p.ny // 2
    padded = torch.zeros((p.nbig_x, p.nbig_y), dtype=y.dtype, device=y.device)
    padded[px0 : px0 + p.nx, py0 : py0 + p.ny] = y
    return torch.fft.fft2(torch.fft.ifftshift(padded))


def assembly_kernels(plans: list, patches: list, grids: list, reps: int = 5, gather_bins: int = 1) -> dict:
    """K1 (``assemble_bin``) and K2 (``extract_bin``) at one launch shape:
    every non-empty bin of every plan of ``plans`` (the bands of a
    multiband launch), plan i's groups taken from ``patches[i]`` (a view
    into the launch's patch tensor) and its forward grid ``grids[i]`` (one
    grid a plan, for all its bins). Per bin: K1 twice, the same bits
    required, held against its plain version in f32 (the old path, whose
    ``index_add_`` adds atomically on the card) and in f64, and on the first
    ``gather_bins`` bins against the gather-form plain version (K1's own
    chunks and order of sums: the same bits required, and of the chunk
    sums); K2 twice into its patches, the same bits required, held against
    its plain version; both within 1e-6 relative L-inf (K1 of the f32 plain
    version, or, where that is itself more than 1e-6 from f64, nearer to
    f64 than it, as with thousands of random groups in one bucket). CUDA-event
    ms of all bins through K1 and through the old path, and of K2 and of
    its plain version (the launch's whole assembly, or its whole
    extraction); the bounds. K2 overwrites ``patches``."""
    import torch

    from pfb_imaging_tpu_torch.ops import gridder_idg as GI

    pairs = [(i, b) for i, p in enumerate(plans) for b in range(p.nbins) if p.bin_gcount[b]]
    k1_rel = k1_rel64 = k1_err = k1_gather_rel = k2_rel = k2_err = plain_rel64 = 0.0
    k1_same = k1_gather_same = k2_same = k2_plain_same = chunks_gather_same = k1_f32_ok = True
    k1_worst = {}
    for n, (i, b) in enumerate(pairs):
        p, pat = plans[i], patches[i]
        gs, gc = p.bin_gstart[b], p.bin_gcount[b]
        bid_b = p.bid[gs : gs + gc]
        g1, g2 = GI.assemble_bin(p, pat, b), GI.assemble_bin(p, pat, b)
        k1_same &= bool(torch.equal(g1, g2))
        ref32 = GI._assemble_bin(p, pat[:, gs : gs + gc], bid_b)
        ref64 = GI._assemble_bin(p, pat[:, gs : gs + gc].double(), bid_b)
        rel, rel64 = rel_linf(g1, ref32), rel_linf(g1.to(ref64.dtype), ref64)
        plain64 = rel_linf(ref32.to(ref64.dtype), ref64)
        # the f32 plain version sums a long bucket's groups one after another
        # (in no fixed order on the card): where that alone leaves it more
        # than 1e-6 from f64, K1 must instead be the nearer of the two to f64
        if float(ref64.abs().max()) == 0.0:  # a bin of empty groups only: K1 must give zeros
            k1_f32_ok &= not bool(g1.any())
        else:
            k1_f32_ok &= rel <= 1e-6 or (plain64 > 1e-6 and rel64 < plain64)
        if rel64 >= k1_rel64 or rel >= k1_rel:  # the bin furthest from a plain version, for the record
            k1_worst = dict(plan=i, bin=b, rel_vs_plain=rel, rel_vs_f64=rel64, plain_rel_vs_f64=plain64)
        k1_rel, k1_rel64, plain_rel64 = max(k1_rel, rel), max(k1_rel64, rel64), max(plain_rel64, plain64)
        k1_err = max(k1_err, float((g1.to(ref64.dtype) - ref64).abs().max()))
        if n < gather_bins:
            gref = GI.assemble_bin_gather_ref(p, pat, b)
            k1_gather_same &= bool(torch.equal(g1, gref))
            k1_gather_rel = max(k1_gather_rel, rel_linf(g1, gref))
            part = GI.chunk_sums(p, pat, b)
            if part is not None:
                chunks_gather_same &= bool(torch.equal(part, GI.chunk_sums_ref(p, pat, b)))
            del gref, part
        del g1, g2, ref32, ref64
    fill = [q.fill_(float("nan")) for q in patches]  # K2 must write every group
    for i, b in pairs:
        p, out = plans[i], fill[i]
        gs, gc = p.bin_gstart[b], p.bin_gcount[b]
        GI.extract_bin(p, grids[i], b, out)
        e1 = out[:, gs : gs + gc].clone()
        GI.extract_bin(p, grids[i], b, out)
        k2_same &= bool(torch.equal(e1, out[:, gs : gs + gc]))
        ref = GI._extract_bin(p, grids[i], p.bid[gs : gs + gc])
        k2_plain_same &= bool(torch.equal(e1, ref))
        k2_rel = max(k2_rel, rel_linf(e1, ref))
        k2_err = max(k2_err, float((e1 - ref).abs().max()))
        del e1, ref
    covered = not any(bool(q.isnan().any()) for q in fill)
    torch.cuda.synchronize()

    def k1():
        for i, b in pairs:
            GI.assemble_bin(plans[i], patches[i], b)

    def k1_chunks():
        for i, b in pairs:
            GI.chunk_sums(plans[i], patches[i], b)

    def k1_plain():
        for i, b in pairs:
            p = plans[i]
            gs, gc = p.bin_gstart[b], p.bin_gcount[b]
            GI._assemble_bin(p, patches[i][:, gs : gs + gc], p.bid[gs : gs + gc])

    def k2():
        for i, b in pairs:
            GI.extract_bin(plans[i], grids[i], b, patches[i])

    def k2_plain():
        for i, b in pairs:
            p = plans[i]
            gs, gc = p.bin_gstart[b], p.bin_gcount[b]
            patches[i][:, gs : gs + gc] = GI._extract_bin(p, grids[i], p.bid[gs : gs + gc])

    k1_bound, k2_bound = assembly_bounds([(plans[i], b) for i, b in pairs])
    # what sets K1's time: the fullest bucket's groups and the empty groups a
    # padded plan puts in bucket 0, cut into chunks; the longest chains
    runs = [GI.bucket_csr(p).starts.diff() for p in plans]
    chains = [chain_lengths(plans[i], b) for i, b in pairs]
    chunk_len = [GI.bucket_csr(p).chunks.diff(dim=1) for p in plans if GI.bucket_csr(p).chunks is not None]
    rec = dict(
        max_groups_per_bucket=max(int(r.max()) for r in runs),
        groups_in_bucket_0=max(int(r[:: p.nbu * p.nbv].max()) for r, p in zip(runs, plans)),
        long_buckets=sum(int((r > GI.LONG_BUCKET).sum()) for r in runs),
        chunks=sum(len(c) for c in chunk_len), longest_chunk=max((int(c.max()) for c in chunk_len), default=0),
        longest_cell_chain=max(c[0] for c in chains), longest_cell_chain_unchunked=max(c[1] for c in chains),
        empty_groups=sum(int((p.cg_idx == p.nrow * p.nchan).all(1).sum()) for p in plans),
        nplans=len(plans), bins=len(pairs), ng=sum(p.ngroups for p in plans), S=plans[0].S,
        nbig=[plans[0].nbig_x, plans[0].nbig_y], padded_order=[GI.bucket_csr(p).order is not None for p in plans],
        k1_ms=cuda_ms(k1, reps), k1_chunk_sums_ms=cuda_ms(k1_chunks, reps), k1_plain_ms=cuda_ms(k1_plain, 2),
        k2_ms=cuda_ms(k2, reps), k2_plain_ms=cuda_ms(k2_plain, 2), k1_bound_ms=k1_bound, k2_bound_ms=k2_bound,
        k1_rel_vs_plain=k1_rel, k1_rel_vs_f64=k1_rel64, k1_plain_rel_vs_f64=plain_rel64, k1_max_abs_err=k1_err,
        k1_two_runs_identical=k1_same, k1_worst_bin=k1_worst,
        k1_gather_bins=min(gather_bins, len(pairs)), k1_gather_identical=k1_gather_same, k1_rel_vs_gather=k1_gather_rel,
        k1_chunk_sums_gather_identical=chunks_gather_same,
        k2_rel_vs_plain=k2_rel, k2_max_abs_err=k2_err, k2_plain_identical=k2_plain_same,
        k2_two_runs_identical=k2_same, k2_wrote_every_group=covered,
    )
    require(k1_same and k2_same, "K1/K2: two launches give the same bits")
    require(k1_gather_same and chunks_gather_same, "K1 and its chunk sums give the gather form's bits")
    require(max(k1_rel64, k1_gather_rel, k2_rel) <= 1e-6 and k1_f32_ok,
            f"K1/K2 within 1e-6 of their plain versions (K1 {k1_worst}, K2 {k2_rel})")
    require(covered, "K2 wrote every group of the launch")
    return rec


def chain_lengths(p, b: int) -> tuple:
    """The longest chain of adds one cell of bin ``b`` makes in K1's
    assembly (a group of a short bucket, or a chunk partial of a long one,
    each one add), and the same without chunks (every group): over the
    cells, the sum over its wraps and quarters of its buckets' terms."""
    import torch

    from pfb_imaging_tpu_torch.ops import gridder_idg as GI

    csr, nb, r = GI.bucket_csr(p), p.nbu * p.nbv, p.S // p.half
    counts = csr.starts[b * nb : (b + 1) * nb + 1].diff().to(torch.int64)
    parts = torch.zeros_like(counts) if csr.pstarts is None else csr.pstarts[b * nb : (b + 1) * nb + 1].diff()
    terms = torch.where(parts > 0, parts.to(torch.int64), counts)
    ext_u, ext_v = GI._ext_dims(p)
    new = torch.zeros((p.nbig_x, p.nbig_y), dtype=torch.int64, device=counts.device)
    old = torch.zeros_like(new)
    for wu in GI._axis_terms(p.nbig_x, p.nbu, ext_u, p.half, r, p.k0_off, counts.device):
        for wv in GI._axis_terms(p.nbig_y, p.nbv, ext_v, p.half, r, p.k0_off, counts.device):
            for oku, bu, _ in wu:
                for okv, bv, _ in wv:
                    k = bu[:, None] * p.nbv + bv[None, :]
                    ok = oku[:, None] & okv[None, :]
                    new += torch.where(ok, terms[k], 0)
                    old += torch.where(ok, counts[k], 0)
    return int(new.max()), int(old.max())


def multiband_assembly(model, reps: int = 5) -> dict:
    """At the multiband plan the main path just cached: the multiband
    Hessian of ``model`` twice (the same bits required, no determinism
    switch; its CUDA-event ms), then :func:`assembly_kernels` on the
    patches its B1 launch takes and each band's bin-0 forward grid."""
    import torch

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.ops import idg_fused as F
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_bins_to_grid_patches, _weighted_round_trip
    from pfb_imaging_tpu_torch.parallel.sharded import multiband_hessian_vis_idg

    mb = [v for k, v in TI._PLAN_CACHE.items() if k[0] == "multiband"]
    require(len(mb) == 1, "one multiband plan cached by the main path")
    mplan, wgt = mb[0][0], mb[0][1]
    p0 = mplan.plans[0]
    x = to_device(model, p0.device, real_dtype(p0.device))
    h1, h2 = multiband_hessian_vis_idg(mplan, x, wgt), multiband_hessian_vis_idg(mplan, x, wgt)
    rec = dict(hessian_two_runs_identical=bool(torch.equal(h1, h2)),
               hessian_ms=cuda_ms(lambda: multiband_hessian_vis_idg(mplan, x, wgt), 2))
    del h1, h2
    pat = torch.empty((2, mplan.nband * mplan.ngroups, p0.S, p0.S), dtype=p0.rdt, device=p0.device)
    for b, p in enumerate(mplan.plans):
        _idg_bins_to_grid_patches(p, x[b], out=pat[:, mplan.band(b)])
    vals = F.vals_from_patches(pat, mplan.scal, p0.wcu, p0.wcv, p0.S)
    del pat
    for b, p in enumerate(mplan.plans):
        vals[:, mplan.band(b)] = _weighted_round_trip(p, vals[:, mplan.band(b)], wgt[b])
    pat = F.patches_from_vals(mplan.scal, vals, p0.wcu, p0.wcv, p0.S)
    del vals
    grids = [forward_grid(p, x[b], 0) for b, p in enumerate(mplan.plans)]
    rec.update(assembly_kernels(mplan.plans, [pat[:, mplan.band(b)] for b in range(mplan.nband)], grids, reps=reps))
    del pat, grids
    torch.cuda.empty_cache()
    return rec


def phase_kernels_assembly(dev, nrow: int = 20_000, nx: int = 512) -> list:
    """K1/K2 at small plans on the card, every bin: chirp at S = 16 and at
    S = 24 with half 8 (r = 3), and a wplanes plan at S = 32 padded to per-bin
    capacities (its groups out of bucket order, as the multiband plans lay
    them), by 3 groups a bin and by 4000 (bucket 0 then holds thousands of
    groups, summed in chunks), on seeded patches and grids, the padding's
    too; :func:`assembly_kernels` with the gather-form plain version on
    every bin (the same bits required: it adds in K1's order)."""
    import torch

    from pfb_imaging_tpu_torch.ops.gridder_idg import plan_idg

    rng = np.random.default_rng(51)
    uvw, freq = bench_coords(rng, nrow, 2)
    uvw[:, 2] *= 30.0
    cell = 2e-6 * 4096 / nx
    kw = dict(nx=nx, ny=nx, cellx=cell, celly=cell, do_wgridding=True, divide_by_n=False, dtype=torch.float32,
              device=dev)
    out = []
    for name, extra in (("chirp_s16", dict(epsilon=1e-5, w_mode="chirp")),
                        ("chirp_s24_half8", dict(epsilon=1e-5, subgrid=24, half=8, w_mode="chirp")),
                        ("wplanes_s32_padded", dict(epsilon=1e-7, w_mode="wplanes")),
                        ("wplanes_s32_long_bucket0", dict(epsilon=1e-7, w_mode="wplanes"))):
        if name.startswith("wplanes"):
            counts = plan_idg(uvw, freq, count_only=True, **kw, **extra)[1]
            pad = 4000 if name.endswith("bucket0") else 3
            extra = dict(extra, bin_gcap=tuple(int(c) + pad for c in counts))
        p = plan_idg(uvw, freq, **kw, **extra)
        pat = torch.as_tensor(rng.standard_normal((2, p.ngroups, p.S, p.S)), device=dev).float()
        g = rng.standard_normal((2, p.nbig_x, p.nbig_y))
        grid = torch.complex(*(torch.as_tensor(a, device=dev).float() for a in g))
        rec = dict(case=name, half=p.half, w_support=p.w_support, nbins=p.nbins,
                   **assembly_kernels([p], [pat], [grid], reps=5, gather_bins=p.nbins))
        emit({"phase": "kernels", "kernel": "idg_assemble+idg_extract", **rec})
        out.append(rec)
    require(any(r["padded_order"][0] for r in out), "a padded plan's groups taken through the CSR's order")
    require(out[-1]["groups_in_bucket_0"] >= 4000 and out[-1]["chunks"] > 0, "bucket 0 summed in chunks")
    return out


@contextlib.contextmanager
def plans_made(module):
    """The IDG plans ``module`` (``core.imager`` or ``core.degrid``) makes
    inside the block, in the order they were made: one dict (nx, freq,
    nbins, w_support, ngroups) a plan."""
    made, plan_idg = [], module.plan_idg

    def planned(uvw, freq, **kw):
        p = plan_idg(uvw, freq, **kw)
        made.append(dict(nx=kw["nx"], freq=np.asarray(freq), nbins=p.nbins, w_support=p.w_support,
                         ngroups=p.ngroups))
        return p

    module.plan_idg = planned
    try:
        yield made
    finally:
        module.plan_idg = plan_idg


def imager_plan_kernels(dev, dt_path: str, plans: list, band: int = 0, eps: float = 1e-7, f64_groups: int = 65536):
    """B1 at the imager's own launch shapes for ``band``: its image plan and
    its PSF plan, planned again from the partition the imager wrote to the
    tree with the imager's arguments (epsilon ``eps``, w-gridding, no slot
    budget, the device's type) and required equal to the imager's plans
    (``plans``, from ``plans_made``) in bins, w-support and groups, on the
    group values the imager's B1 launch takes (weighted visibilities; unit
    ones for the PSF); B2 on B1's patches at the same plan. Each checked
    and timed by :func:`idg_kernels_at_plan` (f64 on ``f64_groups`` middle
    groups), and required within 2e-6 of f64. Returns {"image": record,
    "psf": record}."""
    import torch

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.core.imager import _psf_vis
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_prepare, plan_idg
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    tree = TreeStore(dt_path)
    a = tree.attrs
    pg = tree.group(f"band{band:04d}_time0000").group("part0000")
    uvw, f = np.asarray(pg.read("UVW")), np.asarray(pg.read("FREQ"))
    l0, m0 = pg.attrs.get("l0", 0.0), pg.attrs.get("m0", 0.0)
    rdt = real_dtype(dev)
    wm = to_device(np.asarray(pg.read("WEIGHT")) * np.asarray(pg.read("MASK")), dev, rdt)
    kw = dict(cellx=a["cell_rad"], celly=a["cell_rad"], l0=l0, m0=m0, epsilon=eps, do_wgridding=True,
              divide_by_n=False, dtype=rdt, device=dev)
    out = {}
    for kind, n, vis in (("image", a["nx"], np.asarray(pg.read("VIS"))), ("psf", a["nx_psf"], _psf_vis(uvw, f, l0, m0))):
        p = plan_idg(uvw, f, nx=n, ny=n, **kw)
        shape = dict(nbins=p.nbins, w_support=p.w_support, ngroups=p.ngroups)
        info = [{k: q[k] for k in shape} for q in plans if q["nx"] == n and np.array_equal(q["freq"], f)]
        require(info == [shape], f"band {band}'s {kind} plan planned again equals the imager's")
        vals = _idg_prepare(p, to_device(vis.real, dev, rdt), to_device(vis.imag, dev, rdt), wm)
        rec, _ = idg_kernels_at_plan(p, vals, f64_groups=f64_groups)
        rec.update(nx=n, **shape)
        require(rec["b1_rel_vs_f64"] <= 2e-6 and rec["b2_rel_vs_f64"] <= 2e-6,
                f"B1/B2 vs f64 plain at band {band}'s {kind} plan")
        out[kind] = rec
        del p, vals
        torch.cuda.empty_cache()
    return out


def pipeline_multiband_kernels(dt_path: str, nband: int) -> dict:
    """B1/B2 at the launch shape of the multiband residual that ``sara``
    just ran on ``dt_path`` (its cached plan, on the tree's final MODEL),
    f64 on the last 65,536 groups, required within 2e-6; then the plan
    cache is emptied."""
    import torch

    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    tree = TreeStore(dt_path)
    model = np.stack([np.asarray(tree.group(f"band{b:04d}_time0000").read("MODEL")) for b in range(nband)])
    kern, mplan = multiband_kernels(model, f64_groups=65536, f64_at_end=True)
    require(kern["b1_rel_vs_f64"] <= 2e-6 and kern["b2_rel_vs_f64"] <= 2e-6,
            f"B1/B2 vs f64 plain at sara's multiband launch on {Path(dt_path).name}")
    del mplan
    TI._PLAN_CACHE.clear()
    TI._PLAN_CACHE_BYTES = 0
    torch.cuda.empty_cache()
    return kern


def residual_routes(dev, dt, keys, model, eps: float, residual, trace: bool):
    """The residual of ``model`` by the multiband and by the per-band route,
    each queued whole on the card before it is fetched, as ``deconv`` does:
    seconds of a first call (the per-band route plans here; the multiband
    plans are cached by the main path) and of a second, optionally one
    traced call each (device busy ms and idle share), and each route's
    difference from the other and from ``residual`` (deconv's own, by the
    multiband route), rel Linf. Both must stay within ``ROUTE_REL_LIMIT``."""
    import torch

    from pfb_imaging_tpu_torch import to_host
    from pfb_imaging_tpu_torch.core import imager as TI

    def multiband():
        r = TI.residual_from_parts_multiband(dt, keys, model, epsilon=eps, as_device=True, device=dev)
        require(r is not None, "the multiband route took the final model")
        return to_host(r).astype(np.float64)

    def per_band():
        rs = [TI.residual_from_parts(dt.group(k), model[b], epsilon=eps, as_device=True, device=dev)
              for b, k in enumerate(keys)]
        return np.stack([to_host(r).astype(np.float64) for r in rs])

    rec = {}
    for rep in ("first", "steady"):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        r_mb = multiband()
        t1 = time.perf_counter()
        r_pb = per_band()
        rec[rep] = dict(multiband_seconds=t1 - t0, per_band_seconds=time.perf_counter() - t1,
                        max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    if trace:
        rec["traced"] = {}
        for name, fn in (("multiband", multiband), ("per_band", per_band)):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_prof = (time.perf_counter() - t0) * 1e3
            busy = busy_ms(prof)
            rec["traced"][name] = dict(profiled_wall_ms=wall_prof, device_busy_ms=busy,
                                       idle_share=max(0.0, 1.0 - busy / wall_prof), top_kernels=top_device_ops(prof, 8))
    pb = [v for k, v in TI._PLAN_CACHE.items() if k[0] not in ("multiband", "multiband_declined")]
    rec.update(per_band_plans=[dict(idg=c[4], w_support=c[0].w_support if c[4] else None,
                                    ngroups=c[0].ngroups if c[4] else None) for c in pb],
               multiband_vs_per_band_rel=rel_linf_np(r_mb, r_pb),
               deconv_residual_vs_multiband_rel=rel_linf_np(residual, r_mb),
               limit=ROUTE_REL_LIMIT)
    require(np.isfinite(r_mb).all() and np.isfinite(r_pb).all(), "both residual routes finite")
    require(len(pb) == len(keys) and all(c[4] for c in pb), "the per-band route ran on IDG plans")
    require(rec["multiband_vs_per_band_rel"] <= ROUTE_REL_LIMIT, "the multiband residual matches the per-band one")
    require(rec["deconv_residual_vs_multiband_rel"] <= ROUTE_REL_LIMIT, "deconv's residual matches the multiband one")
    return rec


def phase_main(dev, workdir: Path, nx: int = 2048, nant: int = 64, ntime: int = 500, nband: int = 4,
               nchan_band: int = 4, niter: int = 3, eps: float = 1e-7, seed: int = 42, nsrc: int = 24,
               compare_idg=None):
    """Build a .dt tree on the card with the port's gridding, then deconv.
    With ``compare_idg`` (a ctypes library from ``build_idg_library``), its
    B1/B2 are timed in turns with the tree's at band 0's plan."""
    import torch

    from pfb_imaging_tpu_torch.core import deconv as tdeconv
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_prepare, hessian_vis_idg, to_group_layout, vis2dirty_idg
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    nx_psf = 2 * nx
    cell = 8e-6 * 1024 / nx
    uvw = synth_array(nant, ntime, seed, wscale=0.01)
    chans = channels(nband * nchan_band, *L_BAND)
    srcs = point_sources(nx, nsrc, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nvis = uvw.shape[0] * chans.size
    rec = dict(nx=nx, nx_psf=nx_psf, nband=nband, nrow=uvw.shape[0], nvis=nvis, epsilon=eps, cell_rad=cell)
    emit({"phase": "main_path", "stage": "layout", **rec})

    dt_path = workdir / "smoke.dt"
    plan_s, grid_s, main_plan, main_v, _ = build_tree(dev, workdir, uvw, chans, nband, nchan_band, srcs, nx, cell,
                                                      eps, gen, "main_path")

    # gridding throughput and the kernels at the main path's shapes (band 0)
    vr, vi, wgt = main_v
    t0 = time.perf_counter()
    vis2dirty_idg(main_plan, vr, wgt=wgt, vis_im=vi)
    torch.cuda.synchronize()
    mvis_s = vr.numel() / (time.perf_counter() - t0) / 1e6
    p = main_plan
    vals = _idg_prepare(p, vr, vi, wgt)
    timing, pat = idg_kernels_at_plan(p, vals)
    wgt_g = to_group_layout(p, wgt)
    img = torch.ones((nx, nx), dtype=torch.float32, device=dev)
    timing.update(hessian_vis_ms=cuda_ms(lambda: hessian_vis_idg(p, img, wgt_g), 5),
                  yardstick_slot_contraction_complex64_matmul_ms=slot_contraction_matmul_ms(p, vals))
    if compare_idg is not None:
        timing["compare"] = idg_turns(compare_idg, p, vals, pat)
    emit({"phase": "main_path", "stage": "kernels_at_main_shapes", **timing})
    require(timing["b1_rel_vs_f64"] <= 2e-6 and timing["b2_rel_vs_f64"] <= 2e-6,
            "B1/B2 vs f64 plain at the main path's shapes")
    del main_plan, main_v, p, vals, pat, vr, vi, wgt, wgt_g, img
    torch.cuda.empty_cache()

    # the main path: counters zeroed right before deconv
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    model, residual = tdeconv.deconv(str(dt_path), niter=niter, epsilon=eps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    launches, cyc = got["launches"], got["cycles"]
    for s in cyc:
        emit({"phase": "main_path", "stage": "cycle", **s})
    mfs = model.sum(0)
    peak = np.unravel_index(np.argmax(mfs), mfs.shape)
    near = min(abs(int(peak[0]) - p_) + abs(int(peak[1]) - q_) for p_, q_, _ in srcs)
    summary = dict(
        deconv_seconds=wall, plan_seconds_smoke=plan_s, plan_seconds_deconv=got["spans"].get("residual.plan", 0.0),
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
    require(launches["idg_assemble"] > 0 and launches["idg_extract"] > 0, "K1 and K2 launched")
    require(launches["idg_chunk_sums"] > 0, "K1's chunk sums launched")
    require(launches["psi_analysis"] > 0 and launches["psi_synthesis_ext"] > 0, "P1 and P2 (two cubes) launched")
    require(near <= 1, "brightest model pixel on a true source")
    require(got["counters"].get("residual.multiband_parts", 0) == niter and
            got["counters"].get("residual.fallback_bands", 0) == 0, "every residual took the multiband route")

    # B1/B2 at the launch shape deconv ran (all bands' groups), f64 on all
    mb_kern, _ = multiband_kernels(model)
    emit({"phase": "main_path", "stage": "kernels_at_multiband_launch", **mb_kern})
    require(mb_kern["b1_rel_vs_f64"] <= 2e-6 and mb_kern["b2_rel_vs_f64"] <= 2e-6,
            "B1/B2 vs f64 plain at the main path's multiband launch")
    # K1/K2 at the same launch, and the multiband Hessian twice
    asm = multiband_assembly(model)
    emit({"phase": "main_path", "stage": "assembly_at_multiband_launch", **asm})
    keys = [f"band{b:04d}_time0000" for b in range(nband)]
    routes = residual_routes(dev, TreeStore(dt_path), keys, model, eps, residual, trace=True)
    emit({"phase": "main_path", "stage": "residual_routes", **routes})
    TI._PLAN_CACHE.clear()
    TI._PLAN_CACHE_BYTES = 0
    torch.cuda.empty_cache()
    phase_profile(dev, dt_path, cyc[-1]["lam"])
    shutil.rmtree(workdir)
    return timing, mb_kern, asm, launches, summary


def write_xds(path: Path, uvw, chans, re, im) -> None:
    """A Stokes-I visibility store in ``init``'s schema: root attributes and
    one partition with VIS, WEIGHT, MASK, UVW and FREQ (unit weights)."""
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    xds = TreeStore(path, mode="w")
    xds.set_attrs(ra=0.0, dec=-0.5, product="I", freq=[float(f) for f in chans], cell_rad=None, beam_diameter=None)
    g = xds.group("scan0000")
    g.set_attrs(time=0.0, l0=0.0, m0=0.0)
    vis = np.empty(tuple(re.shape), np.complex64)
    vis.real, vis.imag = re.cpu().numpy(), im.cpu().numpy()
    g.write("VIS", vis)
    g.write("WEIGHT", np.ones(vis.shape, np.float32))
    g.write("MASK", np.ones(vis.shape, np.uint8))
    g.write("UVW", uvw)
    g.write("FREQ", chans)


def phase_imager(dev, workdir: Path, nx: int = 2048, nant: int = 64, ntime: int = 500, nband: int = 4,
                 nchan: int = 16, eps: float = 1e-5, seed: int = 43, nsrc: int = 24):
    """The imager main path: a store of the 64-antenna array with its own
    (uncompressed) w, 16 channels over 856-1712 MHz, seeded point sources
    plus noise summed on the card, imaged by the port's
    ``imager(gridder="pallas")`` in f32 at 2048^2 (4096^2 PSF, 8192^2 PSF
    grid) with Briggs weights. Counts are zeroed right before ``imager`` and
    read right after; then the products are checked, band 0's DIRTY is held
    against the port's f64 stack route on the same data, and B3 against its
    f64 plain version at band 0's own PSF plan."""
    import torch

    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.ops import gridder_pallas as GP
    from pfb_imaging_tpu_torch.ops.gridder import _vis2dirty_prepare, plan_wgridder, vis2dirty_plain

    cell_arcsec = 0.8251
    cell = cell_arcsec * np.pi / 180 / 3600
    uvw = synth_array(nant, ntime, seed, wscale=1.0)
    chans = channels(nchan, *L_BAND)
    srcs = point_sources(nx, nsrc, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    re, im = sky_vis(torch.as_tensor(uvw, device=dev), chans, srcs, cell, nx, 1.0, gen)
    write_xds(workdir / "smoke.xds", uvw, chans, re, im)
    del re, im
    rec = dict(nx=nx, nrow=uvw.shape[0], nvis=uvw.shape[0] * nchan, nband=nband, epsilon=eps,
               max_abs_w_lambda=float(np.abs(uvw[:, 2]).max() * chans.max() / LIGHTSPEED))
    emit({"phase": "imager", "stage": "data", **rec})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = TI.imager(str(workdir / "smoke.xds"), str(workdir / "smoke.dt"), nband=nband, nx=nx, ny=nx,
                    cell_size=cell_arcsec, psf_oversize=2.0, robustness=0.0, epsilon=eps, gridder="pallas",
                    double_precision=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    launches, c = got["launches"], got["counters"]
    summary = dict(imager_seconds=wall, **command_stats(got, "imager"),
                   gridded_mvis_per_s=3 * c["imager.nvis"] / got["spans"]["imager.grid"] / 1e6,
                   plans=c["imager.plans"], plans_wstack=c.get("imager.plans.wstack", 0),
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches,
                   host_planner_calls={k: c.get(f"plan.{k}", 0) for k in ("native", "numpy")})
    emit({"phase": "imager", "stage": "imager", **summary})
    require(launches["scatter_grid_wstack"] > 0, "B3 launched during imager")
    require(out.attrs["complete"] is True and out.attrs["nx_psf"] == 2 * nx, "tree complete at the PSF size")

    bands = []
    for b in range(nband):
        node = out.group(f"band{b:04d}_time0000")
        wsum = float(np.asarray(node.read("WSUM"))[0])
        dirty, psf, noise = (np.asarray(node.read(k)) for k in ("DIRTY", "PSF", "NOISE"))
        require(all(np.isfinite(a).all() for a in (dirty, psf, noise)), f"band {b} products finite")
        peak = np.unravel_index(np.argmax(dirty), dirty.shape)
        near = min(abs(int(peak[0]) - p_) + abs(int(peak[1]) - q_) for p_, q_, _ in srcs)
        bands.append(dict(band=b, wsum=wsum, psf_peak_over_wsum=float(psf.max()) / wsum,
                          dirty_peak_over_wsum=float(dirty.max()) / wsum, dirty_peak_offset_px=near,
                          noise_rms=float(noise.std()) / wsum))
        require(abs(bands[-1]["psf_peak_over_wsum"] - 1.0) <= 1e-4, f"band {b} PSF peak / WSUM = 1")
    emit({"phase": "imager", "stage": "bands", "bands": bands})
    require(bands[0]["dirty_peak_offset_px"] <= 1, "band 0's brightest DIRTY pixel on a true source")

    # band 0: the stack route in f64 on the same data, and B3 at the PSF plan
    pg = out.group("band0000_time0000").group("part0000")
    uvw0, f0 = np.asarray(pg.read("UVW")), np.asarray(pg.read("FREQ"))
    vis0 = np.asarray(pg.read("VIS"))
    wm = torch.as_tensor(np.asarray(pg.read("WEIGHT")) * np.asarray(pg.read("MASK")), device=dev)
    kw = dict(cellx=float(out.attrs["cell_rad"]), celly=float(out.attrs["cell_rad"]), epsilon=eps, divide_by_n=False)
    t0 = time.perf_counter()
    plan64 = plan_wgridder(uvw0, f0, nx=nx, ny=nx, dtype=np.float64, device=dev, **kw)
    d64 = vis2dirty_plain(plan64, torch.as_tensor(vis0.real, device=dev).double(), wm.double(),
                          vis_im=torch.as_tensor(vis0.imag, device=dev).double())
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    dirty0 = torch.as_tensor(np.asarray(out.group("band0000_time0000").read("DIRTY")), device=dev)
    stack_rel = rel_linf(dirty0, d64)
    del plan64, d64, dirty0
    # B3 at band 0's PSF plan (its 20 PSF launches) and image plan (its 16
    # DIRTY and NOISE launches), one middle chunk each; and at the PSF plan
    # with uv stretched to 90% of the grid's width, so that four times as
    # many tiles hold visibilities: a larger scratch buffer
    ones = torch.ones(tuple(wm.shape), dtype=torch.float32, device=dev)
    dense = uvw0.copy()
    dense[:, :2] *= 0.45 / (np.abs(uvw0[:, :2]).max() * f0.max() / LIGHTSPEED * kw["cellx"])
    b3 = {}
    for name, n, u in (("psf", 2 * nx, uvw0), ("image", nx, uvw0), ("dense_psf", 2 * nx, dense)):
        plan = plan_wgridder(u, f0, nx=n, ny=n, dtype=np.float32, device=dev, **kw)
        vals = _vis2dirty_prepare(plan, ones, torch.zeros_like(ones), wm.float())
        nw = min(GP.PLANE_CHUNK, plan.nw)
        b3[name] = scatter_check(plan, vals, max(0, plan.nw // 2 - nw // 2), nw, reps=5)
        del plan, vals
        torch.cuda.empty_cache()
    rec = dict(dirty_vs_stack_f64_rel=stack_rel, stack_f64_seconds=stack_s,
               **{f"b3_at_{name}_plan": r for name, r in b3.items()})
    emit({"phase": "imager", "stage": "checks", **rec})
    require(stack_rel <= 2e-5, "band 0 DIRTY (pallas, f32) vs the stack route (f64)")
    for name in b3:
        require(b3[name]["rel_vs_f64"] <= 1e-5, f"B3 vs f64 plain at band 0's {name} plan")
    del wm, ones, dense
    # the store and the tree stay for the degrid phase, which removes them
    return b3, launches, dict(workdir=workdir, uvw=uvw, chans=chans, srcs=srcs, nx=nx)


def sky_model_mds(path: Path, srcs, nx: int, freqs, device):
    """A .mds of point sources with a flat spectrum over ``freqs`` (one time),
    fitted by the port's ``fit_image_cube``."""
    from pfb_imaging_tpu_torch.utils.modelspec import fit_image_cube, save_mds
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    cube = np.zeros((1, len(freqs), nx, nx))
    for p, q, flux in srcs:
        cube[:, :, p, q] = flux
    coeffs, ix, iy, mattrs = fit_image_cube(np.zeros(1), np.asarray(freqs), cube, device=device)
    save_mds(TreeStore(path, mode="w"), coeffs, ix, iy, mattrs)
    return str(path)


def model_data_error(xds_path: Path, srcs, cell: float, nx: int, dev) -> dict:
    """MODEL_DATA of the store's one partition against the noise-free
    visibilities of ``srcs`` summed on the card: rel Linf against max|V|."""
    import torch

    from pfb_imaging_tpu_torch.utils.store import TreeStore

    g = TreeStore(xds_path).group("scan0000")
    uvw, freq = np.asarray(g.read("UVW")), np.asarray(g.read("FREQ"))
    re, im = sky_vis(torch.as_tensor(uvw, device=dev), freq, srcs, cell, nx, 0.0, None)
    md = torch.as_tensor(np.asarray(g.read("MODEL_DATA")), device=dev)
    err = float(torch.maximum((md.real - re.double()).abs(), (md.imag - im.double()).abs()).max())
    scale = float(torch.complex(re, im).abs().max())
    return dict(max_abs_err=err, max_abs_vis=scale, rel_linf=err / scale, shape=list(md.shape))


def phase_degrid(dev, ctx: dict, eps_pallas: float = 1e-5, eps_auto: float = 1e-7, main_seed: int = 42,
                 nant: int = 64, ntime: int = 500, nband: int = 4, nsrc: int = 24):
    """The degrid main path, two routes at full width.

    (a) pallas (B4): the imager phase's store and tree (the array with its
    own w, 16 channels, 16.1M visibilities); MODEL written into each band
    node (its true sources, flat spectrum), the port's ``model2comps``, then
    ``degrid(gridder="pallas", epsilon=1e-5)`` at 2048^2 (nbig 4096), the
    counts zeroed right before it. Checks: B4 launched; MODEL_DATA within
    10 epsilon (rel Linf against max|V|) of the noise-free visibilities;
    bin 0 within 2e-5 of the port's f64 classic ``dirty2vis``; B4 within
    1e-5 of its f64 plain version at bin 0's plan, one 8-plane chunk.
    (b) auto (IDG on B2): the main phase's array (w x 0.01) as a store and
    a .mds of its sources; ``degrid(gridder="auto", epsilon=1e-7)``. Checks:
    B2 launched; MODEL_DATA within 1e-5 of the noise-free visibilities."""
    import torch

    from pfb_imaging_tpu_torch.core import degrid as TD
    from pfb_imaging_tpu_torch.core.model2comps import model2comps
    from pfb_imaging_tpu_torch.ops import gridder_pallas as GP
    from pfb_imaging_tpu_torch.ops.gridder import _dirty2vis_prepare, _plane_grid, dirty2vis, plan_wgridder
    from pfb_imaging_tpu_torch.utils.modelspec import eval_coeffs_to_slice, load_mds
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    workdir, srcs, nx = ctx["workdir"], ctx["srcs"], ctx["nx"]
    xds, dt = workdir / "smoke.xds", TreeStore(workdir / "smoke.dt")
    cell = float(dt.attrs["cell_rad"])
    model = np.zeros((nx, nx))
    for p, q, flux in srcs:
        model[p, q] = flux
    for key in dt.groups():
        dt.group(key).write("MODEL", model)
    t0 = time.perf_counter()
    mds = model2comps(str(dt.path), str(workdir / "smoke.mds"), device=dev)
    m2c_s = time.perf_counter() - t0
    require(np.asarray(mds.read("coefficients")).shape[1] == len(srcs), "one component per source")

    # (a) the pallas route: counts zeroed right before degrid
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    TD.degrid(str(workdir / "smoke.mds"), str(xds), cell, gridder="pallas", epsilon=eps_pallas, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    launches = got["launches"]
    rec = dict(route="pallas", degrid_seconds=wall, model2comps_seconds=m2c_s, **degrid_stats(got),
               max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches,
               vs_sky=model_data_error(xds, srcs, cell, nx, dev))
    emit({"phase": "degrid", "stage": "pallas", **rec})
    require(launches["gather_grid_wstack"] > 0, "B4 launched during degrid(gridder='pallas')")
    require(rec["vs_sky"]["rel_linf"] <= 10 * eps_pallas, "pallas MODEL_DATA within 10 eps of the sky")

    # bin 0: the f64 classic dirty2vis of the same model, and B4 at its plan
    g = TreeStore(xds).group("scan0000")
    uvw, freq = np.asarray(g.read("UVW")), np.asarray(g.read("FREQ"))
    coeffs, ix, iy, ma = load_mds(TreeStore(workdir / "smoke.mds"))
    chans = np.arange(len(freq))[: len(freq) // len(ma["freqs"])]
    img = eval_coeffs_to_slice(0.0, float(freq[chans].mean()), coeffs, ix, iy, ma)
    kw = dict(nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=eps_pallas, divide_by_n=False, device=dev)
    t0 = time.perf_counter()
    plan64 = plan_wgridder(uvw, freq[chans], dtype=np.float64, **kw)
    v64 = dirty2vis(plan64, torch.as_tensor(img, device=dev))
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    md0 = torch.as_tensor(np.asarray(g.read("MODEL_DATA"))[:, chans], device=dev)
    stack_rel = float((md0 - v64).abs().max() / v64.abs().max())
    del plan64, v64, md0
    plan = plan_wgridder(uvw, freq[chans], dtype=np.float32, **kw)
    nw = min(GP.PLANE_CHUNK, plan.nw)
    p0 = max(0, plan.nw // 2 - nw // 2)
    ieff = _dirty2vis_prepare(plan, torch.as_tensor(img, device=dev))
    grids = torch.stack([torch.view_as_real(_plane_grid(plan, ieff, p0 + q)).permute(2, 0, 1) for q in range(nw)])
    fft_ms = cuda_ms(lambda: [_plane_grid(plan, ieff, p0 + q) for q in range(nw)], 3) / nw
    b4 = gather_check(plan, grids.contiguous(), p0, nw, reps=5)
    checks = dict(bin0_vs_stack_f64_rel=stack_rel, stack_f64_seconds=stack_s, plane_grid_ms=fft_ms, b4_at_bin0_plan=b4)
    emit({"phase": "degrid", "stage": "checks", **checks})
    require(stack_rel <= 2e-5, "bin 0 MODEL_DATA (pallas, f32) vs the classic dirty2vis (f64)")
    require(b4["rel_vs_f64"] <= 1e-5, "B4 vs f64 plain at bin 0's plan")
    del plan, grids, ieff
    torch.cuda.empty_cache()
    shutil.rmtree(workdir)

    # (b) the auto route on the main phase's array
    workdir.mkdir(parents=True)
    uvw = synth_array(nant, ntime, main_seed, wscale=0.01)
    chans = channels(len(ctx["chans"]), *L_BAND)
    cell_m = 8e-6 * 1024 / nx
    srcs_m = point_sources(nx, nsrc, main_seed)
    zeros = torch.zeros((uvw.shape[0], chans.size), device=dev)
    write_xds(workdir / "main.xds", uvw, chans, zeros, zeros)
    del zeros
    band_f = chans.reshape(nband, -1).mean(axis=1)
    mds_m = sky_model_mds(workdir / "main.mds", srcs_m, nx, band_f, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    TD.degrid(mds_m, str(workdir / "main.xds"), cell_m, gridder="auto", epsilon=eps_auto, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    launches_auto = got["launches"]
    rec_auto = dict(route="auto", degrid_seconds=wall, **degrid_stats(got),
                    max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches_auto,
                    vs_sky=model_data_error(workdir / "main.xds", srcs_m, cell_m, nx, dev))
    emit({"phase": "degrid", "stage": "auto", **rec_auto})
    require(launches_auto["vals_from_patches"] > 0, "B2 launched during degrid(gridder='auto')")
    require(set(rec_auto["routes"]) == {"idg"}, "auto routed every bin to IDG")
    require(rec_auto["vs_sky"]["rel_linf"] <= 1e-5, "auto (IDG) MODEL_DATA within 1e-5 of the sky")
    shutil.rmtree(workdir)
    return b4, launches, dict(pallas=rec, checks=checks, auto=rec_auto)


def dft_vis(uvw, freq, img, cell: float, dev, chunk: int = 1024, sv: float = -1.0):
    """Direct f64 forward DFT on the card, the adjoint of ``dft_dirty``:
    V = sum_pixels img e^{-2 pi i phase}."""
    import torch

    nx = img.shape[0]
    c = (torch.arange(nx, device=dev, dtype=torch.float64) - nx // 2) * cell
    ll, mm = torch.meshgrid(c, c, indexing="ij")
    lmn = torch.stack([ll.ravel(), sv * mm.ravel(), -(torch.sqrt(1.0 - ll**2 - mm**2) - 1.0).ravel()])
    u = torch.as_tensor(uvw, device=dev, dtype=torch.float64)
    x = torch.as_tensor(img, device=dev, dtype=torch.float64).reshape(-1)
    out = torch.empty((u.shape[0], len(freq)), dtype=torch.complex128, device=dev)
    for f, nu in enumerate(freq):
        for s in range(0, u.shape[0], chunk):
            ph = (2.0 * np.pi * nu / LIGHTSPEED) * (u[s : s + chunk] @ lmn)
            out[s : s + chunk, f] = torch.complex(torch.cos(ph) @ x, -(torch.sin(ph) @ x))
    return out


def phase_widefield_accuracy(dev, nrow: int = 50_000, nchan: int = 2, nx: int = 256):
    """f32 wplanes IDG on the card against the direct f64 DFT, both ways:
    the TPU bench's coordinates with their own w (|w| to ~5.9e4 wavelengths)
    at 256^2, where ``w_mode="auto"`` must pick wplanes; ``vis2dirty_idg``
    within ``delivered_accuracy`` (interior and edge), ``dirty2vis_idg`` of a
    random image within the edge budget of max|V|, and the adjoint identity
    of the pair (<= 1e-5, sums in f64), at epsilon 1e-5 and 1e-7."""
    import torch

    from pfb_imaging_tpu_torch.ops.gridder_idg import delivered_accuracy, dirty2vis_idg, plan_idg, vis2dirty_idg

    rng = np.random.default_rng(7)
    uvw = rng.uniform(-16000, 16000, (nrow, 3))
    freq = np.linspace(1.0e9, 1.1e9, nchan)
    cell = 8e-6 * 1024 / nx
    vis = rng.standard_normal((nrow, nchan)) + 1j * rng.standard_normal((nrow, nchan))
    img = rng.standard_normal((nx, nx))
    ref = dft_dirty(uvw, freq, vis, nx, cell, dev)
    vref = dft_vis(uvw, freq, img, cell, dev)
    vr, vi = (torch.as_tensor(a, device=dev).float() for a in (vis.real, vis.imag))
    img_t = torch.as_tensor(img, device=dev).float()
    out = []
    for eps in (1e-5, 1e-7):
        plan = plan_idg(uvw, freq, nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=eps, w_mode="auto",
                        divide_by_n=False, device=dev)
        require(plan.w_support > 1, f"w_mode='auto' picks wplanes at epsilon {eps}")
        d = vis2dirty_idg(plan, vr, vis_im=vi).double()
        v = dirty2vis_idg(plan, img_t).to(torch.complex128)
        err = (d - ref).abs() / ref.abs().max()
        q = nx // 4
        budget = delivered_accuracy(plan)
        lhs = float((d * img_t.double()).sum())
        rhs = float((torch.complex(vr, vi).to(torch.complex128).conj() * v).real.sum())
        rec = dict(gridder="idg_wplanes", nx=nx, nvis=nrow * nchan, epsilon=eps, subgrid=plan.S,
                   w_support=plan.w_support, nbins=plan.nbins, ngroups=plan.ngroups,
                   rel_linf=float(err.max()), rel_linf_inner=float(err[q:-q, q:-q].max()),
                   degrid_rel_linf=float((v - vref).abs().max() / vref.abs().max()),
                   adjoint_rel=abs(lhs - rhs) / abs(lhs), budget_inner=budget["interior"], budget_edge=budget["edge"],
                   edge_amp=budget["edge_amp"])
        emit({"phase": "widefield", "stage": "accuracy", **rec})
        require(all(np.isfinite([rec["rel_linf"], rec["degrid_rel_linf"]])), "widefield accuracy finite")
        require(rec["rel_linf_inner"] < budget["interior"], f"wplanes interior accuracy at {eps}")
        require(rec["rel_linf"] < budget["edge"], f"wplanes edge accuracy at {eps}")
        require(rec["degrid_rel_linf"] < budget["edge"], f"wplanes degrid accuracy at {eps}")
        require(rec["adjoint_rel"] <= 1e-5, f"wplanes adjoint identity at {eps}")
        out.append(rec)
        del plan
    torch.cuda.empty_cache()
    return out


def phase_widefield(dev, workdir: Path, nx: int = 2048, nant: int = 64, ntime: int = 500, nband: int = 4,
                    nchan_band: int = 4, niter: int = 2, eps: float = 1e-7, seed: int = 42, nsrc: int = 24):
    """The main phase's array with its own w (``synth_array(..., wscale=1)``,
    |w| to ~7.3e4 wavelengths) at 2048^2, 4 bands, epsilon 1e-7, where the
    IDG planner picks wplanes: a .dt tree built on the card (every band's
    plan must have w_support > 1), B1/B2 at band 0's wplanes plan against
    their plain versions, ``deconv(niter=2)`` with its default routing
    (counts zeroed right before it; every band must take the multiband
    route, none fall back; the rms must fall), B1/B2 at the launch shape of
    that route (all bands' groups, past 2^31 patch elements; f64 on the
    last 65,536 groups), the final model's residual by the multiband and
    the per-band route (within ``ROUTE_REL_LIMIT`` of each other, both on
    wplanes IDG plans, timed and traced), ``imager(gridder="auto")`` on a
    store of the array's sky visibilities (the IDG route, every image and
    PSF plan a wplanes plan), then ``degrid(gridder="auto", epsilon=1e-7)``
    of the sources into that store (every bin on wplanes IDG, MODEL_DATA
    within 1e-5 of the noise-free visibilities). Each stage reports its
    host planning seconds and peak device memory."""
    import torch

    from pfb_imaging_tpu_torch.core import deconv as tdeconv
    from pfb_imaging_tpu_torch.core import degrid as TD
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_prepare
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    cell = 8e-6 * 1024 / nx
    uvw = synth_array(nant, ntime, seed, wscale=1.0)
    chans = channels(nband * nchan_band, *L_BAND)
    srcs = point_sources(nx, nsrc, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    emit({"phase": "widefield", "stage": "layout", "nx": nx, "nband": nband, "nrow": uvw.shape[0],
          "nvis": uvw.shape[0] * chans.size, "epsilon": eps, "cell_rad": cell,
          "max_abs_w_lambda": float(np.abs(uvw[:, 2]).max() * chans.max() / LIGHTSPEED)})
    dt_path = workdir / "smoke.dt"
    TI._PLAN_CACHE.clear()  # the earlier phases' plans; this phase's are read back below
    TI._PLAN_CACHE_BYTES = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    plan_s, grid_s, p, (vr, vi, wgt), bands = build_tree(dev, workdir, uvw, chans, nband, nchan_band, srcs, nx, cell,
                                                         eps, gen, "widefield")
    tree = dict(plan_seconds=plan_s, grid_seconds=grid_s, max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    emit({"phase": "widefield", "stage": "tree", **tree})
    require(len(bands) == nband and all(b["w_support"] > 1 for b in bands), "every band's plan is a wplanes plan")

    # B1/B2 at band 0's wplanes plan: ES-weighted slot phases, chirp rows 0
    require(not bool(p.scal[1].any()) and not bool(p.scal[3].any()), "wplanes angles carry no chirp")
    vals = _idg_prepare(p, vr, vi, wgt)
    kern_band, _ = idg_kernels_at_plan(p, vals, f64_groups=65536)
    kern_band["w_support"], kern_band["nbins"] = p.w_support, p.nbins
    emit({"phase": "widefield", "stage": "kernels_at_wplanes_band_plan", **kern_band})
    require(kern_band["b1_rel_vs_f64"] <= 2e-6 and kern_band["b2_rel_vs_f64"] <= 2e-6,
            "B1/B2 vs f64 plain at band 0's wplanes plan")
    del p, vals, vr, vi, wgt
    torch.cuda.empty_cache()

    # deconv with its default routing: counts zeroed right before it
    keys = [f"band{b:04d}_time0000" for b in range(nband)]
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    model, residual = tdeconv.deconv(str(dt_path), niter=niter, epsilon=eps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    launches, cyc = got["launches"], got["cycles"]
    for s in cyc:
        emit({"phase": "widefield", "stage": "cycle", **s})
    dispatch = dispatch_of(got["counters"])
    summary = dict(deconv_seconds=wall, plan_seconds=got["spans"].get("residual.plan", 0.0),
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches,
                   residual_dispatch=dispatch)
    emit({"phase": "widefield", "stage": "deconv", **summary})
    require(len(cyc) == niter and all(np.isfinite([s["rms"], s["rmax"]]).all() for s in cyc), "cycles ran, finite")
    require(cyc[-1]["rms"] < cyc[0]["rms"], "widefield rms falls")
    require(np.isfinite(model).all() and np.isfinite(residual).all(), "widefield model and residual finite")
    require(dispatch == {"multiband_parts": niter, "fallback_bands": 0},
            "every widefield residual took the multiband route")
    require(launches["patches_from_vals"] > 0 and launches["vals_from_patches"] > 0, "B1/B2 launched in deconv")

    # B1/B2 at the launch shape deconv ran: f64 on the last groups, whose
    # patch offsets pass 2^31 elements
    kern, mplan = multiband_kernels(model, f64_groups=65536, f64_at_end=True)
    int32_groups = 2**31 // (2 * kern["S"] ** 2)
    kern["f64_groups_past_int32_offsets"] = max(0, kern["f64_groups"][1] - max(kern["f64_groups"][0], int32_groups))
    emit({"phase": "widefield", "stage": "kernels_at_multiband_launch", **kern})
    require(mplan.w_support > 1, "the multiband plan is a wplanes plan")
    require(kern["b1_rel_vs_f64"] <= 2e-6 and kern["b2_rel_vs_f64"] <= 2e-6,
            "B1/B2 vs f64 plain at the widefield multiband launch")
    require(kern["ng"] <= int32_groups or kern["f64_groups_past_int32_offsets"] > 0,
            "the f64 check reaches the groups past 2^31 patch elements")
    del mplan
    # K1/K2 at the same launch, and the multiband Hessian twice
    asm = multiband_assembly(model)
    emit({"phase": "widefield", "stage": "assembly_at_multiband_launch", **asm})
    require(launches["idg_assemble"] > 0 and launches["idg_extract"] > 0, "K1/K2 launched in deconv")
    require(launches["idg_chunk_sums"] > 0, "K1's chunk sums launched in deconv")
    require(launches["psi_analysis"] > 0 and launches["psi_synthesis_ext"] > 0, "P1/P2 launched in deconv")

    # the final model's residual by both routes (multiband plans cached)
    routes = residual_routes(dev, TreeStore(dt_path), keys, model, eps, residual, trace=True)
    emit({"phase": "widefield", "stage": "residual_routes", **routes})
    require(all(c["w_support"] > 1 for c in routes["per_band_plans"]), "the per-band route ran on wplanes plans")
    TI._PLAN_CACHE.clear()
    TI._PLAN_CACHE_BYTES = 0
    torch.cuda.empty_cache()
    shutil.rmtree(workdir)

    # imager(gridder="auto") on the array's sky visibilities
    workdir.mkdir(parents=True)
    xds = workdir / "wide.xds"
    re, im = sky_vis(torch.as_tensor(uvw, device=dev), chans, srcs, cell, nx, 1.0, gen)
    write_xds(xds, uvw, chans, re, im)
    del re, im
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = TI.imager(str(xds), str(workdir / "wide.dt"), nband=nband, nx=nx, ny=nx,
                    cell_size=cell * 180 / np.pi * 3600, psf_oversize=2.0, epsilon=eps, gridder="auto",
                    double_precision=False, fits_out=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    c = got["counters"]
    rec_im = dict(imager_seconds=wall, **command_stats(got, "imager"),
                  plans=c.get("imager.plans", 0), plans_wplanes=c.get("imager.plans.wplanes", 0),
                  launches=got["launches"], max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    emit({"phase": "widefield", "stage": "imager", **rec_im})
    require(rec_im["routes"] == {"idg": 1} and rec_im["launches"]["patches_from_vals"] > 0, "imager(auto) on IDG (B1)")
    require(rec_im["plans"] == 2 * nband and rec_im["plans_wplanes"] == rec_im["plans"],
            "imager(auto): every image and PSF plan a wplanes plan")
    d0 = np.asarray(out.group("band0000_time0000").read("DIRTY"))
    require(np.isfinite(d0).all(), "imager(auto) DIRTY finite")
    del out, d0

    # degrid at real w into the same store
    mds = sky_model_mds(workdir / "wide.mds", srcs, nx, chans.reshape(nband, -1).mean(axis=1), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    TD.degrid(mds, str(xds), cell, gridder="auto", epsilon=eps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    dg_launches = got["launches"]
    rec_dg = dict(degrid_seconds=wall, **degrid_stats(got), launches=dg_launches,
                  max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                  vs_sky=model_data_error(xds, srcs, cell, nx, dev))
    emit({"phase": "widefield", "stage": "degrid", **rec_dg})
    require(set(rec_dg["routes"]) == {"idg"} and rec_dg["bins_wplanes"] == rec_dg["routes"]["idg"],
            "degrid: every bin on wplanes IDG")
    require(dg_launches["vals_from_patches"] > 0, "B2 launched during the widefield degrid")
    require(rec_dg["vs_sky"]["rel_linf"] <= 1e-5, "widefield MODEL_DATA within 1e-5 of the sky")
    shutil.rmtree(workdir)
    return kern, kern_band, launches, dg_launches, dict(tree=tree, deconv=summary, routes=routes, imager=rec_im,
                                                        degrid=rec_dg, assembly=asm)


def cli_step(name: str, fn, dev, steps: dict, phase: str = "pipeline"):
    """Run one step of ``phase`` with the counts zeroed right before it;
    record its seconds, launches, counters, spans' seconds, cycles and peak
    device memory, and print them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = read_counts()
    steps[name] = dict(seconds=seconds, launches=got["launches"], counters=got["counters"], spans=got["spans"],
                       cycles=got["cycles"], max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    emit({"phase": phase, "stage": name, **steps[name]})
    return out


def phase_pipeline(dev, workdir: Path, nx: int = 2048, nant: int = 64, ntime: int = 500, nchan: int = 16,
                   nband: int = 4, niter: int = 2, seed: int = 44, nsrc: int = 24, ncheck: int = 4096,
                   keep_imaged: Path | None = None, keep_store: Path | None = None):
    """A user's whole run through the port's own front end at 2048^2: the
    simulator (the JAX simulator's 64-antenna array, 500 integrations in one
    partition of 1,008,000 rows, 16 channels over 856-1712 MHz, 24 seeded
    point sources with spectral indices in [-1, 0], noise 1, two linear
    correlations: the sky predicted by the f64 DFT on the card), then
    ``pfb-torch`` ``init`` -> ``imager`` (defaults: epsilon 1e-7, gridder
    auto; the simulator's cell) -> ``sara --niter 2`` -> ``restore`` ->
    ``model2comps`` -> ``degrid``, through ``cli.main``. Launch counts are
    zeroed right before each step and read right after; each step reports
    its seconds and peak device memory. Checks: the DFT against a direct
    sum over the sources on ``ncheck`` seeded rows (1e-10) and the store's
    noise (rms 1 +- 0.02 a part); init's Stokes I and weights; the imager on
    wplanes IDG (B1) with PSF peak / WSUM = 1 and band 0's brightest pixel
    on a source; every sara cycle on the multiband route (B1, B2) with the
    rms falling; six finite FITS products with the MFS image's brightest
    pixel on a source; every degrid bin on wplanes IDG (B2), MODEL_DATA
    finite and reducing the visibilities' rms. Then ``imager`` at the
    CLI's own default cell (bands 0-2 plan chirp there) and ``sara --niter
    1`` on that tree: IDG (B1), one multiband residual, no band falling
    back. B1/B2 are held to their f64 plain versions at the launch shapes
    of these steps: band 0's image and PSF plans at both cells (degrid's
    bin 0 has band 0's image plan; the record says whether they agree) and
    each sara's multiband launch. With ``keep_imaged``, the tree as the
    imager wrote it is copied there before ``sara`` runs on it; with
    ``keep_store``, the store ``init`` wrote (with degrid's MODEL_DATA) is
    moved there at the end. Returns
    (launches summed over the steps, {where: kernel record}, the steps'
    records, the sky: {"pix": [(p, q, flux)], "sources": the simulator's
    source tuples, "cell_rad"})."""
    import torch

    from pfb_imaging_tpu_torch.cli import main as cli_main
    from pfb_imaging_tpu_torch.core import degrid as TD
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.core.simulate import simulate_vis_store
    from pfb_imaging_tpu_torch.ops.dft import dirty2vis_dft
    from pfb_imaging_tpu_torch.utils.fits import load_fits
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    ms, xds, dt, mds = (str(workdir / n) for n in ("sim.ms.tree", "sim_I.xds", "sim_I.dt", "sim_I.mds"))
    rng = np.random.default_rng(seed)
    pix = point_sources(nx, nsrc, seed)
    alphas = rng.uniform(-1.0, 0.0, nsrc)
    sources = [(p / nx, q / nx, flux, float(a)) for (p, q, flux), a in zip(pix, alphas)]
    TI._PLAN_CACHE.clear()
    TI._PLAN_CACHE_BYTES = 0
    torch.cuda.empty_cache()
    steps: dict = {}
    on = ["--device", str(dev)]

    _, truth = cli_step("simulate", lambda: simulate_vis_store(
        ms, nant=nant, ntime=ntime, times_per_scan=ntime, nchan=nchan, nx=nx, sources=sources, freq0=856e6,
        freq1=1712e6, noise=1.0, ncorr=2, feed_type="linear", device=dev), dev, steps)
    cell, freqs = float(truth["cell_rad"]), truth["freqs"]
    g = TreeStore(ms).group("scan0000")
    vis_raw = g.read("VIS", mmap=True)
    nrow = vis_raw.shape[1]
    rows = np.sort(rng.choice(nrow, ncheck, replace=False))
    uvw_rows = torch.as_tensor(np.asarray(g.read("UVW"))[rows], device=dev)
    comps = [((p - nx // 2) * cell, (q - nx // 2) * cell, flux * (freqs / freqs[0]) ** a)
             for (p, q, flux), a in zip(pix, alphas)]
    ref = point_sum_vis(uvw_rows, freqs, comps)
    dft = torch.cat([dirty2vis_dft(uvw_rows, freqs[c:c + 1], truth["model"][c], nx=nx, ny=nx, cellx=cell, celly=cell,
                                   divide_by_n=False, device=dev) for c in range(nchan)], dim=1)
    xx = torch.as_tensor(np.asarray(vis_raw[0, rows]), device=dev)
    resid = xx - ref
    sim = dict(nrow=nrow, nvis_per_corr=nrow * nchan, cell_rad=cell, dft_dtype=str(dft.dtype),
               max_abs_w_lambda=float(np.abs(np.asarray(g.read("UVW"))[:, 2]).max() * freqs.max() / LIGHTSPEED),
               dft_vs_direct_sum_rel=rel_linf(dft, ref), noise_rms_re=float(resid.real.pow(2).mean().sqrt()),
               noise_rms_im=float(resid.imag.pow(2).mean().sqrt()))
    emit({"phase": "pipeline", "stage": "simulate_checks", **sim})
    require(nrow == nant * (nant - 1) // 2 * ntime and dft.dtype == torch.complex128, "one partition, f64 DFT")
    require(sim["dft_vs_direct_sum_rel"] <= 1e-10, "simulator DFT vs the direct sum over the sources")
    require(abs(sim["noise_rms_re"] - 1.0) <= 0.02 and abs(sim["noise_rms_im"] - 1.0) <= 0.02,
            "simulated noise rms 1 a part")
    del dft, resid, truth

    cli_step("init", lambda: cli_main(["init", ms, xds, *on]), dev, steps)
    gi = TreeStore(xds).group("scan0000")
    yy = torch.as_tensor(np.asarray(vis_raw[1, rows]), device=dev)
    vis_i = torch.as_tensor(np.asarray(gi.read("VIS", mmap=True)[rows]), device=dev)
    wgt_i = np.asarray(gi.read("WEIGHT", mmap=True)[rows])
    init_rel = rel_linf(vis_i, (xx + yy) / 2)
    emit({"phase": "pipeline", "stage": "init_checks", "vis_vs_xx_yy_mean_rel": init_rel,
          "weight_min": float(wgt_i.min()), "weight_max": float(wgt_i.max())})
    require(init_rel <= 1e-12 and (wgt_i == 2.0).all(), "init: VIS = (XX + YY) / 2, WEIGHT = 2")
    del xx, yy, vis_i, vis_raw

    cell_arcsec = cell * 180.0 / np.pi * 3600.0
    with plans_made(TI) as plans:
        cli_step("imager", lambda: cli_main(["imager", xds, dt, "--nband", str(nband), "--nx", str(nx),
                                             "--psf-oversize", "2", "--cell-size", repr(cell_arcsec), *on]), dev, steps)
    st = steps["imager"]
    st.update(**command_stats(st, "imager"), plans_wplanes=st["counters"].get("imager.plans.wplanes", 0))
    require(st["routes"] == {"idg": 1} and st["launches"]["patches_from_vals"] > 0, "imager on IDG (B1)")
    require(st["counters"]["imager.plans"] == 2 * nband == st["plans_wplanes"],
            "imager: every image and PSF plan a wplanes plan")
    tree = TreeStore(dt)
    bands = []
    for b in range(nband):
        node = tree.group(f"band{b:04d}_time0000")
        wsum = float(np.asarray(node.read("WSUM"))[0])
        dirty, psf = np.asarray(node.read("DIRTY")), np.asarray(node.read("PSF"))
        require(np.isfinite(dirty).all() and np.isfinite(psf).all(), f"band {b} DIRTY and PSF finite")
        peak = np.unravel_index(np.argmax(dirty), dirty.shape)
        bands.append(dict(band=b, psf_peak_over_wsum=float(psf.max()) / wsum,
                          dirty_peak_offset_px=min(abs(int(peak[0]) - p) + abs(int(peak[1]) - q) for p, q, _ in pix)))
        require(abs(bands[-1]["psf_peak_over_wsum"] - 1.0) <= 1e-4, f"band {b} PSF peak / WSUM = 1")
    emit({"phase": "pipeline", "stage": "imager_checks", "cell_rad": float(tree.attrs["cell_rad"]), "bands": bands,
          **{k: steps["imager"][k] for k in ("routes", "plan_seconds", "grid_seconds", "plans_wplanes")}})
    require(bands[0]["dirty_peak_offset_px"] <= 1, "band 0's brightest DIRTY pixel on a true source")
    if keep_imaged is not None:
        shutil.rmtree(keep_imaged, ignore_errors=True)
        shutil.copytree(dt, keep_imaged)
    kern = {f"{k}_plan": r for k, r in imager_plan_kernels(dev, dt, plans).items()}
    for k, r in kern.items():
        emit({"phase": "pipeline", "stage": f"kernels_at_imager_{k}", **r})

    cli_step("sara", lambda: cli_main(["sara", dt, "--niter", str(niter), *on]), dev, steps)
    cyc = steps["sara"]["cycles"]
    steps["sara"].update(rms=[c["rms"] for c in cyc], residual_dispatch=dispatch_of(steps["sara"]["counters"]))
    emit({"phase": "pipeline", "stage": "sara_checks", "rms": steps["sara"]["rms"],
          "residual_dispatch": steps["sara"]["residual_dispatch"]})
    require(len(cyc) == niter and all(np.isfinite([c["rms"], c["rmax"]]).all() for c in cyc), "sara cycles finite")
    require(cyc[-1]["rms"] < cyc[0]["rms"], "sara: the rms falls")
    disp = steps["sara"]["residual_dispatch"]
    require(disp["multiband_parts"] == niter and disp["fallback_bands"] == 0, "sara: every cycle on the multiband route")
    la = steps["sara"]["launches"]
    require(la["patches_from_vals"] > 0 and la["vals_from_patches"] > 0, "B1/B2 launched in sara")
    kern["multiband"] = pipeline_multiband_kernels(dt, nband)
    emit({"phase": "pipeline", "stage": "kernels_at_sara_multiband_launch", **kern["multiband"]})
    require(kern["multiband"]["w_support"] > 1, "sara's multiband plan is a wplanes plan")

    cli_step("restore", lambda: cli_main(["restore", dt, *on]), dev, steps)
    fits = {}
    for prod in ("model", "model_mfs", "residual", "residual_mfs", "image", "image_mfs"):
        data, _ = load_fits(str(workdir / f"sim_I_{prod}.fits"))
        require(np.isfinite(data).all(), f"restore: {prod} finite")
        fits[prod] = list(data.shape)
    img = load_fits(str(workdir / "sim_I_image_mfs.fits"))[0][0, 0]
    peak = np.unravel_index(np.argmax(img), img.shape)
    off = min(abs(int(peak[0]) - p) + abs(int(peak[1]) - q) for p, q, _ in pix)
    emit({"phase": "pipeline", "stage": "restore_checks", "shapes": fits, "image_mfs_peak_offset_px": off})
    require(off <= 1, "the MFS image's brightest pixel on a true source")

    cli_step("model2comps", lambda: cli_main(["model2comps", dt, "--mds", mds, *on]), dev, steps)
    cell_dt = float(tree.attrs["cell_rad"])
    with plans_made(TD) as bins:
        cli_step("degrid", lambda: cli_main(["degrid", mds, xds, "--cell-rad", repr(cell_dt), *on]), dev, steps)
    st = steps["degrid"]
    st.update(**degrid_stats(st), bins=[dict(w_support=b["w_support"], ngroups=b["ngroups"]) for b in bins])
    gd = TreeStore(xds).group("scan0000")
    vis = torch.as_tensor(np.asarray(gd.read("VIS")), device=dev)
    md = torch.as_tensor(np.asarray(gd.read("MODEL_DATA")), device=dev)
    dg = dict(model_data_finite=bool(torch.isfinite(torch.view_as_real(md)).all()),
              rms_vis=float(vis.abs().pow(2).mean().sqrt()),
              rms_vis_minus_model=float((vis - md).abs().pow(2).mean().sqrt()))
    # degrid plans each bin as the imager plans that band's image
    im0 = kern["image_plan"]
    dg["bin0_plan_is_band0_image_plan"] = (bins[0]["nbins"], bins[0]["w_support"], bins[0]["ngroups"]) == \
        (im0["nbins"], im0["w_support"], im0["ngroups"])
    emit({"phase": "pipeline", "stage": "degrid_checks", **dg,
          **{k: st[k] for k in ("plan_seconds", "routes", "bins")}})
    require(set(st["routes"]) == {"idg"} and st["bins_wplanes"] == st["routes"]["idg"] == len(bins),
            "degrid: every bin on wplanes IDG")
    require(steps["degrid"]["launches"]["vals_from_patches"] > 0, "B2 launched in degrid")
    require(dg["model_data_finite"] and dg["rms_vis_minus_model"] < dg["rms_vis"], "MODEL_DATA finite, reduces the rms")
    del vis, md

    # the imager at its own default cell (the bands' plans mix chirp and
    # wplanes), then one sara cycle on that tree
    dt_def = str(workdir / "sim_I_default.dt")
    with plans_made(TI) as plans:
        cli_step("imager_default_cell", lambda: cli_main(["imager", xds, dt_def, "--nband", str(nband), "--nx",
                                                          str(nx), "--psf-oversize", "2", *on]), dev, steps)
    st = steps["imager_default_cell"]
    st.update(**command_stats(st, "imager"), cell_rad=float(TreeStore(dt_def).attrs["cell_rad"]),
              plans=st["counters"]["imager.plans"], plans_wplanes=st["counters"].get("imager.plans.wplanes", 0))
    emit({"phase": "pipeline", "stage": "imager_default_cell_checks",
          **{k: st[k] for k in ("routes", "cell_rad", "plan_seconds", "plans", "plans_wplanes")}})
    require(st["routes"] == {"idg": 1} and st["launches"]["patches_from_vals"] > 0,
            "imager at the default cell on IDG (B1)")
    for b in range(nband):
        d = np.asarray(TreeStore(dt_def).group(f"band{b:04d}_time0000").read("DIRTY"))
        require(np.isfinite(d).all(), f"default cell: band {b} DIRTY finite")
    for k, r in imager_plan_kernels(dev, dt_def, plans).items():
        kern[f"default_cell_{k}_plan"] = r
        emit({"phase": "pipeline", "stage": f"kernels_at_default_cell_imager_{k}_plan", **r})
    cli_step("sara_default_cell", lambda: cli_main(["sara", dt_def, "--niter", "1", *on]), dev, steps)
    cyc = steps["sara_default_cell"]["cycles"]
    disp = dispatch_of(steps["sara_default_cell"]["counters"])
    steps["sara_default_cell"].update(rms=[c["rms"] for c in cyc], residual_dispatch=disp)
    emit({"phase": "pipeline", "stage": "sara_default_cell_checks", "rms": steps["sara_default_cell"]["rms"],
          "residual_dispatch": disp})
    require(len(cyc) == 1 and np.isfinite([cyc[0]["rms"], cyc[0]["rmax"]]).all(), "default cell: sara cycle finite")
    require(disp["multiband_parts"] == 1 and disp["fallback_bands"] == 0, "default cell: sara on the multiband route")
    la = steps["sara_default_cell"]["launches"]
    require(la["patches_from_vals"] > 0 and la["vals_from_patches"] > 0, "B1/B2 launched in sara at the default cell")
    kern["default_cell_multiband"] = pipeline_multiband_kernels(dt_def, nband)
    emit({"phase": "pipeline", "stage": "kernels_at_default_cell_sara_multiband_launch",
          **kern["default_cell_multiband"]})
    total = {name: sum(st["launches"][name] for st in steps.values()) for name in KERNELS}
    emit({"phase": "pipeline", "stage": "summary", "seconds": sum(st["seconds"] for st in steps.values()),
          "launches": total, "max_memory_allocated": max(st["max_memory_allocated"] for st in steps.values())})
    torch.cuda.empty_cache()
    if keep_store is not None:
        shutil.rmtree(keep_store, ignore_errors=True)
        shutil.move(xds, keep_store)
    shutil.rmtree(workdir)
    return total, kern, steps, dict(pix=pix, sources=sources, cell_rad=cell)


def mfs_image(dt_path, name: str) -> np.ndarray:
    """The MFS image of ``name`` over a tree's band nodes: their sum over the
    total WSUM."""
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    tree = TreeStore(dt_path)
    nodes = [tree.group(k) for k in tree.groups() if k.startswith("band")]
    wsum = sum(float(np.asarray(n.read("WSUM"))[0]) for n in nodes)
    return sum(np.asarray(n.read(name)) for n in nodes) / wsum


def peak_offset_px(img: np.ndarray, pix, shift: int = 0) -> int:
    """Manhattan distance from the brightest pixel of ``img`` to the nearest
    source of ``pix`` ((p, q, flux) on a grid ``shift`` pixels larger on
    each side)."""
    p, q = np.unravel_index(np.argmax(img), img.shape)
    return min(abs(int(p) + shift - a) + abs(int(q) + shift - b) for a, b, _ in pix)


def band_plan_kernels(dt_path: str, f64_groups: int = 65536) -> dict:
    """B1/B2 at the launch shape of band 0's per-band residual that a command
    just ran on ``dt_path`` (``residual_from_parts``'s cached IDG plan), on
    the group values its B1 launch takes for the tree's band-0 MODEL (B2's
    forward values, weighted), each against its f64 plain version on
    ``f64_groups`` middle groups, required within 2e-6."""
    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.ops.gridder_idg import _weighted_round_trip, dirty2vis_idg_grouped
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    node = TreeStore(dt_path).group("band0000_time0000")
    part = str(node.group("part0000").path)
    hits = [v for k, v in TI._PLAN_CACHE.items() if k[0] == part]
    require(len(hits) == 1 and hits[0][4], f"band 0's residual plan of {Path(dt_path).name} cached, an IDG plan")
    plan, wgt = hits[0][0], hits[0][1]
    x = to_device(np.asarray(node.read("MODEL")), plan.device, real_dtype(plan.device))
    vals = _weighted_round_trip(plan, dirty2vis_idg_grouped(plan, x), wgt)
    rec, _ = idg_kernels_at_plan(plan, vals, f64_groups=f64_groups)
    rec.update(nbins=plan.nbins, w_support=plan.w_support)
    require(rec["b1_rel_vs_f64"] <= 2e-6 and rec["b2_rel_vs_f64"] <= 2e-6,
            f"B1/B2 vs f64 plain at band 0's residual plan of {Path(dt_path).name}")
    return rec


def phase_commands(dev, workdir: Path, imaged: Path, sky: dict, nant: int = 64, nchan: int = 16,
                   hci_ntime: int = 64, hci_nx: int = 1024, hci_chunks: int = 4, step_nx: int = 256,
                   flux_seconds: float = 20.0, seed: int = 44):
    """The commands the JAX CLI has beyond the pipeline, through ``cli.main``
    on the card at the pipeline's width (2048^2, 4 bands, its array and sky,
    epsilon 1e-7), each step with the counts zeroed right before it, its
    seconds, launches and peak memory: ``kclean --niter 2`` (Clark) on a
    copy of the pipeline's freshly imaged tree (``imaged``), ``kclean
    --niter 1 --minor hogbom`` on another copy, ``fluxtractor`` on the
    Clark tree with ``--cg-maxit`` chosen from one measured ``hessian_vis``
    at band 0 so the step takes about ``flux_seconds``, ``deconv --preset
    ista --niter 1`` on a third copy; then ``hci`` on a store of
    ``hci_ntime`` single-integration scans of the same array and sky from
    the port's simulator, ``--nx hci_nx --freq-chunks hci_chunks``, and two
    direct ``hci`` calls at ``step_nx`` with and without a step transient.
    Checks: B1/B2 launched by kclean, fluxtractor and ista; kclean's MFS rmax
    falling and the Clark model's MFS peak on a true source; ista's rms
    falling; the mop finite; hci on IDG with one B1 launch a snapshot, its
    cube finite with the time-mean's peak on a true source; the step's
    frames at its pixel (as the JAX tests) and, against the run without it,
    0 before the step and its amplitude after (1e-4 of it). B1/B2 are held to
    their f64 plain versions (2e-6) at kclean's band-0 residual plan and at
    one hci snapshot plan. Returns (launches summed over the steps,
    {where: kernel record}, the steps' records)."""
    import torch

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.cli import main as cli_main
    from pfb_imaging_tpu_torch.core import hci as THCI
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.core.simulate import simulate_vis_store
    from pfb_imaging_tpu_torch.ops.gridder import plan_wgridder
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_prepare, plan_idg
    from pfb_imaging_tpu_torch.ops.hessian import hessian_vis
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    rdt = real_dtype(dev)
    pix, on, steps, kern = sky["pix"], ["--device", str(dev)], {}, {}
    TI._PLAN_CACHE.clear()
    TI._PLAN_CACHE_BYTES = 0

    def copy(name):
        shutil.copytree(imaged, workdir / name)
        return str(workdir / name)

    dirty0 = mfs_image(imaged, "DIRTY")
    rms0, rmax0 = float(np.std(dirty0)), float(np.abs(dirty0).max())
    nx = dirty0.shape[0]
    nband = sum(k.startswith("band") for k in TreeStore(imaged).groups())
    emit({"phase": "commands", "stage": "imaged_tree", "nx": nx, "nband": nband, "rms": rms0, "rmax": rmax0})

    def launched(name, b2=True):
        la = steps[name]["launches"]
        require(la["patches_from_vals"] > 0 and (la["vals_from_patches"] > 0 or not b2), f"B1/B2 launched in {name}")

    k_clark = copy("kclean_clark.dt")
    cli_step("kclean", lambda: cli_main(["kclean", k_clark, "--niter", "2", *on]), dev, steps, "commands")
    majors = steps["kclean"]["cycles"]
    model_off = peak_offset_px(mfs_image(k_clark, "MODEL"), pix)
    steps["kclean"].update(majors=majors, model_mfs_peak_offset_px=model_off)
    emit({"phase": "commands", "stage": "kclean_checks", "rmax0": rmax0, "majors": majors,
          "model_mfs_peak_offset_px": model_off})
    launched("kclean")
    rmaxs = [rmax0] + [m["rmax"] for m in majors]
    require(all(b < a for a, b in zip(rmaxs, rmaxs[1:])), "kclean: the MFS rmax falls every major iteration")
    require(model_off <= 1, "kclean: the MFS model's peak on a true source")
    kern["kclean_band_plan"] = band_plan_kernels(k_clark)
    emit({"phase": "commands", "stage": "kernels_at_kclean_band_plan", **kern["kclean_band_plan"]})

    k_hog = copy("kclean_hogbom.dt")
    cli_step("kclean_hogbom", lambda: cli_main(["kclean", k_hog, "--niter", "1", "--minor", "hogbom", *on]), dev,
             steps, "commands")
    majors = steps["kclean_hogbom"]["cycles"]
    steps["kclean_hogbom"].update(majors=majors)
    emit({"phase": "commands", "stage": "kclean_hogbom_checks", "majors": majors})
    launched("kclean_hogbom")
    require(len(majors) == 1 and majors[0]["rmax"] < rmax0, "kclean --minor hogbom: the MFS rmax falls")
    shutil.rmtree(k_hog)

    # one exact vis-space Hessian apply at band 0 (classic gridder, as the
    # mop plans it) sizes fluxtractor's CG so the step takes ~flux_seconds
    pg = TreeStore(k_clark).group("band0000_time0000").group("part0000")
    cell = float(TreeStore(k_clark).attrs["cell_rad"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = plan_wgridder(np.asarray(pg.read("UVW")), np.asarray(pg.read("FREQ")), nx=nx, ny=nx, cellx=cell,
                         celly=cell, epsilon=1e-7, divide_by_n=False, dtype=rdt, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    w, m = to_device(pg.read("WEIGHT"), dev, rdt), to_device(pg.read("MASK"), dev, rdt)
    x = to_device(np.asarray(TreeStore(k_clark).group("band0000_time0000").read("MODEL")), dev, rdt)
    apply_ms = cuda_ms(lambda: hessian_vis(plan, x, wgt=w, mask=m), 2)
    # the same apply twice, with no determinism switch (the classic scatter
    # is B3 on the card)
    zero_counts()
    h1 = hessian_vis(plan, x, wgt=w, mask=m)
    torch.cuda.synchronize()
    h_launches = read_counts()["launches"]
    h_same = bool(torch.equal(h1, hessian_vis(plan, x, wgt=w, mask=m)))
    require(h_launches["scatter_grid_wstack"] > 0 and h_launches["gather_grid_wstack"] == 0,
            "the classic hessian_vis scatters through B3")
    nplanes = plan.nw
    del plan, w, m, x, h1
    torch.cuda.empty_cache()
    cg_maxit = max(2, min(50, int((flux_seconds - nband * plan_s) / (nband * apply_ms / 1e3)) - 1))
    cli_step("fluxtractor", lambda: cli_main(["fluxtractor", k_clark, "--cg-maxit", str(cg_maxit), *on]), dev, steps,
             "commands")
    tree = TreeStore(k_clark)
    finite = all(np.isfinite(np.asarray(tree.group(k).read(n))).all() for k in tree.groups() if k.startswith("band")
                 for n in ("MODEL_MOPPED", "RESIDUAL_MOPPED", "UPDATE"))
    steps["fluxtractor"].update(cg_maxit=cg_maxit, hessian_vis_ms=apply_ms, hessian_vis_plan_seconds=plan_s,
                                w_planes=nplanes, hessian_vis_launches=h_launches,
                                hessian_vis_two_runs_identical=h_same)
    emit({"phase": "commands", "stage": "fluxtractor_checks", "cg_maxit": cg_maxit, "hessian_vis_ms": apply_ms,
          "hessian_vis_plan_seconds": plan_s, "w_planes": nplanes, "finite": finite,
          "hessian_vis_launches": h_launches, "hessian_vis_two_runs_identical": h_same})
    require(finite, "fluxtractor: MODEL_MOPPED, RESIDUAL_MOPPED and UPDATE finite")
    launched("fluxtractor")
    require(steps["fluxtractor"]["launches"]["scatter_grid_wstack"] > 0, "fluxtractor's Hessian scatters through B3")
    shutil.rmtree(k_clark)

    ista = copy("ista.dt")
    cli_step("deconv_ista", lambda: cli_main(["deconv", ista, "--preset", "ista", "--niter", "1", *on]), dev, steps,
             "commands")
    cyc = steps["deconv_ista"]["cycles"]
    steps["deconv_ista"].update(rms0=rms0)
    emit({"phase": "commands", "stage": "deconv_ista_checks", "rms0": rms0, "cycles": cyc})
    launched("deconv_ista")
    require(len(cyc) == 1 and cyc[0]["rms"] < rms0, "deconv --preset ista: the rms falls")
    shutil.rmtree(ista)
    TI._PLAN_CACHE.clear()
    TI._PLAN_CACHE_BYTES = 0
    torch.cuda.empty_cache()

    ms, xds, cube = (str(workdir / n) for n in ("snap.ms.tree", "snap_I.xds", "snap.cube"))
    cli_step("hci_simulate", lambda: simulate_vis_store(
        ms, nant=nant, ntime=hci_ntime, times_per_scan=1, nchan=nchan, nx=nx, sources=sky["sources"], freq0=856e6,
        freq1=1712e6, noise=1.0, ncorr=2, feed_type="linear", seed=seed, device=dev), dev, steps, "commands")
    cli_step("hci_init", lambda: cli_main(["init", ms, xds, *on]), dev, steps, "commands")
    cli_step("hci", lambda: cli_main(["hci", xds, cube, "--nx", str(hci_nx), "--freq-chunks", str(hci_chunks), *on]),
             dev, steps, "commands")
    c = steps["hci"]["counters"]
    stats = dict(command_stats(steps["hci"], "hci"), tasks=c["hci.tasks"])
    frames = TreeStore(cube).read("CUBE")
    mean_img = frames.mean(axis=(0, 1))
    finite = bool(np.isfinite(mean_img).all())
    off = peak_offset_px(mean_img, pix, shift=(nx - hci_nx) // 2)
    steps["hci"].update(**stats, cube_shape=list(frames.shape), mean_peak_offset_px=off)
    emit({"phase": "commands", "stage": "hci_checks", **stats, "cube_shape": list(frames.shape), "finite": finite,
          "mean_peak_offset_px": off})
    require(stats["routes"] == {"idg": 1} and steps["hci"]["launches"]["patches_from_vals"] == stats["tasks"],
            "hci: IDG, one B1 launch a snapshot")
    require(tuple(frames.shape) == (hci_ntime, hci_chunks, hci_nx, hci_nx) and finite, "hci: CUBE finite")
    require(off <= 1, "hci: the time-mean's brightest pixel on a true source")
    del frames

    # a step transient at the pixel farthest from every source, injected by
    # a direct call, and the same call without it
    times = np.array([float(TreeStore(xds).group(k).attrs["time"]) for k in TreeStore(xds).groups()])
    t_step = float(np.mean(times))
    shift = (nx - step_nx) // 2
    grid = range(step_nx // 8, step_nx, step_nx // 8)
    cand = [(a, b) for a in grid for b in grid]
    p, q = max(cand, key=lambda c: min(abs(c[0] + shift - a) + abs(c[1] + shift - b) for a, b, _ in pix))
    inject = dict(kind="step", t0=t_step, amplitude=5.0, xfrac=p / step_nx, yfrac=q / step_nx)
    t0 = time.perf_counter()
    with_step = THCI.hci(xds, str(workdir / "step.cube"), nx=step_nx, epsilon=1e-7, inject_transient=inject,
                         device=dev)
    step_s = time.perf_counter() - t0
    without = THCI.hci(xds, str(workdir / "plain.cube"), nx=step_nx, epsilon=1e-7, device=dev)
    at = np.asarray(with_step.read("CUBE"))[:, 0, p, q]
    diff = at - np.asarray(without.read("CUBE"))[:, 0, p, q]
    after = times >= t_step
    rec = dict(pixel=[p, q], t0=t_step, seconds=step_s, before_max_abs=float(np.abs(at[~after]).max()),
               after_rel_to_amplitude=float(np.abs(at[after] / 5.0 - 1.0).max()),
               diff_before_max_abs=float(np.abs(diff[~after]).max()),
               diff_after_rel=float(np.abs(diff[after] / 5.0 - 1.0).max()))
    emit({"phase": "commands", "stage": "hci_step_transient", **rec})
    require(rec["before_max_abs"] < 0.5 and rec["after_rel_to_amplitude"] < 0.15, "hci: the step's frames at its pixel")
    # before t0 the two runs grid the same visibilities
    require(rec["diff_before_max_abs"] < 1e-4 * 5.0 and rec["diff_after_rel"] < 1e-4,
            "hci: the injected step is 0 before t0 and its amplitude after")

    # B1/B2 at one snapshot's plan, as hci plans it (scan 0, chunk 0)
    g = TreeStore(xds).group(TreeStore(xds).groups()[0])
    chans = np.array_split(np.arange(nchan), hci_chunks)[0]
    plan = plan_idg(np.asarray(g.read("UVW")), np.asarray(g.read("FREQ"))[chans], nx=hci_nx, ny=hci_nx,
                    cellx=sky["cell_rad"], celly=sky["cell_rad"], epsilon=1e-7, do_wgridding=True, divide_by_n=False,
                    dtype=rdt, device=dev)
    vis = np.asarray(g.read("VIS"))[:, chans]
    wm = np.asarray(g.read("WEIGHT"))[:, chans] * np.asarray(g.read("MASK"))[:, chans]
    vals = _idg_prepare(plan, to_device(vis.real, dev, rdt), to_device(vis.imag, dev, rdt), to_device(wm, dev, rdt))
    rec, _ = idg_kernels_at_plan(plan, vals, reps=50)
    rec.update(nbins=plan.nbins, w_support=plan.w_support, nvis=int(vis.size))
    kern["hci_snapshot"] = rec
    emit({"phase": "commands", "stage": "kernels_at_hci_snapshot_plan", **rec})
    require(rec["b1_rel_vs_f64"] <= 2e-6 and rec["b2_rel_vs_f64"] <= 2e-6, "B1/B2 vs f64 plain at an hci snapshot plan")
    del plan, vals

    total = {name: sum(st["launches"][name] for st in steps.values()) for name in KERNELS}
    emit({"phase": "commands", "stage": "summary", "seconds": sum(st["seconds"] for st in steps.values()),
          "launches": total, "max_memory_allocated": max(st["max_memory_allocated"] for st in steps.values())})
    TI._PLAN_CACHE.clear()
    TI._PLAN_CACHE_BYTES = 0
    torch.cuda.empty_cache()
    shutil.rmtree(workdir)
    return total, kern, steps


def accuracy_s24_flips(dev, nrow: int = 50_000, nchan: int = 2, nx: int = 256, eps: float = 1e-7):
    """An explicit S = 24 plan with ``flip_v=False`` and ``hermitian=False``
    at 256^2 (the accuracy phase's coordinates) against the direct f64 DFT
    with the same sign of v, both ways: ``vis2dirty_idg`` within
    ``delivered_accuracy`` (interior and edge), ``dirty2vis_idg`` of a random
    image within the edge budget of max|V|, and the adjoint identity of the
    pair (<= 1e-5, sums in f64)."""
    import torch

    from pfb_imaging_tpu_torch.ops.gridder_idg import delivered_accuracy, dirty2vis_idg, plan_idg, vis2dirty_idg

    rng = np.random.default_rng(5)
    uvw, freq = bench_coords(rng, nrow, nchan)
    cell = 8e-6 * 1024 / nx
    vis = rng.standard_normal((nrow, nchan)) + 1j * rng.standard_normal((nrow, nchan))
    img = rng.standard_normal((nx, nx))
    plan = plan_idg(uvw, freq, nx=nx, ny=nx, cellx=cell, celly=cell, epsilon=eps, subgrid=24, flip_v=False,
                    hermitian=False, divide_by_n=False, device=dev)
    require(plan.S == 24 and not plan.hermitian, "an explicit S = 24 plan without the hermitian fold")
    vr, vi = (torch.as_tensor(a, device=dev).float() for a in (vis.real, vis.imag))
    img_t = torch.as_tensor(img, device=dev).float()
    d = vis2dirty_idg(plan, vr, vis_im=vi).double()
    v = dirty2vis_idg(plan, img_t).to(torch.complex128)
    ref = dft_dirty(uvw, freq, vis, nx, cell, dev, sv=1.0)
    vref = dft_vis(uvw, freq, img, cell, dev, sv=1.0)
    err = (d - ref).abs() / ref.abs().max()
    q = nx // 4
    budget = delivered_accuracy(plan)
    lhs = float((d * img_t.double()).sum())
    rhs = float((torch.complex(vr, vi).to(torch.complex128).conj() * v).real.sum())
    rec = dict(nx=nx, nvis=nrow * nchan, epsilon=eps, subgrid=plan.S, half=plan.half, nbins=plan.nbins,
               ngroups=plan.ngroups, flip_v=False, hermitian=False, rel_linf=float(err.max()),
               rel_linf_inner=float(err[q:-q, q:-q].max()),
               degrid_rel_linf=float((v - vref).abs().max() / vref.abs().max()), adjoint_rel=abs(lhs - rhs) / abs(lhs),
               budget_inner=budget["interior"], budget_edge=budget["edge"], edge_amp=budget["edge_amp"])
    emit({"phase": "operators", "stage": "accuracy_s24_flips", **rec})
    require(all(np.isfinite([rec["rel_linf"], rec["degrid_rel_linf"]])), "S = 24 accuracy finite")
    require(rec["rel_linf_inner"] < budget["interior"], "S = 24 interior accuracy within delivered_accuracy")
    require(rec["rel_linf"] < budget["edge"], "S = 24 edge accuracy within delivered_accuracy")
    require(rec["degrid_rel_linf"] < budget["edge"], "S = 24 degrid accuracy within the edge budget")
    require(rec["adjoint_rel"] <= 1e-5, "S = 24 adjoint identity")
    return rec


def idg_runtime_args(dev, imaged: Path, eta: float = 1e-3, seed: int = 47) -> dict:
    """The IDG runtime arguments at band 0's residual plan of the imaged tree
    (``residual_from_parts``'s cached plan; the run that plans it is not
    counted), with that band's masked weight, WSUM and BEAM (the
    partition's, or the cosine-tapered model at the band's mean frequency
    where the imager wrote none):
      * the counts zeroed right before ``hessian_vis_idg(plan, x, wgt_g,
        beam=BEAM, eta=eta, wsum=WSUM)`` on band 0's MODEL (a seeded image
        where it is zero) and read right after: B2 and B1 launched; held to
        the composition of the port's own calls (x·beam → the round trip →
        /wsum → ·beam → + eta·x) within rel L∞ 1e-6; its CUDA-event ms;
      * ``vis2dirty_idg(plan, vis, wgt, mask)`` positional and with
        ``mask=`` by keyword, a seeded 0/1 mask, each held to
        ``vis2dirty_idg(plan, vis, wgt * mask)``: the same tensor, or within
        rel L∞ 1e-7; B1 launched.
    Two runs each of the Hessian, of ``vis2dirty_idg`` and of
    ``dirty2vis_idg`` on the same inputs, with no determinism switch: whether
    they give the same bits (required in the ``same_bits`` stage). The
    Hessian's device time a call by kernel family (B2, B1, K1, K2, FFTs,
    gathers, the rest), from ``torch.profiler``."""
    import torch

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.ops.gridder_idg import dirty2vis_idg, hessian_vis_idg, vis2dirty_idg
    from pfb_imaging_tpu_torch.utils.beam import cosine_taper_beam
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    rdt = real_dtype(dev)
    node = TreeStore(imaged).group("band0000_time0000")
    pg = node.group("part0000")
    nx = int(TreeStore(imaged).attrs["nx"])
    model = np.asarray(node.read("MODEL")) if node.has("MODEL") else np.zeros((nx, nx))
    TI.residual_from_parts(node, model, epsilon=1e-7, device=dev)
    hits = [v for k, v in TI._PLAN_CACHE.items() if k[0] == str(pg.path)]
    require(len(hits) == 1 and hits[0][4], "band 0's residual plan of the imaged tree cached, an IDG plan")
    plan, wgt_g, _, beam, _ = hits[0]
    if beam is None:
        cell = float(TreeStore(imaged).attrs["cell_rad"])
        lm = (np.arange(nx) - nx // 2) * cell
        ll, mm = np.meshgrid(lm, lm, indexing="ij")
        beam = to_device(cosine_taper_beam(ll, mm, float(np.asarray(pg.read("FREQ")).mean())), dev, rdt)
    wsum = float(np.asarray(node.read("WSUM"))[0])
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = to_device(model, dev, rdt)
    if not bool(x.any()):
        x = torch.randn((nx, nx), generator=gen, device=dev, dtype=rdt)
    vis = np.asarray(pg.read("VIS"))
    vc = torch.complex(to_device(vis.real, dev, rdt), to_device(vis.imag, dev, rdt))
    wm = to_device(np.asarray(pg.read("WEIGHT")) * np.asarray(pg.read("MASK")), dev, rdt)
    mask = (torch.rand(wm.shape, generator=gen, device=dev) > 0.5).to(rdt)

    def hess():
        return hessian_vis_idg(plan, x, wgt_g, beam=beam, eta=eta, wsum=wsum)

    torch.cuda.synchronize()
    zero_counts()
    hess()
    torch.cuda.synchronize()
    h_launches = read_counts()["launches"]
    zero_counts()
    vis2dirty_idg(plan, vc, wm, mask)
    vis2dirty_idg(plan, vc, wm, mask=mask)
    torch.cuda.synchronize()
    mask_launches = read_counts()["launches"]
    h, h2 = hess(), hess()
    comp = hessian_vis_idg(plan, x * beam, wgt_g) / wsum * beam + eta * x
    d_pos, d_kw = vis2dirty_idg(plan, vc, wm, mask), vis2dirty_idg(plan, vc, wm, mask=mask)
    d_ref, d_ref2 = vis2dirty_idg(plan, vc, wm * mask), vis2dirty_idg(plan, vc, wm * mask)
    f1, f2 = dirty2vis_idg(plan, x), dirty2vis_idg(plan, x)
    rec = dict(ngroups=plan.ngroups, nbins=plan.nbins, w_support=plan.w_support, S=plan.S, wsum=wsum, eta=eta,
               beam_from_tree=hits[0][3] is not None, hessian_launches=h_launches, mask_launches=mask_launches,
               mask_fraction=float(mask.mean()), hessian_ms=cuda_ms(hess, 5),
               vis2dirty_mask_ms=cuda_ms(lambda: vis2dirty_idg(plan, vc, wm, mask), 5),
               dirty2vis_ms=cuda_ms(lambda: dirty2vis_idg(plan, x), 5),
               hessian_vs_composition_rel=rel_linf(h, comp), hessian_composition_identical=bool(torch.equal(h, comp)),
               mask_positional_identical=bool(torch.equal(d_pos, d_ref)),
               mask_keyword_identical=bool(torch.equal(d_kw, d_ref)), mask_positional_rel=rel_linf(d_pos, d_ref),
               mask_keyword_rel=rel_linf(d_kw, d_ref), hessian_two_runs_identical=bool(torch.equal(h, h2)),
               vis2dirty_two_runs_identical=bool(torch.equal(d_ref, d_ref2)),
               dirty2vis_two_runs_identical=bool(torch.equal(f1, f2)), hessian_split=device_ms_by_family(hess, 3))
    del h, h2, comp, d_pos, d_kw, d_ref, d_ref2, f1, f2
    emit({"phase": "operators", "stage": "idg_runtime_args", **rec})
    require(h_launches["vals_from_patches"] > 0 and h_launches["patches_from_vals"] > 0,
            "B2 and B1 launched by hessian_vis_idg(beam, eta, wsum)")
    require(h_launches["idg_extract"] > 0 and h_launches["idg_assemble"] > 0,
            "K2 and K1 launched by hessian_vis_idg(beam, eta, wsum)")
    require(rec["hessian_vs_composition_rel"] <= 1e-6, "hessian_vis_idg(beam, eta, wsum) = its composition")
    require(rec["mask_launches"]["patches_from_vals"] > 0, "B1 launched by vis2dirty_idg(mask)")
    require(rec["mask_positional_rel"] <= 1e-7 and rec["mask_keyword_rel"] <= 1e-7,
            "vis2dirty_idg(plan, vis, wgt, mask) = vis2dirty_idg(plan, vis, wgt * mask)")
    return rec


def lasso_primal_dual(dev, nband: int, nx: int, lam: float = 0.3, seed: int = 48) -> dict:
    """``PrimalDual`` + ``L1(IdentityPsi)`` on ``tests/test_solvers.py``'s
    lasso (min 0.5||x - b||^2 + lam||x||_1, hess norm 1) at the cube's size,
    b seeded: L1 has no fused dual update, so this runs the Moreau
    fallback through its prox. The answer is the soft threshold of b:
    required within 1e-5 max|b| (f32). Its iterations and seconds."""
    import torch

    from pfb_imaging_tpu_torch import real_dtype
    from pfb_imaging_tpu_torch.ops.identity_psi import IdentityPsi
    from pfb_imaging_tpu_torch.opt.primal_dual import PrimalDual
    from pfb_imaging_tpu_torch.prox.l1 import L1

    gen = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randn((nband, nx, nx), generator=gen, device=dev, dtype=real_dtype(dev))
    pd = PrimalDual(tol=1e-8, maxit=5000, verbosity=0)
    pd.setup(L1(IdentityPsi(nband, nx, nx, device=dev)), hessnorm=1.0)
    pd.set_grad(lambda x: x - b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = pd.solve(torch.zeros_like(b), lam)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    xstar = torch.sign(b) * torch.clamp(b.abs() - lam, min=0.0)
    rec = dict(nband=nband, nx=nx, lam=lam, iters=pd.niter_last, seconds=seconds,
               max_abs_err=float((x - xstar).abs().max()), max_abs_b=float(b.abs().max()))
    emit({"phase": "operators", "stage": "lasso_primal_dual_l1", **rec})
    require(rec["max_abs_err"] <= 1e-5 * rec["max_abs_b"], "PrimalDual + L1 solves the lasso (the soft threshold)")
    return rec


def phase_operators(dev, imaged: Path, sky: dict, eta: float = 1e-2, cg_tol: float = 1e-4, cg_maxit: int = 1000,
                    cg_rel_limit: float = 1e-3, taper_width: int = 1, pd_iters: int = 5, f64_groups: int = 65536,
                    acc_nrow: int = 50_000, acc_nx: int = 256, seed: int = 46):
    """The operators that only the JAX tests reach, on the pipeline's imaged
    tree (2048^2, 4 bands, 4096^2 PSF) as its imager wrote it:
      * ``HessPSF`` at the tree's |PSFHAT| / WSUM per band (eta ``eta``), all
        bands at once: ms of ``dot`` and ``idot(mode="direct")``, then
        ``idot(mode="psf")`` on DIRTY / WSUM (the bands' batched CG, their
        iterations each) with ||dot(idot(y)) - y|| / ||y|| <= ``cg_rel_limit``;
      * ``pcg`` on the same right-hand side with and without the hook
        (``precond`` = the direct inverse under a ``taper_width`` taper; a
        wide taper spreads the preconditioned spectrum: at width 32 on a
        128^2 tree PCG did not stop in 300 iterations): each must stop
        before ``cg_maxit``, and its iterations are recorded;
      * ``nnls`` on DIRTY / total WSUM with the complex PSFHAT (tol 1e-4,
        maxit 50, the power method from a seeded generator): its seconds,
        FISTA iterations and backtracking events; the model >= 0, nonzero,
        its MFS peak within a pixel of the brightest source's;
      * ``Gauss`` dot and sqrtdot on a (4, 2048, 2048) cube (finite; <x, Kx>
        > 0 and <Ka, b> = <a, Kb> to 1e-4) and a ``Mask`` round trip (exact)
        with its adjoint (1e-5);
      * ``plan_idg(subgrid=24)`` on band 0's visibilities at epsilon 1e-7,
        the counts zeroed right before ``vis2dirty_idg`` and
        ``dirty2vis_idg`` on it and read right after (B1 and B2 launched);
        the dirty image within 1e-3 of the imager's band-0 DIRTY (its own
        plan); B1/B2 at this plan against their f64 plain versions on the
        middle ``f64_groups`` groups (2e-6); then
        :func:`accuracy_s24_flips`;
      * ``bringup_checks`` around ``pd_iters`` primal-dual iterations of the
        tree's SARA solve (model 0, residual DIRTY / total WSUM), which must
        raise nothing, then the host syncs per iteration of the same loop
        under ``torch.cuda.set_sync_debug_mode("warn")``;
      * ``memory_line()`` and ``cost_analysis(hessian_psf, ...)``'s flops;
      * :func:`idg_runtime_args` at band 0's residual plan, then
        :func:`lasso_primal_dual` at the cube's size.
    Returns (the S = 24 path's launches, B1/B2's record at the S = 24 plan,
    the phase's record, with the launches of the IDG runtime arguments'
    calls)."""
    import warnings
    from functools import partial

    import torch

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.deconv.nnls import nnls
    from pfb_imaging_tpu_torch.deconv.pfb import _pfb_grad
    from pfb_imaging_tpu_torch.deconv.presets import make_sara
    from pfb_imaging_tpu_torch.ops.gauss import Gauss
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_prepare, dirty2vis_idg, plan_idg, vis2dirty_idg
    from pfb_imaging_tpu_torch.ops.hessian import hessian_psf
    from pfb_imaging_tpu_torch.ops.mask import Mask
    from pfb_imaging_tpu_torch.ops.precond import HessPSF
    from pfb_imaging_tpu_torch.opt.pcg import pcg
    from pfb_imaging_tpu_torch.opt.primal_dual import primal_dual_loop
    from pfb_imaging_tpu_torch.utils.debug import bringup_checks
    from pfb_imaging_tpu_torch.utils.profiling import cost_analysis, memory_line
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    rdt = real_dtype(dev)
    tree = TreeStore(imaged)
    a = tree.attrs
    nx, nxp, nyp, cell = int(a["nx"]), int(a["nx_psf"]), int(a["ny_psf"]), float(a["cell_rad"])
    nodes = [tree.group(k) for k in sorted(tree.groups()) if k.startswith("band")]
    nband = len(nodes)
    wsums = np.array([float(np.asarray(n.read("WSUM"))[0]) for n in nodes])
    wsum = float(wsums.sum())
    dirty = np.stack([np.asarray(n.read("DIRTY")) for n in nodes])
    psfhat = np.stack([np.asarray(n.read("PSFHAT")) for n in nodes])
    gen = torch.Generator(device=dev).manual_seed(seed)
    rec: dict = dict(nband=nband, nx=nx, nx_psf=nxp)

    # ── HessPSF and the PCG hook ──
    hp = HessPSF(np.abs(psfhat) / wsums[:, None, None], nxp, nyp, eta=eta, cg_tol=cg_tol, cg_maxit=cg_maxit,
                 taper_width=taper_width, device=dev)
    y = to_device(dirty / wsums[:, None, None], dev, rdt)
    hrec = dict(eta=eta, cg_tol=cg_tol, taper_width=taper_width, dot_ms=cuda_ms(lambda: hp.dot(y), 10),
                idot_direct_ms=cuda_ms(lambda: hp.idot(y, mode="direct"), 10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xi = hp.idot(y, mode="psf")
    torch.cuda.synchronize()
    hrec.update(idot_psf_seconds=time.perf_counter() - t0, cg_iters_per_band=list(hp.niter_last),
                idot_psf_rel_residual=float((hp.dot(xi) - y).norm() / y.norm()))
    for name, pre in (("pcg_plain", None), ("pcg_precond_direct", partial(hp.idot, mode="direct"))):
        info = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs = pcg(hp.dot, y, precond=pre, tol=cg_tol, maxit=cg_maxit, minit=1, info=info)
        torch.cuda.synchronize()
        hrec[name] = dict(iters=info["niter"], seconds=time.perf_counter() - t0,
                          rel_residual=float((hp.dot(xs) - y).norm() / y.norm()))
    emit({"phase": "operators", "stage": "hesspsf", **hrec})
    require(all(k < cg_maxit for k in hrec["cg_iters_per_band"]), "HessPSF.idot(psf): every band stops before maxit")
    require(hrec["idot_psf_rel_residual"] <= cg_rel_limit, "HessPSF: ||dot(idot(y)) - y|| / ||y|| within its limit")
    for name in ("pcg_plain", "pcg_precond_direct"):
        require(hrec[name]["iters"] < cg_maxit, f"{name} stops before maxit")
    rec["hesspsf"] = hrec
    ca = cost_analysis(hessian_psf, y, hp.abspsfhat, nxp, nyp)
    del hp, xi, xs
    torch.cuda.empty_cache()

    # ── nnls ──
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = nnls(to_device(dirty / wsum, dev, rdt), psfhat / wsum, nxp, nyp, tol=1e-4, maxit=50, info=info,
                 device=dev)
    torch.cuda.synchronize()
    nnls_s = time.perf_counter() - t0
    m = model.cpu().numpy()
    f0 = min(float(np.asarray(n.group(sorted(n.groups())[0]).read("FREQ")).min()) for n in nodes)
    fb = np.array([float(np.asarray(n.group(sorted(n.groups())[0]).read("FREQ")).mean()) for n in nodes])
    mfs_flux = [fl * ((fb / f0) ** al).sum() for (_, _, fl, al) in sky["sources"]]
    brightest = sky["pix"][int(np.argmax(mfs_flux))]
    nrec = dict(seconds=nnls_s, fista_iters=info["niter"], backtracks=info["nbacktrack"],
                beta=info["beta"], model_min=float(m.min()), model_max=float(m.max()), brightest_source=brightest,
                mfs_peak_offset_px=peak_offset_px(m.sum(axis=0), [brightest]))
    emit({"phase": "operators", "stage": "nnls", **nrec})
    require(nrec["model_min"] >= 0.0 and nrec["model_max"] > 0.0, "nnls: a positive model")
    require(nrec["mfs_peak_offset_px"] <= 1, "nnls: the MFS model's peak on the brightest source")
    rec["nnls"] = nrec
    del model, m

    # ── Gauss and Mask ──
    g = Gauss(fb / 1e9, np.arange(nx, dtype=float), np.arange(nx, dtype=float), lf=1.0, lx=2.0, ly=2.0, device=dev)
    xw = torch.randn((nband, nx, nx), generator=gen, device=dev, dtype=rdt)
    xb = torch.randn((nband, nx, nx), generator=gen, device=dev, dtype=rdt)
    kw, ks = g.dot(xw), g.sqrtdot(xw)
    ab, ba = float((g.dot(xw) * xb).double().sum()), float((xw * g.dot(xb)).double().sum())
    mask = np.random.default_rng(seed).random((nx, nx)) > 0.5
    mk = Mask(mask, device=dev)
    x0 = y[0]
    beta = mk.dot(x0)
    back = mk.hdot(beta)
    yb = torch.randn(mk.nnz, generator=gen, device=dev, dtype=rdt)
    lhs, rhs = float((mk.dot(x0) * yb).double().sum()), float((x0 * mk.hdot(yb)).double().sum())
    grec = dict(gauss_dot_ms=cuda_ms(lambda: g.dot(xw), 5), gauss_sqrtdot_ms=cuda_ms(lambda: g.sqrtdot(xw), 5),
                gauss_finite=bool(torch.isfinite(kw).all() and torch.isfinite(ks).all()),
                gauss_quadratic=float((xw * kw).double().sum()), gauss_symmetry_rel=abs(ab - ba) / abs(ab),
                mask_nnz=mk.nnz, mask_dot_ms=cuda_ms(lambda: mk.dot(x0), 10),
                mask_hdot_ms=cuda_ms(lambda: mk.hdot(beta), 10),
                mask_round_trip_exact=bool(torch.equal(back, x0 * torch.as_tensor(mask, device=dev))),
                mask_adjoint_rel=abs(lhs - rhs) / abs(lhs))
    emit({"phase": "operators", "stage": "gauss_mask", **grec})
    require(grec["gauss_finite"] and grec["gauss_quadratic"] > 0 and grec["gauss_symmetry_rel"] <= 1e-4,
            "Gauss: finite, positive and symmetric")
    require(grec["mask_round_trip_exact"] and grec["mask_adjoint_rel"] <= 1e-5, "Mask: round trip and adjoint")
    rec["gauss_mask"] = grec
    del g, xw, xb, kw, ks, back, beta
    torch.cuda.empty_cache()

    # ── an explicit S = 24 plan on band 0's visibilities ──
    pg = nodes[0].group(sorted(nodes[0].groups())[0])
    vis = np.asarray(pg.read("VIS"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p24 = plan_idg(np.asarray(pg.read("UVW")), np.asarray(pg.read("FREQ")), nx=nx, ny=nx, cellx=cell, celly=cell,
                   epsilon=1e-7, subgrid=24, divide_by_n=False, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    require(p24.S == 24 and p24.half == 12, "plan_idg(subgrid=24) plans S = 24, half 12")
    vr, vi = to_device(vis.real, dev, rdt), to_device(vis.imag, dev, rdt)
    wm = to_device(np.asarray(pg.read("WEIGHT")) * np.asarray(pg.read("MASK")), dev, rdt)
    torch.cuda.synchronize()
    zero_counts()
    d24 = vis2dirty_idg(p24, vr, wgt=wm, vis_im=vi)
    m24 = dirty2vis_idg(p24, y[0])
    torch.cuda.synchronize()
    launches = read_counts()["launches"]
    srec = dict(plan_seconds=plan_s, ngroups=p24.ngroups, nbins=p24.nbins, w_support=p24.w_support, nbig=p24.nbig_x,
                nvis=int(vis.size), launches=launches,
                dirty_vs_imager_rel=rel_linf_np(d24.double().cpu().numpy(), dirty[0]),
                degrid_finite=bool(torch.isfinite(m24).all()), degrid_shape=list(m24.shape))
    emit({"phase": "operators", "stage": "plan_s24", **srec})
    require(launches["patches_from_vals"] > 0 and launches["vals_from_patches"] > 0,
            "B1 and B2 launched by vis2dirty_idg / dirty2vis_idg at S = 24")
    require(srec["degrid_finite"] and tuple(m24.shape) == vis.shape, "S = 24 degrid finite, of the data's shape")
    require(srec["dirty_vs_imager_rel"] <= 1e-3, "S = 24 dirty image within 1e-3 of the imager's DIRTY")
    del d24, m24
    vals = _idg_prepare(p24, vr, vi, wm)
    krec, _ = idg_kernels_at_plan(p24, vals, f64_groups=f64_groups)
    krec.update(nbins=p24.nbins, w_support=p24.w_support)
    emit({"phase": "operators", "stage": "kernels_at_s24_plan", **krec})
    require(krec["b1_rel_vs_f64"] <= 2e-6 and krec["b2_rel_vs_f64"] <= 2e-6, "B1/B2 vs f64 plain at the S = 24 plan")
    rec["plan_s24"] = srec
    del p24, vals, vr, vi, wm
    torch.cuda.empty_cache()
    rec["accuracy_s24_flips"] = accuracy_s24_flips(dev, nrow=acc_nrow, nx=acc_nx)

    # ── the NaN trap and the host syncs of the SARA primal-dual loop ──
    parts = np.stack([np.stack([np.abs(np.asarray(n.group(q).read("PSFHAT"))) for q in sorted(n.groups())])
                      for n in nodes])
    geometry = dict(nx=nx, ny=nx, nx_psf=nxp, ny_psf=nyp)
    zeros = np.zeros((nband, nx, nx))
    solver = make_sara(parts, wsums, geometry, zeros, zeros, {}, device=dev)
    del parts
    hess, reg, bwd = solver.hess, solver.reg, solver.backward_alg
    psi = reg.psi
    x = torch.zeros((nband, nx, nx), dtype=rdt, device=dev)
    r = to_device(dirty / wsum, dev, rdt)
    v = psi.dot(x)
    lam = float(r.sum(0).std())
    grad = partial(_pfb_grad, hess.dot, x + r, 1.0)

    def pd():
        return primal_dual_loop(x, v, lam, reg.l1weight, bwd.sigma, bwd.tau, grad, psi_dot=psi.dot,
                                psi_hdot=psi.hdot, primal_prox=bwd.primal_prox, dual_update=reg.dual_update_fn,
                                tol=0.0, maxit=pd_iters)

    with bringup_checks():
        xo, *_ = pd()
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pd()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    prec = dict(pd_iters=pd_iters, bringup_checks_raised=False, model_finite=bool(torch.isfinite(xo).all()),
                host_syncs=syncs, host_syncs_per_pd_iter=syncs / pd_iters, memory_line=memory_line(),
                hessian_psf_flops=ca["flops"], hessian_psf_flops_by_op=ca["by_op"])
    emit({"phase": "operators", "stage": "bringup_and_syncs", **prec})
    require(prec["model_finite"], "primal-dual under bringup_checks: a finite model")
    rec["bringup"] = prec
    del solver, hess, reg, bwd, psi, x, r, v, xo
    torch.cuda.empty_cache()
    rec["idg_runtime_args"] = idg_runtime_args(dev, imaged)
    rec["lasso_primal_dual_l1"] = lasso_primal_dual(dev, nband, nx)
    torch.cuda.empty_cache()
    return launches, krec, rec


def phase_same_bits(dev, workdir: Path, imaged: Path, calls: dict, niter: int = 2, pd_maxit: int = 20) -> dict:
    """Two runs, the same bits, with no determinism switch. ``calls`` maps
    each call an earlier phase ran twice on the same inputs
    (``hessian_vis_idg(beam, eta, wsum)``, ``vis2dirty_idg(mask)`` and
    ``dirty2vis_idg`` at band 0's residual plan of the imaged tree, the
    multiband Hessian at the deconv and widefield launches, fluxtractor's
    classic ``hessian_vis``; five PD iterations at the sara cell's shapes
    with P2 on two cubes and on torch's ``2.0 * vn - v``, from ``phase_psi``)
    to whether the two gave the same bits; then
    ``pfb-torch sara --niter 2 --pd-maxit 20`` runs twice, each on its own
    copy of the imaged tree, and its MODEL and MFS residual are compared bit
    for bit. Every one must give the same bits."""
    import torch

    from pfb_imaging_tpu_torch.cli import main as cli_main
    from pfb_imaging_tpu_torch.core import imager as TI

    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    runs = []
    for i in range(2):
        dt = workdir / f"sara_{i}.dt"
        shutil.copytree(imaged, dt)
        TI._PLAN_CACHE.clear()
        TI._PLAN_CACHE_BYTES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_main(["sara", str(dt), "--niter", str(niter), "--pd-maxit", str(pd_maxit), "--device", str(dev)])
        torch.cuda.synchronize()
        runs.append(dict(seconds=time.perf_counter() - t0, model=_tree_cube(dt), residual=mfs_image(dt, "RESIDUAL")))
    TI._PLAN_CACHE.clear()
    TI._PLAN_CACHE_BYTES = 0
    torch.cuda.empty_cache()
    shutil.rmtree(workdir)
    a, b = runs
    rec = dict(calls, sara_model_identical=bool(np.array_equal(a["model"], b["model"])),
               sara_mfs_residual_identical=bool(np.array_equal(a["residual"], b["residual"])),
               sara_model_max_abs_diff=float(np.abs(a["model"] - b["model"]).max()),
               sara_mfs_residual_max_abs_diff=float(np.abs(a["residual"] - b["residual"]).max()),
               sara_seconds=[r["seconds"] for r in runs], sara_model_abs_sum=float(np.abs(a["model"]).sum()))
    emit({"phase": "same_bits", **rec})
    differ = [k for k, v in rec.items() if k.endswith("identical") and not v]
    require(not differ and rec["sara_model_abs_sum"] > 0, f"two runs give the same bits (differ: {differ})")
    return rec


# ── parallel: ranks as child processes ──────────────────────────────

# the primal-dual budget of every sara run of the parallel phase (keeps its
# five runs, two of them gathering the dual's bands through gloo, ~0.18 s a
# PD iteration on the one card, inside the phase's 150 s)
PAR_PD_MAXIT = 20
# the parts each child process runs, in order (the gloo ranks of b run c)
PAR_PARTS = {"a": ("a",), "bc": ("b", "c")}
# per child run: seconds before the parent kills its ranks and fails
PAR_TIMEOUT_S = {"a": 300.0, "bc": 600.0}


def _par_child(rank: int, run: str, world: int, workdir: str, kw: dict) -> None:
    """One rank of the parallel phase: joins a world of ``world`` ranks on
    the one card ``kw["dev_s"]`` (NCCL for part a, gloo passed explicitly
    for b and c), runs the parts ``PAR_PARTS[run]`` with their arguments
    ``kw[part]``, prints each part's JSON line and saves it for the
    parent."""
    import os

    import torch

    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    os.environ["LOCAL_RANK"] = str(rank)
    from pfb_imaging_tpu_torch.kernels import build
    from pfb_imaging_tpu_torch.parallel.multihost import init_distributed

    dev_s = kw["dev_s"]
    if dev_s.startswith("cuda"):
        build.load()
    backend = "nccl" if run == "a" and dev_s.startswith("cuda") else "gloo"
    init_distributed(f"file://{workdir}/rendezvous_{run}", world, rank, backend=backend, device=dev_s,
                     timeout=PAR_TIMEOUT_S[run])
    for part in PAR_PARTS[run]:
        fn = {"a": _par_world1_nccl, "b": _par_two_ranks, "c": _par_row_hessian}[part]
        rec = fn(rank, world, Path(workdir), dev_s=dev_s, **kw[part])
        rec = {"phase": "parallel", "part": part, "rank": rank, "world": world,
               "backend": torch.distributed.get_backend(), **rec}
        emit(rec)
        (Path(workdir) / f"{part}_{rank}.json").write_text(json.dumps(rec))
    torch.distributed.destroy_process_group()


def _par_run(run: str, world: int, workdir: Path, dev_s: str, **kw) -> dict:
    """Start ``world`` ranks of ``run`` as child processes and wait for
    them: a rank that fails fails the smoke, and ranks still running after
    ``PAR_TIMEOUT_S[run]`` are killed and fail it. Returns each part's
    records, by part."""
    import torch.multiprocessing as tmp

    kw["dev_s"] = dev_s
    ctx = tmp.spawn(_par_child, args=(run, world, str(workdir), kw), nprocs=world, join=False)
    deadline = time.monotonic() + PAR_TIMEOUT_S[run]
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            raise RuntimeError(f"parallel run {run}: ranks still running after {PAR_TIMEOUT_S[run]} s")
    codes = [proc.exitcode for proc in ctx.processes]
    require(all(c == 0 for c in codes), f"parallel run {run}: every rank exits 0 ({codes})")
    return {part: [json.loads((workdir / f"{part}_{r}.json").read_text()) for r in range(world)]
            for part in PAR_PARTS[run]}


def _tree_cube(dt, name: str = "MODEL") -> np.ndarray:
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    tree = TreeStore(str(dt))
    return np.stack([np.asarray(tree.group(k).read(name)) for k in sorted(tree.groups()) if k.startswith("band")])


def _sara(dt, dev_s: str, flags: list) -> dict:
    """``pfb-torch sara --niter 1`` on ``dt`` with the counts zeroed right
    before it: seconds, launches, its cycle's record, and its collectives
    (count and bytes by kind): the whole run's, and those inside the
    solver's forward (CG) and backward (PD) calls, the recorder taken
    around each call."""
    from collections import Counter

    import torch

    from pfb_imaging_tpu_torch.cli import main as cli_main
    from pfb_imaging_tpu_torch.deconv.pfb import PFBSolver
    from pfb_imaging_tpu_torch.utils import profiling

    methods = {name: getattr(PFBSolver, name) for name in ("forward", "backward")}
    taken = {None: Counter(), "forward": Counter(), "backward": Counter()}  # outside and inside the calls

    def around(name):
        def call(self, *args):
            taken[None].update(profiling.take()["counters"])
            out = methods[name](self, *args)
            taken[name].update(profiling.take()["counters"])
            return out
        return call

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for name in methods:
        setattr(PFBSolver, name, around(name))
    try:
        cli_main(["sara", str(dt), "--niter", "1", "--pd-maxit", str(PAR_PD_MAXIT), *flags, "--device", dev_s])
    finally:
        for name, method in methods.items():
            setattr(PFBSolver, name, method)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = read_counts()
    total = taken[None] + taken["forward"] + taken["backward"] + Counter(got["counters"])
    (cyc,) = got["cycles"]
    return dict(seconds=seconds, launches={k: total["launch." + k] for k in KERNELS},
                **{k: cyc[k] for k in ("rms", "rmax", "cg_iters", "pd_iters", "mesh")},
                residual_seconds=got["spans"].get("deconv.residual", 0.0), collectives=collectives_of(total),
                collectives_cg=collectives_of(taken["forward"]), collectives_pd=collectives_of(taken["backward"]))


def _par_world1_nccl(rank: int, world: int, workdir: Path, dev_s: str, imaged: str) -> dict:
    """(a) One rank on NCCL: ``sara --niter 1 --use-mesh`` on a copy of the
    pipeline's imaged tree and the same run without ``--use-mesh`` on the
    tree itself (nothing reads it after this phase); the same CG and PD
    iteration counts and models within 1e-6. Then the witness of (b)'s
    chained run: ``sara --niter 1 --use-mesh`` on one rank over the tree
    (b)'s 2-rank imager made (which (b) copied before its own run)."""
    shutil.copytree(imaged, workdir / "a_mesh.dt")
    runs = {}
    for tag, dt, flags in (("mesh", workdir / "a_mesh.dt", ["--use-mesh"]), ("plain", Path(imaged), []),
                           ("witness", workdir / "b.dt", ["--use-mesh"])):
        runs[tag] = _sara(dt, dev_s, flags)
        for name in ("MODEL", "UPDATE"):
            np.save(workdir / f"a_{tag}_{name.lower()}.npy", _tree_cube(dt, name))
    mesh_model = np.load(workdir / "a_mesh_model.npy")
    rel = rel_linf_np(mesh_model, np.load(workdir / "a_plain_model.npy"))
    require(runs["mesh"]["mesh"] == {"band": 1, "row": 1, "in_mesh": True}, "(a): a one-rank mesh")
    require((runs["mesh"]["cg_iters"], runs["mesh"]["pd_iters"]) == (runs["plain"]["cg_iters"],
                                                                     runs["plain"]["pd_iters"]),
            "(a): --use-mesh stops CG and PD where the run without it does")
    require(rel <= 1e-6, "(a): --use-mesh model within 1e-6 of the run without it")
    return dict(model_rel_mesh_vs_plain=rel, runs=runs)


def _par_two_ranks(rank: int, world: int, workdir: Path, dev_s: str, store: str, imaged: str, cell_arcsec: float,
                   nx: int, nband: int) -> dict:
    """(b) Two ranks on the one card over gloo: which collectives gloo runs
    on CUDA tensors; ``imager`` on a 2-rank row mesh (its products against
    the single-process imager's, B1/B2 against f64 plain at each rank's
    band-0 shard plans, one rank at a time); ``sara --niter 1 --use-mesh``
    on a 2-band mesh twice: on a copy of the tree (a) runs on (the models
    then differ by the mesh alone) and, chained, on a copy of the 2-rank
    imager's own tree (held by the parent to (a)'s one-rank witness on that
    tree). Each rank saves its models for the parent."""
    import torch
    import torch.distributed as dist

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.cli import main as cli_main
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.core.imager import _psf_vis
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_prepare
    from pfb_imaging_tpu_torch.parallel.sharded import plan_idg_sharded
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    dev = torch.device(dev_s)
    probe = {}
    for name, op in (("all_reduce", lambda t: dist.all_reduce(t)),
                     ("all_gather", lambda t: dist.all_gather([torch.empty_like(t) for _ in range(world)], t)),
                     ("all_to_all", lambda t: dist.all_to_all_single(torch.empty_like(t), t))):
        try:
            op(torch.ones(4 * world, device=dev))
            torch.cuda.synchronize()
            probe[name] = "accepted"
        except Exception as e:  # the record is the finding: which collectives gloo refuses on CUDA tensors
            probe[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
    dist.barrier()

    dt = workdir / "b.dt"
    TI._PLAN_CACHE.clear()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    cli_main(["imager", store, str(dt), "--nband", str(nband), "--nx", str(nx), "--psf-oversize", "2",
              "--cell-size", repr(float(cell_arcsec)), "--device", dev_s])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    (this,) = got["ranks"]
    img = dict(seconds=wall, launches=got["launches"], **command_stats(got, "imager"), **this)
    require(img["routes"] == {"idg": 1} and img["mesh_row_size"] == 2 and img["launches"]["patches_from_vals"] > 0,
            "(b): the imager on a 2-rank row mesh, B1 launched")
    ref, got = TreeStore(imaged), TreeStore(str(dt))
    img["products_rel_vs_one_process"] = {
        prod: max(rel_linf_np(np.asarray(got.group(g).read(prod)), np.asarray(ref.group(g).read(prod)))
                  for g in ref.groups() if g.startswith("band"))
        for prod in ("DIRTY", "PSF", "WSUM")}
    require(max(img["products_rel_vs_one_process"].values()) <= 1e-5,
            "(b): DIRTY, PSF and WSUM within 1e-5 of the single-process imager")

    # B1/B2 at each rank's shard plans of band 0 (image and PSF), the launch
    # shapes its imager ran, against their f64 plain versions: both ranks
    # plan at once, then take turns, so each has the card to itself while
    # its kernels are timed
    a = got.attrs
    pg = got.group("band0000_time0000").group("part0000")
    uvw, f = np.asarray(pg.read("UVW")), np.asarray(pg.read("FREQ"))
    l0, m0 = pg.attrs.get("l0", 0.0), pg.attrs.get("m0", 0.0)
    pad = (-uvw.shape[0]) % world
    uvw_p = np.concatenate([uvw, np.zeros((pad, 3))])
    rdt = real_dtype(dev)
    kw = dict(cellx=a["cell_rad"], celly=a["cell_rad"], l0=l0, m0=m0, epsilon=1e-7, do_wgridding=True,
              divide_by_n=False, dtype=rdt, device=dev)
    wm = np.asarray(pg.read("WEIGHT")) * np.asarray(pg.read("MASK"))
    preps = {}
    for kind, n, vis in (("image", a["nx"], np.asarray(pg.read("VIS"))), ("psf", a["nx_psf"], _psf_vis(uvw, f, l0, m0))):
        plan, rows = plan_idg_sharded(uvw_p, f, world, rank, nx=n, ny=n, **kw)

        def share(arr):
            arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
            return to_device(arr[rank * rows:(rank + 1) * rows], dev, rdt)

        preps[kind] = (n, rows, plan, _idg_prepare(plan, share(vis.real), share(vis.imag), share(wm)))
    torch.cuda.synchronize()
    kern = {}
    for turn in range(world):
        if turn == rank:
            for kind, (n, rows, plan, vals) in preps.items():
                rec, _ = idg_kernels_at_plan(plan, vals, f64_groups=65536)
                rec.update(nx=n, rows=rows, nbins=plan.nbins, w_support=plan.w_support, card_alone=True)
                require(rec["b1_rel_vs_f64"] <= 2e-6 and rec["b2_rel_vs_f64"] <= 2e-6,
                        f"(b): B1/B2 vs f64 plain at rank {rank}'s band-0 {kind} shard plan")
                kern[kind] = rec
        dist.barrier()
    del preps
    torch.cuda.empty_cache()
    TI._PLAN_CACHE.clear()

    # sara on a 2-band mesh: on (a)'s input, then chained on the 2-rank
    # imager's tree; copies first, since each run writes its tree
    trees = {"on_a_input": (imaged, workdir / "b_sara.dt"), "chained": (dt, workdir / "b_chain.dt")}
    for i, (src, dst) in enumerate(trees.values()):
        if i % world == rank:  # one copy a rank, at once
            shutil.copytree(src, dst)
    dist.barrier()
    saras = {}
    for tag, (_, dst) in trees.items():
        sara = _sara(dst, dev_s, ["--use-mesh"])
        model = _tree_cube(dst)
        np.save(workdir / f"b_{tag}_model_{rank}.npy", model)
        np.save(workdir / f"b_{tag}_update_{rank}.npy", _tree_cube(dst, "UPDATE"))
        sara.update(tree_model_abs_sum=float(np.abs(model).sum()),
                    collectives_per_pd_iter={k: {f: v[f] / max(1, sara["pd_iters"]) for f in v}
                                             for k, v in sara["collectives_pd"].items()},
                    collectives_per_cg_iter={k: {f: v[f] / max(1, sara["cg_iters"]) for f in v}
                                             for k, v in sara["collectives_cg"].items()})
        require(sara["mesh"] == {"band": 2, "row": 1, "in_mesh": True}, f"(b): sara {tag} on a 2-band mesh")
        require(sara["launches"]["patches_from_vals"] > 0 and sara["launches"]["vals_from_patches"] > 0,
                f"(b): B1/B2 launched in sara {tag}'s residual")
        saras[tag] = sara
    TI._PLAN_CACHE.clear()  # the residuals' plans, before part (c) runs on these ranks
    torch.cuda.empty_cache()
    return dict(gloo_takes_cuda=probe, imager=img, kernels=kern, sara=saras)


def _par_row_hessian(rank: int, world: int, workdir: Path, dev_s: str, nx: int, nx_psf: int, cg_iters: int) -> dict:
    """(c) The row-sharded PSF Hessian at the 8k axis: one band, nx
    ``nx``, a ``nx_psf`` PSF grid split over the ranks' row group, against
    the unsharded HessianCube on rank 0 (within 1e-5), ms per apply, and
    ``cg_iters`` PCG iterations on it."""
    import torch
    import torch.distributed as dist

    from pfb_imaging_tpu_torch.ops.hessian import HessianCube
    from pfb_imaging_tpu_torch.opt.pcg import pcg
    from pfb_imaging_tpu_torch.parallel.mesh import make_mesh

    t_start = time.perf_counter()
    dev = torch.device(dev_s)
    gen = torch.Generator(device=dev).manual_seed(7)
    ax = torch.arange(nx_psf, device=dev, dtype=torch.float32) - nx_psf // 2
    psf = torch.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / 18.0)
    psf += 1e-3 * torch.randn((nx_psf, nx_psf), generator=gen, device=dev)
    ph = torch.fft.rfft2(torch.fft.ifftshift(psf)).abs()
    ph = (ph / ph.max())[None, None].cpu().numpy()
    del psf
    x = torch.randn((1, nx, nx), generator=gen, device=dev)
    mesh = make_mesh(band=1, row=world)
    hess = HessianCube.build(ph, np.ones(1), 1e-3, nx_psf, nx_psf, mesh=mesh, device=dev)
    require(hess.mesh is mesh and mesh.row_size == world, "(c): the row-sharded HessianCube")

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    y = hess.dot(x)
    zero_counts()
    rec = dict(nx=nx, nx_psf=nx_psf, row_size=mesh.row_size, ms_per_apply=wall_ms(lambda: hess.dot(x), 5))
    rec["collectives_per_apply"] = {k: {f: n / 6 for f, n in v.items()}
                                    for k, v in collectives_of(read_counts()["counters"]).items()}
    dist.barrier()
    if rank == 0:  # the unsharded operator, alone on the card
        h0 = HessianCube.build(ph, np.ones(1), 1e-3, nx_psf, nx_psf, device=dev)
        rec.update(rel_vs_unsharded=rel_linf(y, h0.dot(x)), ms_per_apply_unsharded=cuda_ms(lambda: h0.dot(x), 5))
        require(rec["rel_vs_unsharded"] <= 1e-5, "(c): the row-sharded Hessian within 1e-5 of the unsharded one")
        del h0
        torch.cuda.empty_cache()
    dist.barrier()
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pcg(hess.dot, y, tol=0.0, maxit=cg_iters, minit=cg_iters, info=info, mesh=mesh)
    torch.cuda.synchronize()
    rec.update(pcg_iters=info["niter"], pcg_seconds=time.perf_counter() - t0,
               pcg_solution_rel=rel_linf(out, x), pcg_finite=bool(torch.isfinite(out).all()))
    require(rec["pcg_iters"] == cg_iters and rec["pcg_finite"], f"(c): {cg_iters} PCG iterations, finite")
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def phase_parallel(dev, workdir: Path, imaged: Path, store: Path, cell_arcsec: float, nx: int = 2048,
                   nband: int = 4, nx_c: int = 4096, nx_psf_c: int = 8192, cg_iters_c: int = 20):
    """``parallel/`` on the one card, the ranks started as child processes:
    two ranks sharing the card over gloo run (b), ``imager`` on a 2-rank
    row mesh over the pipeline's store, then ``sara --niter 1 --use-mesh``
    on a 2-band mesh over a copy of the pipeline's imaged tree and over a
    copy of the 2-rank imager's tree, and then (c), the row-sharded PSF
    Hessian at nx 4096, nx_psf 8192; one rank on NCCL runs (a), ``sara
    --niter 1 --use-mesh`` against the run without it on the imaged tree,
    and the one-rank witness on the 2-rank imager's tree (so after (b)).
    Held here: both ranks of each (b) run the same rms, model checksum and
    model; (b)'s model on the imaged tree within 1e-4 of (a)'s, and the
    chained model within 1e-4 of the witness (each pair on one input, so
    they differ by the mesh alone; the ordered band reductions make them
    the same bits).
    Two ranks share one card here: the times show the collectives' cost,
    not scaling. Returns (B1/B2 launches by part and rank, the kernel
    records at rank 0's shard plans, the parts' records)."""
    import torch

    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dev_s = f"{dev.type}:{dev.index}" if dev.index is not None else dev.type
    bc = _par_run("bc", 2, workdir, dev_s, b=dict(store=str(store), imaged=str(imaged), cell_arcsec=cell_arcsec,
                                                  nx=nx, nband=nband),
                  c=dict(nx=nx_c, nx_psf=nx_psf_c, cg_iters=cg_iters_c))
    b, c = bc["b"], bc["c"]
    t_bc = time.perf_counter()
    for tag in ("on_a_input", "chained"):
        require(b[0]["sara"][tag]["rms"] == b[1]["sara"][tag]["rms"] and
                b[0]["sara"][tag]["tree_model_abs_sum"] == b[1]["sara"][tag]["tree_model_abs_sum"] and
                np.array_equal(np.load(workdir / f"b_{tag}_model_0.npy"), np.load(workdir / f"b_{tag}_model_1.npy")),
                f"(b): both ranks report the same rms, model checksum and model ({tag})")
    a = _par_run("a", 1, workdir, dev_s, a=dict(imaged=str(imaged)))["a"]
    t_a = time.perf_counter()

    def cube(tag, name):
        return np.load(workdir / f"{tag}_{name}{'_0' if tag.startswith('b_') else ''}.npy")

    # model and update (the PCG solution the PD solve starts from) of each
    # pair: the first two on one input each (the mesh alone differs); the
    # last two across the inputs (the 2-rank imager's f32 sums against one
    # process's), on one rank and on two
    pairs = dict(b_on_a_input_vs_a=("b_on_a_input", "a_mesh"), b_chained_vs_witness=("b_chained", "a_witness"),
                 witness_vs_a=("a_witness", "a_mesh"), b_chained_vs_a=("b_chained", "a_mesh"))
    rel = {k: rel_linf_np(cube(x, "model"), cube(y, "model")) for k, (x, y) in pairs.items()}
    rel.update({f"update_{k}": rel_linf_np(cube(x, "update"), cube(y, "update")) for k, (x, y) in pairs.items()})
    rel.update({f"same_bits_{k}": bool(np.array_equal(cube(x, "model"), cube(y, "model")))
                for k, (x, y) in pairs.items() if k in ("b_on_a_input_vs_a", "b_chained_vs_witness")})
    emit({"phase": "parallel", "stage": "models", **rel,
          "cg_pd_iters": {"a_mesh": [a[0]["runs"]["mesh"]["cg_iters"], a[0]["runs"]["mesh"]["pd_iters"]],
                          "a_witness": [a[0]["runs"]["witness"]["cg_iters"], a[0]["runs"]["witness"]["pd_iters"]],
                          **{f"b_{tag}": [b[0]["sara"][tag]["cg_iters"], b[0]["sara"][tag]["pd_iters"]]
                             for tag in b[0]["sara"]}}})
    require(rel["b_on_a_input_vs_a"] <= 1e-4, "(b): the model on (a)'s input within 1e-4 of part (a)'s")
    require(rel["b_chained_vs_witness"] <= 1e-4,
            "(b): the chained model within 1e-4 of the one-rank witness on the 2-rank imager's tree")
    launches = {"a_mesh": a[0]["runs"]["mesh"]["launches"],
                **{f"b_rank{r['rank']}": {k: r["imager"]["launches"][k] + sum(s["launches"][k]
                                                                              for s in r["sara"].values())
                                          for k in r["imager"]["launches"]} for r in b}}
    summary = dict(seconds=t_a - t0, seconds_bc=t_bc - t0, seconds_a=t_a - t_bc,
                   seconds_c=max(r["seconds"] for r in c),
                   launches=launches, gloo_takes_cuda=b[0]["gloo_takes_cuda"], models=rel)
    emit({"phase": "parallel", "stage": "summary", **summary})
    shutil.rmtree(workdir)
    return launches, b[0]["kernels"], dict(a=a, b=b, c=c, summary=summary)


def k1_chunk_fields(launches: dict, main_asm: dict, wide_asm: dict) -> dict:
    """K1's chunk sums (its first launch, inside its ms) in the kernels line:
    launches on the main path, ms, long buckets, chunks and the longest
    chains at the deconv and the widefield launch."""
    keys = ("long_buckets", "chunks", "longest_chunk", "longest_cell_chain", "longest_cell_chain_unchunked",
            "groups_in_bucket_0")
    return dict(launches_chunk_sums=launches["idg_chunk_sums"], chunk_sums_ms=main_asm["k1_chunk_sums_ms"],
                chunk_sums_ms_widefield_launch=wide_asm["k1_chunk_sums_ms"],
                **{k: main_asm[k] for k in keys}, **{f"{k}_widefield_launch": wide_asm[k] for k in keys})


# the kernels whose launches the recorder counts (``launch.<kernel>``)
KERNELS = (*REPLACES, "idg_chunk_sums")


class Logged(logging.Handler):
    """The port's log records that carry figures: each major cycle's
    (``extra={"cycle": ...}``: deconv's and kclean's) and each imager
    rank's (``extra={"rank": ...}``)."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        if hasattr(record, "cycle") or hasattr(record, "rank"):
            self.records.append(record)


LOGGED = Logged()


def zero_counts() -> None:
    """The port's recorder on and emptied, the log's figures forgotten:
    what the port does from here is counted."""
    from pfb_imaging_tpu_torch.utils import profiling

    for name in ("DECONV", "KCLEAN", "IMAGER"):
        logging.getLogger(f"pfb_tpu.{name}").addHandler(LOGGED)
    profiling.enable()
    profiling.take()
    LOGGED.records.clear()


def read_counts() -> dict:
    """What the port reported since ``zero_counts``, then forgotten: every
    kernel's launches (``launches``, 0 where it had none), the recorder's
    ``counters``, the seconds of its spans by name (``spans``), and the
    log's ``cycles`` and ``ranks``."""
    from pfb_imaging_tpu_torch.utils import profiling

    got, recs = profiling.take(), list(LOGGED.records)
    LOGGED.records.clear()
    spans: dict = {}
    for sp in got["spans"]:
        if sp.end_ns is not None:
            spans[sp.name] = spans.get(sp.name, 0.0) + (sp.end_ns - sp.start_ns) / 1e9
    c = got["counters"]
    return dict(launches={k: c.get("launch." + k, 0) for k in KERNELS}, counters=c, spans=spans,
                cycles=[r.cycle for r in recs if hasattr(r, "cycle")],
                ranks=[r.rank for r in recs if hasattr(r, "rank")])


def under(d: dict, prefix: str) -> dict:
    """The entries of ``d`` whose names start with ``prefix``, by the rest."""
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def collectives_of(counters: dict) -> dict:
    """The collectives counted (``collective.<kind>``, ``.bytes``): {kind:
    {"count", "bytes"}}."""
    return {k: {"count": v, "bytes": counters[f"collective.{k}.bytes"]}
            for k, v in under(counters, "collective.").items() if not k.endswith(".bytes")}


def dispatch_of(counters: dict) -> dict:
    """The residual's routes: partitions on the multiband route, bands that
    fell back to the per-band one."""
    return {k: counters.get(f"residual.{k}", 0) for k in ("multiband_parts", "fallback_bands")}


def command_stats(got: dict, command: str) -> dict:
    """``command``'s phases in seconds (its spans ``<command>.<phase>``) and
    its routes (``<command>.route.<route>``), from ``read_counts``."""
    return dict({f"{k}_seconds": v for k, v in under(got["spans"], command + ".").items()},
                routes=under(got["counters"], command + ".route."))


def degrid_stats(got: dict) -> dict:
    """``command_stats`` of degrid, its visibilities and its bins on
    wplanes IDG plans."""
    c = got["counters"]
    return dict(command_stats(got, "degrid"), nvis=c["degrid.nvis"], bins_wplanes=c.get("degrid.bins.wplanes", 0))


def busy_ms(prof) -> float:
    """The time the card was doing anything in a ``torch.profiler`` trace,
    in ms (``utils.profiling.device_busy``)."""
    from pfb_imaging_tpu_torch.utils.profiling import device_busy

    return sum(e - s for s, e in device_busy(prof)) / 1e6


def top_device_ops(prof, n: int = 6) -> list:
    """The ``n`` kernels with the most device time, as [name, ms, calls]."""
    import torch

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    rows = [(e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return [[k[:60], ms, c] for k, ms, c in sorted(rows, key=lambda r: -r[1])[:n]]


# kernel families of a profiled call: the first family whose key is in a
# kernel's name (lower case) takes its device time
KERNEL_FAMILIES = (("b2_vals_from_patches", "vals_from_patches"), ("b1_patches_from_vals", "patches_from_vals"),
                   ("k1_idg_assemble", "idg_assemble"), ("k1_idg_assemble", "idg_chunk_sums"),
                   ("k2_idg_extract", "idg_extract"), ("fft", "fft"),
                   ("gather", "index"), ("gather", "gather"))


def device_ms_by_family(fn, reps: int = 3) -> dict:
    """Device ms a call of ``fn`` by kernel family (``KERNEL_FAMILIES``,
    the rest under ``other``) over ``reps`` calls under ``torch.profiler``,
    with the device-busy ms a call and the top kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    fam = {name: 0.0 for name, _ in KERNEL_FAMILIES} | {"other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
        key = e.key.lower()
        fam[next((n for n, k in KERNEL_FAMILIES if k in key), "other")] += us / 1e3 / reps
    return dict(ms_per_call=fam, device_busy_ms_per_call=busy_ms(prof) / reps, top_kernels=top_device_ops(prof, 8))


def phase_profile(dev, dt_path: Path, lam: float, iters: int = 20):
    """The steady cycle's parts at the main path's shapes: CUDA-event ms of
    each operator the minor cycle calls, then ``iters`` primal-dual and CG
    iterations timed on the host clock and traced with ``torch.profiler``
    for the device's busy time. The idle share is 1 - busy / unprofiled
    wall time; the profiled wall time is printed beside it."""
    from functools import partial

    import torch

    from pfb_imaging_tpu_torch import real_dtype, to_device
    from pfb_imaging_tpu_torch.utils.store import TreeStore
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
        busy = busy_ms(prof)
        rec.update({f"{name}_iter_wall_ms": wall / iters, f"{name}_iter_device_busy_ms": busy / iters,
                    f"{name}_idle_share": max(0.0, 1.0 - busy / wall), f"{name}_profiled_wall_ms": wall_prof,
                    f"{name}_top_kernels": top_device_ops(prof)})
        require(busy > 0.0, f"torch.profiler traced device time in the {name} loop")
    emit({"phase": "profile", **rec})
    return rec


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--compare-idg", type=Path, default=None,
                    help="another idg_fused.cu (same C interface, e.g. the parent commit's) whose B1/B2 are "
                         "timed in turns with the tree's at the main plan")
    args = ap.parse_args(argv)
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
    phase_kernels_assembly(dev)
    psi_rec = phase_psi(dev)
    dual_rec = phase_dual_update(dev)
    scat, gath = phase_kernels_scatter(dev)
    phase_accuracy(dev)
    phase_accuracy_pallas(dev)
    compare = build_idg_library(args.compare_idg.resolve()) if args.compare_idg else None
    timing, main_mb, main_asm, launches, _ = phase_main(dev, ROOT / "build" / "chip_smoke", compare_idg=compare)
    b3, im_launches, ctx = phase_imager(dev, ROOT / "build" / "chip_smoke_imager")
    b4, dg_launches, _ = phase_degrid(dev, ctx)
    phase_widefield_accuracy(dev)
    wide, wide_band, wf_launches, wf_dg_launches, wf_rec = phase_widefield(dev, ROOT / "build" / "chip_smoke_widefield")
    wide_asm = wf_rec["assembly"]
    imaged = ROOT / "build" / "chip_smoke_commands_imaged.dt"
    store = ROOT / "build" / "chip_smoke_parallel_store.xds"
    pipe_launches, pipe_kern, _, sky = phase_pipeline(dev, ROOT / "build" / "chip_smoke_pipeline", keep_imaged=imaged,
                                                      keep_store=store)
    cmd_launches, cmd_kern, cmd_steps = phase_commands(dev, ROOT / "build" / "chip_smoke_commands", imaged, sky)
    op_launches, op_kern, op_rec = phase_operators(dev, imaged, sky)
    args = op_rec["idg_runtime_args"]
    phase_same_bits(dev, ROOT / "build" / "chip_smoke_same_bits", imaged, {
        "hessian_vis_idg_beam_identical": args["hessian_two_runs_identical"],
        "vis2dirty_idg_mask_identical": args["vis2dirty_two_runs_identical"],
        "dirty2vis_idg_identical": args["dirty2vis_two_runs_identical"],
        "multiband_hessian_deconv_launch_identical": main_asm["hessian_two_runs_identical"],
        "multiband_hessian_widefield_launch_identical": wide_asm["hessian_two_runs_identical"],
        "fluxtractor_hessian_vis_identical": cmd_steps["fluxtractor"]["hessian_vis_two_runs_identical"],
        "pd_fused_extrapolation_identical": psi_rec["pd_fused_same_bits"],
        "dual_update_kernel_identical": dual_rec["two_calls_identical"],
    })
    par_launches, par_kern, _ = phase_parallel(dev, ROOT / "build" / "chip_smoke_parallel", imaged, store,
                                               sky["cell_rad"] * 180.0 / np.pi * 3600.0)
    shutil.rmtree(imaged)
    shutil.rmtree(store)

    kernels = []
    for name, tag in (("patches_from_vals", "b1"), ("vals_from_patches", "b2")):
        # ms, plain_ms, bound_ms and the error at the main path's launch shape:
        # its multiband residual, every band's groups in one launch
        bound_ms, bound_by, bound_simt = idg_bound(main_mb["ng"], main_mb["S"])
        bound_band, _, _ = idg_bound(timing["ng"], timing["S"])
        bound_wide, bound_wide_by, _ = idg_bound(wide["ng"], wide["S"])
        bound_wide_band, _, _ = idg_bound(wide_band["ng"], wide_band["S"])
        ms = main_mb[f"{tag}_ms"]
        at_commands = {}
        for where, r in cmd_kern.items():
            b_ms, b_by, _ = idg_bound(r["ng"], r["S"])
            at_commands.update({f"ms_commands_{where}": r[f"{tag}_ms"],
                                f"plain_ms_commands_{where}": r[f"{tag}_plain_ms"],
                                f"bound_ms_commands_{where}": b_ms, f"bound_by_commands_{where}": b_by,
                                f"rel_vs_f64_commands_{where}": r[f"{tag}_rel_vs_f64"],
                                f"max_abs_err_commands_{where}": r[f"{tag}_max_abs_err"],
                                f"ng_commands_{where}": r["ng"], f"S_commands_{where}": r["S"]})
        at_pipeline = {}
        for where, r in pipe_kern.items():
            b_ms, b_by, _ = idg_bound(r["ng"], r["S"])
            at_pipeline.update({f"ms_pipeline_{where}": r[f"{tag}_ms"], f"plain_ms_pipeline_{where}": r[f"{tag}_plain_ms"],
                                f"bound_ms_pipeline_{where}": b_ms, f"bound_by_pipeline_{where}": b_by,
                                f"rel_vs_f64_pipeline_{where}": r[f"{tag}_rel_vs_f64"],
                                f"ng_pipeline_{where}": r["ng"], f"S_pipeline_{where}": r["S"]})
        bound_s24, bound_s24_by, _ = idg_bound(op_kern["ng"], op_kern["S"])
        at_parallel = {}
        for where, r in par_kern.items():
            b_ms, b_by, _ = idg_bound(r["ng"], r["S"])
            at_parallel.update({f"ms_parallel_rank0_{where}_shard_plan": r[f"{tag}_ms"],
                                f"plain_ms_parallel_rank0_{where}_shard_plan": r[f"{tag}_plain_ms"],
                                f"bound_ms_parallel_rank0_{where}_shard_plan": b_ms,
                                f"bound_by_parallel_rank0_{where}_shard_plan": b_by,
                                f"rel_vs_f64_parallel_rank0_{where}_shard_plan": r[f"{tag}_rel_vs_f64"],
                                f"ng_parallel_rank0_{where}_shard_plan": r["ng"],
                                f"S_parallel_rank0_{where}_shard_plan": r["S"]})
        kernels.append(dict(
            name=name, route="cuda", source="pfb_imaging_tpu_torch/csrc/idg_fused.cu", replaces=REPLACES[name],
            launches=launches[name], max_abs_err=main_mb[f"{tag}_max_abs_err"], ms=ms,
            plain_ms=main_mb[f"{tag}_plain_ms"], bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            ng=main_mb["ng"], S=main_mb["S"], tf32_passes=IDG_TF32_PASSES, bound_ms_f32_simt=bound_simt,
            bound_share=bound_ms / ms, bound_share_f32_simt=bound_simt / ms, rel_vs_f64=main_mb[f"{tag}_rel_vs_f64"],
            ms_band_plan=timing[f"{tag}_ms"], ng_band_plan=timing["ng"], plain_ms_band_plan=timing[f"{tag}_plain_ms"],
            bound_ms_band_plan=bound_band, rel_vs_f64_band_plan=timing[f"{tag}_rel_vs_f64"],
            yardstick_slot_contraction_complex64_matmul_ms=timing["yardstick_slot_contraction_complex64_matmul_ms"],
            ms_ng4096={S: kern[S][f"{tag}_ms"] for S in kern},
            plain_ms_ng4096={S: kern[S][f"{tag}_plain_ms"] for S in kern},
            ms_wplanes_plan=wide[f"{tag}_ms"], ng_wplanes_plan=wide["ng"], plain_ms_wplanes_plan=wide[f"{tag}_plain_ms"],
            bound_ms_wplanes_plan=bound_wide, bound_by_wplanes_plan=bound_wide_by,
            rel_vs_f64_wplanes_plan=wide[f"{tag}_rel_vs_f64"], f64_groups_wplanes_plan=wide["f64_groups"],
            ms_wplanes_band_plan=wide_band[f"{tag}_ms"], ng_wplanes_band_plan=wide_band["ng"],
            plain_ms_wplanes_band_plan=wide_band[f"{tag}_plain_ms"], bound_ms_wplanes_band_plan=bound_wide_band,
            rel_vs_f64_wplanes_band_plan=wide_band[f"{tag}_rel_vs_f64"],
            launches_widefield_deconv=wf_launches[name], launches_widefield_degrid=wf_dg_launches[name],
            launches_pipeline=pipe_launches[name], **at_pipeline, launches_commands=cmd_launches[name],
            **at_commands, launches_operators=op_launches[name], ms_s24_plan=op_kern[f"{tag}_ms"],
            plain_ms_s24_plan=op_kern[f"{tag}_plain_ms"], bound_ms_s24_plan=bound_s24, bound_by_s24_plan=bound_s24_by,
            rel_vs_f64_s24_plan=op_kern[f"{tag}_rel_vs_f64"], ng_s24_plan=op_kern["ng"], S_s24_plan=op_kern["S"],
            launches_operators_hessian_vis_beam=args["hessian_launches"][name],
            launches_operators_vis2dirty_mask=args["mask_launches"][name],
            launches_parallel={k: v[name] for k, v in par_launches.items()}, **at_parallel,
            **({"ms_compare_tree_tree_compare": timing["compare"][f"{tag}_ms_compare_tree_tree_compare"]}
               if "compare" in timing else {}),
        ))
    kernels.append(dict(
        name="scatter_grid_wstack", route="cuda", source="pfb_imaging_tpu_torch/csrc/gridder_scatter.cu",
        replaces=REPLACES["scatter_grid_wstack"], launches=im_launches["scatter_grid_wstack"],
        max_abs_err=b3["psf"]["max_abs_err"], ms=b3["psf"]["ms"], plain_ms=b3["psf"]["plain_ms"],
        bound_ms=b3["psf"]["bound_ms"], bound_by=b3["psf"]["bound_by"], library_ms=None,
        launches_pipeline=pipe_launches["scatter_grid_wstack"], launches_commands=cmd_launches["scatter_grid_wstack"],
        launches_parallel={k: v["scatter_grid_wstack"] for k, v in par_launches.items()},
        ms_image_plan=b3["image"]["ms"], plain_ms_image_plan=b3["image"]["plain_ms"],
        bound_ms_image_plan=b3["image"]["bound_ms"], ms_dense_psf_plan=b3["dense_psf"]["ms"],
        ms_nbig4096={f"W{r['W']}_nw{r['nw']}": r["ms"] for r in scat},
        plain_ms_nbig4096={f"W{r['W']}_nw{r['nw']}": r["plain_ms"] for r in scat},
    ))
    kernels.append(dict(
        name="gather_grid_wstack", route="cuda", source="pfb_imaging_tpu_torch/csrc/gridder_gather.cu",
        replaces=REPLACES["gather_grid_wstack"], launches=dg_launches["gather_grid_wstack"],
        max_abs_err=b4["max_abs_err"], ms=b4["ms"], plain_ms=b4["plain_ms"], bound_ms=b4["bound_ms"],
        bound_by=b4["bound_by"], library_ms=None, launches_pipeline=pipe_launches["gather_grid_wstack"],
        launches_commands=cmd_launches["gather_grid_wstack"],
        launches_parallel={k: v["gather_grid_wstack"] for k, v in par_launches.items()},
        ms_nbig4096={f"W{r['W']}_nw{r['nw']}": r["ms"] for r in gath},
        plain_ms_nbig4096={f"W{r['W']}_nw{r['nw']}": r["plain_ms"] for r in gath},
    ))
    for name, tag in (("idg_assemble", "k1"), ("idg_extract", "k2")):
        # at the main path's launch shape: every bin of every band of its
        # multiband residual, one adjoint's assembly or one forward's extraction
        kernels.append(dict(
            name=name, route="cuda", source="pfb_imaging_tpu_torch/csrc/idg_assemble.cu", replaces=REPLACES[name],
            launches=launches[name], max_abs_err=main_asm[f"{tag}_max_abs_err"], ms=main_asm[f"{tag}_ms"],
            plain_ms=main_asm[f"{tag}_plain_ms"], bound_ms=main_asm[f"{tag}_bound_ms"], bound_by="bytes",
            library_ms=None, library_ms_null_because=ASSEMBLY_NO_LIBRARY, ng=main_asm["ng"], S=main_asm["S"],
            bins=main_asm["bins"], bound_share=main_asm[f"{tag}_bound_ms"] / main_asm[f"{tag}_ms"],
            bound_share_widefield_launch=wide_asm[f"{tag}_bound_ms"] / wide_asm[f"{tag}_ms"],
            rel_vs_plain=main_asm[f"{tag}_rel_vs_plain"], two_runs_identical=main_asm[f"{tag}_two_runs_identical"],
            ms_widefield_launch=wide_asm[f"{tag}_ms"], plain_ms_widefield_launch=wide_asm[f"{tag}_plain_ms"],
            bound_ms_widefield_launch=wide_asm[f"{tag}_bound_ms"], ng_widefield_launch=wide_asm["ng"],
            bins_widefield_launch=wide_asm["bins"], max_abs_err_widefield_launch=wide_asm[f"{tag}_max_abs_err"],
            launches_widefield_deconv=wf_launches[name], launches_widefield_degrid=wf_dg_launches[name],
            launches_pipeline=pipe_launches[name], launches_commands=cmd_launches[name],
            launches_operators=op_launches[name],
            launches_operators_hessian_vis_beam=args["hessian_launches"][name],
            launches_operators_vis2dirty_mask=args["mask_launches"][name],
            launches_parallel={k: v[name] for k, v in par_launches.items()},
            **(k1_chunk_fields(launches, main_asm, wide_asm) if tag == "k1" else {}),
        ))
    for k in kernels[:2] + kernels[-2:]:
        require(k["launches_pipeline"] > 0, f"{k['name']} launched on the pipeline")
        require(k["launches_commands"] > 0, f"{k['name']} launched by the commands")
        require(k["launches_operators"] > 0, f"{k['name']} launched at the S = 24 plan")
        require(k["launches_operators_hessian_vis_beam"] > 0,
                f"{k['name']} launched by hessian_vis_idg(beam, eta, wsum)")
        require(all(n > 0 for n in k["launches_parallel"].values()), f"{k['name']} launched by every rank of (a), (b)")
    for name, tag, bound in (("psi_analysis", "dot", "bound_ms"), ("psi_synthesis", "hdot", "bound_ms"),
                             ("psi_synthesis_ext", "hdot_ext", "bound_ms_ext")):
        # ms and errors at the sara cells' shapes, and at the deconv's default
        # bases; launches on the main path's deconv as for the others, and a
        # primal-dual iteration at the cell's shapes. None of the commands
        # runs Psi (kclean, fluxtractor and hci have no dictionary; ista's is
        # the identity), so their count stays 0 and is not required; PD runs
        # P2 on two cubes, so the one-cube P2 (forward-backward's) runs on
        # none of the paths and its count is not required either.
        dflt, c16 = psi_rec["deconv_default"], psi_rec["cell_1k16"]
        kernels.append(dict(
            name=name, route="cuda", source="pfb_imaging_tpu_torch/csrc/psi_wavelets.cu", replaces=REPLACES[name],
            launches=launches[name], launches_pd_iteration=psi_rec["launches_pd_iteration"][name],
            ms=psi_rec[f"{tag}_ms"], plain_ms=psi_rec[f"plain_{tag}_ms" if tag != "hdot_ext" else "passes_hdot_ms"],
            bound_ms=psi_rec[bound], bound_by="bytes", bound_share=psi_rec[bound] / psi_rec[f"{tag}_ms"],
            library_ms=None, rel_vs_f64=psi_rec[f"rel_vs_f64_{tag}"],
            two_calls_identical=psi_rec["two_calls_identical_ext" if tag == "hdot_ext" else "two_calls_identical"],
            ms_deconv_default=dflt[f"{tag}_ms"], bound_ms_deconv_default=dflt[bound],
            rel_vs_f64_deconv_default=dflt[f"rel_vs_f64_{tag}"], ms_1k16=c16[f"{tag}_ms"], bound_ms_1k16=c16[bound],
            rel_vs_f64_1k16=c16[f"rel_vs_f64_{tag}"],
            launches_widefield_deconv=wf_launches[name], launches_pipeline=pipe_launches[name],
            launches_commands=cmd_launches[name], launches_parallel={k: v[name] for k, v in par_launches.items()},
        ))
        k = kernels[-1]
        if name == "psi_synthesis":
            continue
        require(k["launches_widefield_deconv"] > 0, f"{name} launched by the widefield deconv")
        require(k["launches_pipeline"] > 0, f"{name} launched on the pipeline")
        require(all(n > 0 for n in k["launches_parallel"].values()), f"{name} launched by every rank of (a), (b)")
    # the dual update (S1): ms and bits at the sara cells' shapes; launches on
    # the main path's deconv, a PD iteration, and every path that runs PD
    # with SARA's prior, (b)'s band split too (given the gathered band sum);
    # the commands run no l2,1 primal-dual (kclean, fluxtractor, hci; ista
    # takes the prox)
    c16 = dual_rec["cell_1k16"]
    kernels.append(dict(
        name="dual_update_21m", route="cuda", source="pfb_imaging_tpu_torch/csrc/prox_21m.cu",
        replaces=REPLACES["dual_update_21m"], launches=launches["dual_update_21m"],
        launches_pd_iteration=psi_rec["launches_pd_iteration"]["dual_update_21m"], ms=dual_rec["ms"],
        plain_ms=dual_rec["plain_ms"], bound_ms=dual_rec["bound_ms"], bound_by="bytes",
        bound_share=dual_rec["bound_share"], library_ms=None, same_bits_as_plain=dual_rec["same_bits_as_plain"],
        two_calls_identical=dual_rec["two_calls_identical"], shape=dual_rec["shape"], ms_1k16=c16["ms"],
        plain_ms_1k16=c16["plain_ms"], bound_ms_1k16=c16["bound_ms"], bound_share_1k16=c16["bound_share"],
        same_bits_as_plain_1k16=c16["same_bits_as_plain"], shape_1k16=c16["shape"],
        launches_widefield_deconv=wf_launches["dual_update_21m"], launches_pipeline=pipe_launches["dual_update_21m"],
        launches_commands=cmd_launches["dual_update_21m"],
        launches_parallel={k: v["dual_update_21m"] for k, v in par_launches.items()},
    ))
    k = kernels[-1]
    require(k["launches"] > 0 and k["launches_widefield_deconv"] > 0 and k["launches_pipeline"] > 0,
            "dual_update_21m launched by the deconv, the widefield deconv and the pipeline")
    require(all(n > 0 for n in k["launches_parallel"].values()),
            "dual_update_21m launched by (a)'s one rank and by every rank of (b)'s band split")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
