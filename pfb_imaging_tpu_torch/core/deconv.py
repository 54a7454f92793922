"""``deconv``: the PFB major cycle on a .dt tree (port of
pfb_imaging_tpu/core/deconv.py, single device).

Behaviour kept from the JAX ``deconv``:
  * lambda schedule ``lam = (init_factor if iter0 == 0 and k == 0 else 1)
    * rmsfactor * rms`` (design D5);
  * checkpoint/resume through the tree: band nodes carry niters/rms/rmax/
    hess_norm attrs and MODEL/UPDATE/RESIDUAL/MODEL_BEST/DUAL arrays;
    the PD dual warm-starts from DUAL; ``hess_norm`` is cached in attrs;
  * divergence counting (consecutive rms-and-rmax rises) and best-model
    tracking;
  * the component-model fit to .mds and the model re-evaluation from it;
  * the exact residual's routing: the bands of each time slice try the
    multiband route first (``residual_from_parts_multiband``, one B1 and one
    B2 launch per partition for all its bands); the bands that fall back run
    ``residual_from_parts`` one by one, all queued on the device before any
    is fetched. The recorder counts both (``residual.multiband_parts``,
    ``residual.fallback_bands``);
  * the mesh (``use_mesh``, the default as in JAX): a band x row mesh over
    every rank (``parallel/mesh.py``). The band axis is the largest divisor
    of the band count that is at most the world size; ranks the band axis
    cannot absorb shard the PSF grid's rows when ``nx_psf >=
    row_shard_above`` (the distributed FFT, with |PSFHAT| streamed straight
    into its transposed row-sharded layout, each rank loading only its own
    bands). The solver state is this rank's band slice; the update and
    model are gathered to every rank each cycle, the residual is gridded
    only for the bands this rank holds (the first row rank of the first
    copy, which also writes their nodes) and summed over the ranks, rank 0
    writes the shared attrs and the .mds, and the ranks meet at a barrier
    every cycle. A rank outside the mesh (the world not a whole number of
    band x row grids) takes part in the gathers and sums only. Without
    the mesh, several ranks each run the whole solver and split the
    residual's bands by node, then by local rank.

Each cycle's log line carries the cycle's figures as ``extra={"cycle":
...}``: its number, lam, rms, rmax, the CG and PD iterations, the mesh, its
seconds, the model fit's and the tree write's, and the bytes written.
"""

from __future__ import annotations

import time

import numpy as np

from .. import checked_real_dtype, resolve_device, to_device, to_host
from ..deconv.presets import PRESETS
from ..parallel import multihost as mh
from ..parallel.fft import psfhat_transposed
from ..parallel.mesh import band_sharding, make_mesh, shard_cube, stream_band_stack
from ..utils.logging import get_logger
from ..utils.modelspec import eval_coeffs_to_cube, fit_image_cube, save_mds
from ..utils.profiling import count, memory_line, span
from ..utils.store import TreeStore, require_complete
from .imager import residual_from_parts, residual_from_parts_multiband

log = get_logger("DECONV")


def deconv(
    dt_path,
    preset: str = "sara",
    niter: int = 5,
    rmsfactor: float = 1.0,
    init_factor: float = 1.0,
    gamma: float = 1.0,
    eta: float = 1e-5,
    bases: str = "self,db1,db2",
    nlevels: int = 2,
    positivity: int = 1,
    cg_tol: float = 1e-4,
    cg_maxit: int = 100,
    pd_tol: float = 1e-5,
    pd_maxit: int = 500,
    l1_reweight_from: int = 5,
    fit_mds: bool = True,
    nbasisf: int | None = None,
    epsilon: float = 1e-7,
    do_wgridding: bool = True,
    diverge_count: int = 3,
    double_precision: bool | None = None,
    hess_norm: float | None = None,
    opts_extra: dict | None = None,
    use_mesh: bool = True,
    row_shard_above: int = 8192,
    *,
    device="cuda",
):
    """Run the major cycle in place on the tree. Returns (model, residual)
    as numpy arrays, the same on every rank. Solver state lives on
    ``device`` (f64 on the CPU, f32 on CUDA; ``double_precision`` may only
    name that type, None takes it); the default is the card, and there is
    no fallback to the CPU."""
    rdt = checked_real_dtype(device, double_precision)
    dev = resolve_device(device)
    distributed, me = mh.is_distributed(), mh.rank()
    dt = TreeStore(dt_path, mode="w")
    require_complete(dt)
    attrs = dt.attrs
    nx, ny = attrs["nx"], attrs["ny"]
    nx_psf, ny_psf = attrs["nx_psf"], attrs["ny_psf"]
    band_nodes = [k for k in dt.groups() if k.startswith("band")]
    nband_f = int(attrs["nband"])
    ntime = int(attrs.get("ntime", 1))
    nband = len(band_nodes)
    if nband != nband_f * ntime:
        raise ValueError(f"{nband} band nodes != nband {nband_f} x ntime {ntime}")
    freq_attr = np.asarray(attrs["freq_out"], dtype=float)
    node_times, node_freqs = [], []
    for key in band_nodes:
        na = dt.group(key).attrs
        node_times.append(float(na.get("time_out", 0.0)))
        node_freqs.append(float(na.get("freq_out", freq_attr.ravel()[0])))
    freq_out = np.asarray(node_freqs)

    wsums = np.zeros(nband)
    residual = np.zeros((nband, nx, ny))
    model = np.zeros((nband, nx, ny))
    update = np.zeros((nband, nx, ny))
    abspsfhat, beams = [], []
    iter0 = 0
    for b, key in enumerate(band_nodes):
        node = dt.group(key)
        wsums[b] = float(np.asarray(node.read("WSUM"))[0])
        residual[b] = np.asarray(node.read("RESIDUAL" if node.has("RESIDUAL") else "DIRTY"))
        if node.has("MODEL"):
            model[b] = np.asarray(node.read("MODEL"))
        if node.has("UPDATE"):
            update[b] = np.asarray(node.read("UPDATE"))
        iter0 = max(iter0, int(node.attrs.get("niters", 0)))
        parts = node.groups()

        # |PSFHAT| per partition (abs taken at load), loaded only for the
        # bands this rank's solver holds
        def _ph_loader(node=node, parts=parts):
            if parts:
                return np.stack([np.abs(np.asarray(node.group(p).read("PSFHAT"))) for p in parts])
            return np.abs(np.asarray(node.read("PSFHAT")))[None]

        abspsfhat.append(_ph_loader)
        if parts and all(node.group(p).has("BEAM") for p in parts):
            beams.append(np.stack([np.asarray(node.group(p).read("BEAM")) for p in parts]))
        else:
            beams.append(None)
    beam_per_band = np.stack(beams) if all(bm is not None for bm in beams) else None
    band_beam = None
    if beam_per_band is not None:
        band_beam = np.stack([
            np.asarray(dt.group(key).read("BEAM")) if dt.group(key).has("BEAM") else beam_per_band[b].mean(0)
            for b, key in enumerate(band_nodes)
        ])
    wsum = wsums.sum()
    hess_norm0 = hess_norm if hess_norm is not None else attrs.get("hess_norm")
    # every rank has read the tree before any rank writes to it
    mh.barrier("deconv-read")

    mesh, transposed = None, False
    if use_mesh:
        world = mh.world_size()
        band_size = world
        while nband % band_size:
            band_size -= 1
        # ranks the band axis cannot absorb shard the padded PSF grid's rows
        row_size = 1
        if nx_psf >= row_shard_above and band_size < world:
            row_size = world // band_size
            while row_size > 1 and nx_psf % row_size:
                row_size -= 1
        if row_size > 1 and beam_per_band is not None:
            log.info("per-partition beams: the PSF Hessian is not row-sharded; the %d row ranks repeat the bands",
                     row_size)
            row_size = 1
        mesh = make_mesh(band=band_size, row=row_size)
        if row_size > 1:
            # each band's |PSFHAT| streams straight into the transposed,
            # padded, row-sharded layout of the distributed FFT
            transposed = True
            loaders = [(lambda ld=ld: psfhat_transposed(ld(), row_size)) for ld in abspsfhat]
            abspsfhat = stream_band_stack(mesh, loaders, device=dev, dtype=rdt, row_axis=-2) if mesh.in_mesh else None
            log.info("row-sharded PSF Hessian: %d-way image rows x %d-way bands", row_size, band_size)
        else:
            abspsfhat = stream_band_stack(mesh, abspsfhat, device=dev, dtype=rdt) if mesh.in_mesh else None
        log.info("band mesh: %d-way bands x %d-way rows over %d ranks (%s)", band_size, row_size, world,
                 "this rank outside it" if not mesh.in_mesh else
                 f"bands {mesh.band_slice(nband).start}-{mesh.band_slice(nband).stop - 1}")
    else:
        abspsfhat = np.stack([ld() for ld in abspsfhat])

    opts = dict(
        bases=bases, nlevels=nlevels, eta=eta, gamma=gamma, positivity=positivity, cg_tol=cg_tol,
        cg_maxit=cg_maxit, pd_tol=pd_tol, pd_maxit=pd_maxit, rmsfactor=rmsfactor,
        l1_reweight_from=l1_reweight_from, hess_norm=hess_norm0, verbosity=1,
    )
    if opts_extra:
        opts.update(opts_extra)
    geometry = dict(nx=nx, ny=ny, nx_psf=nx_psf, ny_psf=ny_psf)
    solver = bwd = None
    if mesh is None or mesh.in_mesh:
        sl = band_sharding(mesh, nband)  # the solver holds this rank's bands
        solver = PRESETS[preset](abspsfhat, wsums, geometry, model[sl], update[sl], opts,
                                 beam_per_band=None if beam_per_band is None else beam_per_band[sl], mesh=mesh,
                                 transposed=transposed, device=dev)
        bwd = solver.backward_alg
        if me == 0:  # one writer of the shared attrs (rank 0 always holds bands)
            dt.set_attrs(hess_norm=solver.hess_norm)
        # warm-start the PD dual from the checkpoint when the backward solver
        # has one (forward-backward has none) and every band it holds has one
        keys = band_nodes[sl]
        dual0 = [dt.group(key) for key in keys if dt.group(key).has("DUAL")]
        if getattr(bwd, "_v", None) is not None and len(dual0) == len(keys):
            bwd._v = to_device(np.stack([np.asarray(n.read("DUAL")) for n in dual0]), dev, rdt)
            log.info("warm-started PD dual from checkpoint")
    del abspsfhat

    # the bands whose residual this rank grids and whose nodes it writes:
    # under the mesh those it writes, else its share of the node's
    if mesh is not None:
        owned = set(range(nband)[mesh.band_slice(nband)]) if mesh.writes else set()
    else:
        owned = set(mh.rank_items(range(nband)))

    best_rms = np.inf
    best_model = model.copy()
    mfs = residual.sum(axis=0) / wsum
    rms, rmax = float(np.std(mfs)), float(np.abs(mfs).max())
    diverge = 0
    log.info("start: iter0=%d rms=%.3e rmax=%.3e", iter0, rms, rmax)

    def gather(t):
        return mh.host_gather(t, mesh, (nband, nx, ny)).astype(np.float64)

    for k in range(iter0, iter0 + niter):
        with span("deconv.cycle"):
            t0 = time.perf_counter()
            rin = residual if band_beam is None else residual * band_beam
            upd_t = mdl_t = None
            with span("deconv.forward"):
                if solver is not None:
                    solver.first(shard_cube(mesh, rin / wsum, device=dev, dtype=rdt))
                    upd_t = solver.forward(None)
                update = gather(upd_t)
            lam = (init_factor if (iter0 == 0 and k == 0) else 1.0) * rmsfactor * rms  # D5
            with span("deconv.backward"):
                if solver is not None:
                    mdl_t = solver.backward(lam)
                    solver.last()
                model = gather(mdl_t)
                iters = [int(getattr(solver.forward_alg, "niter_last", -1)), int(getattr(bwd, "niter_last", -1)),
                         solver.hess_norm] if solver is not None else [0, 0, 0.0]
                if distributed:  # rank 0's counts on every rank
                    iters = mh.allsum(np.asarray(iters if me == 0 else [0, 0, 0.0], dtype=np.float64)).tolist()

            t1 = time.perf_counter()
            with span("deconv.fit"):
                if fit_mds and model.any():
                    times_u = np.asarray(node_times).reshape(nband_f, ntime)[0]
                    freqs_u = freq_out.reshape(nband_f, ntime)[:, 0]
                    mcube = model.reshape(nband_f, ntime, nx, ny).transpose(1, 0, 2, 3)
                    coeffs, ix, iy, mattrs = fit_image_cube(times_u, freqs_u, mcube, nbasisf=nbasisf or nband_f,
                                                            nbasist=min(ntime, 2), device=dev)
                    if me == 0:
                        save_mds(TreeStore(str(dt.path).replace(".dt", ".mds"), mode="w"), coeffs, ix, iy, mattrs)
                    mcube = eval_coeffs_to_cube(times_u, freqs_u, coeffs, ix, iy, mattrs)
                    model = mcube.transpose(1, 0, 2, 3).reshape(nband, nx, ny)
            fit_seconds = time.perf_counter() - t1

            with span("deconv.residual"):
                by_time: dict = {}
                for b, key in enumerate(band_nodes):
                    if b in owned:
                        by_time.setdefault(key.split("_time")[-1], []).append((b, key))
                serial, queued = [], []
                for items in by_time.values():
                    idxs = [b for b, _ in items]
                    out = residual_from_parts_multiband(dt, [key for _, key in items], model[idxs], epsilon=epsilon,
                                                        do_wgridding=do_wgridding, as_device=True, device=dev)
                    if out is not None:
                        queued.append((idxs, out))
                    else:
                        serial.extend(items)
                count("residual.fallback_bands", len(serial))
                queued += [([b], residual_from_parts(dt.group(key), model[b], epsilon=epsilon,
                                                     do_wgridding=do_wgridding, as_device=True, device=dev)[None])
                           for b, key in serial]
                for idxs, r in queued:  # everything is queued on the device before the first fetch
                    residual[idxs] = to_host(r)
                if distributed:
                    # each rank gridded its bands: the sum is the whole cube on every rank
                    keep = np.zeros(nband)
                    keep[list(owned)] = 1.0
                    residual = mh.allsum(residual * keep[:, None, None])

            rms_p, rmax_p = rms, rmax
            mfs = residual.sum(axis=0) / wsum
            rms, rmax = float(np.std(mfs)), float(np.abs(mfs).max())
            hess_norm_k = iters[2]
            cycle = dict(iter=k + 1, seconds=time.perf_counter() - t0, fit_seconds=fit_seconds, lam=lam, rms=rms,
                         rmax=rmax, cg_iters=int(iters[0]), pd_iters=int(iters[1]),
                         mesh=None if mesh is None else dict(mesh.shape, in_mesh=mesh.in_mesh))

            if rms < best_rms:
                best_rms = rms
                best_model = model.copy()

            t2 = time.perf_counter()
            with span("deconv.write"):
                duals = dict(mh.owned_band_slices(bwd._v, mesh)) if getattr(bwd, "_v", None) is not None else {}
                nbytes = 0
                for b, key in enumerate(band_nodes):
                    if b not in owned:
                        continue  # one writer a band node: the rank that holds it
                    node = dt.group(key)
                    arrays = dict(MODEL=model[b], UPDATE=update[b], RESIDUAL=residual[b], MODEL_BEST=best_model[b])
                    if b in duals:
                        arrays["DUAL"] = duals[b]
                    for name, a in arrays.items():
                        node.write(name, a)
                        nbytes += np.asarray(a).nbytes
                    node.set_attrs(niters=k + 1, rms=rms, rmax=rmax, hess_norm=hess_norm_k)
                count("deconv.write_bytes", nbytes)
            cycle.update(write_seconds=time.perf_counter() - t2, write_bytes=nbytes)
            log.info("iter %d: lam=%.3e rms=%.3e rmax=%.3e cg=%d pd=%d (%.2f s; fit %.2f s, write %.2f s %.1f MB) "
                     "[%s]", k + 1, lam, rms, rmax, cycle["cg_iters"], cycle["pd_iters"], cycle["seconds"],
                     fit_seconds, cycle["write_seconds"], nbytes / 1e6, memory_line(), extra={"cycle": cycle})
            mh.barrier(f"deconv-iter-{k}")

            if rms > rms_p and rmax > rmax_p:
                diverge += 1
                if diverge >= diverge_count:
                    log.info("Algorithm is diverging, terminating")
                    break
            else:
                diverge = 0

    return model, residual
