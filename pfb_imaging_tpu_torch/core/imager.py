"""``imager`` and the exact once-per-major-cycle residual (port of
pfb_imaging_tpu/core/imager.py).

``imager`` grids a Stokes visibility store (``init``'s schema) into a .dt
image tree: the counts pass and Briggs weights, the per-(band, partition)
DIRTY, PSF, PSFHAT, NOISE and WSUM products (host planning pipelined on a
thread pool while the card grids), time binning, the BEAM product,
PSFPARSN, the MFS products, the root attributes with ``complete=True``, and
the FITS output. ``gridder`` routes as in the JAX package: "pallas" (the
classic plan through the w-stacked scatter kernel), "stack" (the classic
gridder in plain torch), "idg", or "auto" (IDG unless its accuracy envelope
or the slot-padding probe on the narrowest band says stack). With
``model_mds`` it transfers a component model first: per partition the model
is rendered at the partition's time and the band's mean frequency,
predicted (``dirty2vis_idg`` on the IDG route, the classic ``dirty2vis``
otherwise, "pallas" included, as in the JAX package) and subtracted, and
``l2_reweight_dof`` then reweights the residual visibilities (Student-t).

Several ranks (``parallel/``): the bands are owned round-robin by node (the
JAX package's processes). With ``use_mesh`` (None: IDG and more than one
rank on the node) the node's local ranks form a row mesh: each plans and
grids only its own share of every partition's rows (zero rows pad them to a
multiple of the row size) on the layout all shares have in common
(``parallel.sharded.plan_idg_sharded``), the partial images are summed over
the node's ranks, and the model transfer degrids each share and gathers the
visibilities. Without the mesh a node's bands are split over its local
ranks. One rank writes each band node (the first of its node under the
mesh); after a barrier rank 0 assembles the MFS products (from the store
when there are several nodes) and stamps the tree complete, and the other
ranks wait for it at a second barrier.

``residual_from_parts`` computes DIRTY - sum_p R_p^H W_p R_p (B_p model) per
band: the IDG round trip (chirp or wplanes) where the planner accepts the
partition, else (for ``gridder="auto"``, per partition) the classic ES
w-stacking gridder. ``residual_from_parts_multiband`` computes it for all
bands of one time slice at once, per partition one multiband IDG plan whose
patch kernels take every band in one launch; it returns ``None`` where the
layout does not qualify, and the caller then goes band by band.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import checked_real_dtype, real_dtype, resolve_device, to_device, to_device_async, to_host
from ..constants import LIGHTSPEED
from ..geometry import fitcleanbeam, set_image_size, wgridder_conventions
from ..ops.gridder import dirty2vis, plan_wgridder, vis2dirty
from ..ops.gridder_idg import (IDG_MIN_EPS, dirty2vis_idg, hessian_vis_idg, idg_slot_factor, plan_idg,
                               to_group_layout, vis2dirty_idg)
from ..ops.gridder_pallas import vis2dirty_scatter
from ..ops.weighting import box_sum_counts, compute_counts, counts_to_weights, filter_extreme_counts, l2_reweight
from ..parallel import multihost as mh
from ..parallel.mesh import make_mesh
from ..parallel.sharded import plan_idg_sharded, sharded_dirty2vis_idg, sharded_vis2dirty_idg
from ..utils.fits import save_fits, set_wcs
from ..utils.logging import get_logger
from ..utils.modelspec import eval_coeffs_to_slice, load_mds
from ..utils.profiling import count, memory_line, span
from ..utils.store import TreeStore, band_key, part_key

log = get_logger("IMAGER")

# the JAX router's slot-padding bound for IDG (gridder="auto")
IDG_MAX_SLOT_FACTOR = 8.0
GRIDDERS = ("auto", "idg", "stack", "pallas")

_PLAN_CACHE: OrderedDict = OrderedDict()
_PLAN_CACHE_CAP = 256
# byte-bounded LRU: a plan for ~4M visibilities holds ~0.3 GB of device tensors
_PLAN_CACHE_BYTES_CAP = 32 << 30
_PLAN_CACHE_BYTES = 0


def band_mapping(freqs: np.ndarray, nband: int):
    """Split channels into ``nband`` contiguous bins; a list of channel
    index arrays."""
    edges = np.linspace(freqs.min(), freqs.max() * (1 + 1e-12), nband + 1)
    idx = np.clip(np.digitize(freqs, edges) - 1, 0, nband - 1)
    return [np.where(idx == b)[0] for b in range(nband)]


def _psf_vis(uvw, freq, l0, m0):
    """PSF visibilities: ones at the field centre, else the phase ramp of
    an off-centre phase direction."""
    flip_u, flip_v, _, x0, y0 = wgridder_conventions(l0, m0)
    if x0 == 0 and y0 == 0:
        return np.ones((uvw.shape[0], freq.size), dtype=np.complex128)
    signu = -1.0 if flip_u else 1.0
    signv = -1.0 if flip_v else 1.0
    n0 = np.sqrt(1.0 - x0**2 - y0**2)
    freqfactor = 2j * np.pi * freq[None, :] / LIGHTSPEED
    return np.exp(freqfactor * (signu * uvw[:, 0:1] * x0 * signu + signv * uvw[:, 1:2] * y0 * signv
                                - uvw[:, 2:] * (n0 - 1)))


def _psfhat(psf: np.ndarray, dev) -> np.ndarray:
    """rfft2 of the ifftshifted PSF, in f64 on ``dev``."""
    t = torch.from_numpy(np.ascontiguousarray(psf, np.float64)).to(dev)
    return torch.fft.rfft2(torch.fft.ifftshift(t)).cpu().numpy()


def imager(
    xds_path,
    output_store,
    nband: int = 1,
    field_of_view: float | None = None,
    super_resolution_factor: float = 2.0,
    nx: int | None = None,
    ny: int | None = None,
    cell_size: float | None = None,
    psf_oversize: float = 2.0,
    robustness: float | None = None,
    super_uniform_pix: int = 0,
    counts_level: float = 10.0,
    epsilon: float = 1e-7,
    do_wgridding: bool = True,
    double_precision: bool | None = None,
    fits_out: bool = True,
    model_mds: str | None = None,
    l2_reweight_dof: float | None = None,
    gridder: str = "auto",
    plan_threads: int = 8,
    do_noise: bool = True,
    noise_seed: int = 7,
    ntime: int = 1,
    use_mesh: bool | None = None,
    *,
    device="cuda",
):
    """Grid a Stokes vis store into a .dt image tree on ``device`` (the
    card unless the caller asks for the CPU). Returns the TreeStore.

    ``double_precision`` defaults to the device's working type: f64 on the
    CPU (the JAX default), f32 on the card, whose kernels are f32-only."""
    if gridder not in GRIDDERS:
        raise ValueError(f"gridder {gridder!r} not in {GRIDDERS}")
    dev = resolve_device(device)
    if double_precision is None:
        rdt = real_dtype(dev)
    else:
        rdt = torch.float64 if double_precision else torch.float32

    xds = TreeStore(xds_path)
    attrs = xds.attrs
    freqs = np.asarray(attrs["freq"], dtype=float)

    max_blength = 0.0
    for key in xds.groups():
        uvw = xds.group(key).read("UVW", mmap=True)
        max_blength = max(max_blength, float(np.abs(uvw[:, :2]).max()) * np.sqrt(2))
    geo = set_image_size(max_blength, freqs.max(), field_of_view or 1.0, super_resolution_factor,
                         cell_size=cell_size, nx=nx, ny=ny, psf_oversize=psf_oversize)
    nx_im, ny_im, nx_psf, ny_psf = geo.nx, geo.ny, geo.nx_psf, geo.ny_psf
    cell_rad = geo.cell_rad
    log.info("image %dx%d, psf %dx%d, cell %.3e rad", nx_im, ny_im, nx_psf, ny_psf, cell_rad)

    bands = band_mapping(freqs, nband)
    parts = xds.groups()
    model = load_mds(TreeStore(model_mds)) if model_mds is not None else None

    out = TreeStore(output_store, mode="w")
    # a killed run must not leave a tree that passes require_complete
    out.set_attrs(complete=False)

    # ── pass 1: counts over all partitions per band ──────────────────
    with span("imager.counts"):
        counts_per_band = [np.zeros((1, nx_psf, ny_psf)) for _ in range(nband)]
        if robustness is not None:
            for key in parts:
                g = xds.group(key)
                uvw = np.asarray(g.read("UVW"))
                f = np.asarray(g.read("FREQ"))
                wgt = np.asarray(g.read("WEIGHT"))
                mask = np.asarray(g.read("MASK"))
                for b, chans in enumerate(bands):
                    if chans.size:
                        counts_per_band[b] += np.asarray(compute_counts(uvw, f[chans], mask[:, chans],
                                                                        wgt[None, :, chans], nx_psf, ny_psf,
                                                                        cell_rad, cell_rad))
            counts_per_band = [np.asarray(box_sum_counts(filter_extreme_counts(c, level=counts_level),
                                                         super_uniform_pix)) for c in counts_per_band]

    # ── routing ──────────────────────────────────────────────────────
    use_pallas = gridder == "pallas"
    use_idg = gridder == "idg" or (gridder == "auto" and epsilon >= IDG_MIN_EPS)
    if gridder == "auto" and use_idg and parts:
        # slot-padding probe on the PSF grid with the narrowest band's
        # channels (per-band plans see nvis/nband visibilities)
        g0 = xds.group(parts[0])
        narrow = min((bands[b] for b in range(nband) if bands[b].size), key=len)
        try:
            sf, nb = idg_slot_factor(np.asarray(g0.read("UVW")), np.asarray(g0.read("FREQ"))[narrow], nx=nx_psf,
                                     ny=ny_psf, cellx=cell_rad, celly=cell_rad, l0=g0.attrs.get("l0", 0.0),
                                     m0=g0.attrs.get("m0", 0.0), epsilon=epsilon, do_wgridding=do_wgridding,
                                     dtype=rdt)
        except ValueError as e:
            log.info("gridder auto -> stack: %s", e)
            use_idg = False
        else:
            if sf > IDG_MAX_SLOT_FACTOR:
                log.info("gridder auto -> stack: IDG slot padding %.0fx (%d w-bins) exceeds the %.0fx budget",
                         sf, nb, IDG_MAX_SLOT_FACTOR)
                use_idg = False
    route = "pallas" if use_pallas else ("idg" if use_idg else "stack")
    if route == "idg" and dev.type == "cuda" and rdt == torch.float64:
        raise ValueError("the IDG kernels on the card are f32-only; pass double_precision=False")
    count("imager.route." + route)

    # ── several ranks: bands by node, the node's ranks as a row mesh ──
    distributed, me = mh.is_distributed(), mh.rank()
    lws = mh.local_world_size()
    if use_mesh is None:
        use_mesh = use_idg and lws > 1
    mesh = make_mesh(band=1, row=lws) if use_mesh and use_idg else None
    my_bands = set(mh.owned_items(range(nband)) if mesh is not None else mh.rank_items(range(nband)))
    writer = mesh is None or mesh.row_index == 0  # one writer a band node
    rank = dict(mesh_row_size=1 if mesh is None else mesh.row_size, bands=sorted(my_bands))
    log.info("rank %d (node %d of %d): bands %s, %s", me, mh.process_index(), mh.process_count(), rank["bands"],
             f"{mesh.row_size}-way row mesh" if mesh is not None else "no mesh", extra={"rank": rank})

    def _prepare_task(b, ip, key):
        """Read, weight and plan one (band, partition): host work plus the
        plans' transfer, run on the pool while the card grids."""
        with span("imager.plan"):
            chans = bands[b]
            g = xds.group(key)
            uvw = np.asarray(g.read("UVW"))
            f = np.asarray(g.read("FREQ"))[chans]
            vis = np.asarray(g.read("VIS"))[:, chans]
            wgt = np.asarray(g.read("WEIGHT"))[:, chans]
            mask = np.asarray(g.read("MASK"))[:, chans]
            l0 = g.attrs.get("l0", 0.0)
            m0 = g.attrs.get("m0", 0.0)
            if robustness is not None:
                wgt = np.asarray(counts_to_weights(counts_per_band[b], uvw, f, wgt[None], mask, nx_psf, ny_psf,
                                                   cell_rad, cell_rad, robustness))[0]
            kw = dict(cellx=cell_rad, celly=cell_rad, l0=l0, m0=m0, epsilon=epsilon, do_wgridding=do_wgridding,
                      divide_by_n=False, dtype=rdt, device=dev)
            if mesh is not None:
                # this rank's share of the rows, zero rows padding them to a
                # multiple of the row size, on the layout every share has
                d = mesh.row_size
                pad = (-uvw.shape[0]) % d
                uvw_p = np.concatenate([uvw, np.zeros((pad, 3))]) if pad else uvw
                plan_im = plan_idg_sharded(uvw_p, f, d, mesh.row_index, nx=nx_im, ny=ny_im, **kw) + (pad,)
                plan_psf = plan_idg_sharded(uvw_p, f, d, mesh.row_index, nx=nx_psf, ny=ny_psf, **kw) + (pad,)
            else:
                planner = plan_idg if use_idg else plan_wgridder
                plan_im = planner(uvw, f, nx=nx_im, ny=ny_im, **kw)
                plan_psf = planner(uvw, f, nx=nx_psf, ny=ny_psf, **kw)
            wm = to_device(wgt * mask, dev, rdt)
            beam_p = None
            if g.has("BEAM_SMALL"):
                from ..utils.beam import interp_beam

                lg_im = (np.arange(nx_im) - nx_im // 2) * cell_rad
                ll, mm = np.meshgrid(lg_im, lg_im, indexing="ij")
                beam_p = interp_beam(np.asarray(g.read("BEAM_SMALL")), np.asarray(g.read("BEAM_L")),
                                     np.asarray(g.read("BEAM_M")), ll, mm)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return b, ip, key, uvw, f, vis, wgt, mask, wm, l0, m0, plan_im, plan_psf, beam_p

    def shard_rows(a, plan):
        """This rank's share of the rows of (nrow, nchan) ``a``, zero-padded."""
        _, rows, pad = plan
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a[mesh.row_index * rows:(mesh.row_index + 1) * rows]

    def grid_image(plan, visc, wm):
        """One weighted image on the card, returned as f64 numpy."""
        vr, vi = to_device(visc.real, dev, rdt), to_device(visc.imag, dev, rdt)
        if mesh is not None:
            img = sharded_vis2dirty_idg(mesh, plan[0], shard_rows(vr, plan), shard_rows(vi, plan),
                                        wgt=shard_rows(wm, plan), axes="row")
        elif use_pallas:
            img = vis2dirty_scatter(plan, vr, wgt=wm, vis_im=vi)
        elif use_idg:
            img = vis2dirty_idg(plan, vr, wgt=wm, vis_im=vi)
        else:
            img = vis2dirty(plan, vr, wgt=wm, vis_im=vi)
        return img.double().cpu().numpy()

    def count_plans(*plans):
        """The plans made, and those on w: IDG's wplanes (w_support > 1),
        the classic w-stack's planes (nw >= 1)."""
        plans = [p[0] for p in plans] if mesh is not None else plans
        count("imager.plans", len(plans))
        if use_idg:
            count("imager.plans.wplanes", sum(p.w_support > 1 for p in plans))
        else:
            count("imager.plans.wstack", sum(p.nw >= 1 for p in plans))

    # time binning: partitions land in ntime contiguous bins over scan time
    part_times = np.asarray([xds.group(k).attrs.get("time", 0.0) for k in parts], dtype=float)
    if ntime > 1 and parts:
        tedges = np.linspace(part_times.min(), part_times.max() * (1 + 1e-12) + 1e-12, ntime + 1)
        tbin_of = np.clip(np.digitize(part_times, tedges) - 1, 0, ntime - 1)
    else:
        ntime = 1
        tbin_of = np.zeros(len(parts), np.int64)
    time_out = [float(part_times[tbin_of == tb].mean()) if np.any(tbin_of == tb) else 0.0 for tb in range(ntime)]

    tasks = [(b, ip, key) for b in range(nband) if bands[b].size and b in my_bands for ip, key in enumerate(parts)]
    pool = ThreadPoolExecutor(max_workers=max(1, plan_threads))
    window = max(2, min(plan_threads, 4))  # plans hold device tensors; bound them
    pending = deque()
    ti = 0

    freq_out = [float((freqs[c] if c.size else np.array([freqs.mean()])).mean()) for c in bands]
    dirty_acc = {(b, tb): np.zeros((nx_im, ny_im)) for b in range(nband) for tb in range(ntime)}
    psf_acc = {k: np.zeros((nx_psf, ny_psf)) for k in dirty_acc}
    wsum_acc = {k: 0.0 for k in dirty_acc}
    noise_acc = {k: np.zeros((nx_im, ny_im)) for k in dirty_acc}
    beam_acc = {k: np.zeros((nx_im, ny_im)) for k in dirty_acc}
    any_beam = False
    nrng = np.random.default_rng(noise_seed)

    try:
        while ti < len(tasks) or pending:
            while ti < len(tasks) and len(pending) < window:
                pending.append(pool.submit(_prepare_task, *tasks[ti]))
                ti += 1
            with span("imager.wait"):
                b, ip, key, uvw, f, vis, wgt, mask, wm, l0, m0, plan_im, plan_psf, beam_p = pending.popleft().result()
            if model is not None:
                with span("imager.model"):
                    # residual visibilities, then optional Student-t reweighting
                    img = to_device(eval_coeffs_to_slice(float(part_times[ip]), float(f.mean()), *model), dev, rdt)
                    if mesh is not None:
                        # each rank degrids its rows; the shares are gathered
                        _, rows, _ = plan_im
                        mv = mesh.row_all_gather(sharded_dirty2vis_idg(mesh, plan_im[0], img, axes="row"))
                        mv = mv.transpose(0, 1).reshape(2, mesh.row_size * rows, -1)[:, : uvw.shape[0]].cpu().numpy()
                        vis = vis - (mv[0] + 1j * mv[1])
                    else:
                        vis = vis - (dirty2vis_idg if use_idg else dirty2vis)(plan_im, img).cpu().numpy()
                    if l2_reweight_dof:
                        wgt = l2_reweight(vis, wgt, mask, l2_reweight_dof)
                        wm = to_device(wgt * mask, dev, rdt)
            with span("imager.grid"):
                dirty_p = grid_image(plan_im, vis, wm)
                psf_p = grid_image(plan_psf, _psf_vis(uvw, f, l0, m0), wm)
                wsum_p = float(wgt[mask.astype(bool)].sum())
                if do_noise:
                    # unit-variance noise projected with the same weights
                    nv = nrng.standard_normal(vis.shape) + 1j * nrng.standard_normal(vis.shape)
                    safe_w = np.where(wgt > 0, wgt, 1.0)
                    nv = np.where(wgt > 0, nv / np.sqrt(safe_w), 0.0)
                    noise_acc[b, int(tbin_of[ip])] += grid_image(plan_im, nv, wm)
            count("imager.nvis", vis.size)
            count_plans(plan_im, plan_psf)
            del plan_im, plan_psf, wm

            with span("imager.write"):
                tb = int(tbin_of[ip])
                if writer:
                    pg = out.group(band_key(b, tb)).group(part_key(ip))
                    pg.set_attrs(l0=l0, m0=m0, wsum=wsum_p, key=key)
                    pg.write("VIS", vis)
                    pg.write("WEIGHT", wgt)
                    pg.write("MASK", mask)
                    pg.write("UVW", uvw)
                    pg.write("FREQ", f)
                    pg.write("PSF", psf_p)
                    pg.write("PSFHAT", _psfhat(psf_p, dev))
                    if beam_p is not None:
                        pg.write("BEAM", beam_p)
                if beam_p is not None:
                    beam_acc[b, tb] += wsum_p * beam_p
                    any_beam = True
                dirty_acc[b, tb] += dirty_p
                psf_acc[b, tb] += psf_p
                wsum_acc[b, tb] += wsum_p
            log.info("gridded band %d %s: wsum=%.3e [%s]", b, key, wsum_p, memory_line())
    finally:
        pool.shutdown(wait=False, cancel_futures=True)

    with span("imager.finish"):
        dirty_mfs = np.zeros((nx_im, ny_im))
        psf_mfs = np.zeros((nx_psf, ny_psf))
        wsum_tot = 0.0
        for b in range(nband):
            if b not in my_bands or not writer:
                continue  # another rank writes this band's nodes
            for tb in range(ntime):
                node = out.group(band_key(b, tb))
                dirty_b, psf_b, wsum_b = dirty_acc[b, tb], psf_acc[b, tb], wsum_acc[b, tb]
                node.write("DIRTY", dirty_b)
                node.write("PSF", psf_b)
                node.write("PSFHAT", _psfhat(psf_b, dev))
                node.write("WSUM", np.asarray([wsum_b]))
                if do_noise:
                    node.write("NOISE", noise_acc[b, tb])
                if any_beam:
                    node.write("BEAM", beam_acc[b, tb] / max(wsum_b, 1e-300))
                node.write("PSFPARSN", np.asarray(fitcleanbeam((psf_b / max(wsum_b, 1e-300))[None])[0]))
                node.set_attrs(freq_out=freq_out[b], wsum=wsum_b, niters=0, time_out=time_out[tb])
                dirty_mfs += dirty_b
                psf_mfs += psf_b
                wsum_tot += wsum_b
                log.info("band %d time %d: wsum=%.3e, dirty peak=%.3e", b, tb, wsum_b,
                         dirty_b.max() / max(wsum_b, 1e-300))

        if distributed:
            # every band node is on disk before rank 0 assembles the MFS products
            mh.barrier("imager-band-writes")
            if me != 0:
                mh.barrier("imager-complete")
                return out
            # the band nodes of every rank, in band order, whoever imaged them
            dirty_mfs[:], psf_mfs[:], wsum_tot = 0.0, 0.0, 0.0
            for b in range(nband):
                for tb in range(ntime):
                    node = out.group(band_key(b, tb))
                    dirty_mfs += np.asarray(node.read("DIRTY"))
                    psf_mfs += np.asarray(node.read("PSF"))
                    wsum_tot += float(np.asarray(node.read("WSUM"))[0])

        psfpars = fitcleanbeam((psf_mfs / max(wsum_tot, 1e-300))[None])[0]
        out.set_attrs(nband=nband, ntime=ntime, nx=nx_im, ny=ny_im, nx_psf=nx_psf, ny_psf=ny_psf, cell_rad=cell_rad,
                      ra=attrs.get("ra", 0.0), dec=attrs.get("dec", 0.0), freq_out=freq_out, wsum=wsum_tot,
                      psfpars=list(psfpars), product=attrs.get("product", "I"), complete=True)

        if fits_out:
            cell_deg = np.rad2deg(cell_rad)
            radec = (attrs.get("ra", 0.0), attrs.get("dec", 0.0))
            hdr = set_wcs(cell_deg, cell_deg, nx_im, ny_im, radec, np.asarray(freq_out), gausspar=psfpars)
            base = str(out.path)[:-3] if str(out.path).endswith(".dt") else str(out.path)
            save_fits(dirty_mfs / max(wsum_tot, 1e-300), f"{base}_dirty_mfs.fits", hdr)
            hdr_psf = set_wcs(cell_deg, cell_deg, nx_psf, ny_psf, radec, np.asarray(freq_out))
            save_fits(psf_mfs / max(wsum_tot, 1e-300), f"{base}_psf_mfs.fits", hdr_psf)
        if distributed:
            mh.barrier("imager-complete")
    return out


# ── the exact residual ───────────────────────────────────────────────


def _cached_nbytes(cached) -> int:
    if cached is None:  # a multiband slice's refusal
        return 0
    plan, wgt, mask, beam, _ = cached
    return plan.nbytes + sum(t.numel() * t.element_size() for t in (wgt, mask, beam) if t is not None)


def _plan_cache_put(key, cached):
    global _PLAN_CACHE_BYTES
    nb = _cached_nbytes(cached)
    while _PLAN_CACHE and (len(_PLAN_CACHE) >= _PLAN_CACHE_CAP or _PLAN_CACHE_BYTES + nb > _PLAN_CACHE_BYTES_CAP):
        _, old = _PLAN_CACHE.popitem(last=False)
        _PLAN_CACHE_BYTES -= _cached_nbytes(old)
    _PLAN_CACHE[key] = cached
    _PLAN_CACHE_BYTES += nb


def _plan_cache_drop(key):
    global _PLAN_CACHE_BYTES
    if key in _PLAN_CACHE:
        _PLAN_CACHE_BYTES -= _cached_nbytes(_PLAN_CACHE.pop(key))


def _part_stamp(pg: TreeStore) -> tuple:
    """Modification stamps of the arrays a cached plan depends on."""
    stamps = []
    for name in ("UVW", "FREQ", "WEIGHT", "MASK"):
        try:
            stamps.append(pg.mtime(name))
        except (AttributeError, KeyError, OSError):
            stamps.append(None)
    return tuple(stamps)


def _cell_from_root(band_node: TreeStore) -> float:
    return float(TreeStore(band_node.path.parent).attrs["cell_rad"])


def _plan_partition(pg: TreeStore, pk: str, kw: dict, gridder: str, want_idg: bool, dev, rdt):
    """(plan, wgt, mask, beam, is_idg) of one partition: an IDG plan with
    the masked weights (in group layout for chirp plans, in original layout
    for wplanes plans, which weight the replica sum), or the classic plan
    with the weights and mask as they are. ``gridder="auto"`` falls back to
    the classic plan on the IDG planner's ``ValueError``; an explicit "idg"
    propagates it."""
    uvw, f = np.asarray(pg.read("UVW")), np.asarray(pg.read("FREQ"))
    wgt = to_device(pg.read("WEIGHT"), dev, rdt)
    mask = to_device(pg.read("MASK"), dev, rdt)
    plan = None
    if want_idg:
        try:
            plan = plan_idg(uvw, f, max_slot_factor=IDG_MAX_SLOT_FACTOR if gridder == "auto" else None, **kw)
        except ValueError as e:
            if gridder != "auto":
                raise
            log.info("partition %s: %s", pk, e)
    beam = to_device(pg.read("BEAM"), dev, rdt) if pg.has("BEAM") else None
    if plan is not None:
        wm = wgt * mask
        return plan, (wm if plan.w_support > 1 else to_group_layout(plan, wm)), None, beam, True
    return plan_wgridder(uvw, f, **kw), wgt, mask, beam, False


def _timed_plan(fn, dev):
    """fn(), then the device's sync, so that the enclosing ``residual.plan``
    span holds the plan's uploads."""
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def residual_from_parts(band_node: TreeStore, model_b, epsilon: float = 1e-7, do_wgridding: bool = True,
                        double_precision: bool | None = None, gridder: str = "auto", as_device: bool = False, *,
                        device="cuda"):
    """DIRTY - sum_p R_p^H W_p R_p (B_p model) for one band, un-normalised,
    computed on ``device`` and returned as an f64 numpy array, or with
    ``as_device`` as the tensor on ``device`` without waiting for it (so a
    caller can queue every band before it fetches any).

    ``gridder``: "idg", "stack" (classic ES w-stacking), or "auto" (IDG
    where its accuracy envelope covers ``epsilon`` and its planner accepts
    the partition, else stack). Plans are cached per partition path,
    content stamp, geometry and ``gridder``, as in the JAX package.
    ``double_precision`` may only name the device's type (f64 on the CPU,
    f32 on the card): None takes it."""
    if gridder not in ("auto", "idg", "stack"):
        raise ValueError(f"gridder {gridder!r} not in ('auto', 'idg', 'stack')")
    rdt = checked_real_dtype(device, double_precision)
    dev = resolve_device(device)
    with span("residual"):
        with span("residual.lookup"):
            nx, ny = band_node.read("DIRTY", mmap=True).shape
            parts = band_node.groups()
        with span("residual.upload"):
            model_t = to_device_async(model_b, dev, rdt)
        conv = torch.zeros((nx, ny), dtype=rdt, device=dev)
        want_idg = gridder == "idg" or (gridder == "auto" and epsilon >= IDG_MIN_EPS)
        for pk in parts:
            with span("residual.lookup"):
                pg = band_node.group(pk)
                key = (str(pg.path), _part_stamp(pg), nx, ny, epsilon, do_wgridding, gridder, str(dev))
                cached = _PLAN_CACHE.get(key)
                if cached is None:
                    cell = band_node.attrs.get("cell_rad", 0.0) or _cell_from_root(band_node)
                    kw = dict(nx=nx, ny=ny, cellx=cell, celly=cell, l0=pg.attrs.get("l0", 0.0),
                              m0=pg.attrs.get("m0", 0.0), epsilon=epsilon, do_wgridding=do_wgridding,
                              divide_by_n=False, dtype=rdt, device=dev)
                    count("residual.plan_miss")
                    with span("residual.plan"):
                        cached = _timed_plan(lambda: _plan_partition(pg, pk, kw, gridder, want_idg, dev, rdt), dev)
                    _plan_cache_put(key, cached)
                else:
                    _PLAN_CACHE.move_to_end(key)
            with span("residual.launch"):
                plan, wgt, mask, beam, is_idg = cached
                xin = model_t if beam is None else model_t * beam
                if is_idg:
                    conv += hessian_vis_idg(plan, xin, wgt_g=wgt)
                else:
                    conv += vis2dirty(plan, dirty2vis(plan, xin), wgt=wgt, mask=mask)
        # DIRTY is read while the card works through the queued round trips
        with span("residual.dirty"):
            resid = to_device_async(band_node.read("DIRTY", mmap=True), dev, rdt) - conv
        return resid if as_device else to_host(resid).astype(np.float64)


def residual_from_parts_multiband(dt: TreeStore, band_keys: list, model, epsilon: float = 1e-7,
                                  do_wgridding: bool = True, double_precision: bool | None = None, *,
                                  as_device: bool = False, device="cuda"):
    """The raw residual (nband, nx, ny) of all bands of one time slice, per
    partition one multiband IDG plan (``parallel.sharded``) whose B1 and B2
    launches take every band; f64 numpy, or with ``as_device`` the tensor
    on ``device`` without waiting for it. Returns ``None`` where the JAX
    package does: below IDG's accuracy envelope, fewer than 2 bands,
    partitions that differ between the bands, uvw the bands do not share, or
    a layout the planner refuses (``ValueError``, the slot budget of
    ``gridder="auto"`` included); the caller then runs
    :func:`residual_from_parts` band by band. Every partition is planned
    before any is computed; a refusal is cached with the plans, so later
    major cycles decline at once, and the counter
    ``residual.multiband_parts`` counts the partitions only when the whole
    slice ran. The beam multiplies the model
    once, as in the per-band route (the JAX multiband route also multiplies
    the result by it, which its per-band route does not). ``double_precision``
    as in :func:`residual_from_parts`."""
    from ..parallel.sharded import multiband_hessian_vis_idg, multiband_to_group_layout, plan_idg_multiband_freqs

    rdt = checked_real_dtype(device, double_precision)
    if epsilon < IDG_MIN_EPS or len(band_keys) < 2:
        return None
    dev = resolve_device(device)
    nodes = [dt.group(k) for k in band_keys]
    nband = len(nodes)

    def build(pgs, uvw):
        freqs = [np.asarray(pg.read("FREQ")) for pg in pgs]
        cell = float(dt.attrs["cell_rad"])
        kw = dict(nx=nx, ny=ny, cellx=cell, celly=cell, l0=pgs[0].attrs.get("l0", 0.0), m0=pgs[0].attrs.get("m0", 0.0),
                  epsilon=epsilon, do_wgridding=do_wgridding, divide_by_n=False, dtype=rdt,
                  max_slot_factor=IDG_MAX_SLOT_FACTOR, device=dev)
        mplan, nch = plan_idg_multiband_freqs(uvw, freqs, **kw)
        wm = np.zeros((nband, uvw.shape[0], nch))
        for b, pg in enumerate(pgs):
            w = np.asarray(pg.read("WEIGHT")) * np.asarray(pg.read("MASK"))
            wm[b, :, : w.shape[1]] = w
        wm = to_device(wm, dev, rdt)
        wgt = wm if mplan.w_support > 1 else multiband_to_group_layout(mplan, wm)
        beam = (to_device(np.stack([np.asarray(pg.read("BEAM")) for pg in pgs]), dev, rdt)
                if all(pg.has("BEAM") for pg in pgs) else None)
        return mplan, wgt, None, beam, True

    with span("residual"):
        with span("residual.lookup"):
            part_keys = nodes[0].groups()
            if not part_keys or any(n.groups() != part_keys for n in nodes[1:]):
                return None
            nx, ny = nodes[0].read("DIRTY", mmap=True).shape
            pgs_of = {pk: [n.group(pk) for n in nodes] for pk in part_keys}
            keys = {pk: ("multiband", tuple(str(pg.path) for pg in pgs), tuple(_part_stamp(pg) for pg in pgs), nx,
                         ny, epsilon, do_wgridding, str(dev)) for pk, pgs in pgs_of.items()}
            decline_key = ("multiband_declined",) + tuple(keys.values())
            if decline_key in _PLAN_CACHE:
                return None
            plans, built = {}, []  # built: made by this call, dropped again if a later partition declines
            for pk, pgs in pgs_of.items():
                if keys[pk] in _PLAN_CACHE:
                    _PLAN_CACHE.move_to_end(keys[pk])
                    plans[pk] = _PLAN_CACHE[keys[pk]]
                    continue
                count("residual.plan_miss")
                with span("residual.plan"):
                    uvw = np.asarray(pgs[0].read("UVW"))
                    try:
                        if any(not np.array_equal(np.asarray(pg.read("UVW")), uvw) for pg in pgs[1:]):
                            raise ValueError("the bands do not share uvw")
                        cached = _timed_plan(lambda: build(pgs, uvw), dev)
                    except ValueError as e:
                        log.info("multiband partition %s: %s; the slice goes band by band", pk, e)
                        for k in built:
                            _plan_cache_drop(k)
                        _plan_cache_put(decline_key, None)
                        return None
                _plan_cache_put(keys[pk], cached)
                plans[pk] = cached
                built.append(keys[pk])

        with span("residual.upload"):
            xs = [to_device_async(model[b], dev, rdt) for b in range(nband)]
        with span("residual.launch"):
            conv = torch.zeros((nband, nx, ny), dtype=rdt, device=dev)
            for pk in part_keys:
                mplan, wgt, _, beam, _ = plans[pk]
                conv += multiband_hessian_vis_idg(mplan, xs if beam is None else [x * beam[b] for b, x in
                                                                                  enumerate(xs)], wgt)
        count("residual.multiband_parts", len(part_keys))
        # DIRTY is read while the card works through the queued round trips
        with span("residual.dirty"):
            for b, n in enumerate(nodes):
                conv[b] = to_device_async(n.read("DIRTY", mmap=True), dev, rdt) - conv[b]
        return conv if as_device else to_host(conv).astype(np.float64)
