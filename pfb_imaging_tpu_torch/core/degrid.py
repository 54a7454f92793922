"""``degrid``: predict a component model into a visibility container's
MODEL_DATA (port of pfb_imaging_tpu/core/degrid.py).

Per partition and frequency bin the .mds model(s) are rendered on the host
(``eval_coeffs_to_slice``), optionally split by region masks, and degridded
on ``device``; the target is a TreeStore container or an MSv4 processing
set (written through ``utils/msv4``). ``gridder`` routes as in the JAX
package:
  * "idg": the IDG forward (``dirty2vis_idg``; kernel B2 on the card);
  * "stack": the classic ES w-stacking ``dirty2vis`` in plain torch;
  * "auto": IDG where its accuracy envelope covers ``epsilon`` and its
    planner accepts the bin, else stack (per bin, on the planner's
    ``ValueError``);
  * "pallas": the classic plan through the w-stacked gather kernel
    (``dirty2vis_scatter``; kernel B4 on the card).
"auto", "idg" and "stack" plan in the device's working type (f64 on the
CPU, f32 on the card, where the IDG kernels are f32-only). "pallas" plans
in f32 on every device: its gather is f32-only. The JAX ``degrid`` builds
this route's plan without a dtype, so its plan is f64 and its own
``_require_f32`` always refuses it; the port repairs that on purpose.

The recorder (``utils/profiling``) counts each bin's route
(``degrid.route.<route>``), the bins on wplanes IDG plans
(``degrid.bins.wplanes``) and the visibilities (``degrid.nvis``), and
times the planning, each model render, each prediction and each write
(spans ``degrid.plan``, ``.render``, ``.predict``, ``.write``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import real_dtype, resolve_device
from ..ops.gridder import dirty2vis, plan_wgridder
from ..ops.gridder_idg import IDG_MIN_EPS, dirty2vis_idg, plan_idg
from ..ops.gridder_pallas import dirty2vis_scatter
from ..utils.logging import get_logger
from ..utils.modelspec import eval_coeffs_to_slice, load_mds
from ..utils.msv4 import open_msv4
from ..utils.profiling import count, span
from ..utils.regions import region_masks
from ..utils.stokes import _STOKES_IDX, stokes_to_corr
from ..utils.store import TreeStore
from ..utils.zarrio import consolidate, is_zarr_store

log = get_logger("DEGRID")

# occupancy budget for auto IDG routing (the same bound as the imager's)
IDG_MAX_SLOT_FACTOR = 8.0
GRIDDERS = ("auto", "idg", "stack", "pallas")


def _open_target(ms_path):
    if is_zarr_store(ms_path):
        return open_msv4(ms_path), True
    return TreeStore(ms_path, mode="w"), False


def load_region_masks(region_file: str, nx: int, ny: int, cell_rad: float | None = None, radec=None) -> list:
    """[remainder] + one {0,1} mask per region; overlapping regions raise.

    Formats: DS9 region files (circle/box/ellipse/polygon in image, physical
    or fk5/icrs frames) and basic CRTF, through ``utils/regions``; ``.npy``
    with an (nreg, nx, ny) mask stack; and ``circle x y r`` / ``box x y w h``
    pixel lines.
    """
    if region_file.endswith(".npy"):
        regs = np.load(region_file)
        if regs.ndim == 2:
            regs = regs[None]
        masks = [np.asarray(r != 0, np.float64) for r in regs]
    else:
        with open(region_file) as f:
            text = f.read()
        if "(" in text or text.lstrip().lower().startswith("#crtf") or "[[" in text:
            masks = region_masks(text, nx, ny, cell_rad or 1.0, radec=radec)
        else:
            masks = []
            X, Y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
            for line in text.splitlines():
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                kind, *vals = parts
                v = [float(x) for x in vals]
                if kind == "circle":
                    x0, y0, r = v
                    masks.append(((X - x0) ** 2 + (Y - y0) ** 2 <= r * r).astype(np.float64))
                elif kind == "box":
                    x0, y0, w, h = v
                    masks.append(((np.abs(X - x0) <= w / 2) & (np.abs(Y - y0) <= h / 2)).astype(np.float64))
                else:
                    raise ValueError(f"unknown region kind {kind!r} (circle|box)")
        if not masks:
            raise ValueError(f"no regions found in {region_file}")
    total = np.sum(masks, axis=0)
    if (total > 1).any():
        raise ValueError("Overlapping regions are not supported")
    return [1.0 - total] + masks


def degrid(
    mds_path,
    ms_path,
    cell_rad: float,
    column: str = "MODEL_DATA",
    epsilon: float = 1e-7,
    do_wgridding: bool = True,
    freq_bins: int | None = None,
    to_corr: bool = False,
    mds_paths: dict | None = None,
    region_file: str | None = None,
    gridder: str = "auto",
    *,
    device="cuda",
):
    """Render the .mds model(s) per (partition, freq bin) and degrid them
    into ``column`` of every partition of ``ms_path``; returns the target.

    Args:
        mds_path: the Stokes-I component model store.
        mds_paths: optional {product letter: mds path} for multi-product
            prediction (e.g. {"I": ..., "Q": ...}); overrides ``mds_path``.
        to_corr: render into instrument correlations (always on for MSv4
            targets, whose MODEL_DATA column is correlations).
        region_file: split the prediction by image regions: the remainder
            writes ``column``, region i writes ``column{i}``.
        gridder: "idg" | "stack" | "pallas" | "auto" (see the module).
        device: where the prediction runs (the card unless the caller asks
            for the CPU).
    """
    if gridder not in GRIDDERS:
        raise ValueError(f"gridder {gridder!r} not in {GRIDDERS}")
    dev = resolve_device(device)
    use_pallas = gridder == "pallas"
    want_idg = not use_pallas and (gridder == "idg" or (gridder == "auto" and epsilon >= IDG_MIN_EPS))
    rdt = torch.float32 if use_pallas else real_dtype(dev)

    products = mds_paths if mds_paths is not None else {"I": mds_path}
    models = {p: load_mds(TreeStore(path)) for p, path in products.items()}
    mattrs = next(iter(models.values()))[3]
    ms, is_msv4 = _open_target(ms_path)
    nx, ny = mattrs["nx"], mattrs["ny"]
    feed_type = ms.attrs.get("feed_type", "linear")
    ncorr = ms.attrs.get("ncorr", 1)
    to_corr = to_corr or is_msv4
    masks = load_region_masks(region_file, nx, ny, cell_rad, radec=ms.attrs.get("radec")) if region_file else [None]

    for key in ms.groups():
        g = ms.group(key)
        uvw = np.asarray(g.read("UVW"))
        freqs = np.asarray(g.read("FREQ")) if g.has("FREQ") else np.asarray(ms.attrs["freq"])
        ttime = g.attrs.get("time", 0.0)
        nbin = freq_bins or len(mattrs["freqs"])
        edges = np.linspace(freqs.min(), freqs.max() * (1 + 1e-12), nbin + 1)
        which = np.clip(np.digitize(freqs, edges) - 1, 0, nbin - 1)

        # one plan per freq bin, shared by every mask and product render
        with span("degrid.plan"):
            plans = {}
            for bin_id in range(nbin):
                chans = np.where(which == bin_id)[0]
                if chans.size == 0:
                    continue
                kw = dict(nx=nx, ny=ny, cellx=cell_rad, celly=cell_rad, l0=g.attrs.get("l0", 0.0),
                          m0=g.attrs.get("m0", 0.0), epsilon=epsilon, do_wgridding=do_wgridding, divide_by_n=False,
                          dtype=rdt, device=dev)
                plan = None
                if want_idg:
                    try:
                        cap = IDG_MAX_SLOT_FACTOR if gridder == "auto" else None
                        plan = plan_idg(uvw, freqs[chans], max_slot_factor=cap, **kw)
                    except ValueError as e:
                        if gridder == "idg":
                            raise
                        log.info("degrid %s bin %d: %s", key, bin_id, e)
                is_idg = plan is not None
                if not is_idg:
                    plan = plan_wgridder(uvw, freqs[chans], **kw)
                route = "idg" if is_idg else ("pallas" if use_pallas else "stack")
                plans[bin_id] = (plan, route, chans)
                count("degrid.route." + route)
                if is_idg and plan.w_support > 1:
                    count("degrid.bins.wplanes")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        count("degrid.nvis", uvw.shape[0] * freqs.size)

        for mi, mask in enumerate(masks):
            stokes = {}  # Stokes index -> (nrow, nfreq) complex prediction
            for bin_id, (plan, route, chans) in plans.items():
                fc = float(freqs[chans].mean())
                for p, (coeffs, ix, iy, ma) in models.items():
                    with span("degrid.render"):
                        img = eval_coeffs_to_slice(ttime, fc, coeffs, ix, iy, ma)
                        if mask is not None:
                            img = img * mask
                        img = torch.from_numpy(img).to(device=dev, dtype=rdt)
                    with span("degrid.predict"):
                        if route == "idg":
                            mv = dirty2vis_idg(plan, img)
                        elif route == "pallas":
                            mv = dirty2vis_scatter(plan, img)
                        else:
                            mv = dirty2vis(plan, img)
                        mv = mv.cpu().numpy()  # ends in a device sync
                    s = _STOKES_IDX[p]
                    if s not in stokes:
                        stokes[s] = np.zeros((uvw.shape[0], freqs.size), np.complex128)
                    stokes[s][:, chans] = mv
            with span("degrid.write"):
                zeros = np.zeros((uvw.shape[0], freqs.size), np.complex128)
                if to_corr:
                    out = stokes_to_corr(np.stack([stokes.get(s, zeros) for s in range(4)]), feed_type=feed_type,
                                         ncorr=ncorr)
                else:
                    out = stokes.get(0, zeros)
                col = column if mi == 0 else f"{column}{mi}"
                if is_msv4:
                    g.write_column(col, out)
                else:
                    g.write(col, out)
            log.info("degrid: wrote %s (%s) for %s", col, "".join(products), key)
    if is_msv4:
        consolidate(ms_path)
    return ms
