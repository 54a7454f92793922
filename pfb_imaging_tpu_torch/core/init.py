"""``init``: raw measurement container -> Stokes visibility store (port of
pfb_imaging_tpu/core/init.py).

Per partition: apply the optional Jones terms (per-row JONES_P/JONES_Q, or
a gain table mapped onto the rows) and convert the correlations to the
requested Stokes product with ``weight_data`` on ``device``, then write
VIS/WEIGHT/MASK (row, chan), UVW and FREQ. Channel binning
(``_chan_average``), baseline-dependent time averaging (``utils/bda``) and
the ingest beam run on the host. Inputs are the simulator's TreeStore
containers or an MSv4 zarr processing set (``utils/zarrio``,
``utils/msv4``). The output keeps the conversion's types: complex128 VIS
and f64 WEIGHT, as the JAX package writes under x64; the imager casts.
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device, to_host
from ..utils.bda import bda_average
from ..utils.beam import eval_beam_model
from ..utils.gains import gains_to_jones, load_gain_table
from ..utils.logging import get_logger
from ..utils.msv4 import open_msv4
from ..utils.stokes import weight_data
from ..utils.store import TreeStore
from ..utils.zarrio import is_zarr_store

log = get_logger("INIT")


def _chan_average(vis, wgt, mask, freqs, cab: int):
    """Weighted channel binning by factor cab."""
    if cab <= 1:
        return vis, wgt, mask, freqs
    nrow, nchan = vis.shape
    ncout = nchan // cab
    sel = slice(0, ncout * cab)
    v = (vis[:, sel] * wgt[:, sel] * mask[:, sel]).reshape(nrow, ncout, cab).sum(-1)
    w = (wgt[:, sel] * mask[:, sel]).reshape(nrow, ncout, cab).sum(-1)
    f = freqs[sel].reshape(ncout, cab).mean(-1)
    m = (w > 0).astype(np.uint8)
    v = np.where(w > 0, v / np.where(w > 0, w, 1), 0)
    return v, w, m, f


def init(
    ms_path,
    output_store,
    product: str = "I",
    chan_average: int = 1,
    apply_jones: bool = True,
    bda_decorrelation: float | None = None,
    bda_fov: float | None = None,
    bda_max_window: int = 64,
    beam_model: str = "auto",
    beam_npix: int = 129,
    data_column: str | None = None,
    gain_table: str | None = None,
    *,
    device="cuda",
):
    """Convert a raw container to a Stokes product store; returns it.

    ``bda_decorrelation`` (e.g. 0.98): baseline-dependent time averaging
    after the conversion, protecting a field of radius ``bda_fov`` (default
    nx cell_rad / 2 from the container's attributes). ``beam_model``: "auto"
    evaluates the Gaussian dish beam on a small grid per partition when the
    container has a ``beam_diameter``; "none" disables; otherwise any
    ``utils.beam.eval_beam_model`` name. ``gain_table``: a gain table
    (TreeStore or .npz, ``utils/gains`` schema) mapped onto each
    partition's rows and channels and applied through ``weight_data``; it
    overrides JONES_P/JONES_Q. ``device``: where ``weight_data`` runs (the
    card unless the caller asks for the CPU).
    """
    dev = resolve_device(device)
    ms = open_msv4(ms_path, data_column=data_column) if is_zarr_store(ms_path) else TreeStore(ms_path)
    out = TreeStore(output_store, mode="w")
    attrs = ms.attrs
    feed_type = attrs.get("feed_type", "linear")
    freqs = np.asarray(attrs["freq"])
    out.set_attrs(ra=attrs.get("ra", 0.0), dec=attrs.get("dec", 0.0), product=product, freq=freqs.tolist(),
                  cell_rad=attrs.get("cell_rad"), beam_diameter=attrs.get("beam_diameter"))

    beam_diam = attrs.get("beam_diameter")
    if beam_model == "auto":
        beam_kind = "gauss" if beam_diam else None
    elif beam_model in (None, "none"):
        beam_kind = None
    else:
        beam_kind = beam_model  # gauss | kbl | kbuhf | *.npz
    cell_attr = attrs.get("cell_rad") or 0.0
    fov_r = bda_fov if bda_fov is not None else (attrs.get("nx", 128) * cell_attr / 2.0 or 1e-2)

    gtab = load_gain_table(gain_table) if gain_table is not None else None

    for key in ms.groups():
        g = ms.group(key)
        vis = g.read("VIS")
        wgt = g.read("WEIGHT")
        flag = g.read("FLAG")
        jp = g.read("JONES_P") if (apply_jones and g.has("JONES_P")) else None
        jq = g.read("JONES_Q") if (apply_jones and g.has("JONES_Q")) else None
        if gtab is not None and apply_jones:
            if not (g.has("TIME") and g.has("ANTENNA1") and g.has("ANTENNA2")):
                raise ValueError(f"gain_table needs TIME/ANTENNA1/ANTENNA2 columns in {key}")
            g_arr, gt_t, gt_f, gt_te, gt_fe = gtab
            jp, jq = gains_to_jones(g_arr, gt_t, gt_f, np.asarray(g.read("TIME")), np.asarray(g.read("ANTENNA1")),
                                    np.asarray(g.read("ANTENNA2")), freqs, time_edges=gt_te, freq_edges=gt_fe)

        vis_d, wgt_d = weight_data(vis, wgt, jones_p=jp, jones_q=jq, product=product, feed_type=feed_type, device=dev)
        del vis, wgt, jp, jq
        vis_s, wgt_s = to_host(vis_d), to_host(wgt_d)
        del vis_d, wgt_d
        mask = ((flag == 0) & (wgt_s > 0)).astype(np.uint8)
        f_out = freqs
        if chan_average > 1:
            vis_s, wgt_s, mask, f_out = _chan_average(vis_s, wgt_s, mask, freqs, chan_average)

        uvw = np.asarray(g.read("UVW"))
        nrow_in = vis_s.shape[0]
        if bda_decorrelation is not None and g.has("TIME") and g.has("ANTENNA1"):
            vis_s, wgt_s, mask, uvw, _ = bda_average(
                vis_s, wgt_s, mask, uvw, np.asarray(g.read("TIME")), np.asarray(g.read("ANTENNA1")),
                np.asarray(g.read("ANTENNA2")), freq_max=float(f_out.max()), fov_radius=fov_r,
                decorrelation=bda_decorrelation, max_window=bda_max_window)

        og = out.group(key)
        og.set_attrs(**g.attrs)
        og.write("VIS", vis_s)
        og.write("WEIGHT", wgt_s)
        og.write("MASK", mask)
        og.write("UVW", uvw)
        og.write("FREQ", f_out)
        if beam_kind:
            # small-grid beam at the partition's mean frequency (the imager
            # interpolates it onto the image grid)
            ext = fov_r * 1.3
            lg = np.linspace(-ext, ext, beam_npix)
            ll, mm = np.meshgrid(lg, lg, indexing="ij")
            og.write("BEAM_SMALL", eval_beam_model(beam_kind, ll, mm, float(f_out.mean()),
                                                  diameter=beam_diam or 13.5))
            og.write("BEAM_L", lg)
            og.write("BEAM_M", lg)
        log.info("init: %s -> %d rows (%d in), %d chans", key, vis_s.shape[0], nrow_in, vis_s.shape[1])
    return out
