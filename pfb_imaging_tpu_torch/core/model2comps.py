"""``model2comps``: fit a .dt tree's model cube to a component-coefficient
model (port of pfb_imaging_tpu/core/model2comps.py).

The band nodes' MODEL images are fitted over the (time, freq) node grid
with a Legendre basis (``utils/modelspec.fit_image_cube``, its solve in f64
on ``device``) and written as a ``.mds`` store, the component model that
``degrid`` predicts from.
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..utils.logging import get_logger
from ..utils.modelspec import fit_image_cube, save_mds
from ..utils.store import TreeStore, require_complete

log = get_logger("MODEL2COMPS")


def model2comps(dt_path, mds_path=None, model_name: str = "MODEL", nbasisf: int | None = None,
                nbasist: int | None = None, *, device="cuda"):
    """Fit the tree's ``model_name`` cube; returns the mds TreeStore (written
    to ``mds_path``, by default the tree's path with ``.dt`` -> ``.mds``)."""
    dev = resolve_device(device)
    dt = TreeStore(dt_path)
    require_complete(dt)
    attrs = dt.attrs
    band_nodes = sorted(k for k in dt.groups() if k.startswith("band"))
    nband_f = int(attrs.get("nband", len(band_nodes)))
    ntime = int(attrs.get("ntime", 1))
    if len(band_nodes) != nband_f * ntime:
        raise ValueError(f"{dt_path}: {len(band_nodes)} band nodes, expected nband x ntime = {nband_f * ntime}")
    nx, ny = attrs["nx"], attrs["ny"]

    model = np.zeros((nband_f, ntime, nx, ny))
    times = np.zeros((nband_f, ntime))
    freqs = np.zeros((nband_f, ntime))
    freq_attr = np.asarray(attrs["freq_out"], dtype=float).ravel()
    for i, key in enumerate(band_nodes):
        b, t = divmod(i, ntime)  # sorted keys are band-major, time-minor
        node = dt.group(key)
        if node.has(model_name):
            model[b, t] = np.asarray(node.read(model_name))
        times[b, t] = float(node.attrs.get("time_out", 0.0))
        freqs[b, t] = float(node.attrs.get("freq_out", freq_attr[0]))
    if not model.any():
        raise ValueError(f"No {model_name} found in {dt_path}")

    coeffs, ix, iy, mattrs = fit_image_cube(times[0], freqs[:, 0], model.transpose(1, 0, 2, 3),
                                            nbasisf=nbasisf or nband_f, nbasist=nbasist or min(ntime, 2), device=dev)
    mattrs["cell_rad"] = attrs["cell_rad"]
    mds_path = mds_path or str(dt.path).replace(".dt", ".mds")
    mds = TreeStore(mds_path, mode="w")
    save_mds(mds, coeffs, ix, iy, mattrs)
    log.info("wrote %s with %d components", mds_path, ix.size)
    return mds
