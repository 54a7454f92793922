"""``restore``: restored image products (port of pfb_imaging_tpu/core/restore.py).

Letter codes: m (model), r (residual), i (restored image = model (x) clean
beam + residual); upper case for the MFS product. Every product is
restored with the MFS PSF's clean beam, fitted on the host (the reference
also fits each band's beam and then uses none of them); the convolutions
run on ``device``, and the FITS files are written on the host.
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..geometry import fitcleanbeam
from ..utils.fits import save_fits, set_wcs
from ..utils.logging import get_logger
from ..utils.restoration import restore_image
from ..utils.store import TreeStore, require_complete

log = get_logger("RESTORE")

_SUFFIX = {"m": "model", "M": "model_mfs", "r": "residual", "R": "residual_mfs", "i": "image", "I": "image_mfs"}


def restore(dt_path, outputs: str = "mMrRiI", fits_base: str | None = None, *, device="cuda") -> list:
    """Write the requested FITS products of the deconvolved tree; returns
    their file names."""
    dev = resolve_device(device)
    dt = TreeStore(dt_path)
    require_complete(dt)
    attrs = dt.attrs
    nx, ny = attrs["nx"], attrs["ny"]
    band_nodes = [k for k in dt.groups() if k.startswith("band")]
    nband = len(band_nodes)
    # per-node frequency (multi-time trees have nband * ntime nodes)
    freq_out = np.asarray(
        [float(dt.group(k).attrs.get("freq_out", np.asarray(attrs["freq_out"]).ravel()[0])) for k in band_nodes])
    cell_deg = np.rad2deg(attrs["cell_rad"])
    radec = (attrs.get("ra", 0.0), attrs.get("dec", 0.0))

    model = np.zeros((nband, nx, ny))
    residual = np.zeros((nband, nx, ny))
    psf = None
    wsums = np.zeros(nband)
    for b, key in enumerate(band_nodes):
        node = dt.group(key)
        wsums[b] = float(np.asarray(node.read("WSUM"))[0])
        if node.has("MODEL"):
            model[b] = np.asarray(node.read("MODEL"))
        residual[b] = np.asarray(node.read("RESIDUAL" if node.has("RESIDUAL") else "DIRTY"))
        if node.has("PSF"):
            p = np.asarray(node.read("PSF"))
            if psf is None:
                psf = np.zeros((nband,) + p.shape)
            psf[b] = p
    wsum = wsums.sum()

    # the MFS clean beam (every product is restored with it)
    gausspar_mfs = fitcleanbeam((psf.sum(axis=0) / wsum)[None])[0] if psf is not None else np.array([5.0, 5.0, 0.0])

    image = restore_image(model, residual, gausspar_mfs, wsum=wsum, device=dev)
    image_mfs = image.sum(axis=0) / nband if nband > 1 else image[0]
    prods = {
        "m": (model, "Jy/pixel", False),
        "M": (model.sum(axis=0), "Jy/pixel", True),
        "r": (residual / wsum, "Jy/beam", False),
        "R": (residual.sum(axis=0) / wsum, "Jy/beam", True),
        "i": (image, "Jy/beam", False),
        "I": (image_mfs, "Jy/beam", True),
    }
    base = fits_base or (str(dt.path)[: -len(".dt")] if str(dt.path).endswith(".dt") else str(dt.path))
    written = []
    for code, (data, unit, mfs) in prods.items():
        if code not in outputs:
            continue
        freq = np.asarray([freq_out.mean()]) if mfs else freq_out
        hdr = set_wcs(cell_deg, cell_deg, nx, ny, radec, freq, unit=unit,
                      gausspar=np.rad2deg(gausspar_mfs * attrs["cell_rad"]) if unit == "Jy/beam" else None)
        name = f"{base}_{_SUFFIX[code]}.fits"
        save_fits(np.asarray(data), name, hdr)
        written.append(name)
        log.info("wrote %s", name)
    return written
