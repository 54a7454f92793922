"""``kclean``: CLEAN deconvolution (port of pfb_imaging_tpu/core/kclean.py).

Clark (or Hogbom) minor cycle on the wsum-normalised cube on ``device``,
then the exact residual through the measurement operator per band
(``residual_from_parts``: IDG, B2 then B1, where its envelope covers
``epsilon``), every band queued on the device before any is fetched; the
model and residual are checkpointed into the tree after each major
iteration, which stops at ``max(threshold, peak_factor * rmax0)``. Each
major iteration's log line carries its figures as ``extra={"cycle": ...}``:
its number, the minor cycle's name, rmax, rms and the minor cycle's own
counts; the recorder times the minor cycle and the residual as the spans
``kclean.minor`` and ``kclean.residual``.

Departures from the JAX function: it takes ``device`` and no
``double_precision`` (the residual runs in the device's type, f64 on the
CPU and f32 on the card, as ``residual_from_parts`` does), and |PSFHAT| is
computed by ``torch.fft`` on the device, not by numpy on the host.
"""

from __future__ import annotations

import numpy as np

from .. import checked_real_dtype, resolve_device, to_device, to_host
from ..deconv.clark import clark
from ..deconv.hogbom import hogbom
from ..ops.psf import psf_to_psfhat
from ..utils.logging import get_logger
from ..utils.profiling import span
from ..utils.store import TreeStore, require_complete
from .imager import residual_from_parts

log = get_logger("KCLEAN")


def kclean(dt_path, niter: int = 5, minor: str = "clark", gamma: float = 0.1, peak_factor: float = 0.15,
           sub_peak_factor: float = 0.75, minor_maxit: int = 50, subminor_maxit: int = 1000, threshold: float = 0.0,
           mask=None, epsilon: float = 1e-7, do_wgridding: bool = True, double_precision: bool | None = None, *,
           device="cuda"):
    """Returns (model, residual) as f64 numpy arrays; progress is
    checkpointed into the tree. ``double_precision`` may only name the
    device's type (f64 on the CPU, f32 on the card): None takes it."""
    rdt = checked_real_dtype(device, double_precision)
    dev = resolve_device(device)
    dt = TreeStore(dt_path, mode="w")
    require_complete(dt)
    attrs = dt.attrs
    nx, ny = attrs["nx"], attrs["ny"]
    nx_psf, ny_psf = attrs["nx_psf"], attrs["ny_psf"]
    band_nodes = [k for k in dt.groups() if k.startswith("band")]
    nband = len(band_nodes)

    wsums = np.zeros(nband)
    residual = np.zeros((nband, nx, ny))
    psf = np.zeros((nband, nx_psf, ny_psf))
    model = np.zeros((nband, nx, ny))
    for b, key in enumerate(band_nodes):
        node = dt.group(key)
        wsums[b] = float(np.asarray(node.read("WSUM"))[0])
        residual[b] = np.asarray(node.read("RESIDUAL" if node.has("RESIDUAL") else "DIRTY"))
        psf[b] = np.asarray(node.read("PSF"))
        if node.has("MODEL"):
            model[b] = np.asarray(node.read("MODEL"))
    wsum = wsums.sum()
    psf_t = to_device(psf / wsum, dev, rdt)
    del psf
    psfhat = psf_to_psfhat(psf_t).abs()
    wsums_t = to_device(wsums / wsum, dev, rdt)
    mask_t = None if mask is None else to_device(mask, dev, rdt)

    rmax0 = np.abs(residual.sum(axis=0) / wsum).max()
    for k in range(niter):
        info = {}
        with span("kclean.minor"):
            dirty_t = to_device(residual / wsum, dev, rdt)
            if minor == "clark":
                dmodel, _, _ = clark(dirty_t, psf_t, psfhat, wsums_t, mask=mask_t, gamma=gamma, pf=peak_factor,
                                     subpf=sub_peak_factor, maxit=minor_maxit, submaxit=subminor_maxit,
                                     threshold=threshold, info=info)
            else:
                dmodel, _, _ = hogbom(dirty_t, psf_t, gamma=gamma, pf=peak_factor, maxit=subminor_maxit,
                                      threshold=threshold, info=info)
            model = model + to_host(dmodel).astype(np.float64)
            del dirty_t, dmodel

        with span("kclean.residual"):
            queued = [residual_from_parts(dt.group(key), model[b], epsilon=epsilon, do_wgridding=do_wgridding,
                                          as_device=True, device=dev) for b, key in enumerate(band_nodes)]
            for b, r in enumerate(queued):  # every band is queued on the device before the first fetch
                residual[b] = to_host(r)
            del queued
        mfs = residual.sum(axis=0) / wsum
        rmax = np.abs(mfs).max()
        rms = np.std(mfs)
        log.info("major %d: rmax=%.3e rms=%.3e", k + 1, rmax, rms,
                 extra={"cycle": dict(iter=k + 1, minor=minor, rmax=float(rmax), rms=float(rms), **info)})

        for b, key in enumerate(band_nodes):
            node = dt.group(key)
            node.write("MODEL", model[b])
            node.write("RESIDUAL", residual[b])
            node.set_attrs(niters=k + 1, rms=float(rms), rmax=float(rmax))

        if rmax < max(threshold, peak_factor * rmax0):
            log.info("reached threshold")
            break
    return model, residual
