"""Clark CLEAN minor cycle, single and full Stokes (port of
pfb_imaging_tpu/deconv/clark.py).

An active set of pixels above ``subpf * rmax`` is cleaned by a cheap
subminor peak-subtract loop (PSF windows only); then the whole residual is
recomputed once per major iteration by the FFT PSF convolution. The active
set is a dense mask and each subtraction a masked full-image update, as in
the JAX package. The subminor runs on the device in blocks of
``hogbom.BLOCK`` iterations with a device-side ``live`` flag (see
``deconv/hogbom.py``), so the host reads its condition once a block.

dirty/psf are wsum-normalised so ``wsums.sum() == 1`` and MFS images are in
Jy/beam. The single-Stokes functions are the full-Stokes ones with one
correlation: the power over a single correlation is its square exactly.
"""

from __future__ import annotations

import torch

from ..ops.psf import psf_convolve
from .hogbom import BLOCK, add_at_pixel, peak, pixel, psf_window


def _mfs_power(res, mask):
    """sum_corr (sum_band res)^2 * mask: (nx, ny)."""
    return (res.sum(0) ** 2).sum(0) * mask


def fssubminor(residual, psf, active, model, wsums, gamma: float = 0.05, th: float = 0.0, maxit: int = 1000,
               info: dict | None = None):
    """Full-Stokes peak-subtract within the active set: peak search on the
    total polarisation power, every correlation cleaned at the peak.

    residual/model: (nband, ncorr, nx, ny); psf: (nband, ncorr, nx_psf,
    ny_psf); active: (nx, ny) bool; wsums: (nband, ncorr). Returns the
    model (a new tensor); ``info["niter"]`` gets the iterations run."""
    nx, ny = residual.shape[-2:]
    fsel = wsums > 0
    safe_wsums = torch.where(fsel, wsums, torch.ones_like(wsums))
    zero = torch.zeros_like(wsums)
    model = model.clone()
    res = residual
    pq, p, q, amax = peak(_mfs_power(res, active), ny)
    k = torch.zeros((), dtype=torch.int64, device=residual.device)

    def live_now():
        return (amax > th) & (k < maxit)

    while bool(live_now()):
        for _ in range(BLOCK):
            live = live_now()
            xw = pixel(res, pq) / safe_wsums
            add_at_pixel(model, pq, gamma * torch.where(fsel, xw, zero) * live)
            sub = (gamma * xw * live)[:, :, None, None] * psf_window(psf, p, q, nx, ny)
            # inactive pixels are recomputed exactly by the caller's FFT
            # convolution; only active ones matter for the search
            res = res - sub * active
            pq, p, q, amax = peak(_mfs_power(res, active), ny)
            k = k + live
    if info is not None:
        info["niter"] = int(k)
    return model


def subminor(residual, psf, active, model, wsums, gamma: float = 0.05, th: float = 0.0, maxit: int = 1000,
             info: dict | None = None):
    """Single-Stokes peak-subtract within the active set. residual/model:
    (nband, nx, ny); psf: (nband, nx_psf, ny_psf); wsums: (nband,)."""
    return fssubminor(residual[:, None], psf[:, None], active, model[:, None], wsums[:, None], gamma=gamma, th=th,
                      maxit=maxit, info=info)[:, 0]


def fsclark(dirty, psf, psfhat, wsums, mask=None, threshold: float = 0.0, gamma: float = 0.05, pf: float = 0.05,
            maxit: int = 50, subpf: float = 0.5, submaxit: int = 1000, *, info: dict | None = None):
    """Full-Stokes Clark CLEAN: dirty (nband, ncorr, nx, ny) wsum-normalised
    per correlation, psf (nband, ncorr, nx_psf, ny_psf), psfhat its rfft2,
    wsums (nband, ncorr). A host loop over major iterations. Returns
    (model, residual, status); ``info`` gets the major iterations
    (``niter``) and the subminor's summed over them (``subminor_niter``)."""
    nx, ny = dirty.shape[-2:]
    nx_psf, ny_psf = psf.shape[-2:]
    if mask is None:
        mask = torch.ones((nx, ny), dtype=dirty.dtype, device=dirty.device)
    model = torch.zeros_like(dirty)
    residual = dirty
    rmax = float(peak(_mfs_power(residual, mask), ny)[3])
    tol = max(pf * rmax, threshold)
    k, stall, sub_iters = 0, 0, 0
    while rmax > tol and k < maxit and stall < 5:
        subth = subpf * rmax
        active = _mfs_power(residual, mask) > subth**2
        sub = {}
        model = fssubminor(residual, psf, active, model, wsums, gamma=gamma, th=subth, maxit=submaxit, info=sub)
        sub_iters += sub["niter"]
        residual = dirty - psf_convolve(model, psfhat, nx_psf, ny_psf)
        rmax_p = rmax
        rmax = float(peak(_mfs_power(residual, mask), ny)[3])
        k += 1
        if abs(rmax_p - rmax) / abs(rmax_p) < 1e-3:
            stall += 1
    if info is not None:
        info.update(niter=k, subminor_niter=sub_iters)
    status = 1 if (k >= maxit or stall >= 5) else 0
    return model, residual, status


def clark(dirty, psf, psfhat, wsums, mask=None, threshold: float = 0.0, gamma: float = 0.05, pf: float = 0.05,
          maxit: int = 50, subpf: float = 0.5, submaxit: int = 1000, verbosity: int = 1, *,
          info: dict | None = None):
    """Clark CLEAN on (nband, nx, ny) cubes (psf (nband, nx_psf, ny_psf),
    psfhat its rfft2, wsums (nband,)). Returns (model, residual, status).
    ``verbosity`` keeps JAX's position; neither package's loop logs."""
    model, residual, status = fsclark(dirty[:, None], psf[:, None], psfhat[:, None], wsums[:, None], mask=mask,
                                      threshold=threshold, gamma=gamma, pf=pf, maxit=maxit, subpf=subpf,
                                      submaxit=submaxit, info=info)
    return model[:, 0], residual[:, 0], status
