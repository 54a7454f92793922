"""Minor-cycle preset factories (port of pfb_imaging_tpu/deconv/presets.py).
Kept: nu = len(bases) (design D3) and total-wsum normalisation with
per-band eta (design D4, inside HessianCube.build).

Each factory takes numpy inputs: abspsfhat_per_band (nband, npart, nx_psf,
ny_psf//2+1) |PSFHAT|; wsums (nband,) raw per-band weight sums; geometry a
dict with nx, ny, nx_psf, ny_psf; model, update (nband, nx, ny) warm starts.
With a ``mesh`` (``parallel.mesh``) the solver holds this rank's band slice:
wsums stay global, the cubes may be given whole or already sliced, and every
band reduction of the solvers and the regulariser runs over the band group;
a mesh with a row axis larger than 1 also shards the PSF Hessian's FFT
(``transposed=True``: |PSFHAT| is already in ``parallel.fft``'s transposed
layout).
"""

from __future__ import annotations

import numpy as np

from .. import real_dtype, to_device
from ..ops.hessian import HessianCube
from ..ops.identity_psi import IdentityPsi
from ..ops.psi import Psi
from ..opt.forward_backward import ForwardBackward
from ..opt.pcg import PCG
from ..opt.primal_dual import PrimalDual
from ..prox.l1 import L1
from ..prox.l21 import L21
from ..prox.positivity import positivity_prox
from .pfb import PFBSolver

DEFAULT_OPTS = dict(
    bases="self,db1,db2",
    nlevels=2,
    eta=1e-5,
    gamma=1.0,
    hess_norm=None,
    rmsfactor=1.0,
    alpha=2.0,
    positivity=1,
    opt_backend="primal-dual",
    cg_tol=1e-3,
    cg_maxit=100,
    cg_minit=1,
    pd_tol=1e-5,
    pd_maxit=1000,
    pd_verbose=0,
    fb_tol=1e-5,
    fb_maxit=1000,
    fb_verbose=0,
    acceleration=True,
    l1_reweight_from=5,
    pm_tol=1e-3,
    pm_maxit=100,
    verbosity=1,
)


def _opts_with_defaults(opts):
    merged = dict(DEFAULT_OPTS)
    merged.update(opts or {})
    return merged


def _build_hess(abspsfhat_per_band, wsums, geometry, opts, beam_per_band, device, mesh=None, transposed=False):
    return HessianCube.build(abspsfhat_per_band, np.asarray(wsums, dtype=float), opts["eta"], geometry["nx_psf"],
                             geometry["ny_psf"], beam=beam_per_band, mesh=mesh, transposed=transposed, device=device)


def _forward_backward(opts, acceleration: bool, mesh=None):
    return ForwardBackward(tol=opts["fb_tol"], maxit=opts["fb_maxit"], verbosity=opts["fb_verbose"],
                           gamma=opts["gamma"], acceleration=acceleration,
                           primal_prox=positivity_prox(opts["positivity"]), mesh=mesh)


def _build_backward(opts, mesh=None):
    if opts["opt_backend"] == "primal-dual":
        return PrimalDual(tol=opts["pd_tol"], maxit=opts["pd_maxit"], verbosity=opts["pd_verbose"],
                          gamma=opts["gamma"], primal_prox=positivity_prox(opts["positivity"]), mesh=mesh)
    if opts["opt_backend"] == "forward-backward":
        return _forward_backward(opts, opts["acceleration"], mesh)
    raise ValueError(f"Unknown opt_backend '{opts['opt_backend']}'")


def _solver(hess, bwd, reg, model, update, opts, device, mesh):
    dtype = real_dtype(device)
    fwd = PCG(tol=opts["cg_tol"], maxit=opts["cg_maxit"], minit=opts["cg_minit"], mesh=mesh)
    return PFBSolver(
        hess, fwd, bwd, reg, model=to_device(model, device, dtype), update=to_device(update, device, dtype),
        gamma=opts["gamma"], hessnorm=opts["hess_norm"], l1_reweight_from=opts["l1_reweight_from"],
        pm_tol=opts["pm_tol"], pm_maxit=opts["pm_maxit"], verbosity=opts["verbosity"], mesh=mesh,
    )


def make_sara(abspsfhat_per_band, wsums, geometry, model, update, opts=None, beam_per_band=None, mesh=None,
              transposed=False, *, device="cuda"):
    """SARA: l21 over the wavelet dictionary, primal-dual or forward-backward
    backward (``opt_backend``). Under a band ``mesh``, ``abspsfhat_per_band``,
    ``model``, ``update`` and ``beam_per_band`` are this rank's band slice;
    ``wsums`` holds every band."""
    opts = _opts_with_defaults(opts)
    bwd = _build_backward(opts, mesh)
    bases = tuple(opts["bases"].split(",")) if isinstance(opts["bases"], str) else tuple(opts["bases"])
    psi = Psi(model.shape[0], geometry["nx"], geometry["ny"], bases=bases, nlevel=opts["nlevels"], device=device)
    reg = L21(psi, bases, nu=len(bases), rmsfactor=opts["rmsfactor"], alpha=opts["alpha"], mesh=mesh)
    hess = _build_hess(abspsfhat_per_band, wsums, geometry, opts, beam_per_band, device, mesh, transposed)
    return _solver(hess, bwd, reg, model, update, opts, device, mesh)


def make_ista(abspsfhat_per_band, wsums, geometry, model, update, opts=None, beam_per_band=None, mesh=None,
              transposed=False, *, device="cuda"):
    """ISTA: image-domain l1, forward-backward without acceleration; under a
    band ``mesh`` the cubes are this rank's band slice, as in
    :func:`make_sara`."""
    opts = _opts_with_defaults(opts)
    reg = L1(IdentityPsi(model.shape[0], geometry["nx"], geometry["ny"], device=device))
    hess = _build_hess(abspsfhat_per_band, wsums, geometry, opts, beam_per_band, device, mesh, transposed)
    return _solver(hess, _forward_backward(opts, False, mesh), reg, model, update, opts, device, mesh)


PRESETS = {"sara": make_sara, "ista": make_ista}
