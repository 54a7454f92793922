"""Non-negative least squares minor cycle by FISTA and the power method
(port of pfb_imaging_tpu/deconv/nnls.py).

Minimises ``0.5 x^T H x - x^T dirty`` s.t. ``x >= 0``, H the PSF
convolution. JAX starts the power method from ``PRNGKey(42)``, a draw this
package cannot reproduce: pass ``hessnorm`` or a start vector ``b0`` to
match it; otherwise the start is a standard normal draw from ``generator``
(a ``torch.Generator`` on the device seeded with 42 when None).
"""

from __future__ import annotations

import torch

from .. import as_device, complex_dtype, real_dtype, resolve_device
from ..opt.fista import fista
from ..opt.power_method import power_method
from ..ops.psf import psf_convolve


def nnls(dirty, psfhat, nx_psf: int, ny_psf: int, x0=None, tol: float = 1e-5, maxit: int = 100, hessnorm=None,
         *, b0=None, generator=None, info=None, device="cuda"):
    """The non-negative model for ``dirty`` (nband, nx, ny) and the complex
    ``psfhat`` (nband, nx_psf, ny_psf//2+1), both moved to ``device``.
    ``hessnorm`` is the power method's estimate x 1.05 when None. FISTA's
    iterations and backtracking events go to ``info`` when a dict is
    passed."""
    dev = resolve_device(device)
    rdt = dirty.dtype if torch.is_tensor(dirty) else real_dtype(dev)
    dirty, psfhat = (as_device(a, dev, t) for a, t in ((dirty, rdt), (psfhat, complex_dtype(rdt))))

    def hess(x):
        return psf_convolve(x, psfhat, nx_psf, ny_psf)

    if hessnorm is None:
        if b0 is None and generator is None:
            generator = torch.Generator(device=dev).manual_seed(42)
        hessnorm, _ = power_method(hess, tuple(dirty.shape), b0=b0, tol=1e-4, maxit=200, generator=generator,
                                   device=dev, dtype=rdt)
        hessnorm = float(hessnorm) * 1.05

    def fprime(x):
        hx = hess(x)
        fid = 0.5 * torch.vdot(x.reshape(-1), hx.reshape(-1)).real - torch.vdot(x.reshape(-1), dirty.reshape(-1)).real
        return fid, hx - dirty

    x0 = torch.zeros_like(dirty) if x0 is None else as_device(x0, dev, rdt)
    return fista(fprime, lambda x: x.clamp(min=0.0), x0, float(hessnorm), tol=tol, maxit=maxit, info=info)
