"""Spectral-norm estimation by the power method (port of
pfb_imaging_tpu/opt/power_method.py). PFBSolver inflates the result by
1.05 before using it as ``hess_norm``. The Rayleigh quotient's inner
products and the norms are taken band by band (``opt.pcg.band_dots``);
under a band mesh (``mesh``) ``b`` is this rank's band slice and the
bands' values come from the band group, one ``all_gather`` an iteration."""

from __future__ import annotations

import torch

from .pcg import band_dots


def power_method(aop, imsize, b0=None, tol: float = 1e-5, maxit: int = 250, *, generator=None,
                 device=None, dtype=None, mesh=None):
    """Largest eigenvalue of the symmetric operator ``aop``.

    The start vector is ``b0`` or, when that is None, a standard normal draw
    of shape ``imsize`` from ``generator`` on ``device``. Returns (beta, b).
    """
    if b0 is None:
        if generator is None:
            raise ValueError("power_method needs a start vector b0 or a torch.Generator")
        b0 = torch.randn(imsize, generator=generator, device=device, dtype=dtype)
    b = b0 / torch.sqrt(band_dots(mesh, (b0, b0))[0])
    beta = torch.ones((), dtype=b.dtype, device=b.device)
    eps, k = 1.0, 0
    while eps > tol and k < maxit:
        bn = aop(b)
        red = band_dots(mesh, (b, bn), (b, b), (bn, bn))
        betan, b = red[0] / red[1], bn / torch.sqrt(red[2])
        eps = float((betan - beta).abs() / torch.clamp(beta, min=1e-300))
        beta, k = betan, k + 1
    return beta, b
