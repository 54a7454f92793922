"""Preconditioned conjugate gradients (port of pfb_imaging_tpu/opt/pcg.py).

The JAX ``lax.while_loop`` becomes a Python loop; its semantics are kept:
relative-change convergence ``eps = ||x - xp||/||x||``, minimum
iterations, a stall counter (5 stalls with ``|eps_p - eps| < 1e-3 * tol``
terminate), the preconditioner hook ``precond`` (``y = precond(r)``) and the
early exit on a zero initial preconditioned residual. Every inner
product, norm and stop test over a cube is taken band by band and the
bands added in order (:func:`band_dots`). Under a band mesh (``mesh``) the
cube is this rank's band slice and the bands' values come from the band
group (one ``all_gather`` of a few scalars an iteration), so every rank,
and every band split, gets the same bits and stops at the same iteration.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import band_sum
from ..utils.profiling import count, span


def _dot(a, b):
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def band_dots(mesh, *terms) -> torch.Tensor:
    """Reductions over the whole (band-sharded) cube, one value a term: a
    pair (a, b) gives <a, b>, a single cube the number of bands in which it
    has a nonzero. Axis 0 is the band axis of a cube of three or more axes
    (an image of two is one band); each band's values are computed alone
    (a pair's dot band by band, a cube's nonzero flags for every band in
    one call) and the bands added in order (``parallel.mesh.band_sum``).
    Counts its per-band reductions (terms x bands) as ``band.dots``."""

    def bands(t):
        return t if t.ndim >= 3 else t[None]

    terms = [tuple(bands(a) for a in t) if isinstance(t, tuple) else bands(t) for t in terms]
    first = terms[0][0] if isinstance(terms[0], tuple) else terms[0]
    dtype = first.real.dtype if first.is_complex() else first.dtype
    nb = first.shape[0]
    count("band.dots", len(terms) * nb)
    cols = [torch.stack([_dot(t[0][i], t[1][i]) for i in range(nb)]) if isinstance(t, tuple)
            else (t.reshape(nb, -1) != 0).any(1).to(dtype) for t in terms]
    return band_sum(torch.stack(cols, 1), mesh)


def stop_eps(xn, x, mesh=None) -> float:
    """||xn - x|| / ||xn|| over the whole (band-sharded) cube, or 1.0 where
    xn is all zero: the primal loops' convergence measure, read with one
    host sync."""
    d = xn - x
    t = band_dots(mesh, (d, d), (xn, xn), xn)
    eps, nonzero = torch.stack([torch.sqrt(t[0] / torch.clamp(t[1], min=1e-12)), t[2]]).tolist()
    return eps if nonzero > 0 else 1.0


def pcg(aop, b, x0=None, precond=None, tol: float = 1e-5, maxit: int = 500, minit: int = 100, *, info=None,
        mesh=None):
    """Solve ``aop(x) = b``, preconditioned by ``precond`` (an approximate
    inverse of ``aop``) when it is given. Returns x (same shape as b); the
    iteration count goes to ``info["niter"]`` when a dict is passed."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if precond is None:
        precond = lambda r: r  # noqa: E731
    r = aop(x0) - b
    y = precond(r)
    if info is not None:
        info["niter"] = 0
    red = band_dots(mesh, (r, y), y)
    if not bool(red[1] > 0):
        return x0
    rnorm = red[0]
    x, p = x0, -y
    k, eps, stall = 0, 1.0, 0
    while (eps > tol or k < minit) and k < maxit and stall < 5:
        ap = aop(p)
        alpha = rnorm / band_dots(mesh, (p, ap))[0]
        xn = x + alpha * p
        r = r + alpha * ap
        y = precond(r)
        d = xn - x
        red = band_dots(mesh, (r, y), (d, d), (xn, xn))
        rnorm_next = red[0]
        p = (rnorm_next / rnorm) * p - y
        rnorm = rnorm_next
        with span("cg.stop"):  # the host waits here for the iteration's norms
            eps_n = float(torch.sqrt(red[1] / torch.clamp(red[2], min=1e-12)))
        stall += int(abs(eps - eps_n) < 1e-3 * tol)
        x, eps, k = xn, eps_n, k + 1
    if info is not None:
        info["niter"] = k
    return x


class PCG:
    """``ForwardSolver`` over a hess with a ``dot`` method, preconditioned by
    ``hess.precond`` where the hess has one."""

    def __init__(self, tol: float = 1e-5, maxit: int = 500, minit: int = 100, verbosity: int = 1, *, mesh=None):
        self.tol = tol
        self.maxit = maxit
        self.minit = minit
        self.verbosity = verbosity  # JAX's; neither solver logs
        self.mesh = mesh
        self.niter_last = 0

    def solve(self, hess, residual, x0=None):
        info = {}
        x = pcg(hess.dot, residual, x0=x0, precond=getattr(hess, "precond", None), tol=self.tol, maxit=self.maxit,
                minit=self.minit, info=info, mesh=self.mesh)
        self.niter_last = info["niter"]
        return x
