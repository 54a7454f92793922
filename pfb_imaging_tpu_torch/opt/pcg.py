"""Preconditioned conjugate gradients (port of pfb_imaging_tpu/opt/pcg.py).

The JAX ``lax.while_loop`` becomes a Python loop; its semantics are kept:
relative-change convergence ``eps = ||x - xp||/||x||``, minimum
iterations, a stall counter (5 stalls with ``|eps_p - eps| < 1e-3 * tol``
terminate), the preconditioner hook ``precond`` (``y = precond(r)``) and the
early exit on a zero initial preconditioned residual.
"""

from __future__ import annotations

import torch


def _norm_diff(x, xp):
    d = x - xp
    num = torch.vdot(d.reshape(-1), d.reshape(-1)).real
    den = torch.clamp(torch.vdot(x.reshape(-1), x.reshape(-1)).real, min=1e-12)
    return torch.sqrt(num / den)


def _dot(a, b):
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def pcg(aop, b, x0=None, precond=None, tol: float = 1e-5, maxit: int = 500, minit: int = 100, info=None):
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
    if not bool((y != 0).any()):
        return x0
    rnorm = _dot(r, y)
    x, p = x0, -y
    k, eps, stall = 0, 1.0, 0
    while (eps > tol or k < minit) and k < maxit and stall < 5:
        ap = aop(p)
        alpha = rnorm / _dot(p, ap)
        xn = x + alpha * p
        r = r + alpha * ap
        y = precond(r)
        rnorm_next = _dot(r, y)
        p = (rnorm_next / rnorm) * p - y
        rnorm = rnorm_next
        eps_n = float(_norm_diff(xn, x))
        stall += int(abs(eps - eps_n) < 1e-3 * tol)
        x, eps, k = xn, eps_n, k + 1
    if info is not None:
        info["niter"] = k
    return x


class PCG:
    """``ForwardSolver`` over a hess with a ``dot`` method, preconditioned by
    ``hess.precond`` where the hess has one."""

    def __init__(self, tol: float = 1e-5, maxit: int = 500, minit: int = 100):
        self.tol = tol
        self.maxit = maxit
        self.minit = minit
        self.niter_last = 0

    def solve(self, hess, residual, x0=None):
        info = {}
        x = pcg(hess.dot, residual, x0=x0, precond=getattr(hess, "precond", None), tol=self.tol, maxit=self.maxit,
                minit=self.minit, info=info)
        self.niter_last = info["niter"]
        return x
