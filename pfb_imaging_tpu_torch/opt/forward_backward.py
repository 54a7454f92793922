"""Forward-backward splitting with optional FISTA momentum (port of
pfb_imaging_tpu/opt/forward_backward.py), a host loop on tensors as in
``opt/primal_dual.py``.

Per iteration, from the extrapolated point y:
    x     = y - step * grad(y)
    x     = x + Psi(prox_g(Psi^T x) - Psi^T x) / nu      (then primal_prox)
    eps   = ||x - x_prev|| / ||x||
    y     = x + (t - 1) / t_next * (x - x_prev)          (acceleration)
"""

from __future__ import annotations

import logging
import math

from ..ops import PsiOperator, require_protocol
from .pcg import stop_eps

log = logging.getLogger("pfb_tpu.FB")


def forward_backward_loop(x, lam, weight, step, grad, *, psi_dot, psi_hdot, prox_fn, primal_prox=None,
                          nu: float = 1.0, acceleration: bool = True, tol: float = 1e-5, maxit: int = 1000,
                          mesh=None):
    """One run to tolerance or ``maxit``. Returns (x, niter, eps). Under a
    band mesh the stop test is reduced over the band group."""

    def apply_prox(xc):
        alpha = psi_dot(xc)
        alpha_p = prox_fn(alpha, step * lam, sigma=1.0, weight=weight)
        xc = xc + psi_hdot(alpha_p - alpha) / nu
        return xc if primal_prox is None else primal_prox(xc)

    y, t, k, eps = x, 1.0, 0, 1.0
    while eps > tol and k < maxit:
        xn = apply_prox(y - step * grad(y))
        eps = stop_eps(xn, x, mesh)
        if acceleration:
            tn = (1.0 + math.sqrt(1.0 + 4.0 * t**2)) / 2.0
            y = xn + (t - 1.0) / tn * (xn - x)
            t = tn
        else:
            y = xn
        x, k = xn, k + 1
    return x, k, eps


class ForwardBackward:
    """``BackwardSolver`` by forward-backward / FISTA with reweight-on-converge.

    As in the JAX solver, each re-entry after a convergence that
    ``on_converge`` declines runs up to ``maxit`` iterations again while
    the budget shrinks by the iterations taken."""

    def __init__(self, tol: float = 1e-5, maxit: int = 1000, report_freq: int = 10, verbosity: int = 1,
                 gamma: float = 1.0, acceleration: bool = True, on_converge=None, primal_prox=None, *, mesh=None):
        self.tol = tol
        self.mesh = mesh
        self.maxit = maxit
        self.report_freq = report_freq  # JAX's; the port logs once, at the end
        self.verbosity = verbosity
        self.gamma = gamma
        self.acceleration = acceleration
        self.on_converge = on_converge
        self.primal_prox = primal_prox
        self._grad = None
        self._reg = None
        self.niter_last = 0

    def setup(self, prox, hessnorm: float) -> None:
        require_protocol(prox.psi, PsiOperator, "prox.psi")
        self._reg = prox
        self.hessnorm = float(hessnorm)
        self.step = 2.0 * self.gamma / self.hessnorm

    def set_grad(self, grad) -> None:
        self._grad = grad

    def reset(self) -> None:
        """No warm-start state beyond x itself."""

    def solve(self, x, lam: float):
        if self._reg is None:
            raise RuntimeError("regulariser not bound; call setup() before solve()")
        if self._grad is None:
            raise RuntimeError("grad not set; call set_grad() before solve()")
        reg = self._reg
        budget = self.maxit
        k_total, eps = 0, 1.0
        while budget > 0:
            x, k, eps = forward_backward_loop(
                x, lam, getattr(reg, "l1weight", None), self.step, self._grad, psi_dot=reg.psi.dot,
                psi_hdot=reg.psi.hdot, prox_fn=reg.prox_fn, primal_prox=self.primal_prox, nu=reg.nu,
                acceleration=self.acceleration, tol=self.tol, maxit=self.maxit, mesh=self.mesh,
            )
            k_total += k
            budget -= k
            if eps < self.tol:
                if self.on_converge is None or self.on_converge(x, k_total, eps):
                    break
            else:
                break
        self.niter_last = k_total
        if self.verbosity:
            log.info("forward-backward finished after %d iterations, eps=%.3e", k_total, eps)
        return x
