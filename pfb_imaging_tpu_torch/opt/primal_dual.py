"""Primal-dual (PDHG) solver (port of pfb_imaging_tpu/opt/primal_dual.py).

Per iteration:
    v_a   = psi_dot(xp)
    v     = dual_update(vp, v_a, lam, sigma)
    v_ext = 2 v - vp
    x     = xp - tau * (psi_hdot(v_ext) + grad(xp))
          (psi_hdot_ext(v, vp) where given: the same, without v_ext)
    x     = primal_prox(x)
    eps   = ||x - xp|| / ||x||

Step sizes: sigma = hessnorm / (2 gamma) / nu unless given, tau = 0.98 /
(hessnorm / (2 gamma) + sigma nu^2), with ``nu`` the squared frame bound
(design D3). A regulariser without a fused ``dual_update_fn`` (``L1``) is
served by the Moreau decomposition through its ``prox_fn``.
Inner l1 reweighting is a host-level outer loop around the inner loop,
and the dual is warm-started across ``solve`` calls. Under a band mesh the
iterates are this rank's band slice: the dual update's band sum (the
regulariser's ``dual_update_fn``) and the stop test are reduced over the
band group, so every rank stops at the same iteration; the stop test reads
the host once an iteration.
"""

from __future__ import annotations

import logging

import torch

from ..ops import PsiOperator, require_protocol
from ..prox.prox_21m import dual_update as _dual_update_21m
from ..utils.profiling import span
from .pcg import stop_eps


def primal_dual_loop(x, v, lam, l1weight, sigma, tau, grad, *, psi_dot, psi_hdot, primal_prox=None,
                     dual_update=_dual_update_21m, tol: float = 1e-5, maxit: int = 1000, minit: int = 1,
                     it_cap: int | None = None, mesh=None, psi_hdot_ext=None):
    """One PDHG run to tolerance. Returns (x, v, niter, eps). ``psi_hdot_ext(vn,
    v)``, where given, stands for ``psi_hdot(2.0 * vn - v)`` (``Psi.hdot_extrapolated``)."""
    cap = maxit if it_cap is None else min(int(it_cap), maxit)
    k, eps = 0, 1.0
    while (eps > tol or k < minit) and k < cap:
        vn = dual_update(v, psi_dot(x), lam, sigma=sigma, weight=l1weight)
        xn = x - tau * ((psi_hdot(2.0 * vn - v) if psi_hdot_ext is None else psi_hdot_ext(vn, v)) + grad(x))
        if primal_prox is not None:
            xn = primal_prox(xn)
        with span("pd.stop"):  # the host waits here for the iteration's norms
            eps = stop_eps(xn, x, mesh)
        x, v, k = xn, vn, k + 1
    return x, v, k, eps


class PrimalDual:
    """``BackwardSolver``: PDHG with a warm dual and reweight-on-converge."""

    def __init__(self, tol: float = 1e-5, maxit: int = 1000, report_freq: int = 10, verbosity: int = 1,
                 gamma: float = 1.0, sigma: float | None = None, on_converge=None, primal_prox=None, *, mesh=None):
        self.tol = tol
        self.mesh = mesh
        self.maxit = maxit
        self.report_freq = report_freq  # JAX's; the port logs once, at the end
        self.verbosity = verbosity
        self.gamma = gamma
        self._sigma_opt = sigma
        self.on_converge = on_converge
        self.primal_prox = primal_prox
        self._grad = None
        self._reg = None
        self._v = None

    def setup(self, prox, hessnorm: float) -> None:
        require_protocol(prox.psi, PsiOperator, "prox.psi")
        self._reg = prox
        self.hessnorm = float(hessnorm)
        nu = prox.nu
        sigma = self._sigma_opt
        if sigma is None:
            sigma = self.hessnorm / (2.0 * self.gamma) / nu
        self.sigma = sigma
        self.tau = 0.98 / (self.hessnorm / (2.0 * self.gamma) + sigma * nu**2)
        psi = prox.psi
        self._v = torch.zeros((psi.nband, psi.nbasis, psi.nymax, psi.nxmax), dtype=psi.dtype, device=psi.device)
        # the regulariser's fused dual update where it has one, else the
        # Moreau decomposition through its prox
        fn = getattr(prox, "dual_update_fn", None)
        if fn is None:
            prox_fn = prox.prox_fn

            def fn(vp, v, lam, sigma=1.0, weight=None):
                vtilde = vp + sigma * v
                return vtilde - sigma * prox_fn(vtilde, lam, sigma=sigma, weight=weight)

        self._dual_fn = fn

    def set_grad(self, grad) -> None:
        self._grad = grad

    def reset(self) -> None:
        if self._v is not None:
            self._v = torch.zeros_like(self._v)

    def solve(self, x, lam: float):
        if self._reg is None:
            raise RuntimeError("regulariser not bound; call setup() before solve()")
        if self._grad is None:
            raise RuntimeError("grad not set; call set_grad() before solve()")
        reg = self._reg
        v = self._v
        budget = self.maxit
        k_total = 0
        eps = 1.0
        while budget > 0:
            x, v, k, eps = primal_dual_loop(
                x, v, lam, getattr(reg, "l1weight", None), self.sigma, self.tau, self._grad,
                psi_dot=reg.psi.dot, psi_hdot=reg.psi.hdot, primal_prox=self.primal_prox,
                dual_update=self._dual_fn, tol=self.tol, maxit=self.maxit, it_cap=budget, mesh=self.mesh,
                psi_hdot_ext=getattr(reg.psi, "hdot_extrapolated", None),
            )
            k_total += k
            budget -= k
            if eps < self.tol:
                if self.on_converge is None or self.on_converge(x, k_total, eps):
                    break
            else:
                break  # maxit exhausted
        self._v = v
        self.niter_last = k_total
        if self.verbosity:
            logging.getLogger("pfb_tpu.PD").info("primal-dual finished after %d iterations, eps=%.3e", k_total, eps)
        return x
