"""The PFB major-cycle step (port of pfb_imaging_tpu/core/step.py): forward
CG against the PSF Hessian, then the primal-dual backward. The exact
residual stays outside (it needs the measurement operator). Under a band x
row mesh (``mesh``) the cubes are this rank's band slice, the Hessian built
on that mesh runs its row-sharded FFT, and the only other collectives are the
band sums of the dual update and of the CG/PD inner products and stop
tests."""

from __future__ import annotations

from functools import partial

from ..deconv.pfb import _pfb_grad
from ..ops.hessian import hess_cube_dot
from ..opt.pcg import pcg
from ..opt.primal_dual import primal_dual_loop
from ..prox.positivity import positivity
from ..prox.prox_21m import dual_update as dual_update_21m


def pfb_major_step(hess, residual, model, update, dual, l1weight, lam, *, psi, gamma: float = 1.0, sigma, tau,
                   cg_tol: float = 1e-4, cg_maxit: int = 100, cg_minit: int = 1, pd_tol: float = 1e-5,
                   pd_maxit: int = 500, pos: bool = True, mesh=None):
    """One full major-cycle step. Returns (model, update, dual)."""
    aop = partial(hess_cube_dot, hess)
    update = pcg(aop, residual, x0=update, tol=cg_tol, maxit=cg_maxit, minit=cg_minit, mesh=mesh)
    xtilde = model + gamma * update
    grad = partial(_pfb_grad, aop, xtilde, gamma)
    model, dual, _, _ = primal_dual_loop(
        model, dual, lam, l1weight, sigma, tau, grad, psi_dot=psi.dot, psi_hdot=psi.hdot,
        primal_prox=positivity if pos else None,
        dual_update=dual_update_21m if mesh is None else partial(dual_update_21m, mesh=mesh), tol=pd_tol,
        maxit=pd_maxit, mesh=mesh,
    )
    return model, update, dual


def pd_step_sizes(hessnorm: float, gamma: float, nu: float):
    """sigma = hessnorm/(2 gamma)/nu, tau = 0.98/(hessnorm/(2 gamma) + sigma nu^2)."""
    sigma = hessnorm / (2.0 * gamma) / nu
    tau = 0.98 / (hessnorm / (2.0 * gamma) + sigma * nu**2)
    return sigma, tau
