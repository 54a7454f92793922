"""PFBSolver: (hess, forward, backward, regulariser) composed into the PFB
minor cycle (port of pfb_imaging_tpu/deconv/pfb.py). Kept: the gradient
``grad(x) = -H(xtilde - x)/gamma`` with ``xtilde = model + gamma*update``,
the x1.05 hess-norm inflation, ``ReweightOnConverge`` (installed only for a
regulariser that reweights, as ``L21`` does and ``L1`` does not) and the
``reweight_active`` polarity: True means "stop at convergence rather than
trigger reweighting"."""

from __future__ import annotations

import logging
from functools import partial

import torch

from ..ops import LinearOperator, require_protocol
from ..opt import BackwardSolver, ForwardSolver
from ..opt.power_method import power_method

log = logging.getLogger("pfb_tpu.PFB")


class ReweightOnConverge:
    """on_converge callback driving inner l1 reweighting."""

    def __init__(self, regulariser, maxreweight: int = 20, verbosity: int = 1):
        self.reg = regulariser
        self.maxreweight = maxreweight
        self.verbosity = verbosity
        self._num = 0
        self._last_iter = 0

    def reset(self) -> None:
        self._num = 0
        self._last_iter = 0

    def __call__(self, x, k: int, eps: float) -> bool:
        if self.reg.reweight_active and self._num < self.maxreweight:
            self.reg.update_weights(x)
            self._num = self._num + 1 if k - self._last_iter == 1 else 0
            self._last_iter = k
            return False
        if self._num >= self.maxreweight and self.verbosity:
            log.info("Maximum reweighting steps reached")
        return True


def _pfb_grad(hess_dot, xtilde, gamma, x):
    """Gradient of the PFB smooth term."""
    return -hess_dot(xtilde - x) / gamma


class PFBSolver:
    """Preconditioned forward-backward solver (``DeconvSolver``).

    ``model``/``update`` are (nband, nx, ny) tensors on the solver's device,
    this rank's band slice of them under a band ``mesh``. With
    ``hessnorm=None`` the power method estimates it from a start vector
    drawn from ``generator`` (a seeded one on the model's device if None)
    over the WHOLE cube's shape, of which each rank takes its band slice, so
    sharded and unsharded runs start from the same vector.
    """

    def __init__(self, hess, forward_alg, backward_alg, prox, *, model, update, gamma: float = 1.0,
                 hessnorm: float | None = None, l1_reweight_from: int = 5, maxreweight: int = 20,
                 pm_tol: float = 1e-3, pm_maxit: int = 100, verbosity: int = 1, generator=None, mesh=None):
        require_protocol(hess, LinearOperator, "hess")
        require_protocol(forward_alg, ForwardSolver, "forward_alg")
        require_protocol(backward_alg, BackwardSolver, "backward_alg")
        self.hess = hess
        self.forward_alg = forward_alg
        self.backward_alg = backward_alg
        self.reg = prox
        self._model = model
        self._update = update
        self._residual = None
        self._gamma = gamma
        self._l1_reweight_from = l1_reweight_from
        self._iter = 0
        if hessnorm is None:
            log.info("Finding spectral norm of Hessian approximation")
            if generator is None:
                generator = torch.Generator(device=model.device).manual_seed(42)
            nband = model.shape[0] * (1 if mesh is None else mesh.band_size)
            b0 = torch.randn((nband,) + tuple(model.shape[1:]), generator=generator, device=model.device,
                             dtype=model.dtype)
            if mesh is not None:
                b0 = b0[mesh.band_slice(nband)]
            beta, _ = power_method(hess.dot, tuple(model.shape), b0=b0, tol=pm_tol, maxit=pm_maxit, mesh=mesh)
            hessnorm = float(beta) * 1.05
        self.hess_norm = float(hessnorm)
        log.info("Using hess_norm = %.3e", self.hess_norm)
        backward_alg.setup(prox, self.hess_norm)
        self._reweight_cb = None
        if hasattr(prox, "update_weights") and hasattr(prox, "reweight_active"):
            self._reweight_cb = ReweightOnConverge(prox, maxreweight=maxreweight, verbosity=verbosity)
            if getattr(backward_alg, "on_converge", None) is None:
                backward_alg.on_converge = self._reweight_cb

    def first(self, residual) -> None:
        self._residual = residual

    def forward(self, residual):
        if self._residual is None:
            raise RuntimeError("residual not set; call first() before forward()")
        x0 = self._update if bool(self._update.any()) else None
        self._update = self.forward_alg.solve(self.hess, self._residual, x0=x0)
        xtilde = self._model + self._gamma * self._update
        self.backward_alg.set_grad(partial(_pfb_grad, self.hess.dot, xtilde, self._gamma))
        return self._update

    def backward(self, lam: float):
        if self._reweight_cb is not None:
            self._reweight_cb.reset()
        self._model = self.backward_alg.solve(self._model, lam)
        self._iter += 1
        return self._model

    def last(self) -> None:
        if not hasattr(self.reg, "init_reweighting"):
            return
        if self._l1_reweight_from < 0 or self._iter < self._l1_reweight_from:
            return
        log.info("Computing L1 weights")
        self.reg.init_reweighting(self._update)
        self.reg.update_weights(self._model)

    @property
    def reweight_active(self) -> bool:
        if not hasattr(self.reg, "init_reweighting") or self._l1_reweight_from < 0:
            return True
        return self.reg.reweight_active
