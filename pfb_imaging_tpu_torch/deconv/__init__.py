"""Deconvolution solvers (port of pfb_imaging_tpu/deconv): the minor cycles
(hogbom, clark, nnls), the composable ``PFBSolver`` and the presets, with
the protocols of their seams."""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable


@runtime_checkable
class DeconvSolver(Protocol):
    """The outer major cycle calls, in order:
        solver.first(residual)
        update = solver.forward(residual)
        model = solver.backward(lam)
        solver.last()
        residual = compute_residual(model)   # gridder, always external
    """

    def first(self, residual) -> None: ...

    def forward(self, residual): ...

    def backward(self, lam: float): ...

    def last(self) -> None: ...


@runtime_checkable
class Regulariser(Protocol):
    """Separable regulariser R(x) = g(Psi^T x); owns its own state.

    ``prox_fn(v, lam, sigma, weight)`` is the pure coefficient-domain prox;
    optional extensions sniffed by consumers: ``dual_update_fn`` (fused PD
    fast path), ``init_reweighting``/``update_weights``/``reweight_active``.
    """

    psi: Any
    nu: float

    def prox(self, v, lam, sigma=1.0): ...
