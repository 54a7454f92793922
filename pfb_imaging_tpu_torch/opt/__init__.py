"""Optimiser protocols (port of pfb_imaging_tpu/opt/__init__.py)."""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class ForwardSolver(Protocol):
    """Solves the forward (preconditioned gradient) step:
    ``update ≈ hess^{-1} residual``."""

    def solve(self, hess, residual, x0=None): ...


@runtime_checkable
class BackwardSolver(Protocol):
    """Solves the backward (proximal) step.

    Lifecycle: ``setup`` binds the regulariser and step sizes once;
    ``set_grad`` is called each major cycle; ``solve`` iterates; ``reset``
    drops warm-start state (e.g. the dual variable).
    """

    def setup(self, prox, hessnorm): ...

    def set_grad(self, grad): ...

    def solve(self, x, lam): ...

    def reset(self): ...
