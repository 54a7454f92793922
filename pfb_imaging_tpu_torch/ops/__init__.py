"""Mathematical operators (port of pfb_imaging_tpu/ops). The seams are
runtime-checkable protocols, as in JAX: an operator is any object with the
methods below, on tensors."""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class LinearOperator(Protocol):
    """Linear operator on image cubes and its adjoint."""

    def dot(self, x): ...

    def hdot(self, x): ...


@runtime_checkable
class Preconditioner(Protocol):
    """Operator with an (approximate) inverse application."""

    def dot(self, x): ...

    def idot(self, x, **kw): ...
