"""Mathematical operators (port of pfb_imaging_tpu/ops). The seams are
runtime-checkable protocols, as in JAX: an operator is any object with the
methods below, on tensors, and ``require_protocol`` rejects any other at
the seam where it is passed in."""

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


@runtime_checkable
class PsiOperator(Protocol):
    """Sparsity dictionary: analysis ``dot`` (image -> coeffs) and
    synthesis ``hdot`` (coeffs -> image)."""

    def dot(self, x): ...

    def hdot(self, alpha): ...


def require_protocol(obj, protocol: type, name: str = "operator") -> None:
    """Raise ``TypeError`` naming the missing attributes when ``obj`` does
    not satisfy ``protocol``."""
    if not isinstance(obj, protocol):
        missing = [m for m in getattr(protocol, "__protocol_attrs__", []) if not hasattr(obj, m)]
        raise TypeError(f"{name} ({type(obj).__name__}) does not satisfy {protocol.__name__}; missing attrs: {missing}")
