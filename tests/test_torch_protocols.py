"""The port's protocols and seam checks, case by case as
``tests/test_protocols.py`` holds the JAX package's: the operators, solvers
and regularisers satisfy their protocols, ``require_protocol`` raises
JAX's ``TypeError``, and ``PFBSolver``, ``L1``, ``L21`` and the backward
solvers' ``setup`` reject bad wiring with it (before this, an
``AttributeError`` deep inside)."""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu.ops import PsiOperator as JPsiOperator
from pfb_imaging_tpu.ops import require_protocol as j_require
from pfb_imaging_tpu_torch.deconv import DeconvSolver, Regulariser
from pfb_imaging_tpu_torch.deconv.pfb import PFBSolver
from pfb_imaging_tpu_torch.deconv.presets import make_ista, make_sara
from pfb_imaging_tpu_torch.ops import LinearOperator, Preconditioner, PsiOperator, require_protocol
from pfb_imaging_tpu_torch.ops.gauss import Gauss
from pfb_imaging_tpu_torch.ops.hessian import HessianCube
from pfb_imaging_tpu_torch.ops.identity_psi import IdentityPsi
from pfb_imaging_tpu_torch.ops.mask import Mask
from pfb_imaging_tpu_torch.ops.precond import HessPSF
from pfb_imaging_tpu_torch.ops.psi import Psi
from pfb_imaging_tpu_torch.opt import BackwardSolver, ForwardSolver
from pfb_imaging_tpu_torch.opt.forward_backward import ForwardBackward
from pfb_imaging_tpu_torch.opt.pcg import PCG
from pfb_imaging_tpu_torch.opt.primal_dual import PrimalDual
from pfb_imaging_tpu_torch.prox.l1 import L1
from pfb_imaging_tpu_torch.prox.l21 import L21

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.float64)


def test_operator_protocols():
    hc = HessianCube.build(np.zeros((1, 1, 8, 5)), np.ones(1), 0.0, 8, 8, device=CPU)
    assert isinstance(hc, LinearOperator)
    assert isinstance(Mask(np.ones((4, 4)), device=CPU), LinearOperator)
    assert isinstance(Psi(1, 16, 16, bases=("self", "db1"), nlevel=1, device=CPU), PsiOperator)
    assert isinstance(IdentityPsi(1, 4, 4, device=CPU), PsiOperator)
    hp = HessPSF(np.ones((1, 8, 5)), 8, 8, device=CPU)
    assert isinstance(hp, LinearOperator) and isinstance(hp, Preconditioner)
    assert isinstance(Gauss(np.ones(1), np.arange(2.0), np.arange(2.0), device=CPU), LinearOperator)


def test_solver_protocols():
    assert isinstance(PCG(), ForwardSolver)
    assert isinstance(PrimalDual(), BackwardSolver)
    assert isinstance(ForwardBackward(), BackwardSolver)


def test_regulariser_protocols():
    psi = IdentityPsi(1, 4, 4, device=CPU)
    assert isinstance(L21(psi, ("self",)), Regulariser)
    assert isinstance(L1(psi), Regulariser)


def test_require_protocol_rejects():
    class NotAnOp:
        pass

    with pytest.raises(TypeError, match="does not satisfy"):
        require_protocol(NotAnOp(), LinearOperator, "hess")
    with pytest.raises(TypeError):
        require_protocol(NotAnOp(), Preconditioner)


def test_require_protocol_message_is_jax_s():
    class OnlyDot:
        def dot(self, x):
            return x

    msgs = []
    for req, proto in ((require_protocol, PsiOperator), (j_require, JPsiOperator)):
        with pytest.raises(TypeError) as e:
            req(OnlyDot(), proto, "psi")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "psi (OnlyDot) does not satisfy PsiOperator; missing attrs: ['hdot']"


def test_pfbsolver_rejects_bad_wiring():
    psi = IdentityPsi(1, 4, 4, device=CPU)
    reg = L1(psi)

    class BadHess:
        pass

    with pytest.raises(TypeError, match="hess \\(BadHess\\) does not satisfy LinearOperator"):
        PFBSolver(BadHess(), PCG(), ForwardBackward(), reg, model=_zeros(1, 4, 4), update=_zeros(1, 4, 4))
    hc = HessianCube.build(np.ones((1, 1, 8, 5)), np.ones(1), 1e-3, 8, 8, device=CPU)
    with pytest.raises(TypeError, match="forward_alg"):
        PFBSolver(hc, object(), ForwardBackward(), reg, model=_zeros(1, 4, 4), update=_zeros(1, 4, 4), hessnorm=1.0)
    with pytest.raises(TypeError, match="backward_alg"):
        PFBSolver(hc, PCG(), PCG(), reg, model=_zeros(1, 4, 4), update=_zeros(1, 4, 4), hessnorm=1.0)


@pytest.mark.parametrize("cls", [L1, lambda psi: L21(psi, ("self",))], ids=["L1", "L21"])
def test_regularisers_reject_a_psi_without_its_methods(cls):
    class NoPsi:
        nbasis, nymax, nxmax, dtype, device = 1, 4, 4, torch.float64, CPU

    with pytest.raises(TypeError, match="psi \\(NoPsi\\) does not satisfy PsiOperator"):
        cls(NoPsi())


@pytest.mark.parametrize("solver", [PrimalDual, ForwardBackward])
def test_backward_setup_rejects_a_psi_without_its_methods(solver):
    reg = L1(IdentityPsi(1, 4, 4, device=CPU))
    reg.psi = object()
    with pytest.raises(TypeError, match="prox.psi"):
        solver().setup(reg, 1.0)


def test_pfbsolver_satisfies_deconv_protocol():
    hc = HessianCube.build(np.abs(np.random.default_rng(0).standard_normal((1, 1, 8, 5))), np.ones(1), 1e-3, 8, 8,
                           device=CPU)
    psi = IdentityPsi(1, 4, 4, device=CPU)
    reg = L1(psi)
    s = PFBSolver(hc, PCG(maxit=5, minit=1), ForwardBackward(maxit=5), reg,
                  model=_zeros(1, 4, 4), update=_zeros(1, 4, 4), hessnorm=1.0)
    assert isinstance(s, DeconvSolver)
    with pytest.raises(RuntimeError, match="residual not set"):
        s.forward(None)


@pytest.mark.parametrize("preset", [make_sara, make_ista])
def test_the_presets_wiring_passes_every_seam(preset):
    """What the presets build for the commands (``HessianCube``, ``Psi``/``IdentityPsi``,
    ``L21``/``L1``, PCG and the backward solver) passes every check."""
    ph = np.abs(np.random.default_rng(1).standard_normal((2, 1, 32, 17)))
    zeros = np.zeros((2, 16, 16))
    s = preset(ph, np.ones(2), dict(nx=16, ny=16, nx_psf=32, ny_psf=32), zeros, zeros, {"hess_norm": 1.0},
               device=CPU)
    assert isinstance(s, DeconvSolver) and isinstance(s.reg, Regulariser)
    assert isinstance(s.reg.psi, PsiOperator) and isinstance(s.hess, LinearOperator)
