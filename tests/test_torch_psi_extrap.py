"""``Psi.hdot_extrapolated(vn, v)``, the synthesis of a primal-dual
iteration's ``2 vn - v``, on the CPU: its plain path equals
``hdot(2.0 * vn - v)`` bit for bit (f32 and f64; SARA's nine bases and the
deconv's default three; odd and non-square shapes; nband 1, 4 and 16);
``primal_dual_loop`` returns the same ``(x, v, niter)`` bits with and
without ``psi_hdot_ext``; ``PrimalDual.solve`` and ``pfb_major_step`` take
the operator's ``hdot_extrapolated`` where it has one, and the tracer's
``psi.extrap`` counts one call a PD iteration with a ``Psi``, none with
``IdentityPsi`` or in forward-backward. The card's two-cube P2 is held to
the same in ``tests/test_torch_psi_kernel.py``."""

from functools import partial

import numpy as np
import pytest
import torch

from pfb_imaging_tpu_torch.core.step import pd_step_sizes, pfb_major_step
from pfb_imaging_tpu_torch.ops.hessian import HessianCube
from pfb_imaging_tpu_torch.ops.identity_psi import IdentityPsi
from pfb_imaging_tpu_torch.ops.psi import Psi
from pfb_imaging_tpu_torch.opt.forward_backward import ForwardBackward
from pfb_imaging_tpu_torch.opt.primal_dual import PrimalDual, primal_dual_loop
from pfb_imaging_tpu_torch.prox.l1 import L1
from pfb_imaging_tpu_torch.prox.l21 import L21
from pfb_imaging_tpu_torch.prox.positivity import positivity
from pfb_imaging_tpu_torch.prox.prox_21m import dual_update
from torch_recorder import recording

torch.set_num_threads(1)
CPU = torch.device("cpu")
SARA = ("self",) + tuple(f"db{p}" for p in range(1, 9))
DECONV = ("self", "db1", "db2")
# (nx, ny), nband
SHAPES = {"odd_nonsquare_1": ((67, 61), 1), "even_nonsquare_4": ((64, 74), 4), "odd_square_16": ((61, 61), 16)}


def _cubes(psi, nband, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (nband, psi.nbasis, psi.nymax, psi.nxmax)
    return torch.randn(shape, generator=g, dtype=dtype), torch.randn(shape, generator=g, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("bases", [SARA, DECONV], ids=["sara", "deconv"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_path_is_hdot_of_the_extrapolation(shape, bases, dtype):
    (nx, ny), nband = SHAPES[shape]
    psi = Psi(nband, nx, ny, bases=bases, nlevel=2, device=CPU)
    vn, v = _cubes(psi, nband, dtype, seed=nx * ny + nband)
    out = psi.hdot_extrapolated(vn, v)
    assert out.dtype == dtype and out.shape == (nband, nx, ny)
    assert torch.equal(out, psi.hdot(2.0 * vn - v))


def _pd_problem(nband=2, nx=24, ny=20, bases=DECONV):
    psi = Psi(nband, nx, ny, bases=bases, nlevel=2, device=CPU)
    g = torch.Generator().manual_seed(7)
    b = torch.randn((nband, nx, ny), generator=g, dtype=torch.float64)
    l1w = torch.ones((psi.nbasis, psi.nymax, psi.nxmax), dtype=torch.float64)
    return psi, b, l1w


@pytest.mark.parametrize("tol", [0.0, 1e-2], ids=["maxit", "to_tolerance"])
def test_primal_dual_loop_same_bits_with_and_without_the_fused_synthesis(tol):
    psi, b, l1w = _pd_problem()
    x0 = torch.zeros_like(b)
    v0 = torch.zeros((b.shape[0], psi.nbasis, psi.nymax, psi.nxmax), dtype=torch.float64)
    grad = lambda x: x - b  # noqa: E731
    sigma, tau = pd_step_sizes(1.0, 1.0, psi.nbasis)
    runs = [primal_dual_loop(x0, v0, 0.05, l1w, sigma, tau, grad, psi_dot=psi.dot, psi_hdot=psi.hdot,
                             primal_prox=positivity, dual_update=dual_update, tol=tol, maxit=300, psi_hdot_ext=ext)
            for ext in (None, psi.hdot_extrapolated)]
    (xa, va, ka, ea), (xb, vb, kb, eb) = runs
    assert ka == kb and (ka == 300) == (tol == 0.0)
    assert torch.equal(xa, xb) and torch.equal(va, vb) and ea == eb
    assert not torch.equal(xa, x0)


def test_extrap_counts_one_a_pd_iteration_with_psi():
    psi, b, _ = _pd_problem()
    pd = PrimalDual(tol=0.0, maxit=7, verbosity=0)
    pd.setup(L21(psi, DECONV), hessnorm=1.0)
    pd.set_grad(lambda x: x - b)
    with recording() as got:
        pd.solve(torch.zeros_like(b), 0.05)
    assert pd.niter_last == 7
    assert got["counters"]["psi.extrap"] == 7


def test_extrap_counts_nothing_with_identity_psi():
    b = torch.randn((1, 8, 8), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    psi = IdentityPsi(1, 8, 8, device=CPU)
    assert not hasattr(psi, "hdot_extrapolated")
    pd = PrimalDual(tol=0.0, maxit=6, verbosity=0)
    pd.setup(L1(psi), hessnorm=1.0)
    pd.set_grad(lambda x: x - b)
    with recording() as got:
        pd.solve(torch.zeros_like(b), 0.3)
    assert pd.niter_last == 6
    assert got["counters"].get("psi.extrap", 0) == 0


def test_extrap_counts_nothing_in_forward_backward():
    psi, b, _ = _pd_problem()
    fb = ForwardBackward(tol=0.0, maxit=5, verbosity=0)
    fb.setup(L21(psi, DECONV), hessnorm=1.0)
    fb.set_grad(lambda x: x - b)
    with recording() as got:
        fb.solve(torch.zeros_like(b), 0.05)
    assert fb.niter_last == 5
    assert got["counters"].get("psi.extrap", 0) == 0


def test_major_step_takes_the_fused_synthesis():
    nband, nx, nxp = 2, 24, 48
    psi, b, l1w = _pd_problem(nband, nx, nx)
    kx = np.fft.fftfreq(nxp)[:, None]
    ky = np.fft.rfftfreq(nxp)[None, :]
    ph = np.exp(-(kx**2 + ky**2) / 0.02)
    abspsfhat = np.stack([np.stack([ph, ph]) for _ in range(nband)])  # as tests/test_torch_solvers.py builds it
    hess = HessianCube.build(abspsfhat, np.ones(nband), 1e-2, nxp, nxp, device=CPU)
    dual = torch.zeros((nband, psi.nbasis, psi.nymax, psi.nxmax), dtype=torch.float64)
    step = partial(pfb_major_step, hess, b, torch.zeros_like(b), torch.zeros_like(b), dual, l1w, 0.01, psi=psi,
                   sigma=0.5, tau=0.5, cg_maxit=5, pd_tol=0.0, pd_maxit=4)
    with recording() as got:
        model, _, dual_out = step()
    assert got["counters"]["psi.extrap"] == 4
    assert not torch.equal(dual_out, dual) and bool((model >= 0).all())
