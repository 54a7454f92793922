"""Port parity of the solvers: pcg, primal_dual_loop, power_method and the
jitted major step, against the JAX package on the same operator and the
same numpy start vectors, in f64 on the CPU.

Tolerances are set to 0 so both sides run exactly ``maxit`` iterations;
the iterates then agree to accumulated f64 rounding (<= 1e-9 relative)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.core.step import pfb_major_step as j_major_step
from pfb_imaging_tpu.ops.hessian import HessianCube as JHess
from pfb_imaging_tpu.ops.hessian import hess_cube_dot as j_hdot
from pfb_imaging_tpu.ops.psi import Psi as JPsi
from pfb_imaging_tpu.opt.pcg import pcg as j_pcg
from pfb_imaging_tpu.opt.power_method import power_method as j_power
from pfb_imaging_tpu.opt.primal_dual import primal_dual_loop as j_pd_loop
from pfb_imaging_tpu.deconv.pfb import _pfb_grad as j_grad
from pfb_imaging_tpu.prox.positivity import positivity as j_positivity
from pfb_imaging_tpu_torch.core.step import pd_step_sizes, pfb_major_step
from pfb_imaging_tpu_torch.deconv.pfb import _pfb_grad
from pfb_imaging_tpu_torch.ops.hessian import HessianCube
from pfb_imaging_tpu_torch.ops.psi import Psi
from pfb_imaging_tpu_torch.opt.pcg import PCG, pcg
from pfb_imaging_tpu_torch.opt.power_method import power_method
from pfb_imaging_tpu_torch.opt.primal_dual import primal_dual_loop
from pfb_imaging_tpu_torch.prox.positivity import positivity

torch.set_num_threads(1)
CPU = torch.device("cpu")
NB, NX, NXP = 2, 24, 48
BASES = ("self", "db1", "db2")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    # a PSF-like |PSFHAT| (smooth, positive) keeps the Hessian well-posed
    kx = np.fft.fftfreq(NXP)[:, None]
    ky = np.fft.rfftfreq(NXP)[None, :]
    ph = np.exp(-(kx**2 + ky**2) / 0.02)
    abspsfhat = np.stack([np.stack([ph * rng.uniform(0.8, 1.2), ph * rng.uniform(0.8, 1.2)]) for _ in range(NB)])
    wsums = rng.uniform(1.0, 2.0, NB)
    b = rng.standard_normal((NB, NX, NX))
    x0 = rng.standard_normal((NB, NX, NX))
    return dict(
        abspsfhat=abspsfhat, wsums=wsums, b=b, x0=x0,
        hj=JHess.build(abspsfhat, wsums, 1e-2, NXP, NXP),
        ht=HessianCube.build(abspsfhat, wsums, 1e-2, NXP, NXP, device=CPU),
    )


@pytest.mark.parametrize("warm", [False, True])
def test_pcg_matches_jax(problem, warm):
    x0 = problem["x0"] if warm else None
    xj = j_pcg(partial(j_hdot, problem["hj"]), jnp.asarray(problem["b"]),
               x0=None if x0 is None else jnp.asarray(x0), tol=0.0, maxit=12, minit=1)
    info = {}
    xt = pcg(problem["ht"].dot, torch.as_tensor(problem["b"]),
             x0=None if x0 is None else torch.as_tensor(x0), tol=0.0, maxit=12, minit=1, info=info)
    assert info["niter"] == 12
    assert _rel(xt, xj) < 1e-9


def test_pcg_class_counts_iterations(problem):
    solver = PCG(tol=1e-30, maxit=7, minit=1)  # far from converged after 7
    solver.solve(problem["ht"], torch.as_tensor(problem["b"]))
    assert solver.niter_last == 7


def test_pcg_zero_rhs_returns_x0(problem):
    zero = torch.zeros(NB, NX, NX, dtype=torch.float64)
    out = pcg(problem["ht"].dot, zero, tol=0.0, maxit=5)
    assert torch.count_nonzero(out) == 0


def test_power_method_matches_jax(problem):
    b0 = np.random.default_rng(3).standard_normal((NB, NX, NX))
    bj, vj = j_power(partial(j_hdot, problem["hj"]), b0.shape, b0=jnp.asarray(b0), tol=0.0, maxit=25)
    bt, vt = power_method(problem["ht"].dot, b0.shape, b0=torch.as_tensor(b0), tol=0.0, maxit=25)
    assert abs(float(bt) - float(bj)) / abs(float(bj)) < 1e-9
    assert _rel(vt, vj) < 1e-9


def test_power_method_needs_b0_or_generator(problem):
    with pytest.raises(ValueError):
        power_method(problem["ht"].dot, (NB, NX, NX))
    gen = torch.Generator(device=CPU).manual_seed(1)
    beta, _ = power_method(problem["ht"].dot, (NB, NX, NX), generator=gen, device=CPU, dtype=torch.float64,
                           tol=1e-8, maxit=200)
    assert float(beta) > 0


def _pd_inputs(problem):
    rng = np.random.default_rng(4)
    x = np.abs(rng.standard_normal((NB, NX, NX))) * 0.1
    xtilde = rng.standard_normal((NB, NX, NX))
    pj = JPsi(NB, NX, NX, bases=BASES, nlevel=2)
    pt = Psi(NB, NX, NX, bases=BASES, nlevel=2, device=CPU)
    v = rng.standard_normal((NB, len(BASES), pt.nymax, pt.nxmax)) * 0.01
    w = rng.uniform(0.5, 1.5, (len(BASES), pt.nymax, pt.nxmax))
    return x, xtilde, v, w, pj, pt


def test_primal_dual_loop_matches_jax(problem):
    x, xtilde, v, w, pj, pt = _pd_inputs(problem)
    lam = 0.05
    sigma, tau = pd_step_sizes(2.0, 1.0, len(BASES))
    gj = jax.tree_util.Partial(j_grad, jax.tree_util.Partial(j_hdot, problem["hj"]), jnp.asarray(xtilde), 1.0)
    arr = lambda a: jnp.asarray(np.full(1, a))  # noqa: E731
    xj, vj, kj, _ = j_pd_loop(jnp.asarray(x), jnp.asarray(v), arr(lam), jnp.asarray(w), arr(sigma), arr(tau), gj,
                              psi_dot=pj.dot, psi_hdot=pj.hdot, primal_prox=j_positivity, tol=0.0, maxit=15)
    gt = partial(_pfb_grad, problem["ht"].dot, torch.as_tensor(xtilde), 1.0)
    xt, vt, kt, _ = primal_dual_loop(torch.as_tensor(x), torch.as_tensor(v), lam, torch.as_tensor(w), sigma, tau,
                                     gt, psi_dot=pt.dot, psi_hdot=pt.hdot, primal_prox=positivity, tol=0.0,
                                     maxit=15)
    assert int(kj) == kt == 15
    assert _rel(xt, xj) < 1e-9
    assert _rel(vt, vj) < 1e-9


def test_pfb_major_step_matches_jax(problem):
    x, xtilde, v, w, pj, pt = _pd_inputs(problem)
    resid = problem["b"] * 0.1
    lam = 0.02
    sigma, tau = pd_step_sizes(2.0, 1.0, len(BASES))
    arr = lambda a: jnp.asarray(np.full(1, a))  # noqa: E731
    kw = dict(cg_tol=0.0, cg_maxit=6, cg_minit=1, pd_tol=0.0, pd_maxit=8)
    mj, uj, dj = j_major_step(problem["hj"], jnp.asarray(resid), jnp.asarray(x), jnp.asarray(xtilde),
                              jnp.asarray(v), jnp.asarray(w), arr(lam), psi=pj, sigma=arr(sigma), tau=arr(tau), **kw)
    t = torch.as_tensor
    mt, ut, dt = pfb_major_step(problem["ht"], t(resid), t(x), t(xtilde), t(v), t(w), lam, psi=pt, sigma=sigma,
                                tau=tau, **kw)
    assert _rel(ut, uj) < 1e-9
    assert _rel(mt, mj) < 1e-9
    assert _rel(dt, dj) < 1e-9
