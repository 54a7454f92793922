"""Port parity of the solvers: pcg, primal_dual_loop, power_method and the
jitted major step, against the JAX package on the same operator and the
same numpy start vectors, in f64 on the CPU; ``PrimalDual`` + ``L1`` (the
Moreau fallback) and its ``sigma`` on ``tests/test_solvers.py``'s lasso;
the JAX-style positional calls of the repaired constructors and entry points,
and ``double_precision``'s refusal of the type a device does not run.

Tolerances are set to 0 so both sides run exactly ``maxit`` iterations;
the iterates then agree to accumulated f64 rounding (<= 1e-9 relative)."""

import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.core.step import pfb_major_step as j_major_step
from pfb_imaging_tpu.ops.identity_psi import IdentityPsi as JIdentityPsi
from pfb_imaging_tpu.ops.hessian import HessianCube as JHess
from pfb_imaging_tpu.ops.hessian import hess_cube_dot as j_hdot
from pfb_imaging_tpu.ops.psi import Psi as JPsi
from pfb_imaging_tpu.opt.pcg import pcg as j_pcg
from pfb_imaging_tpu.opt.power_method import power_method as j_power
from pfb_imaging_tpu.opt.primal_dual import PrimalDual as JPrimalDual
from pfb_imaging_tpu.opt.primal_dual import primal_dual_loop as j_pd_loop
from pfb_imaging_tpu.prox.l1 import L1 as JL1
from pfb_imaging_tpu.deconv.pfb import _pfb_grad as j_grad
from pfb_imaging_tpu.prox.positivity import positivity as j_positivity
from pfb_imaging_tpu_torch import checked_real_dtype
from pfb_imaging_tpu_torch.core import deconv as TD
from pfb_imaging_tpu_torch.core import fluxtractor as TF
from pfb_imaging_tpu_torch.core import imager as TI
from pfb_imaging_tpu_torch.core import kclean as TK
from pfb_imaging_tpu_torch.core.step import pd_step_sizes, pfb_major_step
from pfb_imaging_tpu_torch.deconv.clark import clark
from pfb_imaging_tpu_torch.deconv.pfb import _pfb_grad
from pfb_imaging_tpu_torch.ops.hessian import HessianCube
from pfb_imaging_tpu_torch.ops.identity_psi import IdentityPsi
from pfb_imaging_tpu_torch.ops.psi import Psi
from pfb_imaging_tpu_torch.opt.fista import fista
from pfb_imaging_tpu_torch.opt.forward_backward import ForwardBackward
from pfb_imaging_tpu_torch.opt.pcg import PCG, pcg
from pfb_imaging_tpu_torch.opt.power_method import power_method
from pfb_imaging_tpu_torch.opt.primal_dual import PrimalDual, primal_dual_loop
from pfb_imaging_tpu_torch.prox.l1 import L1
from pfb_imaging_tpu_torch.prox.l21 import L21
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


def _lasso(nband=1, lam=0.3):
    """``tests/test_solvers.py::_lasso_setup``: min 0.5||x - b||^2 + lam||x||_1,
    solved by the soft threshold of b."""
    b = np.random.default_rng(5).standard_normal((nband, 8, 8))
    return b, np.sign(b) * np.maximum(np.abs(b) - lam, 0.0)


def _pd_lasso(sigma=None, lam=0.3):
    """PrimalDual + L1 over the identity, JAX's and the port's, to tol 1e-8."""
    b, xstar = _lasso(lam=lam)
    jpd = JPrimalDual(tol=1e-8, maxit=5000, verbosity=0, sigma=sigma)
    jpd.setup(JL1(JIdentityPsi(1, 8, 8)), hessnorm=1.0)
    jpd.set_grad(jax.tree_util.Partial(lambda x, b=jnp.asarray(b): x - b))
    xj = np.asarray(jpd.solve(jnp.zeros_like(b), lam))
    tpd = PrimalDual(tol=1e-8, maxit=5000, verbosity=0, sigma=sigma)
    tpd.setup(L1(IdentityPsi(1, 8, 8, device=CPU)), hessnorm=1.0)
    bt = torch.as_tensor(b)
    tpd.set_grad(lambda x: x - bt)
    xt = tpd.solve(torch.zeros_like(bt), lam).numpy()
    return xt, xj, xstar, tpd


def test_primal_dual_l1_takes_the_moreau_fallback():
    """L1 has no fused dual update: PrimalDual serves it through its prox
    (the Moreau decomposition), as JAX's does."""
    xt, xj, xstar, tpd = _pd_lasso()
    assert not hasattr(tpd._reg, "dual_update_fn")
    assert np.abs(xt - xj).max() <= 1e-9
    assert np.abs(xt - xstar).max() <= 1e-5


def test_primal_dual_sigma_override_matches_jax():
    xt, xj, xstar, tpd = _pd_lasso(sigma=0.25)
    assert tpd.sigma == 0.25 and tpd.tau == pytest.approx(0.98 / (0.5 + 0.25))
    assert np.abs(xt - xj).max() <= 1e-9
    assert np.abs(xt - xstar).max() <= 1e-5


def test_primal_dual_l21_with_bases_solves_the_lasso():
    """``L21(psi, ("self",), nu=1.0)``, as ``tests/test_solvers.py`` calls
    it: ``bases`` binds ``bases`` (it bound ``nu`` before)."""
    b, xstar = _lasso()
    reg = L21(IdentityPsi(1, 8, 8, device=CPU), ("self",), nu=1.0)
    assert reg.bases == ("self",) and reg.nu == 1.0
    pd = PrimalDual(tol=1e-8, maxit=5000, verbosity=0)
    pd.setup(reg, hessnorm=1.0)
    bt = torch.as_tensor(b)
    pd.set_grad(lambda x: x - bt)
    assert np.abs(pd.solve(torch.zeros_like(bt), 0.3).numpy() - xstar).max() <= 1e-5


def _names(fn, *args):
    return list(inspect.signature(fn).bind_partial(*args).arguments)


# one JAX-style positional call per repaired constructor or entry point, and the
# name its last argument must bind in the port (as in JAX)
JAX_STYLE_CALLS = {
    "PrimalDual": (PrimalDual, (1e-5, 100, 10), "report_freq"),
    "PrimalDual_sigma": (PrimalDual, (1e-5, 100, 10, 0, 1.0, 0.5), "sigma"),
    "ForwardBackward": (ForwardBackward, (1e-5, 100, 10, 0, 0.5), "gamma"),
    "PCG": (PCG, (1e-5, 100, 1, 0), "verbosity"),
    "fista": (fista, (None, None, None, 1.0, 1e-3, 100, 10), "report_freq"),
    "clark": (clark, (None,) * 4 + (None, 0.0, 0.05, 0.05, 50, 0.5, 1000, 0), "verbosity"),
    "L21": (L21, (None, ("self",)), "bases"),
    "residual_from_parts": (TI.residual_from_parts, (None, None, 1e-7, True, True), "double_precision"),
    "residual_from_parts_multiband": (TI.residual_from_parts_multiband, (None, None, None, 1e-7, True, True),
                                      "double_precision"),
    "deconv": (TD.deconv, ("x.dt", "sara", 5, 1.0, 1.0, 1.0, 1e-5, "self", 2, 1, 1e-4, 100, 1e-5, 500, 5, True,
                           None, 1e-7, True, 3, True), "double_precision"),
    "kclean": (TK.kclean, ("x.dt", 5, "clark", 0.1, 0.15, 0.75, 50, 1000, 0.0, None, 1e-7, True, True),
               "double_precision"),
    "fluxtractor": (TF.fluxtractor, ("x.dt", None, 1e-3, 1e-4, 50, 1e-7, True, True), "double_precision"),
}


@pytest.mark.parametrize("name", JAX_STYLE_CALLS)
def test_jax_style_positional_call_binds_jax_names(name):
    fn, args, last = JAX_STYLE_CALLS[name]
    assert _names(fn, *args)[-1] == last


def test_port_parameters_past_jax_s_are_keyword_only():
    """A call with one positional argument more than JAX takes raises
    instead of binding a port-only parameter (device, mesh, as_device)."""
    for fn, args, _ in JAX_STYLE_CALLS.values():
        jax_count = len([p for p in inspect.signature(fn).parameters.values()
                         if p.kind == p.POSITIONAL_OR_KEYWORD])
        with pytest.raises(TypeError):
            inspect.signature(fn).bind_partial(*range(jax_count + 1))


def test_checked_real_dtype_names_only_the_device_s_type():
    assert checked_real_dtype("cpu") == checked_real_dtype("cpu", True) == torch.float64
    assert checked_real_dtype("cuda") == checked_real_dtype("cuda", False) == torch.float32
    for dev, dp in (("cpu", False), ("cuda", True)):
        with pytest.raises(ValueError, match="double_precision"):
            checked_real_dtype(dev, dp)


@pytest.mark.parametrize("entry", ["residual_from_parts", "residual_from_parts_multiband", "deconv", "kclean",
                                    "fluxtractor"])
def test_double_precision_on_the_card_raises_before_any_cuda_call(entry, tmp_path):
    """``double_precision=True`` with ``device="cuda"`` is refused by
    ``ValueError`` first: without a card the device would raise
    ``RuntimeError`` instead, and no tree is read."""
    missing = str(tmp_path / "missing.dt")
    calls = {
        "residual_from_parts": lambda: TI.residual_from_parts(None, None, double_precision=True, device="cuda"),
        "residual_from_parts_multiband": lambda: TI.residual_from_parts_multiband(
            None, ["a", "b"], None, double_precision=True, device="cuda"),
        "deconv": lambda: TD.deconv(missing, double_precision=True, device="cuda"),
        "kclean": lambda: TK.kclean(missing, double_precision=True, device="cuda"),
        "fluxtractor": lambda: TF.fluxtractor(missing, double_precision=True, device="cuda"),
    }
    with pytest.raises(ValueError, match="double_precision=True on cuda"):
        calls[entry]()
