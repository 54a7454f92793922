"""ISTA and forward-backward in the port against the JAX package, in f64 on
the CPU: the l1, l2,1 and ridge proxes and the identity dictionary (1e-15
relative: the same arithmetic), ``forward_backward_loop`` on the JAX tests'
analytic lasso problem with and without acceleration (1e-10, and the
soft-threshold solution), ``ForwardBackward.solve`` re-entering after
declined convergences (the same iteration counts), the presets' backends,
``PFBSolver`` with a regulariser that does not reweight, and the whole
``deconv(preset="ista")`` on copies of one port-made tree (1e-8, as
tests/test_torch_deconv.py holds sara)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_recorder import logged

from pfb_imaging_tpu.ops.identity_psi import IdentityPsi as JIdentityPsi
from pfb_imaging_tpu.opt import forward_backward as JFB
from pfb_imaging_tpu.prox.l1 import L1 as JL1
from pfb_imaging_tpu.prox.prox2 import prox2 as jprox2
from pfb_imaging_tpu.prox.prox_21 import dual_update_21 as jdual_update_21
from pfb_imaging_tpu.prox.prox_21 import prox_21 as jprox_21
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch.ops.identity_psi import IdentityPsi
from pfb_imaging_tpu_torch.opt import forward_backward as TFB
from pfb_imaging_tpu_torch.prox.l1 import L1
from pfb_imaging_tpu_torch.prox.prox2 import prox2
from pfb_imaging_tpu_torch.prox.prox_21 import dual_update_21, prox_21

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _prox_inputs():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((3, 2, 6, 5))
    vp = rng.standard_normal((3, 2, 6, 5))
    w = rng.uniform(0.5, 1.5, (2, 6, 5))
    v[:, 0, 0, 0] = 0.0  # a zero column: the l2 norm's guard
    return v, vp, w


PROXES = {
    "l1_prox_fn": (lambda m, v, vp, w: m.prox_fn(v, 0.4, sigma=1.3, weight=w), "l1"),
    "prox_21": (lambda m, v, vp, w: m(v, 0.7, sigma=1.3, weight=w), "prox_21"),
    "prox_21_unweighted": (lambda m, v, vp, w: m(v, 0.7), "prox_21"),
    "dual_update_21": (lambda m, v, vp, w: m(vp, v, 0.4, sigma=0.9, weight=w), "dual_update_21"),
    "prox2": (lambda m, v, vp, w: m(v, 0.35), "prox2"),
}


@pytest.mark.parametrize("name", PROXES)
def test_proxes_match_jax(name):
    fn, which = PROXES[name]
    v, vp, w = _prox_inputs()
    jmod = {"l1": JL1, "prox_21": jprox_21, "dual_update_21": jdual_update_21, "prox2": jprox2}[which]
    tmod = {"l1": L1, "prox_21": prox_21, "dual_update_21": dual_update_21, "prox2": prox2}[which]
    ref = np.asarray(fn(jmod, jnp.asarray(v), jnp.asarray(vp), jnp.asarray(w)))
    out = fn(tmod, _t(v), _t(vp), _t(w)).numpy()
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 1e-15


def test_identity_psi_and_l1_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 6, 5))
    jp, tp = JIdentityPsi(2, 6, 5), IdentityPsi(2, 6, 5, device=CPU)
    assert (tp.nband, tp.nbasis, tp.nymax, tp.nxmax) == (jp.nband, jp.nbasis, jp.nymax, jp.nxmax)
    a = tp.dot(_t(x))
    assert a.shape == (2, 1, 6, 5) and _rel(a.numpy(), np.asarray(jp.dot(jnp.asarray(x)))) <= 1e-15
    assert _rel(tp.hdot(a).numpy(), np.asarray(jp.hdot(jp.dot(jnp.asarray(x))))) <= 1e-15
    reg = L1(tp)
    assert reg.l1weight.shape == (1, 6, 5) and reg.l1weight.dtype == torch.float64 and bool((reg.l1weight == 1).all())
    ref = np.asarray(JL1(jp).prox(jp.dot(jnp.asarray(x)), 0.3, sigma=1.1))
    assert _rel(reg.prox(a, 0.3, sigma=1.1).numpy(), ref) <= 1e-15


def _lasso(lam, nband=1):
    """The JAX tests' problem (tests/test_solvers.py): min 0.5||x-b||^2 +
    lam||x||_1 on an 8x8 image, solved by the soft threshold."""
    b = np.random.default_rng(5).standard_normal((nband, 8, 8))
    return b, np.sign(b) * np.maximum(np.abs(b) - lam, 0.0)


@pytest.mark.parametrize("acceleration", [True, False])
def test_forward_backward_loop_matches_jax_on_lasso(acceleration):
    lam, step, maxit = 0.25, 1.0, 40
    b, xstar = _lasso(lam, nband=2)
    jpsi, tpsi = JIdentityPsi(2, 8, 8), IdentityPsi(2, 8, 8, device=CPU)
    # a gradient whose fixed point is not reached in one step: 0.6 (x - b)
    jgrad = jax.tree_util.Partial(lambda x, b=jnp.asarray(b): 0.6 * (x - b))
    bt = _t(b)
    xj, kj, ej = JFB.forward_backward_loop(
        jnp.zeros_like(jnp.asarray(b)), jnp.asarray(lam), jnp.ones((1, 8, 8)), jnp.asarray(step), jgrad,
        psi_dot=jpsi.dot, psi_hdot=jpsi.hdot, prox_fn=JL1.prox_fn, acceleration=acceleration, tol=1e-13,
        maxit=maxit)
    xt, kt, et = TFB.forward_backward_loop(
        torch.zeros_like(bt), lam, torch.ones((1, 8, 8), dtype=torch.float64), step, lambda x: 0.6 * (x - bt),
        psi_dot=tpsi.dot, psi_hdot=tpsi.hdot, prox_fn=L1.prox_fn, acceleration=acceleration, tol=1e-13,
        maxit=maxit)
    assert kt == int(kj) and abs(et - float(ej)) <= 1e-10  # eps: a relative change, near 0 here
    assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-10
    # the step 1 with the 0.6 gradient converges to the threshold at lam
    np.testing.assert_allclose(xt.numpy(), np.sign(b) * np.maximum(np.abs(b) - lam / 0.6, 0.0), atol=1e-6)


@pytest.mark.parametrize("acceleration", [True, False])
def test_forward_backward_solver_matches_jax(acceleration):
    """The JAX tests' lasso through ``ForwardBackward.solve`` (gamma 0.5,
    hessnorm 1: step 1), against JAX and the analytic solution."""
    lam = 0.25
    b, xstar = _lasso(lam)
    bt = _t(b)
    fj = JFB.ForwardBackward(tol=1e-10, maxit=5000, verbosity=0, gamma=0.5, acceleration=acceleration)
    fj.setup(JL1(JIdentityPsi(1, 8, 8)), hessnorm=1.0)
    fj.set_grad(jax.tree_util.Partial(lambda x, b=jnp.asarray(b): x - b))
    ft = TFB.ForwardBackward(tol=1e-10, maxit=5000, verbosity=0, gamma=0.5, acceleration=acceleration)
    ft.setup(L1(IdentityPsi(1, 8, 8, device=CPU)), hessnorm=1.0)
    ft.set_grad(lambda x: x - bt)
    xj = np.asarray(fj.solve(jnp.zeros_like(jnp.asarray(b)), lam))
    xt = ft.solve(torch.zeros_like(bt), lam).numpy()
    assert _rel(xt, xj) <= 1e-10
    np.testing.assert_allclose(xt, xstar, atol=1e-6)


def test_forward_backward_reentry_matches_jax():
    """Each declined convergence re-enters with the full ``maxit`` while the
    budget shrinks, in both packages: the same callback calls, iteration
    counts and iterate."""
    lam = 0.3
    b, _ = _lasso(lam)
    bt = _t(b)
    calls = {"jax": [], "torch": []}

    def declining(tag):
        def cb(x, k, eps):
            calls[tag].append(k)
            return len(calls[tag]) >= 3
        return cb

    fj = JFB.ForwardBackward(tol=1e-3, maxit=50, verbosity=0, gamma=0.4, on_converge=declining("jax"))
    fj.setup(JL1(JIdentityPsi(1, 8, 8)), hessnorm=1.0)
    fj.set_grad(jax.tree_util.Partial(lambda x, b=jnp.asarray(b): 0.7 * (x - b)))
    ft = TFB.ForwardBackward(tol=1e-3, maxit=50, verbosity=0, gamma=0.4, on_converge=declining("torch"))
    ft.setup(L1(IdentityPsi(1, 8, 8, device=CPU)), hessnorm=1.0)
    ft.set_grad(lambda x: 0.7 * (x - bt))
    xj = np.asarray(fj.solve(jnp.zeros_like(jnp.asarray(b)), lam))
    xt = ft.solve(torch.zeros_like(bt), lam).numpy()
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 3
    assert ft.niter_last == calls["torch"][-1]
    assert _rel(xt, xj) <= 1e-10


def _solver_inputs(nband=2, nx=16, nxp=32):
    rng = np.random.default_rng(8)
    psf = np.zeros((nband, nxp, nxp))
    psf[:, nxp // 2, nxp // 2] = 1.0
    psf[:, nxp // 2 - 1 : nxp // 2 + 2, nxp // 2 - 1 : nxp // 2 + 2] += 0.2 * rng.random((nband, 3, 3))
    absphat = np.abs(np.fft.rfft2(np.fft.ifftshift(psf, axes=(1, 2)), axes=(1, 2)))[:, None]
    geometry = dict(nx=nx, ny=nx, nx_psf=nxp, ny_psf=nxp)
    zeros = np.zeros((nband, nx, nx))
    return absphat, np.array([2.0, 3.0]), geometry, zeros


def test_presets_backends():
    from pfb_imaging_tpu_torch.deconv.presets import PRESETS, make_sara
    from pfb_imaging_tpu_torch.opt.forward_backward import ForwardBackward
    from pfb_imaging_tpu_torch.opt.primal_dual import PrimalDual

    absphat, wsums, geometry, zeros = _solver_inputs()
    s = make_sara(absphat, wsums, geometry, zeros, zeros, dict(opt_backend="forward-backward", hess_norm=1.0,
                                                                  acceleration=False, fb_maxit=7), device="cpu")
    assert isinstance(s.backward_alg, ForwardBackward) and s.backward_alg.maxit == 7
    assert not s.backward_alg.acceleration and s.backward_alg.on_converge is s._reweight_cb
    s = make_sara(absphat, wsums, geometry, zeros, zeros, dict(hess_norm=1.0), device="cpu")
    assert isinstance(s.backward_alg, PrimalDual)
    with pytest.raises(ValueError, match="Unknown opt_backend"):
        make_sara(absphat, wsums, geometry, zeros, zeros, dict(opt_backend="admm"), device="cpu")
    ista = PRESETS["ista"](absphat, wsums, geometry, zeros, zeros, dict(hess_norm=1.0, fb_maxit=9), device="cpu")
    assert isinstance(ista.backward_alg, ForwardBackward) and not ista.backward_alg.acceleration
    assert ista.backward_alg.maxit == 9 and ista.backward_alg.step == 2.0


def test_pfb_solver_with_l1_runs_without_reweighting():
    """``L1`` has no reweighting: no callback is installed, ``last`` does
    nothing and ``reweight_active`` says "stop at convergence"."""
    from pfb_imaging_tpu_torch.deconv.presets import make_ista

    absphat, wsums, geometry, zeros = _solver_inputs()
    s = make_ista(absphat, wsums, geometry, zeros, zeros, dict(fb_maxit=20, cg_maxit=5, l1_reweight_from=0),
                  device="cpu")
    assert s._reweight_cb is None and s.backward_alg.on_converge is None and s.reweight_active
    resid = np.zeros_like(zeros)
    resid[:, 5, 7] = 1.0
    s.first(_t(resid))
    s.forward(None)
    model = s.backward(1e-3)
    s.last()
    assert model.shape == zeros.shape and float(model.max()) > 0 and float(model.min()) >= 0


def _port_tree(d):
    """A small 2-band tree from the port's own simulate -> init -> imager
    on the CPU (f64, the JAX schema), at epsilon 1e-7: IDG plans."""
    from pfb_imaging_tpu_torch.cli import main

    ms, xds, dt = str(d / "s.ms"), str(d / "s.xds"), str(d / "s.dt")
    for argv in (["simulate", ms, "--nant", "12", "--ntime", "2", "--nchan", "4", "--nx", "64", "--noise", "0.1"],
                 ["init", ms, xds], ["imager", xds, dt, "--nband", "2", "--nx", "64", "--epsilon", "1e-7"]):
        main(argv + ["--device", "cpu"])
    return dt


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _port_tree(tmp_path_factory.mktemp("ista"))


def test_deconv_ista_matches_jax(tree, tmp_path):
    """``deconv(preset="ista")``: PCG then unaccelerated forward-backward
    against the PSF Hessian with the image-domain l1, positivity, then the
    exact residual, both packages with tolerances so small that CG and FB
    run exactly ``maxit`` iterations, the JAX run's spectral norm for both."""
    import pfb_imaging_tpu.core.deconv as jdeconv

    from pfb_imaging_tpu_torch.core import deconv as tdeconv

    pj, pt = tmp_path / "j.dt", tmp_path / "t.dt"
    shutil.copytree(tree, pj)
    shutil.copytree(tree, pt)
    kw = dict(preset="ista", niter=1, epsilon=1e-7, cg_tol=1e-30, cg_maxit=6,
              opts_extra=dict(fb_tol=1e-30, fb_maxit=15))
    mj, rj = jdeconv.deconv(str(pj), use_mesh=False, **kw)
    hess_norm = TreeStore(str(pj)).attrs["hess_norm"]
    with logged("DECONV") as stats:
        mt, rt = tdeconv.deconv(str(pt), hess_norm=hess_norm, device="cpu", **kw)
    assert len(stats) == 1 and stats[0]["cg_iters"] == 6 and stats[0]["pd_iters"] == 15
    assert np.abs(mt).max() > 0
    assert _rel(mt, mj) <= 1e-8 and _rel(rt, rj) <= 1e-8
    for key in TreeStore(str(pj)).groups():
        nj, nt = TreeStore(str(pj)).group(key), TreeStore(str(pt)).group(key)
        assert not nt.has("DUAL") and not nj.has("DUAL")
        for name in ("MODEL", "RESIDUAL", "UPDATE", "MODEL_BEST"):
            assert _rel(nt.read(name), nj.read(name)) <= 1e-8, (key, name)
        assert nt.attrs["niters"] == nj.attrs["niters"] == 1
        assert abs(nt.attrs["rms"] - nj.attrs["rms"]) <= 1e-8 * nj.attrs["rms"]
