"""Port parity of the PSF-Hessian preconditioner ``HessPSF`` and of PCG's
preconditioner hook against the JAX package, f64 on the CPU, at the sizes
of ``tests/test_hessian.py``'s HessPSF test (2 bands, 32^2 images, 64^2
PSF grid).

Tolerances: ``dot`` and ``idot(mode="direct")`` 1e-12 relative (the same
FFTs); the CG solves 1e-9 relative per band (the same iterations summed in
another order: a band stopping one iteration early or late would differ
from JAX by ~cg_tol, orders above this)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.ops.precond import HessPSF as JHessPSF
from pfb_imaging_tpu.opt.pcg import PCG as JPCG
from pfb_imaging_tpu.opt.pcg import pcg as jpcg
from pfb_imaging_tpu_torch.ops import precond as TP
from pfb_imaging_tpu_torch.ops.precond import HessPSF
from pfb_imaging_tpu_torch.opt.pcg import PCG, pcg

torch.set_num_threads(1)
CPU = torch.device("cpu")
NBAND, NX, NXP = 2, 32, 64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _problem(seed=4):
    """A real point-symmetric PSF per band (|PSFHAT| == PSFHAT), a beam and
    an image cube."""
    rng = np.random.default_rng(seed)
    psf = np.zeros((NBAND, NXP, NXP))
    psf[:, NXP // 2, NXP // 2] = 1.0
    psf += 0.02 * rng.standard_normal(psf.shape)
    psf = 0.5 * (psf + np.roll(psf[:, ::-1, ::-1], (1, 1), axis=(1, 2)))
    ph = np.abs(np.fft.rfft2(np.fft.ifftshift(psf, axes=(-2, -1))))
    beam = rng.uniform(0.3, 1.0, (NBAND, NX, NX))
    x = rng.standard_normal((NBAND, NX, NX))
    return ph, beam, x


def _pair(beam: bool, **kw):
    ph, bm, x = _problem()
    b = bm if beam else None
    return JHessPSF(ph, NXP, NXP, beam=b, **kw), HessPSF(ph, NXP, NXP, beam=b, device=CPU, **kw), x


@pytest.mark.parametrize("beam", [False, True])
def test_dot_matches_jax(beam):
    hj, ht, x = _pair(beam, eta=[1e-3, 2e-2])
    assert _rel(ht.dot(torch.as_tensor(x)), hj.dot(jnp.asarray(x))) < 1e-12
    assert _rel(ht.hdot(torch.as_tensor(x)), hj.hdot(jnp.asarray(x))) < 1e-12


@pytest.mark.parametrize("beam", [False, True])
def test_idot_direct_matches_jax(beam):
    hj, ht, x = _pair(beam, eta=1.0, taper_width=8)
    assert _rel(ht.idot(torch.as_tensor(x), mode="direct"), hj.idot(jnp.asarray(x), mode="direct")) < 1e-12


@pytest.mark.parametrize("beam,eta,tol", [(False, 1e-3, 1e-10), (True, 1e-3, 1e-10), (False, [1e-3, 0.3], 1e-8),
                                          (True, [1e-4, 0.1], 1e-8)])
def test_idot_psf_matches_jax_per_band(beam, eta, tol):
    """The batched CG against JAX's vmapped per-band while_loops. With
    per-band ``eta`` the bands stop at different iterations; each band
    must still match JAX's solve of that band."""
    hj, ht, x = _pair(beam, eta=eta, cg_tol=tol, cg_maxit=300, cg_minit=3)
    y = ht.dot(torch.as_tensor(x))
    xt = ht.idot(y, mode="psf")
    xj = np.asarray(hj.idot(jnp.asarray(y.numpy()), mode="psf"))
    for b in range(NBAND):
        assert _rel(xt[b], xj[b]) < 1e-9, b
    assert all(3 <= k < 300 for k in ht.niter_last)
    if isinstance(eta, list):
        assert ht.niter_last[0] != ht.niter_last[1]


def test_idot_psf_stops_at_maxit_and_keeps_zero_band():
    """A band at ``cg_maxit`` and a band with a zero right-hand side (x0
    back, as the JAX zero-residual exit), each as JAX has it."""
    hj, ht, x = _pair(True, eta=1e-4, cg_tol=1e-14, cg_maxit=7, cg_minit=1)
    x[1] = 0.0
    xt = ht.idot(torch.as_tensor(x), mode="psf")
    xj = np.asarray(hj.idot(jnp.asarray(x), mode="psf"))
    assert ht.niter_last == [7, 0]
    assert _rel(xt[0], xj[0]) < 1e-9
    assert not xt[1].any() and not xj[1].any()


@pytest.mark.parametrize("block", [1, 7])
def test_idot_psf_block_size_is_exact(monkeypatch, block):
    """Reading the stop once a block instead of once an iteration changes
    nothing: bitwise equal to blocks of the default size."""
    _, ht, x = _pair(True, eta=[1e-3, 0.3], cg_tol=1e-8, cg_maxit=200)
    ref = ht.idot(torch.as_tensor(x), mode="psf")
    ref_k = list(ht.niter_last)
    monkeypatch.setattr(TP, "BLOCK", block)
    out = ht.idot(torch.as_tensor(x), mode="psf")
    assert ht.niter_last == ref_k
    assert torch.equal(out, ref)


def test_idot_unknown_mode_raises():
    _, ht, x = _pair(False)
    with pytest.raises(ValueError, match="unknown idot mode"):
        ht.idot(torch.as_tensor(x), mode="nope")


def test_pcg_preconditioner_hook_matches_jax():
    """pcg(precond=...) against JAX's on the PSF Hessian of a broad-lobed
    PSF, preconditioned by the tapered direct inverse (both runs must stop
    before maxit); and on a diagonal system with the exact inverse, where it
    converges in one step."""
    psf = np.zeros((NBAND, NXP, NXP))
    yy, xx = np.mgrid[-NXP // 2 : NXP // 2, -NXP // 2 : NXP // 2]
    psf += 0.02 * np.exp(-(xx**2 + yy**2) / 8.0)
    psf[:, NXP // 2, NXP // 2] += 1.0
    ph = np.abs(np.fft.rfft2(np.fft.ifftshift(psf, axes=(-2, -1))))
    hj = JHessPSF(ph, NXP, NXP, eta=1e-2, taper_width=2)
    ht = HessPSF(ph, NXP, NXP, eta=1e-2, taper_width=2, device=CPU)
    b = ht.dot(torch.as_tensor(_problem()[2]))
    kw = dict(tol=1e-8, maxit=300, minit=2)
    info, plain = {}, {}
    xt = pcg(ht.dot, b, precond=lambda r: ht.idot(r, mode="direct"), info=info, **kw)
    xj = jpcg(hj.dot, jnp.asarray(b.numpy()), precond=lambda r: hj.idot(r, mode="direct"), **kw)
    assert _rel(xt, xj) < 1e-9
    pcg(ht.dot, b, info=plain, **kw)
    assert 2 <= info["niter"] < 300 and 2 <= plain["niter"] < 300
    rng = np.random.default_rng(1)
    d = torch.as_tensor(rng.uniform(1.0, 5.0, (8, 8)))
    rhs = torch.as_tensor(rng.standard_normal((8, 8)))
    one = {}
    xd = pcg(lambda v: d * v, rhs, precond=lambda r: r / d, tol=1e-12, maxit=50, minit=1, info=one)
    np.testing.assert_allclose(xd.numpy(), (rhs / d).numpy(), atol=1e-10)
    assert one["niter"] <= 2


def test_pcg_solve_uses_hess_precond():
    """PCG.solve takes ``hess.precond`` where the hess has one, as JAX's."""

    class Hess:
        def __init__(self, d, calls):
            self.d, self.calls = d, calls

        def dot(self, v):
            return self.d * v

        def precond(self, r):
            self.calls.append(1)
            return r / self.d

    rng = np.random.default_rng(2)
    d = rng.uniform(1.0, 5.0, (6, 6))
    rhs = rng.standard_normal((6, 6))
    calls_t, calls_j = [], []
    xt = PCG(tol=1e-12, maxit=50, minit=1).solve(Hess(torch.as_tensor(d), calls_t), torch.as_tensor(rhs))
    xj = JPCG(tol=1e-12, maxit=50, minit=1).solve(Hess(jnp.asarray(d), calls_j), jnp.asarray(rhs))
    assert calls_t and calls_j
    assert _rel(xt, xj) < 1e-12
    np.testing.assert_allclose(xt.numpy(), rhs / d, atol=1e-10)
