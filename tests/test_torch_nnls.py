"""Port parity of FISTA and the NNLS minor cycle against the JAX package,
f64 on the CPU.

Tolerances: FISTA 1e-12 relative (the same host loop on the same
arithmetic); nnls 1e-9 relative at ``tests/test_deconv.py``'s problem (2
bands, 64^2, FFT convolutions summed in another order over 50 iterations).
JAX starts the power method from ``PRNGKey(42)``, which torch cannot draw,
so the parity cases pass ``hessnorm`` or the same start vector ``b0``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.deconv.nnls import nnls as jnnls
from pfb_imaging_tpu.ops.psf import psf_convolve as jpsf_convolve
from pfb_imaging_tpu.ops.psf import psf_to_psfhat
from pfb_imaging_tpu.opt.fista import fista as jfista
from pfb_imaging_tpu.opt.power_method import power_method as jpower_method
from pfb_imaging_tpu_torch.deconv.nnls import nnls
from pfb_imaging_tpu_torch.opt.fista import fista
from tests.test_deconv import _grid_products, simulate

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def problem():
    sim = simulate()
    dirty, psf, wsums = _grid_products(sim)
    wsum = wsums.sum()
    psfhat = np.asarray(psf_to_psfhat(psf / wsum))
    return sim, dirty / wsum, psfhat


def test_fista_backtracks_as_jax():
    """A quadratic with a start ``beta`` a third of its Lipschitz constant:
    the objective rises, ``beta`` doubles, and every iterate is JAX's."""
    rng = np.random.default_rng(8)
    m = rng.standard_normal((40, 40))
    a = m @ m.T / 40 + 0.1 * np.eye(40)
    b = rng.standard_normal(40)
    lip = float(np.linalg.eigvalsh(a).max())

    def fprime_t(x):
        ax = torch.as_tensor(a) @ x
        return 0.5 * x @ ax - x @ torch.as_tensor(b), ax - torch.as_tensor(b)

    def fprime_j(x):
        ax = jnp.asarray(a) @ x
        return 0.5 * x @ ax - x @ jnp.asarray(b), ax - jnp.asarray(b)

    info = {}
    kw = dict(tol=1e-10, maxit=60)
    xt = fista(fprime_t, lambda x: x.clamp(min=0.0), torch.zeros(40, dtype=torch.float64), lip / 3, info=info, **kw)
    xj = jfista(fprime_j, lambda x: jnp.maximum(x, 0.0), jnp.zeros(40), lip / 3, **kw)
    assert info["nbacktrack"] >= 1 and info["beta"] > lip / 3
    assert _rel(xt, xj) < 1e-12


def test_nnls_matches_jax_with_hessnorm(problem):
    sim, dirty, psfhat = problem
    nx = sim["nx"]
    hess = lambda x: jpsf_convolve(x, jnp.asarray(psfhat), 2 * nx, 2 * nx)  # noqa: E731
    hessnorm = float(jpower_method(hess, dirty.shape, tol=1e-4, maxit=200)[0]) * 1.05
    mj = np.asarray(jnnls(jnp.asarray(dirty), jnp.asarray(psfhat), 2 * nx, 2 * nx, tol=1e-4, maxit=50,
                          hessnorm=hessnorm))
    info = {}
    mt = nnls(dirty, psfhat, 2 * nx, 2 * nx, tol=1e-4, maxit=50, hessnorm=hessnorm, info=info, device=CPU)
    assert _rel(mt, mj) < 1e-9
    assert info["niter"] > 1
    m = mt.numpy()
    assert (m >= 0).all()
    p, q, _ = sim["srcs"][0]
    mfs = m.sum(axis=0)
    assert np.unravel_index(mfs.argmax(), mfs.shape) == (p, q)


def test_nnls_power_method_start(problem):
    """The same start vector ``b0`` gives JAX's ``hessnorm`` and model; the
    default start (a seeded ``torch.Generator``) gives a positive model whose
    brightest pixel is the brightest source's."""
    sim, dirty, psfhat = problem
    nx = sim["nx"]
    b0 = np.array(jax.random.normal(jax.random.PRNGKey(42), dirty.shape))
    mj = np.asarray(jnnls(jnp.asarray(dirty), jnp.asarray(psfhat), 2 * nx, 2 * nx, tol=1e-4, maxit=50))
    mt = nnls(dirty, psfhat, 2 * nx, 2 * nx, tol=1e-4, maxit=50, b0=torch.as_tensor(b0), device=CPU)
    assert _rel(mt, mj) < 1e-9
    md = nnls(dirty, psfhat, 2 * nx, 2 * nx, tol=1e-4, maxit=50, device=CPU).numpy()
    assert (md >= 0).all() and md.max() > 0
    p, q, _ = sim["srcs"][0]
    mfs = md.sum(axis=0)
    assert np.unravel_index(mfs.argmax(), mfs.shape) == (p, q)
