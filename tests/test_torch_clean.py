"""CLEAN in the port against the JAX package, in f64 on the CPU: ``hogbom``,
``clark`` and ``fsclark`` on seeded arrays (separated point sources, so
the peaks are distinct; model and residual to 1e-12 relative, the same
status), with a PSF of twice the image and one smaller than that, where
the PSF window's start is clamped as ``lax.dynamic_slice`` clamps it; the
blocked minor loops against one iteration per block (bitwise); and
``kclean`` (Clark with a mask, and Hogbom) on copies of one port-made tree:
model, residual and the written tree to 1e-8."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.deconv.clark import clark as jclark
from pfb_imaging_tpu.deconv.clark import fsclark as jfsclark
from pfb_imaging_tpu.deconv.hogbom import hogbom as jhogbom
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch.deconv import clark as TC
from pfb_imaging_tpu_torch.deconv import hogbom as TH

torch.set_num_threads(1)
NX = 32


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _problem(lead=(2,), nxp=2 * NX, seed=11):
    """Seeded PSFs (a random symmetric uv sampling's, peaks summing to 1
    over the leading axis), separated point sources near the image's edges
    and centre, and their dirty image by the PSF convolution."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead))
    psf = np.zeros((n, nxp, nxp))
    for i in range(n):
        m = (rng.random((nxp, nxp)) < 0.15).astype(float)
        m = m + m[::-1, ::-1][np.r_[-1, 0 : nxp - 1]][:, np.r_[-1, 0 : nxp - 1]]
        p = np.fft.fftshift(np.real(np.fft.ifft2(m)))
        psf[i] = p / p.max() / lead[0]
    psf = psf.reshape(*lead, nxp, nxp)
    model = np.zeros((*lead, NX, NX))
    for (p, q), f in zip([(3, 4), (16, 16), (28, 27), (9, 25)], [1.0, 0.7, 0.5, 0.3]):
        model[..., p, q] = f * rng.uniform(0.8, 1.2, lead)
    psfhat = np.fft.rfft2(np.fft.ifftshift(psf, axes=(-2, -1)), axes=(-2, -1))
    xhat = np.fft.rfft2(model, s=(nxp, nxp), axes=(-2, -1))
    dirty = np.fft.irfft2(xhat * psfhat, s=(nxp, nxp), axes=(-2, -1))[..., :NX, :NX]
    return dirty, psf, psfhat, psf.max(axis=(-2, -1))


@pytest.mark.parametrize("nxp", [2 * NX, 48], ids=["psf2nx", "psf_clamped"])
def test_hogbom_matches_jax(nxp):
    dirty, psf, _, _ = _problem(nxp=nxp)
    mj, rj, sj = jhogbom(jnp.asarray(dirty), jnp.asarray(psf), gamma=0.1, pf=0.02, maxit=400)
    info = {}
    mt, rt, st = TH.hogbom(_t(dirty), _t(psf), gamma=0.1, pf=0.02, maxit=400, info=info)
    assert info["niter"] >= 5 and st == int(sj)
    assert _rel(mt.numpy(), mj) <= 1e-12 and _rel(rt.numpy(), rj) <= 1e-12


@pytest.mark.parametrize("nxp", [2 * NX, 48], ids=["psf2nx", "psf_clamped"])
@pytest.mark.parametrize("masked", [False, True])
def test_clark_matches_jax(nxp, masked):
    dirty, psf, psfhat, wsums = _problem(nxp=nxp)
    mask = None
    if masked:
        mask = np.ones((NX, NX))
        mask[20:, :12] = 0.0
    kw = dict(gamma=0.1, pf=0.02, maxit=10, subpf=0.5, submaxit=200)
    mj, rj, sj = jclark(jnp.asarray(dirty), jnp.asarray(psf), jnp.asarray(psfhat), jnp.asarray(wsums),
                        mask=None if mask is None else jnp.asarray(mask), **kw)
    info = {}
    mt, rt, st = TC.clark(_t(dirty), _t(psf), torch.from_numpy(psfhat), _t(wsums),
                          mask=None if mask is None else _t(mask), info=info, **kw)
    assert info["niter"] >= 3 and info["subminor_niter"] > info["niter"] and st == sj
    assert _rel(mt.numpy(), mj) <= 1e-12 and _rel(rt.numpy(), rj) <= 1e-12


def test_fsclark_matches_jax():
    """Full Stokes: 2 bands x 2 correlations, the peak on the total
    polarisation power, every correlation cleaned at it."""
    dirty, psf, psfhat, _ = _problem(lead=(2, 2))
    wsums = np.full((2, 2), 0.5)
    kw = dict(gamma=0.2, pf=0.02, maxit=10)
    mj, rj, sj = jfsclark(jnp.asarray(dirty), jnp.asarray(psf), jnp.asarray(psfhat), jnp.asarray(wsums), **kw)
    mt, rt, st = TC.fsclark(_t(dirty), _t(psf), torch.from_numpy(psfhat), _t(wsums), **kw)
    assert st == sj and np.abs(mt.numpy()).max() > 0
    assert _rel(mt.numpy(), mj) <= 1e-12 and _rel(rt.numpy(), rj) <= 1e-12


def test_blocked_loops_equal_one_iteration_per_block(monkeypatch):
    """Iterations past the loop's end are exact no-ops: the results with
    blocks of 32 and 7 are bitwise those with blocks of 1."""
    dirty, psf, psfhat, wsums = _problem(nxp=48)
    runs = {}
    for block in (1, 7, 32):
        monkeypatch.setattr(TH, "BLOCK", block)
        monkeypatch.setattr(TC, "BLOCK", block)
        hi, ci = {}, {}
        h = TH.hogbom(_t(dirty), _t(psf), gamma=0.1, pf=0.02, maxit=301, info=hi)
        c = TC.clark(_t(dirty), _t(psf), torch.from_numpy(psfhat), _t(wsums), gamma=0.1, pf=0.02, submaxit=101,
                     info=ci)
        runs[block] = (h, c, hi, ci)
    for block in (7, 32):
        h, c, hi, ci = runs[block]
        h1, c1, hi1, ci1 = runs[1]
        assert hi == hi1 and ci == ci1
        for a, b in ((h[0], h1[0]), (h[1], h1[1]), (c[0], c1[0]), (c[1], c1[1])):
            assert torch.equal(a, b)


def _port_tree(d):
    """A small 2-band tree from the port's own simulate -> init -> imager
    on the CPU (f64, the JAX schema) at epsilon 1e-7 (IDG plans)."""
    from pfb_imaging_tpu_torch.cli import main

    ms, xds, dt = str(d / "s.ms"), str(d / "s.xds"), str(d / "s.dt")
    for argv in (["simulate", ms, "--nant", "12", "--ntime", "2", "--nchan", "4", "--nx", "64", "--noise", "0.1"],
                 ["init", ms, xds], ["imager", xds, dt, "--nband", "2", "--nx", "64", "--epsilon", "1e-7"]):
        main(argv + ["--device", "cpu"])
    return dt


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _port_tree(tmp_path_factory.mktemp("clean"))


@pytest.mark.parametrize("minor", ["clark", "hogbom"])
def test_kclean_matches_jax(tree, tmp_path, minor):
    """Two major iterations with the residual through IDG (epsilon 1e-7),
    the minor cycles cut at 30 peaks so that neither reaches the threshold
    in one; Clark with a mask that cuts off one source."""
    from pfb_imaging_tpu.core.kclean import kclean as jkclean

    from pfb_imaging_tpu_torch.core import kclean as TK

    pj, pt = tmp_path / "j.dt", tmp_path / "t.dt"
    shutil.copytree(tree, pj)
    shutil.copytree(tree, pt)
    mask = None
    if minor == "clark":
        mask = np.ones((64, 64))
        mask[:, 40:] = 0.0
    kw = dict(niter=2, minor=minor, gamma=0.1, peak_factor=0.05, subminor_maxit=30, epsilon=1e-7, mask=mask)
    mj, rj = jkclean(str(pj), **kw)
    mt, rt = TK.kclean(str(pt), device="cpu", **kw)
    assert len(TK.KCLEAN_STATS) == 2 and TK.KCLEAN_STATS[-1]["rmax"] < TK.KCLEAN_STATS[0]["rmax"]
    assert np.abs(mt).max() > 0
    if mask is not None:
        assert not mt[:, :, 40:].any()
    assert _rel(mt, mj) <= 1e-8 and _rel(rt, rj) <= 1e-8
    for key in TreeStore(str(pj)).groups():
        nj, nt = TreeStore(str(pj)).group(key), TreeStore(str(pt)).group(key)
        for name in ("MODEL", "RESIDUAL"):
            assert _rel(nt.read(name), nj.read(name)) <= 1e-8, (key, name)
        assert nt.attrs["niters"] == nj.attrs["niters"] == 2
        for a in ("rms", "rmax"):
            assert abs(nt.attrs[a] - nj.attrs[a]) <= 1e-8 * nj.attrs[a], a
