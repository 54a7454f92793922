"""The port's weighting and geometry modules (``ops/weighting.py``,
``geometry.py``) against the JAX package on the same inputs, in f64 on the
CPU: uv counts, Briggs weights, ``filter_extreme_counts``,
``box_sum_counts``, the image-size rules and ``fitcleanbeam``.

Tolerances: counts and weights to 1e-12 relative (the same sums, another
order); the box sum to 1e-12; the clean-beam fit to 1e-6 (the same L-BFGS-B
run from the same start, with gradients from ``torch.autograd`` instead of
``jax.grad``, equal to rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_recorder import recording

from pfb_imaging_tpu import geometry as JGEO
from pfb_imaging_tpu.ops import weighting as JW
from pfb_imaging_tpu_torch import geometry as TGEO
from pfb_imaging_tpu_torch import native as TN
from pfb_imaging_tpu_torch.ops import weighting as TW

torch.set_num_threads(1)
NX, CELL = 96, 2e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _data(seed=3, nrow=400, nchan=3):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-900, 900, (nrow, 3))
    freq = np.linspace(0.9e9, 1.1e9, nchan)
    mask = (rng.random((nrow, nchan)) > 0.1).astype(np.float64)
    wgt = rng.uniform(0.2, 2.0, (2, nrow, nchan))
    return uvw, freq, mask, wgt


def test_counts_match_jax_native_and_torch():
    uvw, freq, mask, wgt = _data()
    cj = np.asarray(JW._compute_counts_jax(jnp.asarray(uvw), jnp.asarray(freq), jnp.asarray(mask), jnp.asarray(wgt),
                                           NX, NX, CELL, CELL))
    with recording() as got:
        cn = TW.compute_counts(uvw, freq, mask, wgt, NX, NX, CELL, CELL)
    assert got["counters"].get("plan.native", 0) + got["counters"].get("plan.numpy", 0) == 1
    ct = TW.compute_counts_torch(torch.as_tensor(uvw), torch.as_tensor(freq), torch.as_tensor(mask),
                                 torch.as_tensor(wgt), NX, NX, CELL, CELL)
    assert isinstance(cn, np.ndarray) and cn.shape == (2, NX, NX)
    assert cj.sum() > 0 and _rel(cn, cj) < 1e-12 and _rel(ct, cj) < 1e-12


@pytest.mark.parametrize("robust", [-2.0, 0.0, 1.5])
def test_briggs_weights_match_jax(robust):
    uvw, freq, mask, wgt = _data(4)
    counts = np.asarray(JW.compute_counts(uvw, freq, mask, wgt, NX, NX, CELL, CELL))
    wj = np.asarray(JW._counts_to_weights_jax(jnp.asarray(counts), jnp.asarray(uvw), jnp.asarray(freq),
                                              jnp.asarray(wgt), jnp.asarray(mask), NX, NX, CELL, CELL, robust))
    wn = TW.counts_to_weights(counts, uvw, freq, wgt, mask, NX, NX, CELL, CELL, robust)
    wt = TW.counts_to_weights_torch(torch.as_tensor(counts), torch.as_tensor(uvw), torch.as_tensor(freq),
                                    torch.as_tensor(wgt), torch.as_tensor(mask), NX, NX, CELL, CELL, robust)
    assert _rel(wn, wj) < 1e-12 and _rel(wt, wj) < 1e-12
    assert not np.allclose(wj, wgt)


def test_empty_counts_leave_weights():
    uvw, freq, mask, wgt = _data(5)
    zero = np.zeros((2, NX, NX))
    assert TW.counts_to_weights(zero, uvw, freq, wgt, mask, NX, NX, CELL, CELL, 0.0) is wgt
    out = TW.counts_to_weights_torch(zero, uvw, freq, wgt, mask, NX, NX, CELL, CELL, 0.0)
    assert np.array_equal(np.asarray(out), wgt)


def test_numpy_fallback_matches_native(monkeypatch):
    """Where the host library cannot be built, counts, weights and the plane
    buckets come from the numpy/torch fallback, and agree with the native
    kernels (counts and weights to 1e-12 relative; buckets exactly)."""
    uvw, freq, mask, wgt = _data(8)
    counts = TW.compute_counts(uvw, freq, mask, wgt, NX, NX, CELL, CELL)
    weights = TW.counts_to_weights(counts, uvw, freq, wgt, mask, NX, NX, CELL, CELL, 0.0)
    i0 = np.random.default_rng(9).integers(0, 12, 500)
    buckets = TN.wplane_buckets(i0, 14, 3)
    assert TN._build_and_load() is not None  # the native kernels were the reference
    monkeypatch.setattr(TN, "_LIB", None)
    monkeypatch.setattr(TN, "_TRIED", True)
    with recording() as rec:
        assert _rel(TW.compute_counts(uvw, freq, mask, wgt, NX, NX, CELL, CELL), counts) < 1e-12
        assert _rel(TW.counts_to_weights(counts, uvw, freq, wgt, mask, NX, NX, CELL, CELL, 0.0), weights) < 1e-12
        for got, want in zip(TN.wplane_buckets(i0, 14, 3), buckets):
            assert np.array_equal(got, want)
    assert rec["counters"]["plan.numpy"] == 3


@pytest.mark.parametrize("level", [0.0, 10.0, 3.0])
def test_filter_extreme_counts_matches_jax(level):
    uvw, freq, mask, wgt = _data(6)
    counts = np.asarray(JW.compute_counts(uvw, freq, mask, wgt, NX, NX, CELL, CELL))
    counts[0, 3, 4] = 1e-4  # an extreme low count the floor lifts
    fj = np.asarray(JW.filter_extreme_counts(jnp.asarray(counts), level=level))
    ft = TW.filter_extreme_counts(counts, level=level)
    assert isinstance(ft, np.ndarray) and _rel(ft, fj) < 1e-15
    if level:
        assert ft[0, 3, 4] > 1e-4


@pytest.mark.parametrize("npix", [0, 1, 3])
def test_box_sum_counts_matches_jax(npix):
    counts = np.random.default_rng(7).random((1, 40, 36))
    bj = np.asarray(JW.box_sum_counts(jnp.asarray(counts), npix))
    bt = TW.box_sum_counts(counts, npix)
    assert bt.shape == counts.shape and _rel(bt, bj) < 1e-12


@pytest.mark.parametrize("ncorr, dof", [(None, 5.0), (None, 0.5), (2, 5.0)])
def test_l2_reweight_matches_jax(ncorr, dof):
    """Student-t reweighting of residual visibilities: (nrow, nchan), and
    (ncorr, nrow, nchan) with one variance per correlation; an all-flagged
    input keeps its weights."""
    rng = np.random.default_rng(9)
    shape = (300, 3) if ncorr is None else (ncorr, 300, 3)
    res = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    wgt = rng.uniform(0.2, 2.0, shape)
    mask = (rng.random((300, 3)) > 0.1).astype(np.uint8)
    wj = np.asarray(JW.l2_reweight(jnp.asarray(res), jnp.asarray(wgt), jnp.asarray(mask), dof))
    wt = TW.l2_reweight(res, wgt, mask, dof)
    assert isinstance(wt, np.ndarray) and wt.shape == shape and _rel(wt, wj) < 1e-12
    assert np.array_equal(TW.l2_reweight(res, wgt, np.zeros_like(mask), dof), wgt)


def test_image_geometry_matches_jax():
    for kw in (dict(), dict(cell_size=0.8251, nx=2048, ny=2048), dict(nx=100, ny=64, psf_oversize=1.5),
               dict(psf_oversize=0)):
        gj = JGEO.set_image_size(16000.0, 1.712e9, 0.5, 2.0, **kw)
        gt = TGEO.set_image_size(16000.0, 1.712e9, 0.5, 2.0, **kw)
        for f in ("nx", "ny", "nx_psf", "ny_psf", "cell_rad", "cell_deg", "cell_n", "l0", "m0"):
            assert getattr(gt, f) == pytest.approx(getattr(gj, f), rel=1e-15), (kw, f)
    with pytest.raises(NotImplementedError):
        TGEO.set_image_size(16000.0, 1.712e9, 0.5, 2.0, nx=101)
    assert TGEO.wgridder_conventions(1e-3, -2e-3) == JGEO.wgridder_conventions(1e-3, -2e-3)
    for a, b in zip(TGEO.lm_grid(16, 12, 1e-3, 2e-3, 1e-3, -2e-3), JGEO.lm_grid(16, 12, 1e-3, 2e-3, 1e-3, -2e-3)):
        assert np.allclose(a, np.asarray(b), rtol=0, atol=1e-15)


def _gauss_psf(n, emaj, emin, pa):
    """A rotated Gaussian mainlobe with FWHMs (emaj, emin) in pixels and
    small sidelobe ripples."""
    x = np.arange(n) - n // 2
    xx, yy = np.meshgrid(x, x, indexing="ij")
    t = np.pi / 2 + pa
    xr = np.cos(t) * xx + np.sin(t) * yy
    yr = -np.sin(t) * xx + np.cos(t) * yy
    s = 2 * np.sqrt(2 * np.log(2))
    g = np.exp(-0.5 * ((xr / (emaj / s)) ** 2 + (yr / (emin / s)) ** 2))
    return g + 0.02 * np.cos(0.9 * xx) * np.cos(0.7 * yy) * (g < 0.3)


def test_fitcleanbeam_matches_jax():
    psf = np.stack([_gauss_psf(64, 7.0, 4.0, 0.6), _gauss_psf(64, 5.0, 5.5, 2.1), np.zeros((64, 64))])
    pj = JGEO.fitcleanbeam(psf, pixsize=2.0)
    pt = TGEO.fitcleanbeam(psf, pixsize=2.0)
    assert pt.shape == (3, 3) and np.isnan(pt[2]).all() and np.isnan(pj[2]).all()
    assert np.allclose(pt[:2], pj[:2], rtol=1e-6, atol=0)
    assert pt[0, 0] == pytest.approx(14.0, rel=0.05) and pt[0, 1] == pytest.approx(8.0, rel=0.05)
