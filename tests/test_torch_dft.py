"""The port's explicit DFT against the JAX package on the CPU, in f64:
``dirty2vis_dft`` and ``vis2dirty_dft`` with ``divide_by_n`` on and off,
each axis flip, on a sparse (point-source) and a dense image, with and
without weights and a mask (1e-10 relative to the largest value: the same
sums in another order, the sparse image over its nonzero pixels only), and
the adjoint identity <R x, v> = <x, R^H v> (1e-12)."""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu.ops import dft as J
from pfb_imaging_tpu_torch.ops import dft as T

torch.set_num_threads(1)
NX, NY, CELL, NROW = 24, 20, 2e-3, 150
FREQ = np.array([0.9e9, 1.0e9, 1.2e9])
FLIPS = [dict(), dict(flip_u=True), dict(flip_v=False), dict(flip_w=True)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _data(kind, seed=7):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-300, 300, (NROW, 3))
    if kind == "dense":
        img = rng.standard_normal((NX, NY))
    else:
        img = np.zeros((NX, NY))
        img[rng.integers(0, NX, 5), rng.integers(0, NY, 5)] = rng.uniform(0.2, 1.0, 5)
    vis = rng.standard_normal((NROW, FREQ.size)) + 1j * rng.standard_normal((NROW, FREQ.size))
    wgt = rng.random((NROW, FREQ.size))
    mask = (rng.random((NROW, FREQ.size)) > 0.3).astype(np.uint8)
    return uvw, img, vis, wgt, mask


def _geom(**kw):
    return dict(nx=NX, ny=NY, cellx=CELL, celly=CELL * 1.1, l0=0.01, m0=-0.02, **kw)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("flips", FLIPS, ids=lambda f: next(iter(f), "none"))
@pytest.mark.parametrize("divide_by_n", [True, False])
def test_dirty2vis_dft_matches_jax(kind, flips, divide_by_n):
    uvw, img, *_ = _data(kind)
    kw = _geom(divide_by_n=divide_by_n, **flips)
    vj = np.asarray(J.dirty2vis_dft(uvw, FREQ, img, **kw))
    vt = T.dirty2vis_dft(uvw, FREQ, img, device="cpu", **kw)
    assert vt.dtype == torch.complex128 and tuple(vt.shape) == (NROW, FREQ.size)
    assert _rel(vt, vj) < 1e-10


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("flips", FLIPS, ids=lambda f: next(iter(f), "none"))
@pytest.mark.parametrize("divide_by_n", [True, False])
def test_vis2dirty_dft_matches_jax(weighted, flips, divide_by_n):
    uvw, _, vis, wgt, mask = _data("dense")
    kw = _geom(divide_by_n=divide_by_n, **flips)
    if weighted:
        kw.update(wgt=wgt, mask=mask)
    dj = np.asarray(J.vis2dirty_dft(uvw, FREQ, vis, **kw))
    dt = T.vis2dirty_dft(uvw, FREQ, vis, device="cpu", **kw)
    assert dt.dtype == torch.float64 and tuple(dt.shape) == (NX, NY)
    assert _rel(dt, dj) < 1e-10


@pytest.mark.parametrize("divide_by_n", [True, False])
def test_dft_adjoint_identity(divide_by_n, monkeypatch):
    """<R x, v> = <x, R^H v>, with row blocks of 7 rows forced (so the
    blocking is crossed) and a zero image giving zero visibilities."""
    monkeypatch.setattr(T, "BLOCK_BYTES", 7 * FREQ.size * NX * NY * 16)
    uvw, img, vis, _, _ = _data("dense")
    kw = _geom(divide_by_n=divide_by_n)
    rx = T.dirty2vis_dft(uvw, FREQ, img, device="cpu", **kw)
    rhv = T.vis2dirty_dft(uvw, FREQ, vis, device="cpu", **kw)
    lhs = torch.vdot(rx.reshape(-1), torch.as_tensor(vis).reshape(-1)).real
    rhs = (torch.as_tensor(img) * rhv).sum()
    assert abs(float(lhs - rhs)) < 1e-12 * float(abs(rhs))
    assert not T.dirty2vis_dft(uvw, FREQ, np.zeros((NX, NY)), device="cpu", **kw).abs().any()
