"""Port parity of the classic ES w-stacking gridder: the port's plan and
operators against the JAX ``plan_wgridder``/``vis2dirty``/``dirty2vis`` on
the same uvw, in f64 on the CPU.

Tolerances: plan fields to f64 rounding (1e-12); images and visibilities
to 1e-10 relative (the same f64 algorithm, with window-relative
coordinates and another summation order); the adjoint identity to 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.ops import gridder as J
from pfb_imaging_tpu_torch.ops import gridder as T

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX, CELL, NROW = 64, 3e-4, 300
FREQ = np.array([1.0e9, 1.1e9])
# (do_wgridding, l0, m0): w-stacked, one plane, and an off-centre field
CASES = {"wstack": (True, 0.0, 0.0), "noW": (False, 0.0, 0.0), "offcentre": (True, 2e-3, -1.5e-3)}
_PLANS: dict = {}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _data():
    rng = np.random.default_rng(23)
    uvw = rng.uniform(-400, 400, (NROW, 3))  # uv inside the grid's band
    uvw[:, 2] *= 7.5  # |w| to 11000 wavelengths: ~16 w-planes
    vis = rng.standard_normal((NROW, FREQ.size)) + 1j * rng.standard_normal((NROW, FREQ.size))
    wgt = rng.random((NROW, FREQ.size))
    mask = (rng.random((NROW, FREQ.size)) > 0.1).astype(np.uint8)
    img = rng.standard_normal((NX, NX))
    return uvw, vis, wgt, mask, img


def _kw(case, eps=1e-7):
    do_w, l0, m0 = CASES[case]
    return dict(nx=NX, ny=NX, cellx=CELL, celly=CELL, l0=l0, m0=m0, epsilon=eps, do_wgridding=do_w,
                divide_by_n=False)


def _plans(case):
    if case not in _PLANS:
        uvw = _data()[0]
        pj = J.plan_wgridder(uvw, FREQ, dtype=np.float64, **_kw(case))
        pt = T.plan_wgridder(uvw, FREQ, dtype=np.float64, device=CPU, **_kw(case))
        _PLANS[case] = (pj, pt)
    return _PLANS[case]


def _jax_leaves(pj):
    leaves = {f: np.asarray(getattr(pj, f)) for f in ("u_pix", "v_pix", "w_lam", "sort_idx", "plane_start",
                                                       "plane_count", "phase_re", "phase_im", "corr_img", "nm1",
                                                       "cw_img")}
    meta = {f.name: getattr(pj, f.name) for f in dataclasses.fields(pj) if f.name not in leaves}
    return leaves, meta


@pytest.mark.parametrize("case", CASES)
def test_plan_fields_match_jax(case):
    pj, pt = _plans(case)
    for f in ("support", "beta", "nbig_x", "nbig_y", "nw", "w_support", "capacity", "do_wgridding", "nrow",
              "nchan"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert pt.w0 == pytest.approx(pj.w0, rel=1e-12, abs=1e-12)
    assert pt.dw == pytest.approx(pj.dw, rel=1e-12)
    assert pt.plane_start == tuple(int(x) for x in np.asarray(pj.plane_start))
    assert pt.plane_count == tuple(int(x) for x in np.asarray(pj.plane_count))
    np.testing.assert_array_equal(pt.sort_idx.numpy(), np.asarray(pj.sort_idx))
    nvis = pt.nvis
    np.testing.assert_allclose((pt.iu0 + pt.du).numpy(), np.asarray(pj.u_pix)[:nvis], rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose((pt.iv0 + pt.dv).numpy(), np.asarray(pj.v_pix)[:nvis], rtol=1e-13, atol=1e-12)
    for f in ("corr_img", "nm1", "cw_img"):
        assert _rel(getattr(pt, f), getattr(pj, f)) < 1e-12, f
    phase_j = np.asarray(pj.phase_re) + 1j * np.asarray(pj.phase_im)
    assert _rel(torch.complex(pt.phase_re, pt.phase_im), phase_j) < 1e-12
    if case != "noW":
        assert pt.nw > pt.w_support  # several planes


@pytest.mark.parametrize("case", CASES)
def test_vis2dirty_matches_jax(case):
    pj, pt = _plans(case)
    _, vis, wgt, mask, _ = _data()
    dj = J.vis2dirty(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt), mask=jnp.asarray(mask))
    dt = T.vis2dirty(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt), mask=torch.as_tensor(mask))
    assert _rel(dt, dj) < 1e-10


@pytest.mark.parametrize("case", CASES)
def test_dirty2vis_matches_jax(case):
    pj, pt = _plans(case)
    _, _, _, mask, img = _data()
    vj = J.dirty2vis(pj, jnp.asarray(img), mask=jnp.asarray(mask))
    vt = T.dirty2vis(pt, torch.as_tensor(img), mask=torch.as_tensor(mask))
    assert _rel(vt, vj) < 1e-10


@pytest.mark.parametrize("case", CASES)
def test_operators_are_adjoint(case):
    _, pt = _plans(case)
    _, vis, _, _, img = _data()
    vis_t, img_t = torch.as_tensor(vis), torch.as_tensor(img)
    lhs = float(torch.real(torch.sum(T.dirty2vis(pt, img_t) * vis_t.conj())))
    rhs = float(torch.sum(img_t * T.vis2dirty(pt, vis_t)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_psf_peak_equals_wsum():
    """The PSF of unit visibilities peaks at the sum of the weights."""
    _, pt = _plans("wstack")
    _, _, wgt, mask, _ = _data()
    psf = T.vis2dirty(pt, torch.ones(NROW, FREQ.size, dtype=torch.complex128), wgt=torch.as_tensor(wgt),
                      mask=torch.as_tensor(mask))
    wsum = float((wgt * mask).sum())
    assert abs(float(psf[NX // 2, NX // 2]) - wsum) / wsum < 1e-7
    assert float(psf.max()) == pytest.approx(float(psf[NX // 2, NX // 2]))


@pytest.mark.parametrize("case", CASES)
def test_plan_from_jax_gives_same_operators(case):
    pj, pt = _plans(case)
    _, vis, wgt, _, img = _data()
    pc = T.wgridder_plan_from_jax(*_jax_leaves(pj), device=CPU)
    assert pc.rdt == torch.float64 and pc.nw == pt.nw
    assert _rel(T.vis2dirty(pc, torch.as_tensor(vis), wgt=torch.as_tensor(wgt)),
                T.vis2dirty(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt))) < 1e-12
    assert _rel(T.dirty2vis(pc, torch.as_tensor(img)), T.dirty2vis(pt, torch.as_tensor(img))) < 1e-12


def test_plan_dtype_follows_device_default():
    uvw = _data()[0]
    assert T.plan_wgridder(uvw, FREQ, device=CPU, **_kw("wstack")).rdt == torch.float64
    assert T.plan_wgridder(uvw, FREQ, device=CPU, dtype=np.float32, **_kw("wstack")).rdt == torch.float32
