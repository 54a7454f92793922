"""Port parity of the chirp-mode IDG gridder: the port's host planner and
f64 runtime against the JAX planner's einsum backend on the same uvw, and
both against the exact DFT.

Tolerances: port vs JAX 1e-9 relative (the same f64 algorithm, summed in
another order); against the DFT the plan's own ``delivered_accuracy``
edge budget (2 epsilon in f64)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.ops import gridder_idg as J
from pfb_imaging_tpu.ops.dft import vis2dirty_dft
from pfb_imaging_tpu_torch.ops import gridder_idg as T

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX, CELL, NROW = 64, 1e-4, 300
FREQ = np.array([1.0e9, 1.1e9])
LAYOUTS = {"flat": 0.05, "wbins": 1.0}  # w scale: one w-bin / several w-bins
CASES = [(lay, eps) for lay in LAYOUTS for eps in (1e-5, 1e-7)]
_PLANS: dict = {}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _data(layout):
    rng = np.random.default_rng(17)
    uvw = rng.uniform(-1500, 1500, (NROW, 3))
    uvw[:, 2] *= LAYOUTS[layout]
    vis = rng.standard_normal((NROW, FREQ.size)) + 1j * rng.standard_normal((NROW, FREQ.size))
    wgt = rng.random((NROW, FREQ.size))
    img = rng.standard_normal((NX, NX))
    return uvw, vis, wgt, img


def _kw(eps):
    return dict(nx=NX, ny=NX, cellx=CELL, celly=CELL, epsilon=eps, do_wgridding=True)


def _plans(layout, eps):
    key = (layout, eps)
    if key not in _PLANS:
        uvw = _data(layout)[0]
        pj = J.plan_idg(uvw, FREQ, eval_backend="einsum", dtype=np.float64, divide_by_n=False, **_kw(eps))
        pt = T.plan_idg(uvw, FREQ, device=CPU, **_kw(eps))
        _PLANS[key] = (pj, pt)
    return _PLANS[key]


def _jax_leaves(pj):
    names = ("au_re", "au_im", "av_re", "av_im", "scal", "wcu8", "wcv8", "sg", "cg_idx", "bid", "phase_re",
             "phase_im", "corr_re", "corr_im", "nm1", "nm1_lo")
    leaves = {k: np.asarray(getattr(pj, k)) for k in names}
    skip = set(names) | {"inv_orig", "rep_idx", "win_start", "win_off", "win_len", "sort_idx", "unsort_idx",
                         "scr_re", "scr_im"}
    meta = {f.name: getattr(pj, f.name) for f in dataclasses.fields(pj) if f.name not in skip}
    return leaves, meta


@pytest.mark.parametrize("layout,eps", CASES)
def test_plan_layout_matches_jax(layout, eps):
    pj, pt = _plans(layout, eps)
    for f in ("S", "half", "nbig_x", "nbig_y", "ngroups", "nbins", "bin_gstart", "bin_gcount", "k0_off"):
        assert getattr(pt, f) == getattr(pj, f), f
    np.testing.assert_allclose(pt.bin_wc, pj.bin_wc, rtol=1e-12)
    np.testing.assert_array_equal(pt.cg_idx.numpy(), np.asarray(pj.cg_idx))
    np.testing.assert_array_equal(pt.bid.numpy(), np.asarray(pj.bid))
    assert _rel(torch.complex(pt.corr_re, pt.corr_im), np.asarray(pj.corr_re) + 1j * np.asarray(pj.corr_im)) < 1e-12
    if layout == "wbins":
        assert pt.nbins > 1


@pytest.mark.parametrize("layout,eps", CASES)
def test_vis2dirty_matches_jax(layout, eps):
    pj, pt = _plans(layout, eps)
    _, vis, wgt, _ = _data(layout)
    dj = J.vis2dirty_idg(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt))
    dt = T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt))
    assert _rel(dt, dj) < 1e-9


@pytest.mark.parametrize("layout,eps", CASES)
def test_dirty2vis_grouped_matches_jax(layout, eps):
    pj, pt = _plans(layout, eps)
    img = _data(layout)[3]
    assert _rel(T.dirty2vis_idg_grouped(pt, torch.as_tensor(img)), J.dirty2vis_idg_grouped(pj, jnp.asarray(img))) < 1e-9


@pytest.mark.parametrize("layout,eps", CASES)
def test_hessian_vis_matches_jax(layout, eps):
    pj, pt = _plans(layout, eps)
    _, _, wgt, img = _data(layout)
    hj = J.hessian_vis_idg(pj, jnp.asarray(img), wgt_g=J.to_group_layout(pj, jnp.asarray(wgt)))
    ht = T.hessian_vis_idg(pt, torch.as_tensor(img), wgt_g=T.to_group_layout(pt, torch.as_tensor(wgt)))
    assert _rel(ht, hj) < 1e-9


@pytest.mark.parametrize("layout,eps", CASES)
def test_vis2dirty_within_delivered_accuracy_of_dft(layout, eps):
    pj, pt = _plans(layout, eps)
    uvw, vis, wgt, _ = _data(layout)
    dd = np.asarray(vis2dirty_dft(jnp.asarray(uvw), jnp.asarray(FREQ), jnp.asarray(vis), wgt=jnp.asarray(wgt),
                                  nx=NX, ny=NX, cellx=CELL, celly=CELL, divide_by_n=False))
    budget = T.delivered_accuracy(pt)["edge"]
    assert _rel(T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt)), dd) < budget
    assert _rel(J.vis2dirty_idg(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt)), dd) < budget


@pytest.mark.parametrize("layout,eps", CASES)
def test_grouped_pair_is_adjoint(layout, eps):
    _, pt = _plans(layout, eps)
    img = torch.as_tensor(_data(layout)[3])
    vals = torch.as_tensor(np.random.default_rng(2).standard_normal((2, pt.ngroups, pt.G)))
    vals = vals * (pt.cg_idx < pt.nrow * pt.nchan)  # live slots only
    lhs = float((T.dirty2vis_idg_grouped(pt, img) * vals).sum())
    rhs = float((img * T.vis2dirty_idg_grouped(pt, vals)).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


@pytest.mark.parametrize("layout,eps", CASES)
def test_plan_from_jax_einsum_gives_same_images(layout, eps):
    pj, pt = _plans(layout, eps)
    _, vis, wgt, img = _data(layout)
    pc = T.plan_from_jax(*_jax_leaves(pj), device=CPU)
    ref = J.vis2dirty_idg(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt))
    assert _rel(T.vis2dirty_idg(pc, torch.as_tensor(vis), wgt=torch.as_tensor(wgt)), ref) < 1e-9
    assert _rel(T.dirty2vis_idg_grouped(pc, torch.as_tensor(img)), T.dirty2vis_idg_grouped(pt, torch.as_tensor(img))) < 1e-9


def test_plan_from_jax_fused_plan():
    """A fused (f32, padded, permuted-kron) JAX plan carries over: its
    images match the port's own f64 plan to the f32 rounding of its leaves."""
    uvw, vis, wgt, _ = _data("wbins")
    pf = J.plan_idg(uvw, FREQ, eval_backend="fused", dtype=np.float32, divide_by_n=False, **_kw(1e-5))
    assert pf.fused
    pc = T.plan_from_jax(*_jax_leaves(pf), device=CPU)
    _, pt = _plans("wbins", 1e-5)
    d_c = T.vis2dirty_idg(pc, torch.as_tensor(vis), wgt=torch.as_tensor(wgt))
    d_t = T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt))
    assert _rel(d_c, d_t) < 1e-5


def test_native_and_numpy_bucketing_agree(monkeypatch):
    import pfb_imaging_tpu.native as native

    uvw = _data("wbins")[0]
    a = T.plan_idg(uvw, FREQ, device=CPU, **_kw(1e-5))
    monkeypatch.setattr(native, "idg_bucket_group", lambda *args: None)  # as when the library is missing
    b = T.plan_idg(uvw, FREQ, device=CPU, **_kw(1e-5))
    assert a.bin_gcount == b.bin_gcount
    np.testing.assert_array_equal(a.cg_idx.numpy(), b.cg_idx.numpy())
    np.testing.assert_allclose(a.scal.numpy(), b.scal.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(a.phase_re.numpy(), b.phase_re.numpy(), rtol=0, atol=1e-9)


def test_wplanes_layout_raises():
    uvw = _data("wbins")[0]
    with pytest.raises(NotImplementedError, match="wplanes"):
        T.plan_idg(uvw, FREQ, device=CPU, nx=NX, ny=NX, cellx=3e-4, celly=3e-4, epsilon=1e-5)


def test_slot_budget_refuses_sparse_layout():
    uvw = _data("wbins")[0]
    with pytest.raises(ValueError, match="slot padding"):
        T.plan_idg(uvw, FREQ, device=CPU, max_slot_factor=1.0, **_kw(1e-5))
