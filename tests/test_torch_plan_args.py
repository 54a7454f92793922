"""Port parity of ``plan_idg``'s explicit layout arguments (``subgrid``,
``half``, ``sigma``, ``flip_u/v/w``, ``hermitian``, ``max_bins``): the
port's own plan against the JAX planner's einsum plan on the same uvw, and
both runtimes against ``plan_from_jax`` of the JAX plan.

Tolerances: 1e-9 relative on the narrow layouts and 1e-10 on the wide-w
layout (the same f64 algorithm, summed in another order), as
``test_torch_gridder_idg.py``; against the direct DFT the plan's own
``delivered_accuracy`` edge budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.ops import gridder_idg as J
from pfb_imaging_tpu_torch.ops import dft as T_dft
from pfb_imaging_tpu_torch.ops import gridder_idg as T
from tests.test_torch_gridder_idg import (CELL, FREQ, NX, WCELL, WFREQ, WNX, _data, _jax_leaves, _jax_slot_map, _rel,
                                          _wide_data, _windowed_leaves)

torch.set_num_threads(1)
CPU = torch.device("cpu")
# name: (layout, epsilon, explicit arguments)
CASES = {
    "subgrid24": ("wbins", 1e-7, dict(subgrid=24)),
    "subgrid16_half8_wplanes": ("wide", 1e-5, dict(subgrid=16, half=8, w_mode="wplanes")),
    "flips": ("wbins", 1e-5, dict(flip_u=True, flip_v=False, flip_w=True)),
    "no_hermitian": ("wbins", 1e-5, dict(hermitian=False)),
    "sigma2": ("wbins", 1e-5, dict(sigma=2.0)),
    "subgrid24_flipv_no_hermitian": ("flat", 1e-7, dict(subgrid=24, flip_v=False, hermitian=False)),
}
_PLANS: dict = {}


def _problem(name):
    layout, eps, extra = CASES[name]
    if layout == "wide":
        uvw, vis, wgt, img = _wide_data()
        kw = dict(nx=WNX, ny=WNX, cellx=WCELL, celly=WCELL)
        return uvw, WFREQ, vis, wgt, img, dict(kw, epsilon=eps, do_wgridding=True, divide_by_n=False, **extra)
    uvw, vis, wgt, img = _data(layout)
    kw = dict(nx=NX, ny=NX, cellx=CELL, celly=CELL)
    return uvw, FREQ, vis, wgt, img, dict(kw, epsilon=eps, do_wgridding=True, divide_by_n=False, **extra)


def _plans(name):
    if name not in _PLANS:
        uvw, freq, *_, kw = _problem(name)
        pj = J.plan_idg(uvw, freq, eval_backend="einsum", dtype=np.float64, **kw)
        pt = T.plan_idg(uvw, freq, device=CPU, **kw)
        leaves = _windowed_leaves(pj) if pt.w_support > 1 else _jax_leaves(pj)
        _PLANS[name] = (pj, pt, T.plan_from_jax(*leaves, device=CPU))
    return _PLANS[name]


@pytest.mark.parametrize("name", CASES)
def test_explicit_layout_matches_jax(name):
    pj, pt, _ = _plans(name)
    for f in ("S", "half", "nbig_x", "nbig_y", "w_support", "nbins", "ngroups", "bin_gstart", "bin_gcount", "k0_off",
              "hermitian"):
        assert getattr(pt, f) == getattr(pj, f), f
    np.testing.assert_array_equal(pt.bid.numpy(), np.asarray(pj.bid))
    slots = _jax_slot_map(pj) if pt.w_support > 1 else np.asarray(pj.cg_idx)
    np.testing.assert_array_equal(pt.cg_idx.numpy(), slots)
    assert _rel(torch.complex(pt.corr_re, pt.corr_im), np.asarray(pj.corr_re) + 1j * np.asarray(pj.corr_im)) < 1e-12
    extra = CASES[name][2]
    assert pt.S == extra.get("subgrid", pt.S) and pt.half == extra.get("half", pt.S // 2)


@pytest.mark.parametrize("name", CASES)
def test_explicit_plans_give_jax_images(name):
    """vis2dirty_idg and dirty2vis_idg on the port's own plan against the
    JAX runtime, and the port's runtime on ``plan_from_jax`` of the JAX
    plan against the port's own plan."""
    pj, pt, pc = _plans(name)
    *_, vis, wgt, img, _ = _problem(name)
    tol = 1e-10 if CASES[name][0] == "wide" else 1e-9
    v, w, x = torch.as_tensor(vis), torch.as_tensor(wgt), torch.as_tensor(img)
    dt = T.vis2dirty_idg(pt, v, wgt=w)
    assert _rel(dt, J.vis2dirty_idg(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt))) < tol
    assert _rel(T.vis2dirty_idg(pc, v, wgt=w), dt) < tol
    mt = T.dirty2vis_idg(pt, x)
    assert _rel(mt, J.dirty2vis_idg(pj, jnp.asarray(img))) < tol
    assert _rel(T.dirty2vis_idg(pc, x), mt) < tol


@pytest.mark.parametrize("name", ["flips", "subgrid24_flipv_no_hermitian"])
def test_explicit_conventions_within_delivered_accuracy_of_dft(name):
    """The flips reach the DFT's convention: the port's plan against the
    port's direct DFT with the same flips, within the plan's edge budget,
    both ways."""
    _, pt, _ = _plans(name)
    uvw, freq, vis, wgt, img, kw = _problem(name)
    flips = {k: kw[k] for k in ("flip_u", "flip_v", "flip_w") if k in kw}
    geo = dict(nx=kw["nx"], ny=kw["ny"], cellx=kw["cellx"], celly=kw["celly"], divide_by_n=False, device=CPU, **flips)
    budget = T.delivered_accuracy(pt)["edge"]
    dd = T_dft.vis2dirty_dft(uvw, freq, torch.as_tensor(vis), wgt=torch.as_tensor(wgt), **geo)
    assert _rel(T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt)), dd) < budget
    vd = T_dft.dirty2vis_dft(uvw, freq, torch.as_tensor(img), **geo)
    assert _rel(T.dirty2vis_idg(pt, torch.as_tensor(img)), vd) < budget


@pytest.mark.parametrize("bad,match", [(dict(group_size=64), "group_size"), (dict(eval_backend="einsum"), "einsum"),
                                       (dict(subgrid=20), "subgrid in"), (dict(subgrid=24, half=16), "multiple"),
                                       (dict(max_bins=1), "w-bins")])
def test_refused_arguments_raise(bad, match):
    """The card's kernels serve groups of 128 and S in {16, 24, 32}; half
    must divide S; a chirp layout over ``max_bins`` raises, as in JAX."""
    uvw, freq, *_, kw = _problem("no_hermitian")
    kw = dict(kw, hermitian=True, **bad)
    with pytest.raises(ValueError, match=match):
        T.plan_idg(uvw, freq, device=CPU, **kw)
    if "max_bins" in bad or "half" in bad:
        with pytest.raises(ValueError):
            J.plan_idg(uvw, freq, eval_backend="einsum", dtype=np.float64, **kw)
