"""Port parity of the IDG gridder, chirp and wplanes modes: the port's host
planner and f64 runtime against the JAX planner's einsum backend on the
same uvw, and both against the exact DFT.

Tolerances: port vs JAX 1e-9 relative on the narrow layouts and 1e-10 on
the wide-w layout (the same f64 algorithm, summed in another order; the
wide layout's plans are equal group for group); against the DFT the plan's
own ``delivered_accuracy`` edge budget (2 epsilon in f64); adjoint gaps
1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.ops import gridder_idg as J
from pfb_imaging_tpu.ops.dft import vis2dirty_dft
from pfb_imaging_tpu_torch.ops import dft as T_dft
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
        pt = T.plan_idg(uvw, FREQ, device=CPU, divide_by_n=False, **_kw(eps))
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


def _beam_wsum(nx, wgt):
    beam = 0.5 + np.random.default_rng(29).random((nx, nx))
    return beam, float(wgt.sum())


@pytest.mark.parametrize("layout,eps", CASES)
def test_hessian_vis_beam_eta_wsum_matches_jax(layout, eps):
    """B R^H W R B x / wsum + eta x on a chirp plan, JAX's order of the
    steps (the port took (plan, x, wgt_g) only)."""
    pj, pt = _plans(layout, eps)
    _, _, wgt, img = _data(layout)
    beam, wsum = _beam_wsum(NX, wgt)
    hj = J.hessian_vis_idg(pj, jnp.asarray(img), wgt_g=J.to_group_layout(pj, jnp.asarray(wgt)),
                           beam=jnp.asarray(beam), eta=1e-3, wsum=wsum)
    ht = T.hessian_vis_idg(pt, torch.as_tensor(img), wgt_g=T.to_group_layout(pt, torch.as_tensor(wgt)),
                           beam=torch.as_tensor(beam), eta=1e-3, wsum=wsum)
    assert _rel(ht, hj) < 1e-9
    wg = T.to_group_layout(pt, torch.as_tensor(wgt))
    plain = T.hessian_vis_idg(pt, torch.as_tensor(img * beam), wgt_g=wg)
    assert _rel(ht, plain / wsum * torch.as_tensor(beam) + 1e-3 * torch.as_tensor(img)) < 1e-12


@pytest.mark.parametrize("layout,eps", CASES)
def test_vis2dirty_mask_in_jax_s_position(layout, eps):
    """``vis2dirty_idg(plan, vis, wgt, mask)``, positional and by keyword,
    grids JAX's image: the mask multiplies the weight (the port took a
    positional fourth argument as the imaginary part)."""
    pj, pt = _plans(layout, eps)
    _, vis, wgt, _ = _data(layout)
    mask = (np.random.default_rng(31).random(wgt.shape) > 0.3).astype(float)
    dj = J.vis2dirty_idg(pj, jnp.asarray(vis), jnp.asarray(wgt), jnp.asarray(mask))
    t = torch.as_tensor
    pos = T.vis2dirty_idg(pt, t(vis), t(wgt), t(mask))
    assert _rel(pos, dj) < 1e-9
    assert torch.equal(T.vis2dirty_idg(pt, t(vis), wgt=t(wgt), mask=t(mask)), pos)
    assert torch.equal(T.vis2dirty_idg(pt, t(vis), t(wgt * mask)), pos)
    dj_mask_only = J.vis2dirty_idg(pj, jnp.asarray(vis), mask=jnp.asarray(mask))
    assert _rel(T.vis2dirty_idg(pt, t(vis), mask=t(mask)), dj_mask_only) < 1e-9


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


def test_slot_budget_refuses_sparse_layout():
    uvw = _data("wbins")[0]
    with pytest.raises(ValueError, match="slot padding"):
        T.plan_idg(uvw, FREQ, device=CPU, max_slot_factor=1.0, **_kw(1e-5))


# ── the wide-w layout: wplanes under "auto" (the JAX tests'
# ``_wide_w_problem`` at twice its cell and with their routing test's w
# spread, |w| < 2200, so that "auto" picks wplanes at both epsilons) ─────

WNX, WCELL, WNROW = 128, 1e-4, 4000
WFREQ = np.linspace(1e9, 1.1e9, 2)
WIDE_CASES = [(mode, eps) for mode in ("auto", "wplanes", "chirp") for eps in (1e-5, 1e-7)]
_WIDE: dict = {}


def _wide_data():
    rng = np.random.default_rng(23)
    uvw = rng.uniform(-800, 800, (WNROW, 3))
    uvw[:, 2] = rng.uniform(-2200, 2200, WNROW)
    vis = rng.standard_normal((WNROW, 2)) + 1j * rng.standard_normal((WNROW, 2))
    wgt = rng.uniform(0.5, 2.0, (WNROW, 2))
    img = rng.standard_normal((WNX, WNX))
    return uvw, vis, wgt, img


def _wkw(eps, mode, **extra):
    return dict(nx=WNX, ny=WNX, cellx=WCELL, celly=WCELL, epsilon=eps, do_wgridding=True, w_mode=mode, **extra)


def _wide_plans(mode, eps):
    key = (mode, eps)
    if key not in _WIDE:
        uvw = _wide_data()[0]
        pj = J.plan_idg(uvw, WFREQ, eval_backend="einsum", dtype=np.float64, divide_by_n=False, **_wkw(eps, mode))
        pt = T.plan_idg(uvw, WFREQ, device=CPU, divide_by_n=False, **_wkw(eps, mode))
        _WIDE[key] = (pj, pt)
    return _WIDE[key]


def _jax_slot_map(pj):
    """A windowed JAX plan's (ng, G) original-index slot map, from its
    windows (nvis on dead slots)."""
    nvis = pj.nrow * pj.nchan
    lane = np.arange(pj.G)
    wo, wl = np.asarray(pj.win_off), np.asarray(pj.win_len)
    live = (lane >= wo[:, None]) & (lane < (wo + wl)[:, None])
    sort_idx = np.append(np.asarray(pj.sort_idx), nvis)
    return sort_idx[np.where(live, np.asarray(pj.win_start)[:, None] + lane, nvis)]


def _assert_same_layout(pj, pt):
    for f in ("S", "half", "nbig_x", "nbig_y", "w_support", "nbins", "ngroups", "bin_gstart", "bin_gcount", "k0_off"):
        assert getattr(pt, f) == getattr(pj, f), f
    np.testing.assert_allclose(pt.bin_wc, pj.bin_wc, rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(pt.bid.numpy(), np.asarray(pj.bid))
    if pt.w_support > 1:
        np.testing.assert_array_equal(pt.cg_idx.numpy(), _jax_slot_map(pj))
        np.testing.assert_array_equal(pt.rep_idx.numpy(), np.asarray(pj.rep_idx))
    else:
        np.testing.assert_array_equal(pt.cg_idx.numpy(), np.asarray(pj.cg_idx))
    assert _rel(torch.complex(pt.corr_re, pt.corr_im), np.asarray(pj.corr_re) + 1j * np.asarray(pj.corr_im)) < 1e-12


@pytest.mark.parametrize("mode,eps", WIDE_CASES)
def test_wide_plan_layout_and_count_pass_match_jax(mode, eps):
    """The mode, planes/bins, w-support and groups per bin are JAX's, and so
    is the count pass's (nbins, gcount, (wlo, whi, w_support)) triple."""
    pj, pt = _wide_plans(mode, eps)
    _assert_same_layout(pj, pt)
    assert (pt.w_support > 1) == (mode != "chirp")  # "auto" picks wplanes on this layout
    if pt.w_support > 1:
        assert pt.S == 32 and pt.half == 16 and not pt.scal[1].any() and not pt.scal[3].any()
    uvw = _wide_data()[0]
    cj = J.plan_idg(uvw, WFREQ, count_only=True, divide_by_n=False, **_wkw(eps, mode))
    ct = T.plan_idg(uvw, WFREQ, count_only=True, device=CPU, **_wkw(eps, mode))
    assert ct[0] == cj[0] and ct[1] == cj[1] and ct[2][2] == cj[2][2]
    np.testing.assert_allclose(ct[2][:2], cj[2][:2], rtol=1e-15)


@pytest.mark.parametrize("mode", ["wplanes", "chirp"])
def test_forced_w_range_and_capacities_match_jax(mode):
    """``force_w_range`` (a wider range than the layout's own) and
    ``bin_gcap`` (padded per-bin capacities) give JAX's layout and images."""
    uvw, vis, wgt, _ = _wide_data()
    nb, gc, (wlo, whi, _) = J.plan_idg(uvw, WFREQ * 1.2, count_only=True, divide_by_n=False, **_wkw(1e-5, mode))
    kw = _wkw(1e-5, mode, force_w_range=(1.2 * wlo, 1.2 * whi, nb))
    _, gcount, _ = J.plan_idg(uvw, WFREQ, count_only=True, divide_by_n=False, **kw)
    kw["bin_gcap"] = tuple(c + 2 for c in gcount)
    pj = J.plan_idg(uvw, WFREQ, eval_backend="einsum", dtype=np.float64, divide_by_n=False, **kw)
    pt = T.plan_idg(uvw, WFREQ, device=CPU, divide_by_n=False, **kw)
    _assert_same_layout(pj, pt)
    assert pt.bin_gcount == kw["bin_gcap"]
    dj = J.vis2dirty_idg(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt))
    assert _rel(T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt)), dj) < 1e-10


@pytest.mark.parametrize("eps", [1e-5, 1e-7])
def test_wplanes_runtime_matches_jax(eps):
    """vis2dirty_idg, dirty2vis_idg and hessian_vis_idg with original-layout
    weights against JAX's wplanes einsum runtime, f64."""
    pj, pt = _wide_plans("wplanes", eps)
    _, vis, wgt, img = _wide_data()
    dj = J.vis2dirty_idg(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt))
    assert _rel(T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt)), dj) < 1e-10
    vj = J.dirty2vis_idg(pj, jnp.asarray(img))
    assert _rel(T.dirty2vis_idg(pt, torch.as_tensor(img)), vj) < 1e-10
    hj = J.hessian_vis_idg(pj, jnp.asarray(img), wgt_g=jnp.asarray(wgt))
    assert _rel(T.hessian_vis_idg(pt, torch.as_tensor(img), wgt_g=torch.as_tensor(wgt)), hj) < 1e-10


@pytest.mark.parametrize("eps", [1e-5, 1e-7])
def test_wplanes_hessian_beam_eta_wsum_matches_jax(eps):
    """hessian_vis_idg(beam, eta, wsum) on a wplanes plan, whose weight is in
    original layout, and vis2dirty_idg with a positional mask there."""
    pj, pt = _wide_plans("wplanes", eps)
    _, vis, wgt, img = _wide_data()
    beam, wsum = _beam_wsum(WNX, wgt)
    hj = J.hessian_vis_idg(pj, jnp.asarray(img), wgt_g=jnp.asarray(wgt), beam=jnp.asarray(beam), eta=1e-3,
                           wsum=wsum)
    t = torch.as_tensor
    assert _rel(T.hessian_vis_idg(pt, t(img), wgt_g=t(wgt), beam=t(beam), eta=1e-3, wsum=wsum), hj) < 1e-9
    mask = (np.random.default_rng(37).random(wgt.shape) > 0.3).astype(float)
    dj = J.vis2dirty_idg(pj, jnp.asarray(vis), jnp.asarray(wgt), jnp.asarray(mask))
    assert _rel(T.vis2dirty_idg(pt, t(vis), t(wgt), t(mask)), dj) < 1e-9


@pytest.mark.parametrize("eps", [1e-5, 1e-7])
def test_wplanes_pair_is_adjoint(eps):
    """<R x, v> = <x, R^H v> through the replica sum and the windowed
    gather, gap relative to |x| |R^H v|; and the grouped pair on live slots."""
    _, pt = _wide_plans("wplanes", eps)
    _, vis, _, img = _wide_data()
    x, v = torch.as_tensor(img), torch.as_tensor(vis)
    d, mv = T.vis2dirty_idg(pt, v), T.dirty2vis_idg(pt, x)
    lhs = float((d * x).sum())
    rhs = float((v.conj() * mv).real.sum())
    assert abs(lhs - rhs) / float(d.norm() * x.norm()) < 1e-12
    vals = torch.as_tensor(np.random.default_rng(2).standard_normal((2, pt.ngroups, pt.G)))
    vals = vals * (pt.cg_idx < pt.nrow * pt.nchan)
    g = T.vis2dirty_idg_grouped(pt, vals)
    lhs = float((T.dirty2vis_idg_grouped(pt, x) * vals).sum())
    assert abs(lhs - float((x * g).sum())) / float(g.norm() * x.norm()) < 1e-12


@pytest.mark.parametrize("eps", [1e-5, 1e-7])
def test_wplanes_within_delivered_accuracy_of_dft(eps):
    pj, pt = _wide_plans("wplanes", eps)
    uvw, vis, wgt, _ = _wide_data()
    dd = np.asarray(vis2dirty_dft(jnp.asarray(uvw), jnp.asarray(WFREQ), jnp.asarray(vis), wgt=jnp.asarray(wgt),
                                  nx=WNX, ny=WNX, cellx=WCELL, celly=WCELL, divide_by_n=False))
    budget = T.delivered_accuracy(pt)["edge"]
    assert _rel(T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt)), dd) < budget


@pytest.mark.parametrize("mode,eps", WIDE_CASES)
def test_slot_factor_matches_jax(mode, eps):
    """Padding per intrinsic slot (w_support replicas in wplanes mode)."""
    uvw = _wide_data()[0]
    kw = _wkw(eps, mode)
    sj = J.idg_slot_factor(uvw, WFREQ, **kw)
    st = T.idg_slot_factor(uvw, WFREQ, **kw)
    assert st[1] == sj[1] and st[0] == pytest.approx(sj[0], rel=1e-15)


def _windowed_leaves(pj):
    names = ("au_re", "au_im", "av_re", "av_im", "scal", "wcu8", "wcv8", "sg", "bid", "phase_re", "phase_im",
             "corr_re", "corr_im", "nm1", "nm1_lo", "rep_idx", "win_start", "win_off", "win_len", "sort_idx")
    leaves = {k: np.asarray(getattr(pj, k)) for k in names}
    skip = set(names) | {"cg_idx", "inv_orig", "unsort_idx", "scr_re", "scr_im"}
    return leaves, {f.name: getattr(pj, f.name) for f in dataclasses.fields(pj) if f.name not in skip}


@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_plan_from_jax_windowed_gives_same_images(backend):
    """A windowed JAX plan carries over: the einsum plan (f64) to 1e-10 of
    the JAX images, the fused plan (f32 leaves, padded groups) to 1e-5 of
    the port's own f64 plan."""
    uvw, vis, wgt, img = _wide_data()
    _, pt = _wide_plans("wplanes", 1e-5)
    if backend == "einsum":
        pj, _ = _wide_plans("wplanes", 1e-5)
    else:
        pj = J.plan_idg(uvw, WFREQ, eval_backend="fused", dtype=np.float32, divide_by_n=False,
                        **_wkw(1e-5, "wplanes"))
        assert pj.fused and pj.windowed
    pc = T.plan_from_jax(*_windowed_leaves(pj), device=CPU)
    assert pc.w_support == pj.w_support > 1
    d_c = T.vis2dirty_idg(pc, torch.as_tensor(vis), wgt=torch.as_tensor(wgt))
    v_c = T.dirty2vis_idg(pc, torch.as_tensor(img))
    if backend == "einsum":
        assert _rel(d_c, J.vis2dirty_idg(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt))) < 1e-10
        assert _rel(v_c, J.dirty2vis_idg(pj, jnp.asarray(img))) < 1e-10
    else:
        assert _rel(d_c, T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt))) < 1e-5
        assert _rel(v_c, T.dirty2vis_idg(pt, torch.as_tensor(img))) < 1e-5


def test_f32_wplanes_plan_takes_the_flattened_taper():
    """At epsilon 1e-7 the JAX bisection leaves the chirp-free S = 32 taper
    unflattened (1/T ~ 1e3 per axis at the edge); the port's f32 plans
    search further (``fit_taper(widen=True)``) and take a flat one, whose
    f32 image stays inside its (much tighter) ``delivered_accuracy`` of the
    DFT. The f64 plan keeps JAX's taper (the parity tests above)."""
    pj, pt = _wide_plans("wplanes", 1e-7)
    uvw, vis, wgt, _ = _wide_data()
    p32 = T.plan_idg(uvw, WFREQ, device=CPU, dtype=torch.float32, divide_by_n=False, **_wkw(1e-7, "wplanes"))
    assert p32.w_support == pt.w_support and p32.bin_gcount == pt.bin_gcount
    amp32, amp64 = T.delivered_accuracy(p32)["edge_amp"], T.delivered_accuracy(pt)["edge_amp"]
    assert amp64 > 1e5 and amp32 < 1e3
    dd = np.asarray(vis2dirty_dft(jnp.asarray(uvw), jnp.asarray(WFREQ), jnp.asarray(vis), wgt=jnp.asarray(wgt),
                                  nx=WNX, ny=WNX, cellx=WCELL, celly=WCELL, divide_by_n=False))
    d32 = T.vis2dirty_idg(p32, torch.as_tensor(vis.real).float(), wgt=torch.as_tensor(wgt).float(),
                          vis_im=torch.as_tensor(vis.imag).float())
    assert _rel(d32.double(), dd) < T.delivered_accuracy(p32)["edge"]


@pytest.mark.parametrize("mode,eps", WIDE_CASES)
def test_w_scheme_pass_gives_the_count_pass_scheme(mode, eps):
    """``count_only="w"`` stops before the bucket pass with the count pass's
    bin count and (wlo, whi, w_support)."""
    uvw = _wide_data()[0]
    nb, gc, scheme = T.plan_idg(uvw, WFREQ, count_only=True, device=CPU, **_wkw(eps, mode))
    assert T.plan_idg(uvw, WFREQ, count_only="w", device=CPU, **_wkw(eps, mode)) == (nb, None, scheme)


@pytest.mark.parametrize("layout", ["wide", "wbins"])
def test_multiband_plans_match_jax_capacity_plans(layout):
    """The port's multiband planner (w scheme without a bucket pass, plans
    padded to common capacities on the device) gives, band for band, the
    layout and angles of the JAX route: an all-channel count pass, a count
    pass per band, then ``plan_idg(force_w_range, bin_gcap)``. wplanes on
    the wide layout, chirp on the narrow one, at epsilon 1e-7."""
    from pfb_imaging_tpu_torch.parallel.sharded import plan_idg_multiband_freqs

    if layout == "wide":
        uvw, kw = _wide_data()[0], _wkw(1e-7, "auto")
        freqs = [WFREQ, WFREQ * 1.15]
    else:
        uvw, kw = _data(layout)[0], dict(_kw(1e-7), w_mode="auto")
        freqs = [FREQ, FREQ * 1.15]
    mplan, nch = plan_idg_multiband_freqs(uvw, freqs, device=CPU, divide_by_n=False, **kw)
    assert nch == 2 and (mplan.w_support > 1) == (layout == "wide")
    nbins, _, (wlo, whi, ws) = J.plan_idg(uvw, np.unique(np.concatenate(freqs)), count_only=True,
                                          divide_by_n=False, **kw)
    jkw = dict(kw, w_mode="wplanes" if ws > 1 else "chirp", force_w_range=(wlo, whi, nbins), divide_by_n=False)
    counts = [J.plan_idg(uvw, f, count_only=True, **jkw)[1] for f in freqs]
    jkw["bin_gcap"] = tuple(max(1, max(c[b] for c in counts)) for b in range(nbins))
    for b, f in enumerate(freqs):
        pj = J.plan_idg(uvw, f, eval_backend="einsum", dtype=np.float64, **jkw)
        pt = mplan.plans[b]
        _assert_same_layout(pj, pt)
        assert pt.scal.data_ptr() == mplan.scal[:, mplan.band(b)].data_ptr()
        pp = T.plan_idg(uvw, f, device=CPU, **{k: v for k, v in jkw.items() if k != "divide_by_n"})
        for name in ("scal", "phase_re", "phase_im", "sg", "cg_idx", "bid"):
            torch.testing.assert_close(getattr(pt, name), getattr(pp, name), rtol=0, atol=0, msg=name)
        if pt.w_support > 1:
            torch.testing.assert_close(pt.rep_idx, pp.rep_idx, rtol=0, atol=0)


# ── divide_by_n: the 1/n of the DFT convention in the image correction ──


@pytest.mark.parametrize("layout, eps", [("wbins", 1e-5), ("wide", 1e-5)])
def test_divide_by_n_plans_match_jax_and_the_dft(layout, eps):
    """``plan_idg(divide_by_n=True)`` on a chirp layout and on a wplanes one:
    the image correction and both directions match JAX's plan (1e-9), and
    the adjoint image is within ``delivered_accuracy`` of the port's own
    ``vis2dirty_dft(divide_by_n=True)``."""
    if layout == "wide":
        uvw, vis, wgt, img = _wide_data()
        freq, nx, cell, kw = WFREQ, WNX, WCELL, _wkw(eps, "auto")
    else:
        uvw, vis, wgt, img = _data(layout)
        freq, nx, cell, kw = FREQ, NX, CELL, _kw(eps)
    pj = J.plan_idg(uvw, freq, eval_backend="einsum", dtype=np.float64, divide_by_n=True, **kw)
    pt = T.plan_idg(uvw, freq, device=CPU, divide_by_n=True, **kw)
    assert (pt.w_support > 1) == (layout == "wide")
    assert _rel(torch.complex(pt.corr_re, pt.corr_im), np.asarray(pj.corr_re) + 1j * np.asarray(pj.corr_im)) < 1e-12
    dt = T.vis2dirty_idg(pt, torch.as_tensor(vis), wgt=torch.as_tensor(wgt))
    assert _rel(dt, J.vis2dirty_idg(pj, jnp.asarray(vis), wgt=jnp.asarray(wgt))) < 1e-9
    assert _rel(T.dirty2vis_idg(pt, torch.as_tensor(img)), J.dirty2vis_idg(pj, jnp.asarray(img))) < 1e-9
    dd = T_dft.vis2dirty_dft(uvw, freq, vis, wgt=wgt, nx=nx, ny=nx, cellx=cell, celly=cell, divide_by_n=True,
                             device=CPU)
    assert _rel(dt, dd) < T.delivered_accuracy(pt)["edge"]


def test_divide_by_n_defaults_as_in_jax():
    """The default is now JAX's (True): a plan with defaults is the
    divide_by_n=True plan, and differs from the old default (False) by the
    1/n of the field's edge, far beyond the f64 parity tolerance."""
    import inspect

    for fn in (T.plan_idg, J.plan_idg):
        assert inspect.signature(fn).parameters["divide_by_n"].default is True
    uvw, vis, wgt, _ = _wide_data()
    kw = _wkw(1e-7, "auto")
    d_def, d_on, d_off = (T.vis2dirty_idg(T.plan_idg(uvw, WFREQ, device=CPU, **kw, **extra), torch.as_tensor(vis),
                                          wgt=torch.as_tensor(wgt))
                          for extra in ({}, dict(divide_by_n=True), dict(divide_by_n=False)))
    assert torch.equal(d_def, d_on)
    assert _rel(d_off, d_on) > 1e-6
