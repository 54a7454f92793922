"""The whole slice: the port's ``deconv`` major cycle against the JAX
``deconv`` on copies of one small .dt tree (nx 64, 2 bands, 1 partition),
in f64 on the CPU, and the exact residual's routes: multiband (chirp plans
on that tree; wplanes plans on a wide-w tree) and per band.

Both runs take the same residual route (by default the multiband one, as
the JAX package does; or both with the multiband route switched off), the
same ``hess_norm`` and tolerances so small that CG and PD run exactly
``maxit`` iterations. MODEL, RESIDUAL and the rms/rmax attrs then agree to
f64 rounding accumulated over the cycles (<= 1e-8 relative); the residuals
alone to 1e-10."""

import shutil
from collections import OrderedDict

import numpy as np
import pytest
import torch

from pfb_imaging_tpu.constants import LIGHTSPEED
from pfb_imaging_tpu.utils.store import TreeStore

torch.set_num_threads(1)
NX, NXP, CELL, NROW = 64, 128, 1e-4, 600
FREQS = (np.array([1.00e9, 1.05e9]), np.array([1.10e9, 1.15e9]))
SOLVE = dict(niter=2, epsilon=1e-7, cg_tol=1e-30, cg_maxit=6, pd_tol=1e-30, pd_maxit=15)


def _dft_dirty(uvw, freq, vis, wgt, n, cell=CELL):
    """dirty[x, y] = sum w Re(V exp(+2 pi i phase)), the pinned convention
    (su, sv, sw) = (1, -1, 1) at the field centre, without the 1/n."""
    c = (np.arange(n) - n // 2) * cell
    ll, mm = np.meshgrid(c, c, indexing="ij")
    nm1 = np.sqrt(1.0 - ll**2 - mm**2) - 1.0
    out = np.zeros((n, n))
    for f in range(freq.size):
        u, v, w = (uvw * (freq[f] / LIGHTSPEED)).T
        ph = 2j * np.pi * (u[:, None] * ll.ravel() - v[:, None] * mm.ravel() - w[:, None] * nm1.ravel())
        out += np.real((wgt[:, f] * vis[:, f]) @ np.exp(ph)).reshape(n, n)
    return out


def _model_vis(uvw, freq, srcs, cell=CELL):
    c = (np.arange(NX) - NX // 2) * cell
    vis = np.zeros((uvw.shape[0], freq.size), complex)
    for (p, q, flux) in srcs:
        l, m = c[p], c[q]
        nm1 = np.sqrt(1.0 - l * l - m * m) - 1.0
        for f in range(freq.size):
            u, v, w = (uvw * (freq[f] / LIGHTSPEED)).T
            vis[:, f] += flux * np.exp(-2j * np.pi * (u * l - v * m - w * nm1))
    return vis


def _build_tree(path, rng, uvw, cell):
    """A complete two-band .dt tree on one partition: DFT DIRTY and PSF of
    two point sources plus noise, with random weights and masks."""
    srcs = [(NX // 2 + 5, NX // 2 - 3, 1.0), (NX // 4, NX // 2, 0.4)]
    nrow = uvw.shape[0]
    root = TreeStore(path, mode="w")
    wsum_tot = 0.0
    for b, freq in enumerate(FREQS):
        wgt = rng.uniform(0.5, 1.5, (nrow, freq.size))
        mask = (rng.random((nrow, freq.size)) > 0.05).astype(np.uint8)
        vis = _model_vis(uvw, freq, srcs, cell) + 0.05 * (rng.standard_normal((nrow, freq.size))
                                                          + 1j * rng.standard_normal((nrow, freq.size)))
        wm = wgt * mask
        psf = _dft_dirty(uvw, freq, np.ones_like(vis), wm, NXP, cell)
        node = root.group(f"band{b:04d}_time0000")
        wsum = float(wm.sum())
        wsum_tot += wsum
        node.write("DIRTY", _dft_dirty(uvw, freq, vis, wm, NX, cell))
        node.write("WSUM", np.asarray([wsum]))
        node.set_attrs(freq_out=float(freq.mean()), wsum=wsum, niters=0, time_out=0.0)
        pg = node.group("part0000")
        pg.set_attrs(l0=0.0, m0=0.0, wsum=wsum)
        for name, arr in (("UVW", uvw), ("FREQ", freq), ("WEIGHT", wgt), ("MASK", mask), ("VIS", vis),
                          ("PSFHAT", np.fft.rfft2(np.fft.ifftshift(psf)))):
            pg.write(name, arr)
    root.set_attrs(nx=NX, ny=NX, nx_psf=NXP, ny_psf=NXP, nband=2, ntime=1, cell_rad=cell,
                   freq_out=[float(f.mean()) for f in FREQS], wsum=wsum_tot, complete=True)
    ph = max(np.abs(TreeStore(path).group(f"band{b:04d}_time0000").group("part0000").read("PSFHAT")).max()
             for b in range(2))
    return path, 1.05 * ph / wsum_tot


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    rng = np.random.default_rng(13)
    uvw = rng.uniform(-1500, 1500, (NROW, 3))
    uvw[:, 2] *= 0.05
    return _build_tree(tmp_path_factory.mktemp("slice") / "t.dt", rng, uvw, CELL)


@pytest.fixture(scope="module")
def wide_tree(tmp_path_factory):
    """A wide field with a wide w spread (cell 2e-4, |uv| < 600 m, |w| <
    1500 m, 800 rows): at epsilon 1e-7 the IDG planner picks wplanes, for
    the multiband count pass and for each band."""
    rng = np.random.default_rng(29)
    uvw = rng.uniform(-600, 600, (800, 3))
    uvw[:, 2] = rng.uniform(-1500, 1500, 800)
    return _build_tree(tmp_path_factory.mktemp("wide") / "w.dt", rng, uvw, 2e-4)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def _deconv_both(src, hess_norm, tmp_path, niter=2):
    import pfb_imaging_tpu.core.deconv as jdeconv

    from pfb_imaging_tpu_torch.core import deconv as tdeconv

    pj, pt = tmp_path / "j.dt", tmp_path / "t.dt"
    shutil.copytree(src, pj)
    shutil.copytree(src, pt)
    kw = dict(SOLVE, niter=niter)
    mj, rj = jdeconv.deconv(str(pj), hess_norm=hess_norm, use_mesh=False, **kw)
    mt, rt = tdeconv.deconv(str(pt), hess_norm=hess_norm, device="cpu", **kw)
    return pj, pt, mj, rj, mt, rt


def test_deconv_matches_jax(tree, tmp_path):
    """Both runs take their default residual route, the multiband one."""
    from pfb_imaging_tpu_torch.core import deconv as tdeconv

    src, hess_norm = tree
    pj, pt, mj, rj, mt, rt = _deconv_both(src, hess_norm, tmp_path)
    assert tdeconv.CYCLE_STATS[-1]["residual_dispatch"]["multiband_parts"] >= 2
    assert [s["cg_iters"] for s in tdeconv.CYCLE_STATS] == [SOLVE["cg_maxit"]] * 2
    assert [s["pd_iters"] for s in tdeconv.CYCLE_STATS] == [SOLVE["pd_maxit"]] * 2
    assert np.abs(mt).max() > 0
    assert _rel(mt, mj) < 1e-8
    assert _rel(rt, rj) < 1e-8
    for b in range(2):
        nj = TreeStore(pj).group(f"band{b:04d}_time0000")
        nt = TreeStore(pt).group(f"band{b:04d}_time0000")
        for name in ("MODEL", "RESIDUAL", "UPDATE", "MODEL_BEST", "DUAL"):
            assert _rel(nt.read(name), nj.read(name)) < 1e-8, name
        assert nt.attrs["niters"] == nj.attrs["niters"] == 2
        for a in ("rms", "rmax"):
            assert abs(nt.attrs[a] - nj.attrs[a]) / abs(nj.attrs[a]) < 1e-8, a
    assert TreeStore(pt).attrs["hess_norm"] == pytest.approx(hess_norm, rel=1e-15)
    # the residual shrinks from cycle 1 to cycle 2
    stats = tdeconv.CYCLE_STATS
    assert stats[-1]["rms"] < stats[0]["rms"]


def test_deconv_per_band_route_matches_jax(tree, tmp_path, monkeypatch):
    """With the multiband route switched off in both packages, every band
    falls back to the per-band residual (queued on the device, then
    fetched) and the cycle still matches JAX's."""
    import pfb_imaging_tpu.core.deconv as jdeconv

    from pfb_imaging_tpu_torch.core import deconv as tdeconv

    src, hess_norm = tree
    monkeypatch.setattr(jdeconv, "residual_from_parts_multiband", lambda *a, **k: None)
    monkeypatch.setattr(tdeconv, "residual_from_parts_multiband", lambda *a, **k: None)
    pj, pt, mj, rj, mt, rt = _deconv_both(src, hess_norm, tmp_path)
    d = [s["residual_dispatch"]["fallback_bands"] for s in tdeconv.CYCLE_STATS]
    assert d[1] - d[0] == 2
    assert _rel(mt, mj) < 1e-8 and _rel(rt, rj) < 1e-8


def test_deconv_wide_field_matches_jax(wide_tree, tmp_path):
    """One cycle on the wide-w tree: the residual runs on wplanes plans
    through the multiband route in both packages."""
    from pfb_imaging_tpu_torch.core import deconv as tdeconv

    src, hess_norm = wide_tree
    pj, pt, mj, rj, mt, rt = _deconv_both(src, hess_norm, tmp_path, niter=1)
    assert tdeconv.CYCLE_STATS[0]["residual_dispatch"]["multiband_parts"] >= 1
    assert np.abs(mt).max() > 0
    assert _rel(mt, mj) < 1e-8 and _rel(rt, rj) < 1e-8


@pytest.mark.parametrize("which", ["tree", "wide_tree"])
def test_multiband_residual_matches_jax(which, request):
    """The port's multiband residual against JAX's, chirp plans on the
    narrow tree and wplanes plans on the wide one; then the port's per-band
    route ("auto") against JAX's."""
    from pfb_imaging_tpu.core.imager import residual_from_parts as jresidual
    from pfb_imaging_tpu.core.imager import residual_from_parts_multiband as jmultiband

    from pfb_imaging_tpu_torch.core import imager as TI

    src, _ = request.getfixturevalue(which)
    dt = TreeStore(src)
    keys = [k for k in dt.groups() if k.startswith("band")]
    model = np.stack([_residual_model() * s for s in (1.0, 0.8)])
    rj = jmultiband(dt, keys, model, epsilon=1e-7)
    n0 = TI.RESIDUAL_DISPATCH_STATS["multiband_parts"]
    rt = TI.residual_from_parts_multiband(dt, keys, model, epsilon=1e-7, device="cpu")
    assert rj is not None and rt is not None
    assert TI.RESIDUAL_DISPATCH_STATS["multiband_parts"] == n0 + 1
    mplan = next(v for k, v in reversed(TI._PLAN_CACHE.items()) if k[0] == "multiband")[0]
    assert (mplan.w_support > 1) == (which == "wide_tree")
    assert _rel(rt, rj) < 1e-10
    for b, k in enumerate(keys):
        pb = TI.residual_from_parts(dt.group(k), model[b], epsilon=1e-7, device="cpu")
        assert _rel(pb, jresidual(dt.group(k), model[b], epsilon=1e-7)) < 1e-10
        plan, wgt = next(reversed(TI._PLAN_CACHE.values()))[:2]
        assert plan.w_support == mplan.w_support and wgt.shape == ((800, 2) if which == "wide_tree" else
                                                                  (plan.ngroups, plan.G))


def test_multiband_residual_applies_the_beam_once(tree, tmp_path):
    """With a BEAM in every partition the multiband route gives the
    per-band route's residual, DIRTY - R^H W R (beam model) (the JAX
    multiband route also multiplies the result by the beam)."""
    from pfb_imaging_tpu_torch.core import imager as TI

    src, _ = tree
    path = tmp_path / "beam.dt"
    shutil.copytree(src, path)
    dt = TreeStore(path)
    keys = [k for k in dt.groups() if k.startswith("band")]
    c = (np.arange(NX) - NX // 2) / NX
    for b, k in enumerate(keys):
        dt.group(k).group("part0000").write("BEAM", np.exp(-(c[:, None] ** 2 + c[None, :] ** 2) * (2.0 + b)))
    model = np.stack([_residual_model() * s for s in (1.0, 0.8)])
    rt = TI.residual_from_parts_multiband(dt, keys, model, epsilon=1e-7, device="cpu")
    rb = np.stack([TI.residual_from_parts(dt.group(k), model[b], epsilon=1e-7, device="cpu")
                   for b, k in enumerate(keys)])
    assert rt is not None and _rel(rt, rb) < 1e-10


def test_multiband_residual_declines_what_jax_declines(tree, monkeypatch):
    """``None`` for one band, below IDG's envelope, and on a planner
    refusal (a slot budget it cannot meet)."""
    from pfb_imaging_tpu.core.imager import residual_from_parts_multiband as jmultiband

    from pfb_imaging_tpu_torch.core import imager as TI

    src, _ = tree
    dt = TreeStore(src)
    keys = [k for k in dt.groups() if k.startswith("band")]
    model = np.zeros((2, NX, NX))
    assert TI.residual_from_parts_multiband(dt, keys[:1], model[:1], device="cpu") is None
    assert TI.residual_from_parts_multiband(dt, keys, model, epsilon=1e-9, device="cpu") is None
    monkeypatch.setattr(TI, "IDG_MAX_SLOT_FACTOR", 1e-3)
    monkeypatch.setattr(TI, "_PLAN_CACHE", OrderedDict())
    assert TI.residual_from_parts_multiband(dt, keys, model, device="cpu") is None
    import pfb_imaging_tpu.core.imager as JI

    monkeypatch.setattr(JI, "IDG_MAX_SLOT_FACTOR", 1e-3)
    monkeypatch.setattr(JI, "_PLAN_CACHE", OrderedDict())
    assert jmultiband(dt, keys, model) is None


def test_multiband_decline_is_cached_and_counts_nothing(tree, tmp_path, monkeypatch):
    """A slice whose second partition the multiband route refuses (its uvw
    differ between the bands) returns ``None`` without counting a
    partition or keeping the first partition's plan; the next call declines
    from the cache, without planning again, as JAX's route declines."""
    from pfb_imaging_tpu.core.imager import residual_from_parts_multiband as jmultiband

    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.parallel import sharded

    src, _ = tree
    path = tmp_path / "two_parts.dt"
    shutil.copytree(src, path)
    dt = TreeStore(path)
    keys = [k for k in dt.groups() if k.startswith("band")]
    for b, k in enumerate(keys):
        p0, p1 = dt.group(k).group("part0000"), TreeStore(path / k / "part0001", mode="w")
        p1.set_attrs(l0=0.0, m0=0.0)
        for name in ("FREQ", "WEIGHT", "MASK"):
            p1.write(name, np.asarray(p0.read(name)))
        p1.write("UVW", np.asarray(p0.read("UVW")) * (1.0 + 0.01 * b))
    model = np.stack([_residual_model() * s for s in (1.0, 0.8)])
    monkeypatch.setattr(TI, "_PLAN_CACHE", OrderedDict())
    monkeypatch.setattr(TI, "_PLAN_CACHE_BYTES", 0)
    n0, p0 = TI.RESIDUAL_DISPATCH_STATS["multiband_parts"], TI.PLAN_STATS["plans"]
    assert TI.residual_from_parts_multiband(dt, keys, model, device="cpu") is None
    assert jmultiband(dt, keys, model) is None
    assert TI.RESIDUAL_DISPATCH_STATS["multiband_parts"] == n0 and TI.PLAN_STATS["plans"] == p0 + 1
    assert list(TI._PLAN_CACHE.values()) == [None] and TI._PLAN_CACHE_BYTES == 0

    def refuse(*a, **k):
        raise AssertionError("a cached decline plans again")

    monkeypatch.setattr(sharded, "plan_idg_multiband_freqs", refuse)
    assert TI.residual_from_parts_multiband(dt, keys, model, device="cpu") is None
    assert TI.RESIDUAL_DISPATCH_STATS["multiband_parts"] == n0


def test_deconv_resumes_from_checkpoint(tree, tmp_path):
    """A second call continues from niters, the MODEL and the DUAL."""
    from pfb_imaging_tpu_torch.core import deconv as tdeconv

    src, hess_norm = tree
    pt = tmp_path / "t.dt"
    shutil.copytree(src, pt)
    kw = dict(SOLVE, niter=1)
    tdeconv.deconv(str(pt), hess_norm=hess_norm, device="cpu", **kw)
    tdeconv.deconv(str(pt), hess_norm=None, device="cpu", **kw)  # hess_norm from attrs
    node = TreeStore(pt).group("band0000_time0000")
    assert node.attrs["niters"] == 2
    assert tdeconv.CYCLE_STATS[0]["iter"] == 2
    assert node.has("DUAL")


def test_multiband_jax_residual_matches_port_per_band(tree):
    from pfb_imaging_tpu.core.imager import residual_from_parts_multiband

    from pfb_imaging_tpu_torch.core.imager import residual_from_parts

    src, _ = tree
    dt = TreeStore(src)
    keys = [k for k in dt.groups() if k.startswith("band")]
    model = np.zeros((2, NX, NX))
    model[:, NX // 2 + 5, NX // 2 - 3] = [0.9, 0.8]
    model[:, 10, 40] = 0.3
    rj = residual_from_parts_multiband(dt, keys, model, epsilon=1e-7)
    assert rj is not None
    rt = np.stack([residual_from_parts(dt.group(k), model[b], epsilon=1e-7, device="cpu")
                   for b, k in enumerate(keys)])
    assert _rel(rt, rj) < 1e-6


def test_residual_refuses_layout_outside_idg(tree):
    """An explicit ``gridder="idg"`` propagates the planner's refusal."""
    from pfb_imaging_tpu_torch.core.imager import residual_from_parts

    src, _ = tree
    node = TreeStore(src).group("band0000_time0000")
    with pytest.raises(ValueError):
        residual_from_parts(node, np.zeros((NX, NX)), epsilon=1e-9, gridder="idg", device="cpu")


def _residual_model():
    model = np.zeros((NX, NX))
    model[NX // 2 + 5, NX // 2 - 3] = 0.9
    model[10, 40] = 0.3
    return model


@pytest.mark.parametrize("gridder, eps", [("stack", 1e-7), ("auto", 1e-9)])
def test_residual_stack_matches_jax(tree, gridder, eps):
    """The classic-gridder residual (explicit, and the "auto" fallback below
    IDG's accuracy envelope) against the JAX one, f64, rel 1e-9."""
    from pfb_imaging_tpu.core.imager import residual_from_parts as jresidual

    from pfb_imaging_tpu_torch.core import imager as TI

    src, _ = tree
    node = TreeStore(src).group("band0001_time0000")
    rj = jresidual(node, _residual_model(), epsilon=eps, gridder=gridder)
    n0 = TI.PLAN_STATS["plans"]
    rt = TI.residual_from_parts(node, _residual_model(), epsilon=eps, gridder=gridder, device="cpu")
    assert _rel(rt, rj) < 1e-9
    rt2 = TI.residual_from_parts(node, _residual_model(), epsilon=eps, gridder=gridder, device="cpu")
    assert TI.PLAN_STATS["plans"] == n0 + 1 and np.array_equal(rt2, rt)  # the cached plan


def test_residual_auto_falls_back_per_partition(tree, monkeypatch):
    """``gridder="auto"`` falls back to the classic gridder when the IDG
    planner refuses a partition (here: a slot budget it cannot meet)."""
    from pfb_imaging_tpu.core.imager import residual_from_parts as jresidual

    from pfb_imaging_tpu_torch.core import imager as TI

    src, _ = tree
    node = TreeStore(src).group("band0000_time0000")
    monkeypatch.setattr(TI, "IDG_MAX_SLOT_FACTOR", 1e-3)
    monkeypatch.setattr(TI, "_PLAN_CACHE", OrderedDict())  # no plan cached by an earlier test
    rt = TI.residual_from_parts(node, _residual_model(), epsilon=1e-7, gridder="auto", device="cpu")
    plan, _, _, _, is_idg = next(reversed(TI._PLAN_CACHE.values()))
    assert not is_idg and plan.nw >= 1
    rj = jresidual(node, _residual_model(), epsilon=1e-7, gridder="stack")
    assert _rel(rt, rj) < 1e-9
