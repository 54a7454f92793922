"""The whole slice: the port's ``deconv`` major cycle against the JAX
``deconv`` on copies of one small .dt tree (nx 64, 2 bands, 1 partition),
in f64 on the CPU.

The JAX run takes the per-band residual route (its multiband residual is
monkeypatched off), which is the route the port implements; both runs get
the same ``hess_norm`` and tolerances so small that CG and PD run exactly
``maxit`` iterations. MODEL, RESIDUAL and the rms/rmax attrs then agree to
f64 rounding accumulated over two cycles (<= 1e-8 relative)."""

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


def _dft_dirty(uvw, freq, vis, wgt, n):
    """dirty[x, y] = sum w Re(V exp(+2 pi i phase)), the pinned convention
    (su, sv, sw) = (1, -1, 1) at the field centre, without the 1/n."""
    c = (np.arange(n) - n // 2) * CELL
    ll, mm = np.meshgrid(c, c, indexing="ij")
    nm1 = np.sqrt(1.0 - ll**2 - mm**2) - 1.0
    out = np.zeros((n, n))
    for f in range(freq.size):
        u, v, w = (uvw * (freq[f] / LIGHTSPEED)).T
        ph = 2j * np.pi * (u[:, None] * ll.ravel() - v[:, None] * mm.ravel() - w[:, None] * nm1.ravel())
        out += np.real((wgt[:, f] * vis[:, f]) @ np.exp(ph)).reshape(n, n)
    return out


def _model_vis(uvw, freq, srcs):
    c = (np.arange(NX) - NX // 2) * CELL
    vis = np.zeros((uvw.shape[0], freq.size), complex)
    for (p, q, flux) in srcs:
        l, m = c[p], c[q]
        nm1 = np.sqrt(1.0 - l * l - m * m) - 1.0
        for f in range(freq.size):
            u, v, w = (uvw * (freq[f] / LIGHTSPEED)).T
            vis[:, f] += flux * np.exp(-2j * np.pi * (u * l - v * m - w * nm1))
    return vis


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    rng = np.random.default_rng(13)
    uvw = rng.uniform(-1500, 1500, (NROW, 3))
    uvw[:, 2] *= 0.05
    srcs = [(NX // 2 + 5, NX // 2 - 3, 1.0), (NX // 4, NX // 2, 0.4)]
    path = tmp_path_factory.mktemp("slice") / "t.dt"
    root = TreeStore(path, mode="w")
    wsum_tot = 0.0
    for b, freq in enumerate(FREQS):
        wgt = rng.uniform(0.5, 1.5, (NROW, freq.size))
        mask = (rng.random((NROW, freq.size)) > 0.05).astype(np.uint8)
        vis = _model_vis(uvw, freq, srcs) + 0.05 * (rng.standard_normal((NROW, freq.size))
                                                    + 1j * rng.standard_normal((NROW, freq.size)))
        wm = wgt * mask
        psf = _dft_dirty(uvw, freq, np.ones_like(vis), wm, NXP)
        node = root.group(f"band{b:04d}_time0000")
        wsum = float(wm.sum())
        wsum_tot += wsum
        node.write("DIRTY", _dft_dirty(uvw, freq, vis, wm, NX))
        node.write("WSUM", np.asarray([wsum]))
        node.set_attrs(freq_out=float(freq.mean()), wsum=wsum, niters=0, time_out=0.0)
        pg = node.group("part0000")
        pg.set_attrs(l0=0.0, m0=0.0, wsum=wsum)
        for name, arr in (("UVW", uvw), ("FREQ", freq), ("WEIGHT", wgt), ("MASK", mask), ("VIS", vis),
                          ("PSFHAT", np.fft.rfft2(np.fft.ifftshift(psf)))):
            pg.write(name, arr)
    root.set_attrs(nx=NX, ny=NX, nx_psf=NXP, ny_psf=NXP, nband=2, ntime=1, cell_rad=CELL,
                   freq_out=[float(f.mean()) for f in FREQS], wsum=wsum_tot, complete=True)
    ph = max(np.abs(TreeStore(path).group(f"band{b:04d}_time0000").group("part0000").read("PSFHAT")).max()
             for b in range(2))
    return path, 1.05 * ph / wsum_tot


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_deconv_matches_jax(tree, tmp_path, monkeypatch):
    import pfb_imaging_tpu.core.deconv as jdeconv

    from pfb_imaging_tpu_torch.core import deconv as tdeconv

    src, hess_norm = tree
    pj, pt = tmp_path / "j.dt", tmp_path / "t.dt"
    shutil.copytree(src, pj)
    shutil.copytree(src, pt)
    monkeypatch.setattr(jdeconv, "residual_from_parts_multiband", lambda *a, **k: None)
    mj, rj = jdeconv.deconv(str(pj), hess_norm=hess_norm, use_mesh=False, **SOLVE)
    mt, rt = tdeconv.deconv(str(pt), hess_norm=hess_norm, device="cpu", **SOLVE)
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
