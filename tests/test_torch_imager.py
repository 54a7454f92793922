"""The slice as a whole: the port's ``imager`` against the JAX ``imager`` on
one small visibility store built by the JAX ``simulate_vis_store`` ->
``init`` chain, on the CPU.

Each route is compared product by product on every band node: DIRTY, PSF,
PSFHAT, WSUM, NOISE and PSFPARSN, the partitions' weights and PSFs, and the
root attributes. Tolerances: f64 routes ("stack", "idg", "auto") to 1e-9
relative (the same algorithms in another summation order; the clean-beam
fit to 1e-6, an L-BFGS-B run on those PSFs); the f32 "pallas" route to
2e-5, the JAX Pallas tests' own bound.
"""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu.core import imager as JI
from pfb_imaging_tpu.core.init import init
from pfb_imaging_tpu.core.simulate import simulate_vis_store
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch.core import imager as TI

torch.set_num_threads(1)
COMMON = dict(nband=2, nx=32, ny=32, psf_oversize=1.5, fits_out=False)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def xds(tmp_path_factory):
    d = tmp_path_factory.mktemp("imager")
    ms = str(d / "sim.ms.tree")
    simulate_vis_store(ms, nant=6, ntime=2, nchan=4, nx=24, beam_diameter=13.5, noise=0.1)
    init(ms, str(d / "sim.xds"), product="I")
    return d


@pytest.fixture(scope="module")
def dense_xds(tmp_path_factory):
    """One partition of 8 stacked snapshots of 16 antennas: dense enough
    for the IDG slot-padding probe to accept it."""
    d = tmp_path_factory.mktemp("imager_dense")
    ms = str(d / "sim.ms.tree")
    simulate_vis_store(ms, nant=16, ntime=8, times_per_scan=8, nchan=4, nx=24, noise=0.1)
    init(ms, str(d / "sim.xds"), product="I")
    return d


@pytest.fixture(scope="module")
def wide_xds(tmp_path_factory):
    """One partition of 8 stacked snapshots of 24 antennas, imaged below
    at 100 arcsec cells: a wide field, where the IDG planner picks wplanes
    and the slot-padding probe accepts it."""
    d = tmp_path_factory.mktemp("imager_wide")
    ms = str(d / "sim.ms.tree")
    simulate_vis_store(ms, nant=24, ntime=8, times_per_scan=8, nchan=4, nx=24, noise=0.1)
    init(ms, str(d / "sim.xds"), product="I")
    return d


def _run_both(d, name, **kw):
    kw = {**COMMON, **kw}
    tj, tt = str(d / f"{name}_j.dt"), str(d / f"{name}_t.dt")
    JI.imager(str(d / "sim.xds"), tj, **kw)
    TI.imager(str(d / "sim.xds"), tt, device="cpu", **kw)
    return TreeStore(tj), TreeStore(tt)


def _compare(sj, st, tol, names=("DIRTY", "PSF", "PSFHAT", "WSUM", "NOISE"), fit_tol=1e-6):
    assert st.groups() == sj.groups()
    assert st.attrs["complete"] is True
    for a in ("nband", "ntime", "nx", "ny", "nx_psf", "ny_psf", "product"):
        assert st.attrs[a] == sj.attrs[a], a
    for a in ("cell_rad", "wsum"):
        assert st.attrs[a] == pytest.approx(sj.attrs[a], rel=1e-12), a
    assert np.allclose(st.attrs["freq_out"], sj.attrs["freq_out"], rtol=1e-15)
    assert np.allclose(st.attrs["psfpars"], sj.attrs["psfpars"], rtol=fit_tol)
    for key in sj.groups():
        nj, nt = sj.group(key), st.group(key)
        for name in names:
            assert nt.has(name), (key, name)
            assert _rel(nt.read(name), nj.read(name)) < tol, (key, name)
        assert np.allclose(nt.read("PSFPARSN"), nj.read("PSFPARSN"), rtol=fit_tol), key
        for a in ("freq_out", "wsum", "time_out"):
            assert nt.attrs[a] == pytest.approx(nj.attrs[a], rel=1e-12), (key, a)
        for pk in nj.groups():
            for name in ("WEIGHT", "MASK", "UVW", "FREQ", "VIS"):
                assert np.array_equal(nt.group(pk).read(name), nj.group(pk).read(name)), (key, pk, name)
            assert _rel(nt.group(pk).read("PSF"), nj.group(pk).read("PSF")) < tol, (key, pk)


def test_stack_f64_matches_jax(xds):
    """Natural weights, two bands and two time bins (one partition each),
    the BEAM product, the NOISE image and the FITS output."""
    sj, st = _run_both(xds, "stack", gridder="stack", ntime=2, fits_out=True)
    _compare(sj, st, 1e-9, names=("DIRTY", "PSF", "PSFHAT", "WSUM", "NOISE", "BEAM"))
    assert len(st.groups()) == 4
    assert (xds / "stack_t_dirty_mfs.fits").exists() and (xds / "stack_t_psf_mfs.fits").exists()
    assert TI.IMAGER_STATS["route"] == "stack"


def test_briggs_weights_match_jax(xds):
    sj, st = _run_both(xds, "briggs", gridder="stack", robustness=0.0)
    _compare(sj, st, 1e-9)
    natural = TreeStore(str(xds / "sim.xds"))
    w_in = natural.group(natural.groups()[0]).read("WEIGHT")
    w_out = st.group(st.groups()[0]).group("part0000").read("WEIGHT")
    assert not np.allclose(w_out, w_in[:, : w_out.shape[1]])


def test_pallas_f32_matches_jax(xds):
    """The pallas route (the CUDA kernel's plain version here) against the
    JAX Pallas route in interpret mode, both f32."""
    sj, st = _run_both(xds, "pallas", gridder="pallas", double_precision=False, epsilon=1e-5)
    _compare(sj, st, 2e-5, fit_tol=1e-3)
    assert TI.IMAGER_STATS["route"] == "pallas"
    assert all(p["psf"]["nw"] >= 1 for p in TI.IMAGER_STATS["plans"])


def test_idg_f64_matches_jax(xds):
    sj, st = _run_both(xds, "idg", gridder="idg", epsilon=1e-7)
    _compare(sj, st, 1e-9)
    assert TI.IMAGER_STATS["route"] == "idg"


@pytest.mark.parametrize("layout, eps, route", [("dense", 1e-7, "idg"), ("sparse", 1e-7, "stack"),
                                               ("sparse", 1e-9, "stack")])
def test_auto_routes_as_jax(xds, dense_xds, layout, eps, route):
    """``gridder="auto"``: IDG where the slot-padding probe accepts the
    layout, stack where it refuses it or below IDG's accuracy envelope. The
    products match JAX's to 1e-9, which the two routes' 1e-7-level
    differences would break, so JAX took the same route."""
    d = dense_xds if layout == "dense" else xds
    sj, st = _run_both(d, f"auto{eps:.0e}", gridder="auto", epsilon=eps)
    assert TI.IMAGER_STATS["route"] == route
    _compare(sj, st, 1e-9)


def test_auto_wide_field_grids_on_wplanes_as_jax(wide_xds):
    """``gridder="auto"`` on a wide field: the probe keeps IDG, every image
    and PSF plan is a wplanes plan, and the products match JAX's to 1e-9."""
    sj, st = _run_both(wide_xds, "wide", gridder="auto", epsilon=1e-7, cell_size=100.0, nband=1,
                        use_mesh=False)
    assert TI.IMAGER_STATS["route"] == "idg"
    plans = [p[k] for p in TI.IMAGER_STATS["plans"] for k in ("image", "psf")]
    assert plans and all(p["w_support"] > 1 for p in plans)
    _compare(sj, st, 1e-9)


@pytest.fixture(scope="module")
def port_xds(tmp_path_factory):
    """The ``xds`` store made by the port alone (its simulate -> init), for
    the tests that need no JAX product."""
    from pfb_imaging_tpu_torch.core.init import init as port_init
    from pfb_imaging_tpu_torch.core.simulate import simulate_vis_store as port_simulate

    d = tmp_path_factory.mktemp("imager_port")
    ms = str(d / "sim.ms.tree")
    port_simulate(ms, nant=6, ntime=2, nchan=4, nx=24, beam_diameter=13.5, noise=0.1, device="cpu")
    port_init(ms, str(d / "sim.xds"), product="I", device="cpu")
    return d


def test_unported_options_raise(port_xds):
    """``use_mesh=True`` on one process (a one-rank row mesh: the sharded
    planner at one shard) gives the products of ``use_mesh=False``; an
    unknown gridder raises."""
    xds = port_xds
    kw = dict(nband=2, nx=24, epsilon=1e-7, gridder="idg", fits_out=False, device="cpu")
    TI.imager(str(xds / "sim.xds"), str(xds / "mesh.dt"), use_mesh=True, **kw)
    assert TI.IMAGER_STATS["route"] == "idg" and TI.IMAGER_STATS["mesh_row_size"] == 1
    TI.imager(str(xds / "sim.xds"), str(xds / "plain.dt"), use_mesh=False, **kw)
    a, b = TreeStore(str(xds / "plain.dt")), TreeStore(str(xds / "mesh.dt"))
    for g in a.groups():
        for prod in ("DIRTY", "PSF", "WSUM", "NOISE"):
            x, y = np.asarray(a.group(g).read(prod)), np.asarray(b.group(g).read(prod))
            np.testing.assert_allclose(y, x, rtol=1e-10, atol=1e-10 * np.abs(x).max(), err_msg=(g, prod))
    with pytest.raises(ValueError):
        TI.imager(str(xds / "sim.xds"), str(xds / "x.dt"), gridder="wsclean", device="cpu")


def test_band_mapping_and_psf_vis_match_jax():
    freqs = np.linspace(0.9e9, 1.1e9, 7)
    for nband in (1, 3, 7):
        for a, b in zip(TI.band_mapping(freqs, nband), JI.band_mapping(freqs, nband)):
            assert np.array_equal(a, b)
    uvw = np.random.default_rng(1).uniform(-500, 500, (20, 3))
    for l0, m0 in ((0.0, 0.0), (1e-3, -2e-3)):
        assert _rel(TI._psf_vis(uvw, freqs, l0, m0), JI._psf_vis(uvw, freqs, l0, m0)) < 1e-14
