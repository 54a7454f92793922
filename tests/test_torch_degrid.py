"""The degrid slice: the port's IDG forward ``dirty2vis_idg`` and its
``degrid`` against the JAX package on the CPU, on visibility containers
from the JAX ``simulate_vis_store`` and component models fitted by the JAX
``fit_image_cube``.

Tolerances: f64 routes to 1e-9 relative to the largest visibility ("stack"
at epsilon 1e-10 to 1e-10): the same algorithms summed in another order;
MSv4 targets to 1e-6 (their MODEL_DATA is complex64); the port's f32
"pallas" route against the JAX "stack" route at epsilon 1e-5 to 2e-5, the
JAX Pallas tests' own bound. The JAX "pallas" degrid is not called: it
always raises (it plans in f64, and its gather refuses f64 plans), which
the port repairs by planning that route in f32.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.core.degrid import degrid as jax_degrid
from pfb_imaging_tpu.core.simulate import simulate_vis_store
from pfb_imaging_tpu.ops import gridder_idg as JI
from pfb_imaging_tpu.utils.modelspec import fit_image_cube, save_mds
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch.core import degrid as TD
from pfb_imaging_tpu_torch.ops import gridder_idg as TI

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _mds(d, truth, ms, name="m.mds"):
    """Two components: a centre source with a ragged spectrum and a flat
    off-centre one (the model of the JAX degrid tests)."""
    rng = np.random.default_rng(5)
    freqs = np.asarray(TreeStore(ms).attrs["freq"])
    nx = truth["nx"]
    cube = np.zeros((1, freqs.size, nx, nx))
    cube[:, :, nx // 2, nx // 2] = 1.0 + 0.05 * rng.standard_normal(freqs.size)
    cube[:, :, nx // 2 + 5, nx // 2 - 4] = 0.5
    coeffs, ix, iy, mattrs = fit_image_cube(np.zeros(1), freqs, cube)
    save_mds(TreeStore(str(d / name), mode="w"), coeffs, ix, iy, mattrs)
    return str(d / name)


@pytest.fixture(scope="module")
def sparse(tmp_path_factory):
    """Nine antennas, two scans: sparse enough that "auto" routes to stack."""
    d = tmp_path_factory.mktemp("degrid")
    ms = str(d / "d.ms.tree")
    _, truth = simulate_vis_store(ms, nant=9, ntime=2, nchan=3, nx=32)
    return d, ms, truth, _mds(d, truth, ms)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """One partition of 8 stacked snapshots of 16 antennas: dense enough for
    the IDG slot-padding bound."""
    d = tmp_path_factory.mktemp("degrid_dense")
    ms = str(d / "d.ms.tree")
    _, truth = simulate_vis_store(ms, nant=16, ntime=8, times_per_scan=8, nchan=4, nx=24)
    return d, ms, truth, _mds(d, truth, ms)


def _columns(ms, col_t, col_j):
    ts = TreeStore(ms)
    return [(np.asarray(ts.group(k).read(col_t)), np.asarray(ts.group(k).read(col_j))) for k in ts.groups()]


# ── dirty2vis_idg ────────────────────────────────────────────────────

NX, CELL = 64, 1e-4
FREQ = np.array([1.0e9, 1.1e9])


@pytest.mark.parametrize("wscale, eps", [(0.05, 1e-5), (1.0, 1e-5), (1.0, 1e-7)])
def test_dirty2vis_idg_matches_jax(wscale, eps):
    """The port's f64 ``dirty2vis_idg`` against JAX's (einsum backend) on one
    w-bin and on several, with a mask and split output; and the exact
    adjoint of the port's ``vis2dirty_idg``."""
    rng = np.random.default_rng(19)
    uvw = rng.uniform(-1500, 1500, (300, 3))
    uvw[:, 2] *= wscale
    kw = dict(nx=NX, ny=NX, cellx=CELL, celly=CELL, epsilon=eps, do_wgridding=True)
    pj = JI.plan_idg(uvw, FREQ, eval_backend="einsum", dtype=np.float64, divide_by_n=False, **kw)
    pt = TI.plan_idg(uvw, FREQ, device=CPU, divide_by_n=False, **kw)
    img = rng.standard_normal((NX, NX))
    mask = (rng.random((300, FREQ.size)) > 0.2).astype(np.float64)
    vj = np.asarray(JI.dirty2vis_idg(pj, jnp.asarray(img), mask=jnp.asarray(mask)))
    vt = TI.dirty2vis_idg(pt, torch.as_tensor(img), mask=torch.as_tensor(mask))
    assert vt.dtype == torch.complex128 and vt.shape == (300, FREQ.size)
    assert _rel(vt, vj) < 1e-9
    split = TI.dirty2vis_idg(pt, torch.as_tensor(img), mask=torch.as_tensor(mask), split=True)
    assert split.shape == (2, 300, FREQ.size) and _rel(split, np.stack([vj.real, vj.imag])) < 1e-9
    vis = rng.standard_normal((300, FREQ.size)) + 1j * rng.standard_normal((300, FREQ.size))
    lhs = float((torch.as_tensor(vis).conj() * TI.dirty2vis_idg(pt, torch.as_tensor(img))).real.sum())
    rhs = float((torch.as_tensor(img) * TI.vis2dirty_idg(pt, torch.as_tensor(vis))).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


# ── degrid, port against JAX ─────────────────────────────────────────


@pytest.mark.parametrize("gridder, eps, tol", [("stack", 1e-10, 1e-10), ("idg", 1e-6, 1e-9), ("auto", 1e-7, 1e-9)])
def test_degrid_matches_jax(sparse, gridder, eps, tol):
    d, ms, truth, mds = sparse
    col = f"M_{gridder}"
    TD.degrid(mds, ms, truth["cell_rad"], column=col + "_T", gridder=gridder, epsilon=eps, device=CPU)
    jax_degrid(mds, ms, truth["cell_rad"], column=col + "_J", gridder=gridder, epsilon=eps)
    routes = {b["route"] for b in TD.DEGRID_STATS["bins"]}
    assert routes == {"stack" if gridder == "auto" else gridder}
    for a, b in _columns(ms, col + "_T", col + "_J"):
        assert a.shape == b.shape == (36, 3)
        assert _rel(a, b) < tol


def test_degrid_auto_takes_idg_where_jax_does(dense):
    """On a dense layout "auto" routes every bin to IDG; the 1e-9 match with
    JAX, which IDG and stack (1e-7 apart) would break, says JAX did too."""
    d, ms, truth, mds = dense
    TD.degrid(mds, ms, truth["cell_rad"], column="A_T", gridder="auto", epsilon=1e-7, device=CPU)
    jax_degrid(mds, ms, truth["cell_rad"], column="A_J", gridder="auto", epsilon=1e-7)
    assert {b["route"] for b in TD.DEGRID_STATS["bins"]} == {"idg"}
    assert TD.DEGRID_STATS["nvis"] == sum(a.size for a, _ in _columns(ms, "A_T", "A_J"))
    for a, b in _columns(ms, "A_T", "A_J"):
        assert _rel(a, b) < 1e-9


def test_degrid_pallas_f32_matches_jax_stack(sparse):
    """The port's "pallas" route (f32 plans, the gather's plain version here)
    against the JAX "stack" route at the same epsilon."""
    d, ms, truth, mds = sparse
    TD.degrid(mds, ms, truth["cell_rad"], column="P_T", gridder="pallas", epsilon=1e-5, device=CPU)
    jax_degrid(mds, ms, truth["cell_rad"], column="P_J", gridder="stack", epsilon=1e-5)
    assert {b["route"] for b in TD.DEGRID_STATS["bins"]} == {"pallas"}
    for a, b in _columns(ms, "P_T", "P_J"):
        assert _rel(a, b) < 2e-5


def test_degrid_to_corr_and_msv4_match_jax(tmp_path):
    """``to_corr=True`` into a TreeStore target, and an MSv4 target (its
    correlation layout forced), as the JAX MSv4 write-back test."""
    from pfb_imaging_tpu.utils import zarrio
    from tests.test_msv4 import _treestore_to_msv4

    ms = str(tmp_path / "ms")
    _, truth = simulate_vis_store(ms, nant=5, ntime=2, nchan=3, nx=16)
    mds = _mds(tmp_path, truth, ms)
    kw = dict(gridder="stack", epsilon=1e-10)
    TD.degrid(mds, ms, truth["cell_rad"], column="C_T", to_corr=True, device=CPU, **kw)
    jax_degrid(mds, ms, truth["cell_rad"], column="C_J", to_corr=True, **kw)
    for a, b in _columns(ms, "C_T", "C_J"):
        assert a.shape == b.shape and a.shape[0] == TreeStore(ms).attrs["ncorr"]
        assert _rel(a, b) < 1e-10
    zt, zj = str(tmp_path / "t.zarr"), str(tmp_path / "j.zarr")
    _treestore_to_msv4(ms, zt)
    shutil.copytree(zt, zj)
    TD.degrid(mds, zt, truth["cell_rad"], device=CPU, **kw)
    jax_degrid(mds, zj, truth["cell_rad"], **kw)
    for z in (zt, zj):
        assert "MODEL_DATA" in zarrio.open_zarr(z).group("msv4_0000")
    for gi in range(len(TreeStore(ms).groups())):
        a, b = (zarrio.open_zarr(z).group(f"msv4_{gi:04d}").array("MODEL_DATA").read() for z in (zt, zj))
        assert a.dtype == np.complex64 and a.shape == b.shape
        assert _rel(a, b) < 1e-6


def test_degrid_region_split_matches_jax(sparse, tmp_path):
    """Region files: the remainder and the region columns sum to the
    unsplit prediction, the region column carries only its source, both
    match JAX's; overlapping regions raise in both."""
    from pfb_imaging_tpu.core.degrid import load_region_masks as jax_masks

    d, ms, truth, mds = sparse
    nx = truth["nx"]
    reg = tmp_path / "regions.txt"
    reg.write_text(f"circle {nx // 2 + 5} {nx // 2 - 4} 2.5\n")
    kw = dict(gridder="stack", epsilon=1e-10, to_corr=True)
    TD.degrid(mds, ms, truth["cell_rad"], column="FULL", device=CPU, **kw)
    TD.degrid(mds, ms, truth["cell_rad"], column="SPLIT_T", region_file=str(reg), device=CPU, **kw)
    jax_degrid(mds, ms, truth["cell_rad"], column="SPLIT_J", region_file=str(reg), **kw)
    ts = TreeStore(ms)
    for key in ts.groups():
        g = ts.group(key)
        full, rem, one = (np.asarray(g.read(c)) for c in ("FULL", "SPLIT_T", "SPLIT_T1"))
        np.testing.assert_allclose(rem + one, full, rtol=1e-12, atol=1e-12 * np.abs(full).max())
        assert np.abs(one).max() > 0.1
        assert _rel(rem, g.read("SPLIT_J")) < 1e-10 and _rel(one, g.read("SPLIT_J1")) < 1e-10
    masks = TD.load_region_masks(str(reg), nx, nx)
    assert len(masks) == 2 and float(np.sum(masks, axis=0).max()) == 1.0
    for a, b in zip(masks, jax_masks(str(reg), nx, nx)):
        assert np.array_equal(a, b)
    reg2 = tmp_path / "overlap.reg"
    reg2.write_text(f"image\ncircle({nx // 2},{nx // 2},4)\ncircle({nx // 2},{nx // 2 + 1},4)\n")
    for fn in (TD.load_region_masks, jax_masks):
        with pytest.raises(ValueError, match="Overlapping"):
            fn(str(reg2), nx, nx)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """One partition of 8 stacked snapshots of 24 antennas: dense enough
    that at a cell of 1e-3 rad and epsilon 1e-7 the IDG planner takes every
    bin in wplanes mode within the slot budget."""
    d = tmp_path_factory.mktemp("degrid_wide")
    ms = str(d / "d.ms.tree")
    _, truth = simulate_vis_store(ms, nant=24, ntime=8, times_per_scan=8, nchan=4, nx=24)
    return d, ms, truth, _mds(d, truth, ms)


@pytest.mark.parametrize("which, eps, route", [("sparse", 1e-5, "stack"), ("wide", 1e-7, "idg")])
def test_degrid_auto_on_wide_field_matches_jax(which, eps, route, request):
    """``gridder="auto"`` at a cell of 1e-3 rad (a wide field for these
    arrays): where the planner picks wplanes and accepts the layout, every
    bin runs on wplanes IDG plans; where the slot budget refuses it, the
    bins fall back to stack. Either way MODEL_DATA matches JAX's to 1e-9,
    which IDG and stack (1e-7 apart) would break."""
    d, ms, truth, mds = request.getfixturevalue(which)
    TD.degrid(mds, ms, 1e-3, column="W_T", gridder="auto", epsilon=eps, device=CPU)
    jax_degrid(mds, ms, 1e-3, column="W_J", gridder="auto", epsilon=eps)
    bins = TD.DEGRID_STATS["bins"]
    assert {b["route"] for b in bins} == {route}
    if route == "idg":
        assert all(b["w_support"] > 1 for b in bins)
    for a, b in _columns(ms, "W_T", "W_J"):
        assert _rel(a, b) < 1e-9


@pytest.fixture(scope="module")
def port_sparse(tmp_path_factory):
    """The ``sparse`` container and model made by the port alone: its
    ``simulate_vis_store`` and its ``fit_image_cube`` (for the tests that
    need no JAX product)."""
    from pfb_imaging_tpu_torch.core.simulate import simulate_vis_store as port_simulate
    from pfb_imaging_tpu_torch.utils import modelspec as TM
    from pfb_imaging_tpu_torch.utils.store import TreeStore as PortStore

    d = tmp_path_factory.mktemp("degrid_port")
    ms = str(d / "d.ms.tree")
    _, truth = port_simulate(ms, nant=9, ntime=2, nchan=3, nx=32, device=CPU)
    freqs = np.asarray(PortStore(ms).attrs["freq"])
    nx = truth["nx"]
    cube = np.zeros((1, freqs.size, nx, nx))
    cube[:, :, nx // 2, nx // 2] = 1.0
    coeffs, ix, iy, mattrs = TM.fit_image_cube(np.zeros(1), freqs, cube, device=CPU)
    TM.save_mds(PortStore(str(d / "m.mds"), mode="w"), coeffs, ix, iy, mattrs)
    return d, ms, truth, str(d / "m.mds")


def test_degrid_checks_its_arguments(port_sparse):
    d, ms, truth, mds = port_sparse
    with pytest.raises(ValueError, match="gridder"):
        TD.degrid(mds, ms, truth["cell_rad"], gridder="wsclean", device=CPU)
    with pytest.raises(ValueError, match="IDG accuracy envelope"):
        TD.degrid(mds, ms, truth["cell_rad"], gridder="idg", epsilon=1e-10, device=CPU)
