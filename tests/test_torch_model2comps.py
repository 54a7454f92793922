"""The model side of the degrid slice: the port's ``model2comps`` and the
imager's model transfer (``model_mds``, ``l2_reweight_dof``) against the
JAX package on the CPU.

Tolerances: ``model2comps`` coefficients to 1e-12 relative (the same
least-squares fit, solved by a pseudo-inverse instead of LAPACK's
``gelsd``), locations exactly; the imager's products and its partitions'
residual visibilities and reweighted weights to 1e-9 relative (the stack
route in f64, as ``tests/test_torch_imager.py``).
"""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu.core import imager as JI
from pfb_imaging_tpu.core.init import init
from pfb_imaging_tpu.core.model2comps import model2comps as jax_model2comps
from pfb_imaging_tpu.core.simulate import simulate_vis_store
from pfb_imaging_tpu.utils.modelspec import fit_image_cube, save_mds
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch.core import imager as TI
from pfb_imaging_tpu_torch.core.model2comps import model2comps

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _tree(path, nband, ntime, nx=24, complete=True, seed=0):
    """A .dt tree in the imager's schema holding a MODEL per band node: a
    few components with a power-law spectrum that drifts with time."""
    rng = np.random.default_rng(seed)
    freq_out = np.linspace(0.9e9, 1.1e9, nband)
    root = TreeStore(path, mode="w")
    pix = rng.integers(0, nx, (5, 2))
    flux = rng.uniform(0.2, 1.0, 5)
    for b in range(nband):
        for t in range(ntime):
            model = np.zeros((nx, nx))
            model[pix[:, 0], pix[:, 1]] = flux * (freq_out[b] / 1e9) ** -0.7 * (1.0 + 0.1 * t)
            node = root.group(f"band{b:04d}_time{t:04d}")
            node.write("MODEL", model)
            node.set_attrs(freq_out=float(freq_out[b]), time_out=float(100.0 * t))
    root.set_attrs(nband=nband, ntime=ntime, nx=nx, ny=nx, cell_rad=3e-5, freq_out=freq_out.tolist(),
                   complete=complete)
    return str(path)


@pytest.mark.parametrize("nband, ntime, nbasisf", [(3, 1, None), (4, 2, None), (4, 2, 2)])
def test_model2comps_matches_jax(tmp_path, nband, ntime, nbasisf):
    dt = _tree(tmp_path / "m.dt", nband, ntime)
    mt = model2comps(dt, str(tmp_path / "t.mds"), nbasisf=nbasisf, device=CPU)
    mj = jax_model2comps(dt, str(tmp_path / "j.mds"), nbasisf=nbasisf)
    for name in ("location_x", "location_y"):
        assert np.array_equal(mt.read(name), mj.read(name)), name
    assert mt.read("coefficients").shape == mj.read("coefficients").shape
    assert _rel(mt.read("coefficients"), mj.read("coefficients")) < 1e-12
    assert mt.attrs == mj.attrs


def test_model2comps_default_path_and_refusals(tmp_path):
    dt = _tree(tmp_path / "m.dt", 2, 1)
    assert str(model2comps(dt, device=CPU).path) == str(tmp_path / "m.mds")
    with pytest.raises(RuntimeError, match="completion stamp"):
        model2comps(_tree(tmp_path / "k.dt", 2, 1, complete=False), device=CPU)
    empty = TreeStore(_tree(tmp_path / "e.dt", 2, 1))
    for key in empty.groups():
        empty.group(key).write("MODEL", np.zeros((24, 24)))
    with pytest.raises(ValueError, match="No MODEL"):
        model2comps(str(empty.path), device=CPU)


@pytest.fixture(scope="module")
def xds(tmp_path_factory):
    """A store in ``init``'s schema and a component model on the imager's
    32^2 grid (two sources, one of them off the simulated ones)."""
    d = tmp_path_factory.mktemp("transfer")
    ms = str(d / "sim.ms.tree")
    simulate_vis_store(ms, nant=6, ntime=2, nchan=4, nx=24, noise=0.1)
    init(ms, str(d / "sim.xds"), product="I")
    freqs = np.asarray(TreeStore(str(d / "sim.xds")).attrs["freq"])
    cube = np.zeros((1, freqs.size, 32, 32))
    cube[:, :, 16, 16] = 1.0 + 0.1 * np.linspace(-1, 1, freqs.size)
    cube[:, :, 20, 11] = 0.3
    coeffs, ix, iy, mattrs = fit_image_cube(np.zeros(1), freqs, cube)
    save_mds(TreeStore(str(d / "m.mds"), mode="w"), coeffs, ix, iy, mattrs)
    return d


@pytest.mark.parametrize("dof", [None, 5.0])
def test_imager_model_transfer_matches_jax(xds, dof):
    """``model_mds`` (and Student-t reweighting with ``l2_reweight_dof``) on
    the stack route: products, residual visibilities and weights."""
    kw = dict(nband=2, nx=32, ny=32, psf_oversize=1.5, fits_out=False, gridder="stack", robustness=0.0,
              model_mds=str(xds / "m.mds"), l2_reweight_dof=dof)
    tag = "l2" if dof else "sub"
    JI.imager(str(xds / "sim.xds"), str(xds / f"{tag}_j.dt"), **kw)
    TI.imager(str(xds / "sim.xds"), str(xds / f"{tag}_t.dt"), device="cpu", **kw)
    sj, st = TreeStore(str(xds / f"{tag}_j.dt")), TreeStore(str(xds / f"{tag}_t.dt"))
    plain = TreeStore(str(xds / "sim.xds"))
    assert TI.IMAGER_STATS["model_seconds"] > 0
    assert st.groups() == sj.groups()
    assert st.attrs["wsum"] == pytest.approx(sj.attrs["wsum"], rel=1e-9)
    for key in sj.groups():
        nj, nt = sj.group(key), st.group(key)
        for name in ("DIRTY", "PSF", "NOISE", "WSUM"):
            assert _rel(nt.read(name), nj.read(name)) < 1e-9, (key, name)
        for pk in nj.groups():
            for name in ("VIS", "WEIGHT"):
                assert _rel(nt.group(pk).read(name), nj.group(pk).read(name)) < 1e-9, (key, pk, name)
            vis_in = plain.group(nj.group(pk).attrs["key"]).read("VIS")
            assert not np.allclose(nt.group(pk).read("VIS"), vis_in[:, : nt.group(pk).read("VIS").shape[1]])
