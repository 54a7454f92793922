"""``deconv`` and ``pfb_major_step`` of the port on a band x row mesh of
spawned gloo ranks, against the JAX package (its mesh on 8 virtual CPU
devices) and the port's single process.

* Band mesh: a 2-band tree (the JAX simulate -> init -> imager chain, the
  stack gridder at epsilon 1e-9, as ``tests/test_parallel.py`` runs it)
  deconvolved on 2 ranks, one band each, with ``use_mesh=True``. The port's
  single process estimates the spectral norm; the JAX run takes it (the
  packages start their power methods from different random vectors); the
  ranks run their own sharded power method from the single process's start
  vector. Models within 1e-10 (atol) of JAX's and the same bits as one
  process's (the band reductions add the bands in band order on any
  split), rms and the CG/PD iteration counts the same on both ranks and as
  on one process.
* Four bands on 2 ranks, two each: the same bits as one process.
* Row mesh: a 1-band tree on 2 ranks with ``row_shard_above`` below its PSF
  grid, so deconv's Hessian runs the distributed FFT.
* ``pfb_major_step`` on a 2 x 2 band x row mesh of 4 ranks against the
  unsharded step (the port of ``__graft_entry__.dryrun_multichip``).
* Without a process group ``use_mesh=True`` is bit for bit
  ``use_mesh=False``.
"""

import shutil

import numpy as np
import pytest
import torch

from torch_ranks import load, run_ranks, save
from torch_recorder import logged, recording

torch.set_num_threads(1)
DKW = dict(preset="sara", niter=2, eta=1e-4, cg_maxit=20, pd_maxit=100, l1_reweight_from=-1, epsilon=1e-9,
           fit_mds=False)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """2-, 1- and 4-band trees from the JAX chain, as tests/test_parallel.py."""
    from pfb_imaging_tpu.core.imager import imager
    from pfb_imaging_tpu.core.init import init
    from pfb_imaging_tpu.core.simulate import simulate_vis_store

    d = tmp_path_factory.mktemp("pdeconv")
    ms = str(d / "m.ms.tree")
    _, truth = simulate_vis_store(ms, nant=10, ntime=1, nchan=4, nx=48)
    init(ms, str(d / "m.xds"))
    kw = dict(nx=48, cell_size=np.rad2deg(truth["cell_rad"]) * 3600, epsilon=1e-9, fits_out=False)
    imager(str(d / "m.xds"), str(d / "b2.dt"), nband=2, **kw)
    imager(str(d / "m.xds"), str(d / "b1.dt"), nband=1, **kw)
    imager(str(d / "m.xds"), str(d / "b4.dt"), nband=4, **kw)
    return d


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _deconv_ranks(rank, world, outdir, dt, row_shard_above):
    from pfb_imaging_tpu_torch.core import deconv as D

    with recording() as got, logged("DECONV") as cycles:
        model, residual = D.deconv(dt, use_mesh=True, row_shard_above=row_shard_above, device="cpu", **DKW)
    save(outdir, "model", model, rank)
    save(outdir, "residual", residual, rank)
    save(outdir, "stats", [[c["rms"], c["cg_iters"], c["pd_iters"]] for c in cycles], rank)
    save(outdir, "mesh", [cycles[0]["mesh"]["band"], cycles[0]["mesh"]["row"]], rank)
    save(outdir, "all_to_all", got["counters"].get("collective.all_to_all", 0), rank)


def _single(dt):
    from pfb_imaging_tpu_torch.core import deconv as D

    with logged("DECONV") as cycles:
        model, _ = D.deconv(dt, use_mesh=True, device="cpu", **DKW)
    return model, [[c["rms"], c["cg_iters"], c["pd_iters"]] for c in cycles]


def _check_ranks(out, model1, stats1, world=2):
    from pfb_imaging_tpu_torch.utils.store import TreeStore  # noqa: F401

    for r in range(world):
        np.testing.assert_allclose(load(out, "model", r), model1, rtol=0, atol=1e-10)
        st = load(out, "stats", r)
        np.testing.assert_array_equal(st, load(out, "stats", 0))  # every rank the same bits
        np.testing.assert_array_equal(st[:, 1:], np.asarray(stats1)[:, 1:])  # the same stop iterations
        np.testing.assert_allclose(st[:, 0], np.asarray(stats1)[:, 0], rtol=1e-10)
        np.testing.assert_array_equal(load(out, "residual", r), load(out, "residual", 0))


def test_deconv_band_mesh_matches_jax_and_one_process(trees, tmp_path):
    from pfb_imaging_tpu.core.deconv import deconv as jax_deconv
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    src = trees / "b2.dt"
    model1, stats1 = _single(_copy(src, tmp_path / "one.dt"))
    hess_norm = TreeStore(str(tmp_path / "one.dt")).attrs["hess_norm"]
    model_j, _ = jax_deconv(_copy(src, tmp_path / "jax.dt"), use_mesh=True, hess_norm=hess_norm, **DKW)
    np.testing.assert_allclose(model1, model_j, rtol=0, atol=1e-10)
    dt = _copy(src, tmp_path / "ranks.dt")
    out = run_ranks(_deconv_ranks, 2, tmp_path, dt, 8192)
    assert list(load(out, "mesh", 0)) == [2, 1]
    _check_ranks(out, model1, stats1)
    np.testing.assert_array_equal(load(out, "model", 0), model1)
    np.testing.assert_allclose(load(out, "model", 0), model_j, rtol=0, atol=1e-10)
    t = TreeStore(dt)
    assert t.attrs["hess_norm"] == pytest.approx(hess_norm, rel=1e-12)
    for b, key in enumerate(sorted(k for k in t.groups() if k.startswith("band"))):
        node = t.group(key)
        assert node.attrs["niters"] == 2
        np.testing.assert_array_equal(node.read("MODEL"), load(out, "model", 0)[b])


def test_deconv_four_bands_on_two_ranks_same_bits_as_one_process(trees, tmp_path):
    """Two bands a rank: a sum over the ranks would add the bands in
    another order than one process does; the ordered band reductions give
    one process's bits."""
    model1, stats1 = _single(_copy(trees / "b4.dt", tmp_path / "one.dt"))
    out = run_ranks(_deconv_ranks, 2, tmp_path, _copy(trees / "b4.dt", tmp_path / "ranks.dt"), 8192)
    assert list(load(out, "mesh", 0)) == [2, 1]
    _check_ranks(out, model1, stats1)
    for r in range(2):
        np.testing.assert_array_equal(load(out, "model", r), model1)
    assert np.abs(model1).max() > 0


def test_deconv_row_mesh_matches_jax_and_one_process(trees, tmp_path):
    from pfb_imaging_tpu.core.deconv import deconv as jax_deconv
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    src = trees / "b1.dt"
    model1, stats1 = _single(_copy(src, tmp_path / "one.dt"))
    hess_norm = TreeStore(str(tmp_path / "one.dt")).attrs["hess_norm"]
    model_j, _ = jax_deconv(_copy(src, tmp_path / "jax.dt"), use_mesh=True, row_shard_above=16, hess_norm=hess_norm,
                            **DKW)
    out = run_ranks(_deconv_ranks, 2, tmp_path, _copy(src, tmp_path / "ranks.dt"), 16)
    assert list(load(out, "mesh", 0)) == [1, 2]
    assert int(load(out, "all_to_all", 0)) > 0  # the distributed FFT ran
    _check_ranks(out, model1, stats1)
    np.testing.assert_allclose(load(out, "model", 0), model_j, rtol=0, atol=1e-10)


def test_deconv_use_mesh_on_one_process_is_bitwise(trees, tmp_path):
    from pfb_imaging_tpu_torch.core import deconv as D

    outs = []
    for flag in (True, False):
        with logged("DECONV") as cycles:
            model, residual = D.deconv(_copy(trees / "b2.dt", tmp_path / f"{flag}.dt"), use_mesh=flag,
                                       device="cpu", **DKW)
        outs.append((model, residual, [(c["cg_iters"], c["pd_iters"]) for c in cycles]))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]


# ── pfb_major_step on a 2 x 2 mesh ───────────────────────────────────

NBAND, NX, NXP = 4, 32, 64


def _step_problem():
    rng = np.random.default_rng(5)
    ph = np.abs(rng.standard_normal((NBAND, 1, NXP, NXP // 2 + 1))) + 0.1
    wsums = rng.uniform(1.0, 2.0, NBAND)
    resid = rng.standard_normal((NBAND, NX, NX)) * 0.1
    return ph, wsums, resid


def _step(mesh):
    from pfb_imaging_tpu_torch.core.step import pd_step_sizes, pfb_major_step
    from pfb_imaging_tpu_torch.ops.hessian import HessianCube
    from pfb_imaging_tpu_torch.ops.psi import Psi

    ph, wsums, resid = _step_problem()
    sl = slice(0, NBAND) if mesh is None else mesh.band_slice(NBAND)
    nb = sl.stop - sl.start
    hess = HessianCube.build(ph[sl], wsums, 1e-3, NXP, NXP, mesh=mesh, device="cpu")
    psi = Psi(nb, NX, NX, bases=("self", "db1", "db2"), nlevel=2, device="cpu")
    sigma, tau = pd_step_sizes(hessnorm=1.1, gamma=1.0, nu=float(psi.nbasis))
    residual = torch.as_tensor(resid[sl])
    dual = torch.zeros((nb, psi.nbasis, psi.nymax, psi.nxmax), dtype=torch.float64)
    l1weight = torch.ones((psi.nbasis, psi.nymax, psi.nxmax), dtype=torch.float64)
    return pfb_major_step(hess, residual, torch.zeros_like(residual), torch.zeros_like(residual), dual, l1weight,
                          0.01, psi=psi, gamma=1.0, sigma=sigma, tau=tau, cg_tol=1e-8, cg_maxit=6, cg_minit=1,
                          pd_tol=1e-8, pd_maxit=6, pos=True, mesh=mesh)


def _step_ranks(rank, world, outdir):
    from pfb_imaging_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(band=2, row=2)
    assert mesh.band_size == 2 and mesh.row_size == 2
    model, update, dual = _step(mesh)
    save(outdir, "band", mesh.band_index, rank)
    for name, t in (("model", model), ("update", update), ("dual", dual)):
        save(outdir, name, t, rank)


def test_pfb_major_step_on_a_2x2_mesh(tmp_path):
    ref = [t.numpy() for t in _step(None)]
    out = run_ranks(_step_ranks, 4, tmp_path)
    for r in range(4):
        sl = slice(2 * int(load(out, "band", r)), 2 * int(load(out, "band", r)) + 2)
        for name, full in zip(("model", "update", "dual"), ref):
            got = load(out, name, r)
            np.testing.assert_allclose(got, full[sl], rtol=0, atol=1e-10 * np.abs(full).max(), err_msg=(r, name))
    assert np.abs(ref[0]).max() > 0
