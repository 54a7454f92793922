"""The port's multi-process imager and a whole run over two nodes, on
spawned gloo ranks, against the JAX package and the port's single process.

* ``imager(use_mesh=True)`` on one node of 2 ranks (a 2-way row mesh: each
  rank plans and grids half of every partition's rows on B1's route, the
  images summed over the node), with and without a transferred model and
  Student-t reweighting (the model degridded on B2's route, each rank its
  rows), against JAX's imager (1e-9, the IDG f64 parity of
  tests/test_torch_imager.py; its serial route, which tests/test_parallel.py
  holds to its 8-device row mesh at 1e-10, at a tenth of the CPU time) and
  the port's single process (1e-10), as tests/test_parallel.py:178-255 does.
* One node of 2 ranks without a mesh (``use_mesh=False``, and the pallas
  route): the bands split over the ranks, and the tree's attrs and MFS FITS
  files, which rank 0 builds from every band node, equal to one process's.
* Two nodes of two ranks (``LOCAL_WORLD_SIZE=2``): the rank layout (row
  groups inside a node, the band axis across nodes, ``spanning_devices``
  node-minor), then simulate -> init (rank 0) -> imager (bands by node, a
  row mesh inside each) -> deconv (a 2-band mesh, two copies), every rank
  reporting the same rms and model checksum, equal to one process's run
  (the counterpart of tests/test_multihost.py).
"""

import numpy as np
import pytest
import torch

from torch_ranks import load, run_ranks, save
from torch_recorder import logged

torch.set_num_threads(1)
SRC = ((0.4, 0.3, 0.8, -0.7),)
PRODUCTS = ("DIRTY", "PSF", "WSUM")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The JAX simulate -> init chain, and a one-source model (.mds)."""
    from pfb_imaging_tpu.core.init import init
    from pfb_imaging_tpu.core.simulate import simulate_vis_store
    from pfb_imaging_tpu.utils.modelspec import fit_image_cube, save_mds
    from pfb_imaging_tpu.utils.store import TreeStore

    d = tmp_path_factory.mktemp("pimager")
    ms = str(d / "m.ms.tree")
    _, truth = simulate_vis_store(ms, nant=9, ntime=2, nchan=4, nx=32, sources=SRC)
    init(ms, str(d / "m.xds"), product="I")
    nx = truth["nx"]
    mcube = np.zeros((1, 2, nx, nx))
    mcube[:, :, nx // 2 + 3, nx // 2 - 2] = 0.3
    coeffs, ix, iy, mattrs = fit_image_cube(np.array([0.0]), np.array([1.0e9, 1.2e9]), mcube, nbasisf=1, nbasist=1)
    save_mds(TreeStore(str(d / "m.mds"), mode="w"), coeffs, ix, iy, mattrs)
    kw = dict(nband=2, nx=nx, cell_size=np.rad2deg(truth["cell_rad"]) * 3600, epsilon=1e-5, do_wgridding=True,
              fits_out=False, do_noise=False, gridder="idg")
    return d, kw


def _cases(d, kw):
    return {"plain": kw, "model": dict(kw, model_mds=str(d / "m.mds"), l2_reweight_dof=2.0)}


def _imager_ranks(rank, world, outdir, d, kw):
    from pfb_imaging_tpu_torch.core import imager as TI

    for name, ckw in _cases(d, kw).items():
        with logged("IMAGER", "rank") as ranks:
            TI.imager(str(d / "m.xds"), str(d / f"ranks_{name}.dt"), use_mesh=True, device="cpu", **ckw)
        (this,) = ranks
        save(outdir, f"row_size_{name}", this["mesh_row_size"], rank)


def test_imager_row_mesh_matches_jax_and_one_process(store, tmp_path):
    from pfb_imaging_tpu.core.imager import imager as jax_imager
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    d, kw = store
    out = run_ranks(_imager_ranks, 2, tmp_path, d, kw)
    for name, ckw in _cases(d, kw).items():
        assert all(int(load(out, f"row_size_{name}", r)) == 2 for r in range(2))
        jax_imager(str(d / "m.xds"), str(d / f"jax_{name}.dt"), use_mesh=False, **ckw)
        TI.imager(str(d / "m.xds"), str(d / f"one_{name}.dt"), use_mesh=False, device="cpu", **ckw)
        ranks_t, jax_t, one_t = (TreeStore(str(d / f"{tag}_{name}.dt")) for tag in ("ranks", "jax", "one"))
        assert ranks_t.attrs["complete"] is True and ranks_t.groups() == jax_t.groups()
        for g in jax_t.groups():
            for prod in PRODUCTS:
                y = np.asarray(ranks_t.group(g).read(prod))
                for ref, tol in ((one_t, 1e-10), (jax_t, 1e-9)):
                    x = np.asarray(ref.group(g).read(prod))
                    np.testing.assert_allclose(y, x, rtol=tol, atol=tol * max(1.0, np.abs(x).max()),
                                               err_msg=(name, g, prod))
            # the partition data the deconv residual reads (model-subtracted VIS)
            for pk in one_t.group(g).groups():
                np.testing.assert_allclose(ranks_t.group(g).group(pk).read("VIS"),
                                           one_t.group(g).group(pk).read("VIS"), rtol=0, atol=1e-12)


# ── one node of two ranks, no mesh ───────────────────────────────────

NO_MESH = {"idg": dict(use_mesh=False), "pallas": dict(gridder="pallas", double_precision=False, epsilon=1e-5)}


def _no_mesh_ranks(rank, world, outdir, d, kw):
    from pfb_imaging_tpu_torch.core import imager as TI

    for name, nkw in NO_MESH.items():
        with logged("IMAGER", "rank") as ranks:
            TI.imager(str(d / "m.xds"), str(d / f"nomesh_{name}.dt"), device="cpu",
                      **dict(kw, fits_out=True, **nkw))
        (this,) = ranks
        save(outdir, f"stats_{name}", [this["mesh_row_size"], *this["bands"]], rank)


def test_imager_no_mesh_two_ranks_match_one_process(store, tmp_path):
    """Two ranks of one node without a row mesh (``use_mesh=False`` on the
    IDG route, and the pallas route, which never takes one) split the bands
    between them; rank 0 then builds the tree's ``wsum``/``psfpars`` and the
    MFS FITS files from every rank's band nodes, equal to one process's."""
    from pfb_imaging_tpu_torch.core import imager as TI
    from pfb_imaging_tpu_torch.utils.fits import load_fits
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    d, kw = store
    out = run_ranks(_no_mesh_ranks, 2, tmp_path, d, kw)
    for name, nkw in NO_MESH.items():
        assert [[int(v) for v in load(out, f"stats_{name}", r)] for r in range(2)] == [[1, 0], [1, 1]]
        TI.imager(str(d / "m.xds"), str(d / f"nomesh1_{name}.dt"), device="cpu", **dict(kw, fits_out=True, **nkw))
        ranks_t, one_t = TreeStore(str(d / f"nomesh_{name}.dt")), TreeStore(str(d / f"nomesh1_{name}.dt"))
        assert ranks_t.attrs["complete"] is True and ranks_t.groups() == one_t.groups()
        assert ranks_t.attrs["wsum"] == one_t.attrs["wsum"] > 0, name
        np.testing.assert_array_equal(ranks_t.attrs["psfpars"], one_t.attrs["psfpars"], err_msg=name)
        for g in one_t.groups():
            for prod in PRODUCTS:
                np.testing.assert_array_equal(ranks_t.group(g).read(prod), one_t.group(g).read(prod),
                                              err_msg=(name, g, prod))
        for kind in ("dirty", "psf"):
            x, _ = load_fits(str(d / f"nomesh1_{name}_{kind}_mfs.fits"))
            y, _ = load_fits(str(d / f"nomesh_{name}_{kind}_mfs.fits"))
            assert np.abs(x).max() > 0
            np.testing.assert_array_equal(y, x, err_msg=(name, kind))


# ── two nodes of two ranks ───────────────────────────────────────────

SIM = dict(nant=6, ntime=2, nchan=2, nx=24)
IMG = dict(nband=2, nx=64, epsilon=1e-6, psf_oversize=1.5, fits_out=False, gridder="idg")
DEC = dict(niter=1, epsilon=1e-9, cg_maxit=6, pd_maxit=6, use_mesh=True)


def _pipeline(d, dist=False):
    from pfb_imaging_tpu_torch.core.deconv import deconv
    from pfb_imaging_tpu_torch.core.imager import imager
    from pfb_imaging_tpu_torch.core.init import init
    from pfb_imaging_tpu_torch.core.simulate import simulate_vis_store
    from pfb_imaging_tpu_torch.parallel.multihost import barrier, rank

    if rank() == 0:
        simulate_vis_store(str(d / "mh.ms"), device="cpu", **SIM)
        init(str(d / "mh.ms"), str(d / "mh.xds"), product="I", device="cpu")
    barrier("data-ready")
    with logged("IMAGER", "rank") as ranks:
        imager(str(d / "mh.xds"), str(d / "mh.dt"), device="cpu", **IMG)
    barrier("imaged")
    with logged("DECONV") as cycles:
        model, residual = deconv(str(d / "mh.dt"), device="cpu", **DEC)
    (stats,) = ranks
    return model, residual, stats, cycles[-1]


def _two_node_ranks(rank, world, outdir, d):
    from pfb_imaging_tpu_torch.parallel import multihost as mh
    from pfb_imaging_tpu_torch.parallel.mesh import make_mesh, shard_cube, stream_band_stack
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    assert (mh.process_count(), mh.local_world_size(), mh.is_multihost()) == (2, 2, True)
    layout = {}
    for band, row in ((2, 2), (2, 1), (1, 2)):
        m = make_mesh(band=band, row=row)
        grid = [int(r) for r in m.grids[m.copy_index].ravel()]
        layout[f"{band}x{row}"] = [m.copy_index, m.band_index, m.row_index] + grid
    save(outdir, "layout", [v for k in sorted(layout) for v in layout[k]], rank)
    # a band-sharded cube on the 2-band mesh: each rank's slice, loaded only
    # for its own band, and the bands only the first copy's ranks return
    m = make_mesh(band=2, row=1)
    cube = np.arange(2 * 3 * 4, dtype=float).reshape(2, 3, 4)
    local = shard_cube(m, cube, device="cpu")
    streamed = stream_band_stack(m, [lambda b=b: cube[b] for b in range(2)], device="cpu")
    assert torch.equal(local, streamed)
    save(outdir, "slice", local, rank)
    save(outdir, "owned", [b for b, arr in mh.owned_band_slices(local, m) if np.array_equal(arr, cube[b])], rank)
    save(outdir, "spanning", mh.spanning_devices(4), rank)
    save(outdir, "node", [mh.process_index(), mh.local_rank(), *mh.owned_items(range(5))], rank)
    model, residual, istats, cyc = _pipeline(d)
    t = TreeStore(str(d / "mh.dt"))
    assert t.attrs.get("complete")
    save(outdir, "imager", [istats["mesh_row_size"], *istats["bands"]], rank)
    save(outdir, "result", [cyc["rms"], float(np.abs(model).sum()), cyc["cg_iters"], cyc["pd_iters"]], rank)
    save(outdir, "model", model, rank)
    save(outdir, "node_rms", [float(t.group(g).attrs["rms"]) for g in sorted(t.groups())], rank)


def test_two_nodes_layout_and_pipeline_match_one_process(tmp_path):
    d = tmp_path / "ranks"
    d.mkdir()
    out = run_ranks(_two_node_ranks, 4, tmp_path, d, local_world=2, timeout=400)
    # the layout: a 2 x 2 mesh's row groups are each node's ranks; a 2-band
    # axis spans the nodes (ranks 0 and 2), its copy on the second ranks
    lay = {r: load(out, "layout", r) for r in range(4)}
    for r in range(4):
        node, lrank, *own = (int(v) for v in load(out, "node", r))
        assert (node, lrank) == (r // 2, r % 2)
        assert own == [b for b in range(5) if b % 2 == node]
        assert list(load(out, "spanning", r)) == [0, 2, 1, 3]
        # sorted keys: 1x2, 2x1, 2x2
        c12, c21, c22 = lay[r][:5], lay[r][5:10], lay[r][10:17]
        assert list(c22[3:]) == [0, 1, 2, 3] and c22[1] == node and c22[2] == lrank  # rows = node's ranks
        assert list(c21[3:]) == ([0, 2] if lrank == 0 else [1, 3]) and c21[0] == lrank and c21[1] == node
        assert list(c12[3:]) == ([0, 1] if node == 0 else [2, 3]) and c12[0] == node and c12[2] == lrank
        assert [int(v) for v in load(out, "imager", r)] == [2, node]  # band `node`, 2-way rows
        np.testing.assert_array_equal(load(out, "slice", r)[0], np.arange(24.0).reshape(2, 3, 4)[node])
        assert list(load(out, "owned", r)) == ([node] if lrank == 0 else [])  # one writer a band
    res = [load(out, "result", r) for r in range(4)]
    for r in range(4):
        np.testing.assert_array_equal(res[r], res[0])  # every rank the same bits
        np.testing.assert_array_equal(load(out, "model", r), load(out, "model", 0))
    one = tmp_path / "one"
    one.mkdir()
    model1, _, _, cyc1 = _pipeline(one)
    assert res[0][2:].tolist() == [cyc1["cg_iters"], cyc1["pd_iters"]]
    assert res[0][0] == pytest.approx(cyc1["rms"], rel=1e-9)
    assert res[0][1] == pytest.approx(float(np.abs(model1).sum()), rel=1e-9)
    np.testing.assert_allclose(load(out, "model", 0), model1, rtol=0, atol=1e-9 * np.abs(model1).max())
    assert np.abs(model1).max() > 0
    np.testing.assert_allclose(load(out, "node_rms", 0), res[0][0], rtol=0)
