"""The port's row-sharded gridding (``parallel/sharded.py``) on four spawned
gloo ranks (a 2 x 2 band x row mesh, rows split over the flattened mesh),
against the JAX package's SPMD versions on its virtual CPU devices and
against the unsharded routes.

* ``plan_idg_sharded``: rank i's plan is the JAX stack's leaf i (carried
  over by ``plan_from_jax``): the integer layout equal, the per-slot
  constants within 1e-12 (angles compared through their cosines and sines,
  which is all the kernels use).
* ``sharded_vis2dirty_idg`` (B1's route) and ``sharded_dirty2vis_idg`` (B2's)
  against JAX's and against one plan over all rows: 1e-10.
* ``plan_wgridder_sharded`` + ``sharded_vis2dirty`` and
  ``row_sharded_vis2dirty`` (the exact DFT): 1e-10.
All f64, from seeded numpy inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_ranks import load, run_ranks, save

torch.set_num_threads(1)
NSH = 4
IDG_KW = dict(nx=64, ny=64, cellx=8e-6 * 1024 / 64, celly=8e-6 * 1024 / 64, epsilon=1e-5, do_wgridding=True,
              divide_by_n=False)
WG_KW = dict(nx=32, ny=32, cellx=1e-4, celly=1e-4, epsilon=1e-7, do_wgridding=True, divide_by_n=False)
DFT_KW = dict(nx=16, ny=16, cellx=1e-4, celly=1e-4, divide_by_n=True)
FREQ = np.linspace(1e9, 1.1e9, 2)
PLAN_INT = ("cg_idx", "bid")
PLAN_FLOAT = ("phase_re", "phase_im", "sg", "corr_re", "corr_im")


def _idg_data():
    rng = np.random.default_rng(11)
    nrow = 1600
    uvw = rng.uniform(-16000, 16000, (nrow, 3))
    uvw[:, 2] *= 0.3  # several w-bins
    vis = rng.standard_normal((nrow, 2)) + 1j * rng.standard_normal((nrow, 2))
    return uvw, vis, rng.uniform(0.5, 2.0, (nrow, 2)), rng.standard_normal((64, 64))


def _small_data(nrow, seed):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-200, 200, (nrow, 3))
    vis = rng.standard_normal((nrow, 2)) + 1j * rng.standard_normal((nrow, 2))
    return uvw, vis, rng.uniform(0.5, 2.0, (nrow, 2))


def _ranks(rank, world, outdir):
    from pfb_imaging_tpu_torch.parallel.mesh import make_mesh
    from pfb_imaging_tpu_torch.parallel.sharded import (plan_idg_sharded, plan_wgridder_sharded,
                                                        row_sharded_vis2dirty, sharded_dirty2vis_idg,
                                                        sharded_vis2dirty, sharded_vis2dirty_idg)

    mesh = make_mesh(band=2, row=2)
    i = mesh.index()
    save(outdir, "index", i, rank)
    t = torch.as_tensor

    uvw, vis, wgt, img = _idg_data()
    plan, rows = plan_idg_sharded(uvw, FREQ, NSH, i, device="cpu", **IDG_KW)
    sl = slice(i * rows, (i + 1) * rows)
    for name in PLAN_INT + PLAN_FLOAT + ("scal",):
        save(outdir, f"plan_{name}", getattr(plan, name), rank)
    save(outdir, "plan_bins", [plan.nbins, plan.ngroups, *plan.bin_gstart, *plan.bin_gcount], rank)
    save(outdir, "idg_dirty", sharded_vis2dirty_idg(mesh, plan, t(vis.real[sl]), t(vis.imag[sl]), t(wgt[sl])), rank)
    save(outdir, "idg_vis", sharded_dirty2vis_idg(mesh, plan, t(img)), rank)

    uvw, vis, wgt = _small_data(256, 0)
    wplan, rows = plan_wgridder_sharded(uvw, FREQ, NSH, i, device="cpu", **WG_KW)
    sl = slice(i * rows, (i + 1) * rows)
    save(outdir, "wg_dirty", sharded_vis2dirty(mesh, wplan, t(vis[sl]), t(wgt[sl])), rank)

    uvw, vis, wgt = _small_data(64, 1)
    sl = slice(i * 16, (i + 1) * 16)
    save(outdir, "dft_dirty", row_sharded_vis2dirty(mesh, uvw[sl], FREQ, t(vis[sl]), t(wgt[sl]), device="cpu",
                                                    **DFT_KW), rank)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_ranks, NSH, tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def jax_idg():
    import jax.numpy as jnp

    from pfb_imaging_tpu.parallel.mesh import make_mesh
    from pfb_imaging_tpu.parallel.sharded import plan_idg_sharded, sharded_dirty2vis_idg, sharded_vis2dirty_idg

    uvw, vis, wgt, img = _idg_data()
    stacked, rows = plan_idg_sharded(uvw, FREQ, NSH, dtype=np.float64, **IDG_KW)
    mesh = make_mesh(band=2, row=2)
    sh = lambda a: jnp.asarray(a.reshape(NSH, rows, -1))  # noqa: E731
    dirty = np.asarray(sharded_vis2dirty_idg(mesh, stacked, sh(vis.real), sh(vis.imag), sh(wgt)))
    mv = np.asarray(sharded_dirty2vis_idg(mesh, stacked, jnp.asarray(img)))
    return stacked, rows, dirty, mv


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def _indices(ranks):
    idx = [int(load(ranks, "index", r)) for r in range(NSH)]
    assert sorted(idx) == list(range(NSH))
    return idx


@pytest.mark.parametrize("shard", range(NSH))
def test_plan_idg_sharded_is_the_jax_leaf(ranks, jax_idg, shard):
    import jax

    from pfb_imaging_tpu_torch.ops.gridder_idg import plan_from_jax

    stacked = jax_idg[0]
    r = _indices(ranks).index(shard)
    leaf = jax.tree_util.tree_map(lambda a: a[shard], stacked)
    names = ("au_re", "au_im", "av_re", "av_im", "scal", "wcu8", "wcv8", "sg", "cg_idx", "bid", "phase_re",
             "phase_im", "corr_re", "corr_im", "nm1", "nm1_lo")
    skip = set(names) | {"inv_orig", "rep_idx", "win_start", "win_off", "win_len", "sort_idx", "unsort_idx",
                         "scr_re", "scr_im"}
    meta = {f.name: getattr(leaf, f.name) for f in dataclasses.fields(leaf) if f.name not in skip}
    ref = plan_from_jax({k: np.asarray(getattr(leaf, k)) for k in names}, meta, device="cpu")
    bins = [int(v) for v in load(ranks, "plan_bins", r)]
    assert bins == [ref.nbins, ref.ngroups, *ref.bin_gstart, *ref.bin_gcount]
    for name in PLAN_INT:
        np.testing.assert_array_equal(load(ranks, f"plan_{name}", r), getattr(ref, name).numpy(), err_msg=name)
    for name in PLAN_FLOAT:
        np.testing.assert_allclose(load(ranks, f"plan_{name}", r), getattr(ref, name).numpy(), rtol=0, atol=1e-12,
                                   err_msg=name)
    scal, sref = load(ranks, "plan_scal", r), ref.scal.numpy()
    live = ref.cg_idx.numpy() < ref.nrow * ref.nchan
    for row, mult in ((0, 1), (1, 2), (2, 1), (3, 2)):  # du, phi (enters as 2 phi), dv, phi
        for fn in (np.cos, np.sin):
            np.testing.assert_allclose(fn(mult * scal[row])[live], fn(mult * sref[row])[live], rtol=0, atol=1e-12)


def test_sharded_vis2dirty_idg_matches_jax_and_local(ranks, jax_idg):
    from pfb_imaging_tpu_torch.ops.gridder_idg import plan_idg, vis2dirty_idg

    uvw, vis, wgt, _ = _idg_data()
    local = vis2dirty_idg(plan_idg(uvw, FREQ, device="cpu", **IDG_KW), torch.as_tensor(vis),
                          wgt=torch.as_tensor(wgt)).numpy()
    for r in range(NSH):
        out = load(ranks, "idg_dirty", r)
        assert _rel(out, jax_idg[2]) < 1e-10, r
        assert _rel(out, local) < 1e-10, r


def test_sharded_dirty2vis_idg_matches_jax_and_local(ranks, jax_idg):
    from pfb_imaging_tpu_torch.ops.gridder_idg import dirty2vis_idg, plan_idg

    uvw, _, _, img = _idg_data()
    rows = jax_idg[1]
    local = dirty2vis_idg(plan_idg(uvw, FREQ, device="cpu", **IDG_KW), torch.as_tensor(img), split=True).numpy()
    idx = _indices(ranks)
    for r in range(NSH):
        i = idx[r]
        out = load(ranks, "idg_vis", r)
        assert out.shape == (2, rows, 2)
        assert _rel(out, jax_idg[3][i]) < 1e-10, r
        assert _rel(out, local[:, i * rows:(i + 1) * rows]) < 1e-10, r


def test_sharded_wgridder_matches_jax_and_local(ranks):
    import jax.numpy as jnp

    from pfb_imaging_tpu.parallel.mesh import make_mesh
    from pfb_imaging_tpu.parallel.sharded import plan_wgridder_sharded, sharded_vis2dirty
    from pfb_imaging_tpu_torch.ops.gridder import plan_wgridder, vis2dirty

    uvw, vis, wgt = _small_data(256, 0)
    stacked, rows = plan_wgridder_sharded(uvw, FREQ, NSH, **WG_KW)
    sh = lambda a: jnp.asarray(a.reshape(NSH, rows, -1))  # noqa: E731
    jout = np.asarray(sharded_vis2dirty(make_mesh(band=2, row=2), stacked, sh(vis), sh(wgt)))
    local = vis2dirty(plan_wgridder(uvw, FREQ, device="cpu", **WG_KW), torch.as_tensor(vis),
                      wgt=torch.as_tensor(wgt)).numpy()
    for r in range(NSH):
        out = load(ranks, "wg_dirty", r)
        assert _rel(out, jout) < 1e-10, r
        assert _rel(out, local) < 1e-10, r


def test_row_sharded_dft_matches_jax(ranks):
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops.dft import vis2dirty_dft

    uvw, vis, wgt = _small_data(64, 1)
    ref = np.asarray(vis2dirty_dft(jnp.asarray(uvw), jnp.asarray(FREQ), jnp.asarray(vis), wgt=jnp.asarray(wgt),
                                   **DFT_KW))
    for r in range(NSH):
        assert _rel(load(ranks, "dft_dirty", r), ref) < 1e-10, r


def test_multiband_vis2dirty_idg_matches_jax():
    """``plan_idg_multiband`` + ``multiband_vis2dirty_idg`` (every band of a
    partition in one B1 launch) against the JAX stack's vmapped dispatch
    and against each band's plan alone (tests/test_parallel.py's layout,
    bands of unequal widths): 1e-10."""
    import jax.numpy as jnp

    from pfb_imaging_tpu.parallel.sharded import multiband_vis2dirty_idg as jax_mb, plan_idg_multiband as jax_plan
    from pfb_imaging_tpu_torch.ops.gridder_idg import vis2dirty_idg
    from pfb_imaging_tpu_torch.parallel.sharded import multiband_vis2dirty_idg, plan_idg_multiband

    rng = np.random.default_rng(12)
    nrow, nchan = 1200, 6
    uvw = rng.uniform(-16000, 16000, (nrow, 3))
    uvw[:, 2] *= 0.2
    freq = np.linspace(1e9, 1.2e9, nchan)
    vis = rng.standard_normal((nrow, nchan)) + 1j * rng.standard_normal((nrow, nchan))
    wgt = rng.uniform(0.5, 2.0, (nrow, nchan))
    slices = [np.arange(0, 4), np.arange(4, 6)]
    mplan, nch = plan_idg_multiband(uvw, freq, slices, device="cpu", **IDG_KW)
    stacked, nch_j = jax_plan(uvw, freq, slices, dtype=np.float64, **IDG_KW)
    assert nch == nch_j == 4
    vr, vi, wg = (np.zeros((2, nrow, nch)) for _ in range(3))
    for b, sl in enumerate(slices):
        vr[b, :, : sl.size], vi[b, :, : sl.size], wg[b, :, : sl.size] = vis.real[:, sl], vis.imag[:, sl], wgt[:, sl]
    out = multiband_vis2dirty_idg(mplan, *(torch.as_tensor(a) for a in (vr, vi, wg))).numpy()
    ref = np.asarray(jax_mb(stacked, jnp.asarray(vr), jnp.asarray(vi), jnp.asarray(wg)))
    assert _rel(out, ref) < 1e-10
    for b, p in enumerate(mplan.plans):
        alone = vis2dirty_idg(p, torch.as_tensor(vr[b]), wgt=torch.as_tensor(wg[b]), vis_im=torch.as_tensor(vi[b]))
        assert _rel(out[b], alone.numpy()) < 1e-10, b
