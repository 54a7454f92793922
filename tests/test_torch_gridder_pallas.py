"""The port's w-stacked scatter and gather (``ops/gridder_pallas.py``: the
plain versions of the CUDA kernels that replace the Pallas kernels B3, B5
and B6, and B4) against the JAX Pallas kernels in interpret mode, the
direct one-plane oracle of the JAX tests, and the JAX classic gridder, on
the CPU; the kernels' host plan (plane spans, scratch offsets, compose
lists) checked by brute force, and their passes rehearsed in torch on it.

Tolerances: the plain version in f64 against the f32 Pallas kernel to
1e-5 relative (f32 stencils); against the f64 oracle, the rehearsals and
the gather/scatter adjoint to 1e-12; the f32 ``vis2dirty_scatter`` and
``dirty2vis_scatter`` against JAX's to 2e-5, the JAX tests' own bound.

JAX is imported inside the tests that compare with it, so the ``gpu``
test also runs where only PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_gridder_pallas.py``.
"""

import dataclasses
import gc
import itertools

import numpy as np
import pytest
import torch

from pfb_imaging_tpu_torch.ops import gridder as TG
from pfb_imaging_tpu_torch.ops import gridder_pallas as TP

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def direct_scatter(u_loc, v_loc, vre, vim, support, beta, nbig):
    """The one-plane oracle of the JAX tests: a dense loop over each
    visibility's ES stencil, window cells taken mod nbig."""
    grid = np.zeros((2, nbig, nbig))
    for k in range(u_loc.size):
        i0 = int(np.floor(u_loc[k] - support / 2.0)) + 1
        j0 = int(np.floor(v_loc[k] - support / 2.0)) + 1
        for a in range(support):
            xu = 2.0 * (i0 + a - u_loc[k]) / support
            for b in range(support):
                xv = 2.0 * (j0 + b - v_loc[k]) / support
                w = TG.es_kernel(np.array(xu), beta) * TG.es_kernel(np.array(xv), beta)
                grid[0, (i0 + a) % nbig, (j0 + b) % nbig] += vre[k] * w
                grid[1, (i0 + a) % nbig, (j0 + b) % nbig] += vim[k] * w
    return grid


def _wide_uvw(nrow, seed, wscale):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-1500, 1500, (nrow, 3))
    uvw[:, 2] *= wscale
    return uvw


def _ten_antennas(wfrac=0.02):
    """The 10-antenna layout of the JAX wrapper test."""
    r0 = np.random.RandomState(5)
    a1, a2 = np.asarray(list(itertools.combinations(range(10), 2))).T
    antennas = 6e3 * r0.normal(size=(10, 3))
    antennas[:, 2] *= wfrac
    return antennas[a1] - antennas[a2]


KW = dict(nx=64, ny=64, cellx=1e-4, celly=1e-4, divide_by_n=False)
FREQ = np.array([1.0e9, 1.1e9])


def test_scatter_ref_matches_jax_wstack_kernel():
    """Six planes of a w-stacked f32 plan: the plain version against JAX
    ``pallas_scatter_grid_wstack`` (interpret mode) on the same sorted
    stream. The JAX plan sends windows that wrap the grid edge to an XLA
    scatter outside its kernel, so their values are zero here; the port
    grids them in the kernel (see the oracle test below)."""
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops import gridder as JG
    from pfb_imaging_tpu.ops import gridder_pallas as JP

    uvw = _wide_uvw(150, 3, 20.0)
    pj = JG.plan_wgridder(uvw, FREQ, epsilon=1e-5, dtype=np.float32, **KW)
    pt = TG.plan_wgridder(uvw, FREQ, epsilon=1e-5, dtype=np.float32, device=CPU, **KW)
    assert pt.nw == pj.nw >= 10
    nvis = pt.nvis
    rng = np.random.default_rng(4)
    vre = rng.standard_normal(nvis).astype(np.float32)
    vim = rng.standard_normal(nvis).astype(np.float32)
    tiles = JP.plan_pallas(pj)
    vre[tiles["fallback"]] = 0.0
    vim[tiles["fallback"]] = 0.0
    p0, nw = 3, 6
    idx = tiles["pad_idx"]
    pad = lambda a: jnp.asarray(np.concatenate([a, [0.0]]).astype(np.float32)[idx])  # noqa: E731
    wl = np.asarray(pj.w_lam, np.float64)[:nvis]
    out_j = JP.pallas_scatter_grid_wstack(
        tiles["lu8_dev"], tiles["fu_dev"], tiles["fv_dev"], pad(wl), pad(vre), pad(vim), support=pj.support,
        beta=pj.beta, capacity=tiles["capacity"], nchunks=tiles["nchunks"], ntx=tiles["ntx"], nty=tiles["nty"],
        nbig_x=pj.nbig_x, nbig_y=pj.nbig_y, nw=nw, w0=pj.w0 + p0 * pj.dw, dw=pj.dw, w_support=pj.w_support,
        interpret=True)
    tt = TP.tiles_for(pt)
    vt_re, vt_im = torch.as_tensor(vre)[tt.perm], torch.as_tensor(vim)[tt.perm]  # tile order
    out_t = TP.scatter_grid_wstack_ref(pt, tt, vt_re.double(), vt_im.double(), p0, nw)
    assert out_t.shape == (nw, 2, pt.nbig_x, pt.nbig_y)
    assert _rel(out_t, out_j) < 1e-5
    # the wrapper takes the plain version for CPU tensors
    got = TP.scatter_grid_wstack(pt, tt, vt_re, vt_im, p0, nw)
    assert got.dtype == torch.float32 and _rel(got, out_j) < 1e-5


@pytest.mark.parametrize("eps", [1e-5, 1e-7])
def test_one_plane_matches_direct_oracle(eps):
    """nw = 1 (a plan without w-gridding): the one-plane grid that B5 and B6
    compute, against the JAX tests' direct oracle, windows that wrap the
    grid edge included."""
    uvw = _wide_uvw(300, 5, 1.0)
    pt = TG.plan_wgridder(uvw, FREQ, epsilon=eps, do_wgridding=False, dtype=np.float64, device=CPU, **KW)
    assert pt.nw == 1 and pt.support == (6 if eps == 1e-5 else 8)
    rng = np.random.default_rng(6)
    vre, vim = rng.standard_normal((2, pt.nvis))
    u = (pt.iu0 + pt.du).numpy()
    v = (pt.iv0 + pt.dv).numpy()
    wraps = (np.floor(u - pt.support / 2) + 1 < 0) | (np.floor(v - pt.support / 2) + 1 < 0)
    assert wraps.any()
    oracle = direct_scatter(u, v, vre, vim, pt.support, pt.beta, pt.nbig_x)
    tt = TP.plan_pallas(pt)
    out = TP.scatter_grid_wstack_ref(pt, tt, torch.as_tensor(vre)[tt.perm], torch.as_tensor(vim)[tt.perm], 0, 1)
    assert _rel(out[0], oracle) < 1e-12


ACC_WARPS = 8  # warps of the CUDA accumulate block


def _emulate_kernel(plan, tiles, vre, vim, p0, nw):
    """The CUDA scatter's two passes in torch on the host plan (f64).
    Accumulate: per launched block of the chunk plan, its visibilities into
    (nq, 2, A, TILE + W) partials of its planes [qa, qa + nq) at the
    tile-relative window starts, each plane's rows split into the bands of
    the warps that own it (warp w: plane w mod nq), each band adding only
    the window rows inside it; stored at the block's scratch offset.
    Compose: per output tile and plane, the sum of the partials its
    compose list names, in list order, each read from the core's first
    cell (ox, oy) on, written once into a NaN-filled grid (every cell must
    be written). Values come in tile order."""
    W, tile = plan.support, TP.TILE
    A, S = tile + W - 1, tile + W
    part = 2 * A * S
    ch = TP.chunk_plan(plan, tiles, p0, nw)
    scratch = torch.full((max(ch.scratch, 1),), float("nan"), dtype=torch.float64)
    offs = torch.arange(W)
    v_t = torch.stack([vre, vim]).double()
    for blk in ch.act.tolist():
        qa, nq, off = int(ch.qa[blk]), int(ch.nq[blk]), int(ch.off[blk])
        s, c = int(tiles.blk_start[blk]), int(tiles.blk_count[blk])
        sl = slice(s, s + c)
        ku = TG.es_kernel(2.0 * (tiles.du[sl, None].double() - offs) / W, plan.beta)
        kv = TG.es_kernel(2.0 * (tiles.dv[sl, None].double() - offs) / W, plan.beta)
        rows = tiles.lu[sl, None].long() + offs  # (c, W) accumulator rows of each window
        cell = rows[:, :, None] * S + (tiles.lv[sl, None, None] + offs)
        acc = torch.zeros((nq, 2, A * S), dtype=torch.float64)
        for w in range(ACC_WARPS):
            q, nband = w % nq, (ACC_WARPS - 1 - w % nq) // nq + 1
            r0, r1 = (w // nq) * A // nband, (w // nq + 1) * A // nband
            ww = TG._w_weight(plan, tiles.w_rel[sl].double(), p0 + qa + q)
            inband = ((rows >= r0) & (rows < r1))[:, :, None]
            contrib = (v_t[:, sl] * ww)[:, :, None, None] * (ku[:, :, None] * kv[:, None, :] * inband)
            acc[q].index_add_(1, cell.reshape(-1), contrib.reshape(2, -1))
        scratch[off : off + nq * part] = acc.reshape(-1)
    out = torch.full((nw, 2, plan.nbig_x, plan.nbig_y), float("nan"), dtype=torch.float64)
    for t in range(tiles.ntx * tiles.nty):
        gx0, gy0 = t // tiles.nty * tile, t % tiles.nty * tile
        cw, chh = min(tile, plan.nbig_x - gx0), min(tile, plan.nbig_y - gy0)
        for q in range(nw):
            core = torch.zeros((2, tile, tile), dtype=torch.float64)
            for e in range(int(tiles.cmp_ptr[t]), int(tiles.cmp_ptr[t + 1])):
                blk, oxy = int(tiles.cmp_blk[e]), int(tiles.cmp_oxy[e])
                qq = q - int(ch.qa[blk])
                if not 0 <= qq < int(ch.nq[blk]):
                    continue
                ox, oy = oxy >> 16, oxy & 0xFFFF
                src = scratch[int(ch.off[blk]) + qq * part :][:part].reshape(2, A, S)
                nx_, ny_ = min(tile, A - ox), min(tile, A - oy)
                core[:, :nx_, :ny_] += src[:, ox : ox + nx_, oy : oy + ny_]
            out[q, :, gx0 : gx0 + cw, gy0 : gy0 + chh] = core[:, :cw, :chh]
    assert not out.isnan().any()
    return out


@pytest.mark.parametrize("do_w", [True, False])
def test_tile_plan_reassembles_grid(do_w, monkeypatch):
    """The layout the CUDA scatter reads (tile order, tile-relative window
    starts, blocks cut at ``BLOCK_VIS``, plane spans, scratch offsets,
    compose lists) puts every stencil where the plain version does,
    wrapped windows included."""
    monkeypatch.setattr(TP, "BLOCK_VIS", 16)  # several blocks per busy tile
    uvw = _wide_uvw(200, 7, 20.0 if do_w else 1.0)
    pt = TG.plan_wgridder(uvw, FREQ, epsilon=1e-5, do_wgridding=do_w, dtype=np.float32, device=CPU, **KW)
    tiles = TP.plan_pallas(pt)
    assert int(tiles.blk_count.max()) <= 16 and int(tiles.blk_count.sum()) == pt.nvis
    assert len(set(tiles.blk_tile.tolist())) < tiles.nblocks
    assert int(tiles.lu.min()) >= 0 and int(tiles.lu.max()) < TP.TILE
    rng = np.random.default_rng(8)
    vre, vim = (torch.as_tensor(a) for a in rng.standard_normal((2, pt.nvis)))  # tile order
    p0, nw = (2, 4) if do_w else (0, 1)
    ch = TP.chunk_plan(pt, tiles, p0, nw)
    if do_w:  # some blocks miss the chunk and are not launched
        assert 0 < ch.act.numel() < tiles.nblocks and ch.nq_max <= nw
    ref = TP.scatter_grid_wstack_ref(pt, tiles, vre, vim, p0, nw)
    assert _rel(_emulate_kernel(pt, tiles, vre, vim, p0, nw), ref) < 1e-12


@pytest.mark.parametrize("nx", [45, 81])
def test_tile_plan_reassembles_grid_with_short_last_tile(nx, monkeypatch):
    """nbig 90 and 162 are not multiples of TILE: the last tile is short,
    and at 162 (2 cells past the last full tile, fewer than W - 1) the apron
    of the tile before it wraps past the grid edge into tile 0. The
    accumulate/compose rehearsal still matches the plain version."""
    monkeypatch.setattr(TP, "BLOCK_VIS", 32)
    uvw = _wide_uvw(300, 21, 20.0)
    kw = dict(KW, nx=nx, ny=nx)
    # an f32 plan: the tile plan holds its coordinates exactly
    pt = TG.plan_wgridder(uvw, FREQ, epsilon=1e-5, dtype=np.float32, device=CPU, **kw)
    assert pt.nbig_x == 2 * nx and pt.nbig_x % TP.TILE in (26, 2)
    tiles = TP.plan_pallas(pt)
    rng = np.random.default_rng(22)
    vre, vim = (torch.as_tensor(a) for a in rng.standard_normal((2, pt.nvis)))
    p0, nw = 1, min(TP.PLANE_CHUNK, pt.nw - 1)
    ref = TP.scatter_grid_wstack_ref(pt, tiles, vre, vim, p0, nw)
    assert _rel(_emulate_kernel(pt, tiles, vre, vim, p0, nw), ref) < 1e-12


@pytest.mark.parametrize("nx", [32, 45, 81])
def test_compose_lists_name_exactly_the_covering_blocks(nx, monkeypatch):
    """Per output tile, the compose list holds exactly the blocks whose tile
    plus (W - 1)-cell apron covers a cell of its core, taken mod nbig
    (short and wrapped tiles included), and each entry's (ox, oy) maps
    position (ox + x, oy + y) of the block's partial onto core cell
    (x, y); brute force over every block's cells."""
    monkeypatch.setattr(TP, "BLOCK_VIS", 8)
    pt = TG.plan_wgridder(_wide_uvw(200, 23, 20.0), FREQ, epsilon=1e-5, dtype=np.float32, device=CPU,
                          **dict(KW, nx=nx, ny=nx))
    tiles = TP.plan_pallas(pt)
    nbx, nby, tile = pt.nbig_x, pt.nbig_y, TP.TILE
    A = tile + pt.support - 1
    owner = (np.arange(nbx)[:, None] // tile) * tiles.nty + np.arange(nby)[None, :] // tile  # tile of each cell
    ptr, blks, oxys = tiles.cmp_ptr.numpy(), tiles.cmp_blk.numpy(), tiles.cmp_oxy.numpy()
    want = {t: set() for t in range(tiles.ntx * tiles.nty)}
    for b, t2 in enumerate(tiles.blk_tile.tolist()):
        gx = (t2 // tiles.nty * tile + np.arange(A)) % nbx
        gy = (t2 % tiles.nty * tile + np.arange(A)) % nby
        for t in np.unique(owner[gx[:, None], gy[None, :]]):
            want[int(t)].add(b)
    for t in range(tiles.ntx * tiles.nty):
        ents = list(zip(blks[ptr[t] : ptr[t + 1]].tolist(), oxys[ptr[t] : ptr[t + 1]].tolist()))
        assert {b for b, _ in ents} == want[t]
        assert [b for b, _ in ents] == sorted(b for b, _ in ents)  # the fixed order
        gx0, gy0 = t // tiles.nty * tile, t % tiles.nty * tile
        for b, oxy in ents:
            t2 = int(tiles.blk_tile[b])
            ox, oy = oxy >> 16, oxy & 0xFFFF
            assert ox < A and oy < A
            assert (t2 // tiles.nty * tile + ox) % nbx == gx0 and (t2 % tiles.nty * tile + oy) % nby == gy0


@pytest.mark.parametrize("do_w", [True, False])
def test_block_plane_spans_and_scratch_offsets(do_w, monkeypatch):
    """Each block's plane span covers every (visibility, plane) pair whose
    f64 w-weight is not zero; per chunk, the launched blocks are those
    whose span meets it, and their scratch slots (nq partial planes each)
    follow one another without overlap or gap."""
    monkeypatch.setattr(TP, "BLOCK_VIS", 16)
    uvw = _wide_uvw(200, 25, 20.0 if do_w else 1.0)
    pt = TG.plan_wgridder(uvw, FREQ, epsilon=1e-5, do_wgridding=do_w, dtype=np.float64, device=CPU, **KW)
    tiles = TP.plan_pallas(pt)
    lo, hi = tiles.blk_planes.T
    blk_of = np.repeat(np.arange(tiles.nblocks), tiles.blk_count.numpy())  # block of each visibility, tile order
    w_t = pt.w_rel[tiles.perm]
    for p in range(pt.nw):
        on = (TG._w_weight(pt, w_t, p) != 0).numpy()
        assert on.any()
        assert ((lo[blk_of[on]] <= p) & (p < hi[blk_of[on]])).all()
    part = 2 * (TP.TILE + pt.support - 1) * (TP.TILE + pt.support)
    for p0 in range(0, pt.nw, 3):
        nw = min(TP.PLANE_CHUNK, pt.nw - p0)
        ch = TP.chunk_plan(pt, tiles, p0, nw)
        assert TP.chunk_plan(pt, tiles, p0, nw) is ch  # cached
        qa, nq, off, act = ch.qa.numpy(), ch.nq.numpy(), ch.off.numpy(), ch.act.numpy()
        np.testing.assert_array_equal(nq, np.maximum(np.minimum(hi, p0 + nw) - np.maximum(lo, p0), 0))
        np.testing.assert_array_equal(act, np.flatnonzero(nq))
        assert (qa[act] == np.maximum(lo[act], p0) - p0).all() and ch.nq_max == nq.max()
        ends = off[act] + nq[act] * part
        assert off[act[0]] == 0 and (off[act[1:]] == ends[:-1]).all() and ends[-1] == ch.scratch


@pytest.mark.parametrize("nx,block_vis", [(32, 8), (45, 16), (81, 64), (81, 2048)])
def test_scratch_stays_within_its_bound(nx, block_vis, monkeypatch):
    """On plans whose uv spread over the whole grid, the blocks number at
    most the occupied tiles plus nvis / BLOCK_VIS, and each chunk's scratch
    at most nw partial planes of 2 (TILE + W - 1)(TILE + W) floats per
    launched block: the bound ``ChunkPlan`` states."""
    monkeypatch.setattr(TP, "BLOCK_VIS", block_vis)
    pt = TG.plan_wgridder(_wide_uvw(400, 27, 20.0), FREQ, epsilon=1e-5, dtype=np.float32, device=CPU,
                          **dict(KW, nx=nx, ny=nx))
    tiles = TP.plan_pallas(pt)
    occupied = len(set(tiles.blk_tile.tolist()))
    assert occupied > tiles.ntx * tiles.nty // 2
    assert tiles.nblocks <= occupied + pt.nvis / block_vis
    part = 2 * (TP.TILE + pt.support - 1) * (TP.TILE + pt.support)
    for p0 in range(0, pt.nw, TP.PLANE_CHUNK):
        nw = min(TP.PLANE_CHUNK, pt.nw - p0)
        ch = TP.chunk_plan(pt, tiles, p0, nw)
        assert 0 < ch.scratch <= nw * part * ch.act.numel() <= nw * part * (occupied + pt.nvis / block_vis)


def test_vis2dirty_scatter_matches_jax_with_wgridding():
    """The port's f32 ``vis2dirty_scatter`` against JAX's (Pallas B3 in
    interpret mode) on the 10-antenna layout of the JAX tests."""
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops import gridder as JG
    from pfb_imaging_tpu.ops import gridder_pallas as JP

    uvw = _ten_antennas()
    kw = dict(nx=64, ny=64, cellx=2.5e-5 / 2, celly=2.5e-5 / 2, epsilon=1e-5, do_wgridding=True, dtype=np.float32)
    pj = JG.plan_wgridder(uvw, FREQ, **kw)
    pt = TG.plan_wgridder(uvw, FREQ, device=CPU, **kw)
    rng = np.random.default_rng(9)
    vis = rng.standard_normal((uvw.shape[0], 2)) + 1j * rng.standard_normal((uvw.shape[0], 2))
    dj = np.asarray(JP.vis2dirty_scatter(pj, jnp.asarray(vis.astype(np.complex64))))
    dt = TP.vis2dirty_scatter(pt, torch.as_tensor(vis.astype(np.complex64)))
    assert _rel(dt, dj) < 2e-5


def test_vis2dirty_scatter_without_wgridding_matches_classic():
    """With ``do_wgridding=False`` the port is held against the JAX classic
    ``vis2dirty``, not against the JAX ``vis2dirty_scatter``: that one
    multiplies every visibility by an ES w-weight even when the plan keeps
    the raw w (w0 = 0, dw = 1, w_support = 1), which the classic gridder's
    ``_w_weight`` does not, so its image is wrong there. The port follows
    ``_w_weight``."""
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops import gridder as JG
    from pfb_imaging_tpu.ops import gridder_pallas as JP

    uvw = _ten_antennas()
    kw = dict(nx=64, ny=64, cellx=2.5e-5 / 2, celly=2.5e-5 / 2, epsilon=1e-5, do_wgridding=False)
    pj = JG.plan_wgridder(uvw, FREQ, dtype=np.float64, **kw)
    pt = TG.plan_wgridder(uvw, FREQ, dtype=np.float32, device=CPU, **kw)
    assert pt.nw == 1 and not pt.do_wgridding
    rng = np.random.default_rng(10)
    vis = rng.standard_normal((uvw.shape[0], 2)) + 1j * rng.standard_normal((uvw.shape[0], 2))
    dj = np.asarray(JG.vis2dirty(pj, jnp.asarray(vis)))
    dt = TP.vis2dirty_scatter(pt, torch.as_tensor(vis.astype(np.complex64)))
    assert _rel(dt, dj) < 2e-5


def test_require_f32_raises_on_f64_plan():
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops import gridder as JG
    from pfb_imaging_tpu.ops import gridder_pallas as JP

    uvw = _ten_antennas()
    kw = dict(nx=32, ny=32, cellx=2.5e-5, celly=2.5e-5, epsilon=1e-5)
    pt = TG.plan_wgridder(uvw, FREQ, dtype=np.float64, device=CPU, **kw)
    pj = JG.plan_wgridder(uvw, FREQ, dtype=np.float64, **kw)
    vis = np.ones((uvw.shape[0], 2), np.complex128)
    with pytest.raises(ValueError, match="f32-only"):
        TP.vis2dirty_scatter(pt, torch.as_tensor(vis))
    with pytest.raises(ValueError, match="f32-only"):
        JP.vis2dirty_scatter(pj, jnp.asarray(vis))


def test_tiles_cache_keeps_several_plans():
    uvw = _ten_antennas()
    plans = [TG.plan_wgridder(uvw, FREQ, nx=n, ny=n, cellx=2.5e-5, celly=2.5e-5, epsilon=1e-5, dtype=np.float32,
                              device=CPU) for n in (32, 48)]
    t0, t1 = TP.tiles_for(plans[0]), TP.tiles_for(plans[1])
    assert TP.tiles_for(plans[0]) is t0 and TP.tiles_for(plans[1]) is t1
    n = len(TP._TILES)
    del plans
    gc.collect()
    assert len(TP._TILES) == n - 2  # an entry leaves with its plan


def test_wrapper_checks_its_arguments():
    uvw = _ten_antennas()
    pt = TG.plan_wgridder(uvw, FREQ, nx=32, ny=32, cellx=2.5e-5, celly=2.5e-5, epsilon=1e-5, dtype=np.float32,
                          device=CPU)
    tiles = TP.tiles_for(pt)
    v = torch.zeros(pt.nvis, dtype=torch.float32)
    with pytest.raises(ValueError, match="plane chunk"):
        TP._check_launch(pt, tiles, v, v, 0, TP.PLANE_CHUNK + 1)
    with pytest.raises(TypeError, match="float32"):
        TP._check_launch(pt, tiles, v.double(), v.double(), 0, 1)


def _jax_leaves(pj):
    """The numpy leaves and static fields of a JAX ``WGridderPlan``."""
    names = ("u_pix", "v_pix", "w_lam", "sort_idx", "plane_start", "plane_count", "phase_re", "phase_im",
             "corr_img", "nm1", "cw_img")
    leaves = {f: np.asarray(getattr(pj, f)) for f in names}
    return leaves, {f.name: getattr(pj, f.name) for f in dataclasses.fields(pj) if f.name not in leaves}


@pytest.mark.parametrize("do_w", [True, False])
def test_dirty2vis_scatter_matches_jax_gather_kernel(do_w):
    """The port's f32 ``dirty2vis_scatter`` (the gather's plain version here)
    on a plan converted from the JAX f32 plan, against JAX
    ``dirty2vis_scatter``, which runs the Pallas gather B4 in interpret mode,
    on the 10-antenna layout of the JAX tests."""
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops import gridder as JG
    from pfb_imaging_tpu.ops import gridder_pallas as JP

    assert JP._interpret_default()
    uvw = _ten_antennas()
    kw = dict(nx=64, ny=64, cellx=2.5e-5 / 2, celly=2.5e-5 / 2, epsilon=1e-5, do_wgridding=do_w, dtype=np.float32)
    pj = JG.plan_wgridder(uvw, FREQ, **kw)
    pt = TG.wgridder_plan_from_jax(*_jax_leaves(pj), device=CPU)
    assert pt.rdt == torch.float32 and pt.nw == pj.nw and pt.do_wgridding == do_w
    img = np.random.default_rng(13).standard_normal((64, 64)).astype(np.float32)
    vj = np.asarray(JP.dirty2vis_scatter(pj, jnp.asarray(img)))
    vt = TP.dirty2vis_scatter(pt, torch.as_tensor(img))
    assert vt.dtype == torch.complex64 and vt.shape == vj.shape
    assert _rel(torch.view_as_real(vt), np.stack([vj.real, vj.imag], -1)) < 2e-5
    assert _rel(TP.dirty2vis_scatter(pt, torch.as_tensor(img), split=True), np.stack([vj.real, vj.imag])) < 2e-5


def _emulate_gather(plan, tiles, grids, p0, nw):
    """The CUDA gather's order in torch on the host plan: per launched block
    of the chunk plan, stage only its planes [qa, qa + nq) of the tile plus
    apron from ``grids`` (cells taken mod nbig), then per visibility the
    stencil-weighted sum over the staged window at its tile-relative start,
    on the planes its f32 rule names (floor(w_rel - w_support / 2) and the
    next w_support + 1), each times its w-weight. Returns (2, nvis) in tile
    order."""
    W, tile = plan.support, TP.TILE
    A = tile + W - 1
    ch = TP.chunk_plan(plan, tiles, p0, nw)
    out = torch.zeros((2, plan.nvis), dtype=torch.float64)
    offs = torch.arange(W)
    for blk in ch.act.tolist():
        qa, nq = int(ch.qa[blk]), int(ch.nq[blk])
        t = int(tiles.blk_tile[blk])
        gx = (t // tiles.nty * tile + torch.arange(A)) % plan.nbig_x
        gy = (t % tiles.nty * tile + torch.arange(A)) % plan.nbig_y
        staged = grids[qa : qa + nq][:, :, gx[:, None], gy[None, :]].double()  # (nq, 2, A, A)
        s, c = int(tiles.blk_start[blk]), int(tiles.blk_count[blk])
        sl = slice(s, s + c)
        ku = TG.es_kernel(2.0 * (tiles.du[sl, None].double() - offs) / W, plan.beta)
        kv = TG.es_kernel(2.0 * (tiles.dv[sl, None].double() - offs) / W, plan.beta)
        iu = tiles.lu[sl, None].long() + offs
        iv = tiles.lv[sl, None].long() + offs
        pa = torch.floor(tiles.w_rel[sl] - 0.5 * plan.w_support).long() - p0 - qa
        for q in range(nq):
            ww = TG._w_weight(plan, tiles.w_rel[sl].double(), p0 + qa + q)
            if plan.do_wgridding:
                ww = torch.where((pa <= q) & (q < pa + plan.w_support + 2), ww, 0.0)
            win = staged[q][:, iu[:, :, None], iv[:, None, :]]  # (2, c, W, W)
            out[:, sl] += ww * (win * (ku[:, :, None] * kv[:, None, :])).sum(dim=(2, 3))
    return out


@pytest.mark.parametrize("do_w", [True, False])
def test_tile_plan_reproduces_gather(do_w, monkeypatch):
    """The gather kernel's block order, staged plane spans and wrap,
    rehearsed in torch on the tile plan, against the plain version in
    f64, windows that cross the grid edge included."""
    monkeypatch.setattr(TP, "BLOCK_VIS", 16)
    uvw = _wide_uvw(200, 7, 20.0 if do_w else 1.0)
    # an f32 plan, so that the plan and the kernel's f32 tile plan hold the
    # same coordinates; the grids and the arithmetic are f64
    pt = TG.plan_wgridder(uvw, FREQ, epsilon=1e-5, do_wgridding=do_w, dtype=np.float32, device=CPU, **KW)
    tiles = TP.plan_pallas(pt)
    assert len(set(tiles.blk_tile.tolist())) < tiles.nblocks
    u, v = (pt.iu0 + pt.du).numpy(), (pt.iv0 + pt.dv).numpy()
    assert ((np.floor(u - pt.support / 2) + 1 < 0) | (np.floor(v - pt.support / 2) + 1 < 0)).any()
    p0, nw = (2, 5) if do_w else (0, 1)
    if do_w:
        assert int(TP.chunk_plan(pt, tiles, p0, nw).nq.min()) < nw  # some blocks stage fewer planes
    grids = torch.as_tensor(np.random.default_rng(14).standard_normal((nw, 2, pt.nbig_x, pt.nbig_y)))
    ref = TP.gather_grid_wstack_ref(pt, tiles, grids, p0, nw)
    assert ref.shape == (2, pt.nvis) and ref.dtype == torch.float64
    assert _rel(_emulate_gather(pt, tiles, grids, p0, nw), ref) < 1e-12
    # the wrapper adds into its accumulator on the CPU
    acc = torch.ones((2, pt.nvis), dtype=torch.float64)
    assert TP.gather_grid_wstack(pt, tiles, grids, p0, nw, out=acc) is acc
    assert _rel(acc - 1.0, ref) < 1e-15


@pytest.mark.parametrize("do_w", [True, False])
def test_gather_is_adjoint_of_scatter(do_w):
    """<gather(grids), v> = <grids, scatter(v)> on one tile plan, in f64."""
    uvw = _wide_uvw(200, 15, 20.0 if do_w else 1.0)
    pt = TG.plan_wgridder(uvw, FREQ, epsilon=1e-7, do_wgridding=do_w, dtype=np.float64, device=CPU, **KW)
    tiles = TP.tiles_for(pt)
    rng = np.random.default_rng(16)
    p0, nw = (1, min(TP.PLANE_CHUNK, pt.nw - 1)) if do_w else (0, 1)
    grids = torch.as_tensor(rng.standard_normal((nw, 2, pt.nbig_x, pt.nbig_y)))
    v = torch.as_tensor(rng.standard_normal((2, pt.nvis)))
    lhs = float((TP.gather_grid_wstack_ref(pt, tiles, grids, p0, nw) * v).sum())
    rhs = float((grids * TP.scatter_grid_wstack_ref(pt, tiles, v[0], v[1], p0, nw)).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_gather_wrapper_checks_its_arguments():
    uvw = _ten_antennas()
    pt = TG.plan_wgridder(uvw, FREQ, nx=32, ny=32, cellx=2.5e-5, celly=2.5e-5, epsilon=1e-5, dtype=np.float32,
                          device=CPU)
    tiles = TP.tiles_for(pt)
    g = torch.zeros((1, 2, pt.nbig_x, pt.nbig_y), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        TP._check_tensor("grids", g.double(), tuple(g.shape), tiles)
    with pytest.raises(ValueError, match="shape"):
        TP._check_tensor("grids", g[:, :, :-1], tuple(g.shape), tiles)
    with pytest.raises(ValueError, match="f32-only"):
        TP.dirty2vis_scatter(TG.plan_wgridder(uvw, FREQ, nx=32, ny=32, cellx=2.5e-5, celly=2.5e-5, epsilon=1e-5,
                                              dtype=np.float64, device=CPU), torch.zeros((32, 32)))


@pytest.mark.gpu
def test_gather_kernel_matches_plain_on_cuda():
    """The CUDA gather against its plain version in f64 (rel Linf <= 1e-5:
    f32 stencils and sums in another order), one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    uvw = _wide_uvw(20000, 11, 20.0)
    for do_w, nw in ((True, 8), (False, 1)):
        pt = TG.plan_wgridder(uvw, FREQ, epsilon=1e-5, do_wgridding=do_w, dtype=np.float32, device=dev,
                              nx=256, ny=256, cellx=1e-4, celly=1e-4)
        rng = np.random.default_rng(17)
        grids = torch.as_tensor(rng.standard_normal((nw, 2, pt.nbig_x, pt.nbig_y)), device=dev).float()
        p0 = max(0, pt.nw // 2 - nw // 2)
        before = TP.LAUNCHES["gather_grid_wstack"]
        tiles = TP.tiles_for(pt)
        out = TP.gather_grid_wstack(pt, tiles, grids, p0, nw)
        torch.cuda.synchronize()
        assert TP.LAUNCHES["gather_grid_wstack"] == before + 1
        ref = TP.gather_grid_wstack_ref(pt, tiles, grids.double(), p0, nw)
        assert _rel(out.cpu(), ref.cpu()) < 1e-5


@pytest.mark.gpu
def test_kernel_matches_plain_on_cuda():
    """The CUDA kernel against its plain version in f64 (rel Linf <= 1e-5:
    f32 stencils and sums in another order), one launch count per call;
    with uv over the whole grid, and inside a small disk (most tiles hold
    no visibility, so compose alone writes their zeros) into memory left
    holding NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    uvw = _wide_uvw(20000, 11, 20.0)
    for do_w, nw, uv_scale in ((True, 8, 1.0), (False, 1, 1.0), (True, 8, 0.1)):
        pt = TG.plan_wgridder(uvw * np.array([uv_scale, uv_scale, 1.0]), FREQ, epsilon=1e-5, do_wgridding=do_w,
                              dtype=np.float32, device=dev, nx=256, ny=256, cellx=1e-4, celly=1e-4)
        rng = np.random.default_rng(12)
        vre, vim = (torch.as_tensor(a, device=dev).float() for a in rng.standard_normal((2, pt.nvis)))
        p0 = max(0, pt.nw // 2 - nw // 2)
        before = TP.LAUNCHES["scatter_grid_wstack"]
        tiles = TP.tiles_for(pt)
        torch.full((nw, 2, pt.nbig_x, pt.nbig_y), float("nan"), device=dev)  # freed: the output reuses it
        out = TP.scatter_grid_wstack(pt, tiles, vre, vim, p0, nw)
        torch.cuda.synchronize()
        assert TP.LAUNCHES["scatter_grid_wstack"] == before + 1
        ref = TP.scatter_grid_wstack_ref(pt, tiles, vre.double(), vim.double(), p0, nw)
        assert _rel(out.cpu(), ref.cpu()) < 1e-5
