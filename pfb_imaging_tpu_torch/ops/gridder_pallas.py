"""The w-stacked scatter and gather cores of ``gridder="pallas"`` (port of
pfb_imaging_tpu/ops/gridder_pallas.py; the name is kept so the counterpart
is easy to find).

``scatter_grid_wstack`` grids the classic plan's sorted stream into a chunk
of w-planes: plane p of the output is

    sum_vis es(2(u - iu)/W) es(2(v - iv)/W) ww_p(w) value,

with ww_p = es(2(w - w0 - p dw)/(w_support dw)) when the plan w-grids, and
1 when it does not (the ``_w_weight`` rule: the JAX kernel applies the ES
w-weight even to plans without w-gridding, which makes
``imager(gridder="pallas", do_wgridding=False)`` wrong there; the port does
not copy that). On a CUDA tensor it launches the hand-written kernel of
``csrc/gridder_scatter.cu``, which replaces the Pallas kernels
``pallas_scatter_grid_wstack`` (B3) and, as its one-plane case,
``pallas_scatter_grid`` (B5) and ``pallas_scatter_grid_grouped`` (B6); on a
CPU tensor it runs the plain version ``scatter_grid_wstack_ref`` (plane
buckets and ``index_add_``).

``gather_grid_wstack`` is its transpose, the degrid core: per visibility,
sum_p ww_p(w) sum_ij es es grid_p[iu + i, iv + j] over a chunk of planes.
On a CUDA tensor it launches ``csrc/gridder_gather.cu``, which replaces
``pallas_gather_grid`` (B4); on a CPU tensor it runs
``gather_grid_wstack_ref`` (the classic ``dirty2vis`` loop over each
plane's bucket). ``LAUNCHES`` counts kernel launches.

The tile plan is the port's own, sized for Hopper's shared memory: a block
owns a ``TILE`` x ``TILE`` uv tile plus a W-1 cell apron for at most
``BLOCK_VIS`` of the tile's visibilities, and the planes of a chunk of at
most ``PLANE_CHUNK`` that they can touch (``ChunkPlan``). The scatter
accumulates each block's partial grids into a scratch buffer and composes
every output tile once from the partials that cover it (the compose
lists); the gather stages only a block's planes. Windows that wrap the
grid edge are handled in the kernels (cell indices taken mod nbig), so no
visibility goes around them.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from .gridder import (WGridderPlan, _as_ri, _chunks, _dirty2vis_finish_ri, _dirty2vis_prepare, _plane_grid,
                      _plane_image, _scatter_plane, _uv_stencil, _vis2dirty_finish, _vis2dirty_prepare, _w_weight)
from .. import complex_dtype

TILE = 32  # uv cells per tile side
BLOCK_VIS = 2048  # visibilities per block at most (a busy tile gets several blocks)
PLANE_CHUNK = 8  # w-planes per kernel pass
MAX_SUPPORT = 16
LAUNCHES = {"scatter_grid_wstack": 0, "gather_grid_wstack": 0}


@dataclasses.dataclass(frozen=True, eq=False)
class ScatterTiles:
    """The kernels' view of a plan: visibilities in tile order, the block
    list with each block's planes, and the scatter's compose lists.
    ``perm`` maps tile order to the plan's sorted stream."""

    ntx: int
    nty: int
    nblocks: int
    perm: torch.Tensor  # (nvis,) int64
    lu: torch.Tensor  # (nvis,) int32 window start in the tile, [0, TILE)
    lv: torch.Tensor
    du: torch.Tensor  # (nvis,) f32 u - iu0 (window-relative)
    dv: torch.Tensor
    w_rel: torch.Tensor  # (nvis,) f32 (w - w0) / dw
    blk_tile: torch.Tensor  # (nblocks,) int32 tile id tx * nty + ty
    blk_start: torch.Tensor  # (nblocks,) int64 first visibility (tile order)
    blk_count: torch.Tensor  # (nblocks,) int32
    blk_planes: np.ndarray  # (nblocks, 2) int64, host: planes [lo, hi) its visibilities can touch
    cmp_ptr: torch.Tensor  # (ntx * nty + 1,) int32: tile t's entries cmp_ptr[t] .. cmp_ptr[t + 1]
    cmp_blk: torch.Tensor  # (nentries,) int32 block whose partial covers part of the tile's core
    cmp_oxy: torch.Tensor  # (nentries,) int32 65536 ox + oy: the core's first cell in that partial
    chunks: dict = dataclasses.field(default_factory=dict, repr=False)  # (p0, nw) -> ChunkPlan


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Each block's planes within the chunk p0 .. p0+nw-1, and where the
    scatter puts its partial grids (nq, 2, TILE + W - 1, TILE + W) f32.

    The scratch holds at most nw such planes per launched block, and there
    are at most (occupied tiles + nvis / BLOCK_VIS) blocks: where every tile
    holds one block, (TILE + W - 1)(TILE + W) / TILE^2 times the chunk's
    grid (1.37 at W = 6, 1.52 at W = 8), plus nw 8 (TILE + W - 1)(TILE + W)
    / BLOCK_VIS bytes per visibility beyond that (49 B at W = 8, nw = 8)."""

    act: torch.Tensor  # (nact,) int32 the blocks with nq > 0, which are launched
    qa: torch.Tensor  # (nblocks,) int32 first plane, relative to p0
    nq: torch.Tensor  # (nblocks,) int32 planes (0: the block misses the chunk)
    off: torch.Tensor  # (nblocks,) int64 float offset of the partial in the scratch buffer
    nq_max: int
    scratch: int  # floats of the scratch buffer


def plan_pallas(plan: WGridderPlan) -> ScatterTiles:
    """The tile layout of a plan's sorted stream, on the plan's device:
    visibilities bucketed stably by the ``TILE`` x ``TILE`` tile holding
    their (wrapped) window start, window starts relative to that tile, the
    blocks (each tile's run, w-sorted, cut into pieces of at most
    ``BLOCK_VIS``) with their plane spans, and the compose lists."""
    ntx, nty = -(-plan.nbig_x // TILE), -(-plan.nbig_y // TILE)
    iu0w = torch.remainder(plan.iu0, plan.nbig_x)
    iv0w = torch.remainder(plan.iv0, plan.nbig_y)
    tx, ty = iu0w // TILE, iv0w // TILE
    key_s, perm = torch.sort(tx * nty + ty, stable=True)
    counts = torch.bincount(key_s, minlength=ntx * nty).cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    nb = -(-counts // BLOCK_VIS)
    tid = np.repeat(np.arange(counts.size), nb)
    piece = np.arange(int(nb.sum())) - np.repeat(np.cumsum(nb) - nb, nb)
    blk_start = starts[tid] + piece * BLOCK_VIS
    w_rel = plan.w_rel[perm].float()
    cmp_ptr, cmp_blk, cmp_oxy = _compose_lists(plan, ntx, nty, tid)
    dev = plan.device
    as_t = lambda a, t: torch.as_tensor(a, dtype=t, device=dev)  # noqa: E731
    return ScatterTiles(
        ntx=ntx, nty=nty, nblocks=tid.size, perm=perm,
        lu=(iu0w - tx * TILE)[perm].to(torch.int32), lv=(iv0w - ty * TILE)[perm].to(torch.int32),
        du=plan.du[perm].float(), dv=plan.dv[perm].float(), w_rel=w_rel,
        blk_tile=as_t(tid, torch.int32), blk_start=as_t(blk_start, torch.int64),
        blk_count=as_t(np.minimum(counts[tid] - piece * BLOCK_VIS, BLOCK_VIS), torch.int32),
        blk_planes=_block_planes(plan, w_rel, blk_start), cmp_ptr=as_t(cmp_ptr, torch.int32),
        cmp_blk=as_t(cmp_blk, torch.int32), cmp_oxy=as_t(cmp_oxy, torch.int32),
    )


def _block_planes(plan: WGridderPlan, w_rel, blk_start: np.ndarray) -> np.ndarray:
    """(nblocks, 2): the planes [lo, hi) that some visibility of each block
    can touch, by the kernels' own f32 rule: planes pa .. pa + w_support + 1
    with pa = floor(w_rel - w_support / 2) (one more on each side than the
    support, for the rounding); [0, 1) without w-gridding."""
    if not plan.do_wgridding:
        return np.tile(np.array([0, 1], np.int64), (blk_start.size, 1))
    if blk_start.size == 0:
        return np.zeros((0, 2), np.int64)
    pa = torch.floor(w_rel - 0.5 * plan.w_support).to(torch.int64).cpu().numpy()
    return np.stack([np.minimum.reduceat(pa, blk_start), np.maximum.reduceat(pa, blk_start) + plan.w_support + 2], 1)


def _reach(ntile: int, nbig: int, span: int) -> np.ndarray:
    """Along one axis, rows (t, t2, o): tile t2's ``span`` cells from its
    origin, taken mod nbig, cover tile t's core from position o (< span)
    on. Besides t itself (o = 0), that is the tile before it, the one
    before that where the last tile is short, and repeats where nbig <
    span."""
    t = np.arange(ntile)
    o = (TILE * (t[:, None] - t[None, :])) % nbig
    rows = []
    while (o < span).any():
        i, j = np.nonzero(o < span)
        rows.append(np.stack([i, j, o[i, j]], 1))
        o = o + nbig
    return np.concatenate(rows)


def _compose_lists(plan: WGridderPlan, ntx: int, nty: int, blk_tile: np.ndarray):
    """CSR over output tiles: the blocks whose tile plus apron covers part of
    each tile's core, with where the core starts in their partial (65536 ox
    + oy), ordered by block, then offset (the compose's fixed order)."""
    span = TILE + plan.support - 1
    rx, ry = _reach(ntx, plan.nbig_x, span), _reach(nty, plan.nbig_y, span)
    dst = (rx[:, None, 0] * nty + ry[None, :, 0]).ravel()
    src = (rx[:, None, 1] * nty + ry[None, :, 1]).ravel()
    oxy = (rx[:, None, 2] * 65536 + ry[None, :, 2]).ravel()
    nbt = np.bincount(blk_tile, minlength=ntx * nty)
    k = nbt[src]
    dst, src, oxy, k = dst[k > 0], src[k > 0], oxy[k > 0], k[k > 0]
    first = np.cumsum(nbt) - nbt
    blk = np.repeat(first[src], k) + np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    dst, oxy = np.repeat(dst, k), np.repeat(oxy, k)
    order = np.lexsort((oxy, blk, dst))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=ntx * nty))])
    return ptr, blk[order], oxy[order]


def chunk_plan(plan: WGridderPlan, tiles: ScatterTiles, p0: int, nw: int) -> ChunkPlan:
    """Each block's planes within p0 .. p0+nw-1 and its scratch offset, on
    the plan's device; cached on ``tiles`` per (p0, nw)."""
    ch = tiles.chunks.get((p0, nw))
    if ch is None:
        qa = np.clip(tiles.blk_planes[:, 0] - p0, 0, nw)
        nq = np.clip(tiles.blk_planes[:, 1] - p0, 0, nw) - qa  # lo < hi, so nq >= 0
        act = np.flatnonzero(nq)
        part = 2 * (TILE + plan.support - 1) * (TILE + plan.support)
        off = np.zeros(tiles.nblocks, np.int64)
        off[act] = (np.cumsum(nq[act]) - nq[act]) * part
        dev = tiles.perm.device
        as_t = lambda a, t: torch.as_tensor(a, dtype=t, device=dev)  # noqa: E731
        ch = tiles.chunks[(p0, nw)] = ChunkPlan(
            act=as_t(act, torch.int32), qa=as_t(qa, torch.int32), nq=as_t(nq, torch.int32),
            off=as_t(off, torch.int64), nq_max=int(nq.max()) if nq.size else 0, scratch=int(nq.sum()) * part)
    return ch


_TILES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def tiles_for(plan: WGridderPlan) -> ScatterTiles:
    """Per-plan tile layout, cached by plan identity (plans are immutable);
    an entry leaves the cache with its plan."""
    tiles = _TILES.get(plan)
    if tiles is None:
        tiles = _TILES[plan] = plan_pallas(plan)
    return tiles


def scatter_grid_wstack_ref(plan: WGridderPlan, tiles: ScatterTiles, vre, vim, p0: int, nw: int):
    """Plain version: planes p0 .. p0+nw-1 of the (nw, 2, nbig_x, nbig_y)
    grids from values in tile order (``v[tiles.perm]`` of the plan's sorted
    stream), per plane bucket with ``index_add_``, in ``vre``'s dtype (f32
    or f64)."""
    vals = torch.stack([vre, vim])
    vals = torch.empty_like(vals).index_copy_(1, tiles.perm, vals)  # back to the sorted stream
    out = vals.new_zeros((nw, 2, plan.nbig_x, plan.nbig_y))
    for q in range(nw):
        if plan.plane_count[p0 + q]:
            _scatter_plane(plan, vals, p0 + q, out=out[q])
    return out


def _check_launch(plan: WGridderPlan, tiles: ScatterTiles, vre, vim, p0: int, nw: int) -> None:
    _check_chunk(plan, p0, nw)
    for name, t in (("vre", vre), ("vim", vim)):
        _check_tensor(name, t, (plan.nvis,), tiles)


def _check_chunk(plan: WGridderPlan, p0: int, nw: int) -> None:
    if not (1 <= nw <= PLANE_CHUNK and 0 <= p0 and p0 + nw <= plan.nw):
        raise ValueError(f"plane chunk [{p0}, {p0 + nw}) outside 1..{PLANE_CHUNK} planes of 0..{plan.nw}")
    if plan.support > MAX_SUPPORT:
        raise ValueError(f"kernel support {plan.support} > {MAX_SUPPORT}")
    if not plan.do_wgridding and nw != 1:
        raise ValueError("a plan without w-gridding has one plane")


def _check_tensor(name: str, t, shape: tuple, tiles: ScatterTiles) -> None:
    if t.device != tiles.perm.device:
        raise ValueError(f"{name} is on {t.device}, the tiles on {tiles.perm.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape} or not contiguous")


def scatter_grid_wstack(plan: WGridderPlan, tiles: ScatterTiles, vre, vim, p0: int, nw: int):
    """Planes p0 .. p0+nw-1 (nw <= ``PLANE_CHUNK``) of the w-stacked grids,
    (nw, 2, nbig_x, nbig_y), from values ``vre``/``vim`` (nvis,) in tile
    order: the plain version for CPU tensors, else the CUDA kernel (f32)."""
    if vre.device.type == "cpu":
        return scatter_grid_wstack_ref(plan, tiles, vre, vim, p0, nw)
    _check_launch(plan, tiles, vre, vim, p0, nw)
    ch = chunk_plan(plan, tiles, p0, nw)
    out = torch.empty((nw, 2, plan.nbig_x, plan.nbig_y), dtype=torch.float32, device=vre.device)  # written whole
    scratch = torch.empty(max(ch.scratch, 1), dtype=torch.float32, device=vre.device)
    from ..kernels.build import check, load

    code = load().pfb_scatter_grid_wstack(
        ch.act.data_ptr(), ch.act.numel(), tiles.blk_start.data_ptr(), tiles.blk_count.data_ptr(), ch.qa.data_ptr(),
        ch.nq.data_ptr(), ch.off.data_ptr(), ch.nq_max, tiles.cmp_ptr.data_ptr(), tiles.cmp_blk.data_ptr(),
        tiles.cmp_oxy.data_ptr(), tiles.lu.data_ptr(), tiles.lv.data_ptr(), tiles.du.data_ptr(), tiles.dv.data_ptr(),
        tiles.w_rel.data_ptr(), vre.data_ptr(), vim.data_ptr(), scratch.data_ptr(), out.data_ptr(), plan.support,
        float(plan.beta), plan.nbig_x, plan.nbig_y, tiles.ntx, tiles.nty, plan.w_support, int(plan.do_wgridding), p0,
        nw, torch.cuda.current_stream(vre.device).cuda_stream,
    )
    check(code, "scatter_grid_wstack")
    LAUNCHES["scatter_grid_wstack"] += 1
    return out


def vis2dirty_pallas_wstack(plan: WGridderPlan, tiles: ScatterTiles, vis_re, vis_im, wgt=None, mask=None):
    """vis2dirty through the w-stacked scatter, ``PLANE_CHUNK`` planes per
    pass, each non-empty plane finished by the classic FFT + w-screen
    epilogue."""
    vals = _vis2dirty_prepare(plan, vis_re, vis_im, wgt, mask).index_select(1, tiles.perm)
    acc = torch.zeros((plan.nx, plan.ny), dtype=complex_dtype(plan.rdt), device=plan.device)
    for p0 in range(0, plan.nw, PLANE_CHUNK):
        nwc = min(PLANE_CHUNK, plan.nw - p0)
        grids = scatter_grid_wstack(plan, tiles, vals[0], vals[1], p0, nwc)
        for q in range(nwc):
            if plan.plane_count[p0 + q]:
                acc += _plane_image(plan, grids[q], p0 + q)
        del grids
    return _vis2dirty_finish(plan, acc)


def gather_grid_wstack_ref(plan: WGridderPlan, tiles: ScatterTiles, grids, p0: int, nw: int):
    """Plain version: per visibility, in tile order, (2, nvis) in ``grids``'
    dtype, sum over planes p0 .. p0+nw-1 of ``ww_p(w)`` times the stencil-
    weighted window sum of plane p's grid ``grids[p - p0]`` (the classic
    ``dirty2vis`` inner loop over each plane's bucket)."""
    dt = grids.dtype
    out = grids.new_zeros((2, plan.nvis))  # the sorted stream
    for q in range(nw):
        p = p0 + q
        for sl in _chunks(plan, p):
            iu, iv, ku, kv = _uv_stencil(plan, sl, dt)
            g = grids[q][:, iu[:, :, None], iv[:, None, :]]
            kw2 = (ku[:, :, None] * kv[:, None, :]) * _w_weight(plan, plan.w_rel[sl].to(dt), p)[:, None, None]
            out[:, sl] += (g * kw2[None]).sum(dim=(2, 3))
    return out.index_select(1, tiles.perm)


def gather_grid_wstack(plan: WGridderPlan, tiles: ScatterTiles, grids, p0: int, nw: int, out=None):
    """Degrid planes p0 .. p0+nw-1 (nw <= ``PLANE_CHUNK``) of the w-stacked
    ``grids`` (nw, 2, nbig_x, nbig_y) and add the result, (2, nvis) in tile
    order, into ``out`` (zeros when None), which is returned: the plain
    version for CPU tensors, else the CUDA kernel (f32)."""
    if out is None:
        out = grids.new_zeros((2, plan.nvis))
    if grids.device.type == "cpu":
        return out.add_(gather_grid_wstack_ref(plan, tiles, grids, p0, nw))
    _check_chunk(plan, p0, nw)
    _check_tensor("grids", grids, (nw, 2, plan.nbig_x, plan.nbig_y), tiles)
    _check_tensor("out", out, (2, plan.nvis), tiles)
    ch = chunk_plan(plan, tiles, p0, nw)
    if ch.act.numel():
        from ..kernels.build import check, load

        code = load().pfb_gather_grid_wstack(
            ch.act.data_ptr(), ch.act.numel(), tiles.blk_tile.data_ptr(), tiles.blk_start.data_ptr(),
            tiles.blk_count.data_ptr(), ch.qa.data_ptr(), ch.nq.data_ptr(), ch.nq_max, tiles.lu.data_ptr(),
            tiles.lv.data_ptr(), tiles.du.data_ptr(), tiles.dv.data_ptr(), tiles.w_rel.data_ptr(), grids.data_ptr(),
            out.data_ptr(), plan.nvis, plan.support, float(plan.beta), plan.nbig_x, plan.nbig_y, tiles.nty,
            plan.w_support, int(plan.do_wgridding), p0, torch.cuda.current_stream(grids.device).cuda_stream,
        )
        check(code, "gather_grid_wstack")
        LAUNCHES["gather_grid_wstack"] += 1
    return out


def dirty2vis_pallas_wstack(plan: WGridderPlan, tiles: ScatterTiles, image, mask=None):
    """dirty2vis through the w-stacked gather, ``PLANE_CHUNK`` planes per
    pass: the chunk's non-empty planes' grids (the classic screen, pad,
    ifftshift, fft2), one gather into a tile-order accumulator, then one
    un-permute and the classic phase-shift epilogue. Returns (2, nrow,
    nchan)."""
    ieff = _dirty2vis_prepare(plan, image)
    acc = torch.zeros((2, plan.nvis), dtype=plan.rdt, device=plan.device)
    for p0 in range(0, plan.nw, PLANE_CHUNK):
        nwc = min(PLANE_CHUNK, plan.nw - p0)
        if not any(plan.plane_count[p0 : p0 + nwc]):
            continue
        grids = torch.empty((nwc, 2, plan.nbig_x, plan.nbig_y), dtype=plan.rdt, device=plan.device)
        for q in range(nwc):
            if plan.plane_count[p0 + q]:
                grids[q] = torch.view_as_real(_plane_grid(plan, ieff, p0 + q)).permute(2, 0, 1)
            else:
                grids[q].zero_()
        gather_grid_wstack(plan, tiles, grids, p0, nwc, out=acc)
        del grids
    vis = torch.empty_like(acc).index_copy_(1, tiles.perm, acc)  # back to the sorted stream
    return _dirty2vis_finish_ri(plan, vis, mask)


def _require_f32(plan: WGridderPlan) -> None:
    if plan.rdt != torch.float32:
        raise ValueError(
            "the Pallas scatter backend is f32-only (Mosaic VMEM tiles); "
            "plan with dtype=np.float32 / double_precision=False"
        )


def vis2dirty_scatter(plan: WGridderPlan, vis, wgt=None, mask=None, vis_im=None):
    """Classic-stack-signature adjoint through the w-stacked scatter core."""
    _require_f32(plan)
    return vis2dirty_pallas_wstack(plan, tiles_for(plan), *_as_ri(vis, vis_im), wgt, mask)


def dirty2vis_scatter(plan: WGridderPlan, image, mask=None, split: bool = False):
    """Classic-stack-signature forward through the w-stacked gather core:
    complex (nrow, nchan) visibilities, or (2, nrow, nchan) with ``split``."""
    _require_f32(plan)
    out = dirty2vis_pallas_wstack(plan, tiles_for(plan), image, mask)
    return out if split else torch.complex(out[0], out[1])
