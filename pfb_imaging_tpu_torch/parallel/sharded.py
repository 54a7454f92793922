"""Row-sharded gridding over a mesh, and the multiband IDG plans (port of
pfb_imaging_tpu/parallel/sharded.py).

Gridding is linear in visibility rows, so the rows split over the ranks of
a mesh: each rank plans and grids only its own shard and the partial images
are summed by one ``all_reduce``; degridding is row-local and needs no
collective. The JAX package stacks every shard's plan into one SPMD program,
so its planners pad the shards to one static layout (a shared w grid, common
per-bin group capacities); here a rank plans only its own shard, on the same
shared grid and capacities, so its plan equals the JAX stack's leaf at its
index. Each rank runs the cheap count pass of every shard, so all ranks
agree on the capacities without a collective. The paths: the exact DFT
(``row_sharded_vis2dirty``), the classic w-stacking gridder
(``plan_wgridder_sharded`` + ``sharded_vis2dirty``) and IDG
(``plan_idg_sharded`` + ``sharded_vis2dirty_idg`` on B1 /
``sharded_dirty2vis_idg`` on B2).

Bands of one partition share its uvw rows and see different channels. The
JAX package plans them to one layout (a common w grid through
``force_w_range``, common per-bin group capacities through ``bin_gcap``)
and vmaps the residual round trip over the band axis. Here the bands' group
axes are laid end to end instead: the per-band plans keep their own
assembly, FFT and screens, run band by band, while the angles of every band
sit in one (4, nband * ng, G) tensor, so the patch kernels B1 and B2 each
take all bands of a partition in one launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops import idg_fused
from ..ops.dft import vis2dirty_dft
from ..ops.gridder import plan_wgridder, vis2dirty
from ..ops.gridder_idg import (IDGPlan, _idg_accumulate_bins, _idg_bins_to_grid_patches, _idg_finish, _idg_prepare,
                               _weighted_round_trip, dirty2vis_idg, plan_idg, to_group_layout, vis2dirty_idg)
from ..utils.profiling import span

__all__ = ["row_sharded_vis2dirty", "plan_wgridder_sharded", "sharded_vis2dirty", "plan_idg_sharded",
           "sharded_vis2dirty_idg", "sharded_dirty2vis_idg", "MultibandIDGPlan", "plan_idg_multiband",
           "plan_idg_multiband_freqs", "multiband_vis2dirty_idg", "multiband_to_group_layout",
           "multiband_hessian_vis_idg"]


def _shard_rows(uvw, nshards: int, index: int):
    uvw = np.asarray(uvw)
    nrow = uvw.shape[0]
    if nrow % nshards:
        raise ValueError(f"nrow={nrow} not divisible by nshards={nshards}: pad with zero-weight rows")
    if not 0 <= index < nshards:
        raise ValueError(f"shard {index} of {nshards}")
    rows = nrow // nshards
    return uvw, rows, slice(index * rows, (index + 1) * rows)


def row_sharded_vis2dirty(mesh, uvw, freq, vis, wgt=None, *, nx: int, ny: int, cellx: float, celly: float,
                          l0: float = 0.0, m0: float = 0.0, divide_by_n: bool = True, axes=("band", "row"),
                          device="cuda"):
    """The exact DFT adjoint of this rank's rows (``uvw``, ``vis``, ``wgt``:
    its shard of rows over the flattened ``axes``), summed over ``axes``:
    the whole dirty image on every rank."""
    img = vis2dirty_dft(uvw, freq, vis, wgt=wgt, nx=nx, ny=ny, cellx=cellx, celly=celly, l0=l0, m0=m0,
                        divide_by_n=divide_by_n, device=device)
    return mesh.all_reduce(img, axes)


def plan_wgridder_sharded(uvw, freq, nshards: int, index: int, *, device="cuda", **kw):
    """Shard ``index`` of ``nshards`` equal row chunks, planned for the
    classic gridder on the w-plane grid (w0, dw, nw) of the whole rows'
    plan, as every shard of the JAX stack is. Returns (plan, rows per shard)."""
    dev = resolve_device(device)
    uvw, rows, sl = _shard_rows(uvw, nshards, index)
    whole = plan_wgridder(uvw, freq, device="cpu", **kw)
    if whole.do_wgridding:
        kw = dict(kw, force_w_grid=(whole.w0, whole.dw, whole.nw))
    del whole
    return plan_wgridder(uvw[sl], freq, device=dev, **kw), rows


def sharded_vis2dirty(mesh, plan, vis, wgt=None, axes=("band", "row")):
    """This rank's rows gridded by the classic gridder, the image summed
    over ``axes``: ``vis``/``wgt`` (rows, nchan) are its shard."""
    return mesh.all_reduce(vis2dirty(plan, vis, wgt=wgt), axes)


def plan_idg_sharded(uvw, freq, nshards: int, index: int, *, device="cuda", **kw):
    """Shard ``index`` of ``nshards`` equal row chunks, planned for IDG on
    the layout every shard of the JAX stack shares: the w range and bin count
    of the whole rows' count pass (``force_w_range``), its w scheme pinned
    (wplanes when its w support exceeds 1, else chirp), and per-bin group
    capacities that are the maximum over the shards' count passes
    (``bin_gcap``). Returns (plan, rows per shard)."""
    dev = resolve_device(device)
    uvw, rows, sl = _shard_rows(uvw, nshards, index)
    nbins, _, (wlo, whi, ws) = plan_idg(uvw, freq, count_only=True, device=dev, **kw)
    force = (wlo, whi, nbins)
    kw = dict(kw, w_mode="wplanes" if ws > 1 else "chirp", force_w_range=force, device=dev)
    counts = [plan_idg(uvw[i * rows:(i + 1) * rows], freq, count_only=True, **kw)[1] for i in range(nshards)]
    gcap = tuple(max(1, max(int(c[b]) for c in counts)) for b in range(nbins))
    return plan_idg(uvw[sl], freq, bin_gcap=gcap, **kw), rows


def sharded_vis2dirty_idg(mesh, plan, vis_re, vis_im, wgt=None, axes=("band", "row")):
    """This rank's rows gridded by IDG (B1), the image summed over ``axes``:
    ``vis_re``/``vis_im``/``wgt`` (rows, nchan) are its shard."""
    return mesh.all_reduce(vis2dirty_idg(plan, vis_re, wgt=wgt, vis_im=vis_im), axes)


def sharded_dirty2vis_idg(mesh, plan, image, axes=("band", "row")):
    """This rank's rows degridded by IDG (B2) from the whole image: (2,
    rows, nchan) re/im. Degridding is row-local: no collective."""
    return dirty2vis_idg(plan, image, split=True)


@dataclasses.dataclass
class MultibandIDGPlan:
    """Per-band IDG plans laid out alike (the same bins, ``w_support`` and
    group counts per bin), with ``scal`` (4, nband * ng, G) their angles end
    to end; each band's ``plans[b].scal`` is a view of its part of it."""

    plans: list
    scal: torch.Tensor

    @property
    def nband(self) -> int:
        return len(self.plans)

    @property
    def ngroups(self) -> int:
        """Groups of one band."""
        return self.plans[0].ngroups

    @property
    def w_support(self) -> int:
        return self.plans[0].w_support

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes - p.scal.numel() * p.scal.element_size() for p in self.plans) + \
            self.scal.numel() * self.scal.element_size()

    def band(self, b: int) -> slice:
        return slice(b * self.ngroups, (b + 1) * self.ngroups)


def _pad_to_caps(p: IDGPlan, gcap: tuple, scal_out: torch.Tensor) -> None:
    """Pad plan ``p`` in place to the per-bin group capacities ``gcap``:
    empty groups at the end of each bin's block, as ``plan_idg(...,
    bin_gcap=gcap)`` lays them out (dead slots: ``cg_idx`` nvis, sign 1,
    zero angles and phase), on the plan's device. Its angles go into
    ``scal_out`` (4, sum(gcap), G), zeros where they land, which it then
    views."""
    dev, ng, G = p.device, sum(gcap), p.G
    start = np.concatenate([[0], np.cumsum(gcap)])[:-1]
    remap = torch.as_tensor(np.concatenate([start[b] + np.arange(c) for b, c in enumerate(p.bin_gcount)]),
                            dtype=torch.int64, device=dev)

    def pad(t, fill):
        out = t.new_full((ng,) + tuple(t.shape[1:]), fill)
        out[remap] = t
        return out

    scal_out[:, remap] = p.scal
    p.scal = scal_out
    p.cg_idx, p.sg = pad(p.cg_idx, p.nrow * p.nchan), pad(p.sg, 1.0)
    p.phase_re, p.phase_im, p.bid = pad(p.phase_re, 0.0), pad(p.phase_im, 0.0), pad(p.bid, 0)
    if p.rep_idx is not None:  # flat slot indices g * G + k
        p.rep_idx = remap[p.rep_idx // G] * G + p.rep_idx % G
    p.ngroups, p.bin_gstart, p.bin_gcount = ng, tuple(int(x) for x in start), tuple(int(x) for x in gcap)


def plan_idg_multiband_freqs(uvw, freqs, *, device="cuda", **kw):
    """Plan every band of a shared-uvw partition to one layout, as the JAX
    planner does: the w scheme of all channels together fixes the w range,
    the bin count and the mode (wplanes when its w-support exceeds 1, else
    chirp); each band is planned with them forced, and every bin's group
    block is padded to the largest band's. The JAX planner takes the w
    scheme from an all-channel count pass and the capacities from a count
    pass per band, then plans with ``bin_gcap``; here the w scheme stops
    before the bucket pass (``count_only="w"``) and the capacities come from
    the plans themselves, padded on the device: the same layout, with no
    visibility bucketed twice. Narrower bands are padded to the widest
    band's channel count with their last channel, which must carry zero
    weight. ``kw`` are :func:`plan_idg`'s. Returns (MultibandIDGPlan,
    nch_max)."""
    with span("plan.multiband"):
        uvw = np.asarray(uvw)
        freqs = [np.asarray(f) for f in freqs]
        nch_max = max(f.size for f in freqs)
        nbins, _, (wlo, whi, ws) = plan_idg(uvw, np.unique(np.concatenate(freqs)), count_only="w", device=device, **kw)
        kw = dict(kw, w_mode="wplanes" if ws > 1 else "chirp", force_w_range=(wlo, whi, nbins), device=device)

        def band_freq(fb):
            return np.concatenate([fb, np.full(nch_max - fb.size, fb[-1])]) if fb.size < nch_max else fb

        plans: list[IDGPlan] = [plan_idg(uvw, band_freq(fb), **kw) for fb in freqs]
        p0 = plans[0]
        for p in plans[1:]:
            if not (torch.equal(p.wcu, p0.wcu) and torch.equal(p.wcv, p0.wcv) and p.nbins == p0.nbins):
                raise ValueError("multiband plans differ in their taper or bin grid")
        gcap = tuple(max(1, max(p.bin_gcount[b] for p in plans)) for b in range(nbins))
        ng = sum(gcap)
        scal = p0.scal.new_zeros((4, len(plans) * ng, p0.G))
        mplan = MultibandIDGPlan(plans=plans, scal=scal)
        for b, p in enumerate(plans):
            _pad_to_caps(p, gcap, scal[:, b * ng : (b + 1) * ng])
        return mplan, nch_max


def plan_idg_multiband(uvw, freq, band_slices, **kw):
    """:func:`plan_idg_multiband_freqs` with each band's channels given as
    index slices of ``freq``. Returns (MultibandIDGPlan, nch_max)."""
    freq = np.asarray(freq)
    return plan_idg_multiband_freqs(uvw, [freq[np.asarray(sl)] for sl in band_slices], **kw)


def multiband_vis2dirty_idg(mplan: MultibandIDGPlan, vis_re, vis_im, wgt):
    """Every band of one partition gridded with one B1 launch: vis_re,
    vis_im, wgt (nband, nrow, nch_max), zero weight on the channels past a
    band's width. Returns (nband, nx, ny)."""
    vals = torch.cat([_idg_prepare(p, vis_re[b], vis_im[b], wgt[b]) for b, p in enumerate(mplan.plans)], dim=1)
    p0 = mplan.plans[0]
    patches = idg_fused.patches_from_vals(mplan.scal, vals, p0.wcu, p0.wcv, p0.S)
    return torch.stack([_idg_finish(p, _idg_accumulate_bins(p, patches[:, mplan.band(b)]))
                        for b, p in enumerate(mplan.plans)])


def multiband_to_group_layout(mplan: MultibandIDGPlan, arr):
    """(nband, nrow, nch_max) -> (nband, ng, G): each band's group layout."""
    return torch.stack([to_group_layout(p, arr[b]) for b, p in enumerate(mplan.plans)])


def multiband_hessian_vis_idg(mplan: MultibandIDGPlan, x, wgt_g):
    """R_b^H W_b R_b x_b for every band b of one partition: the forward
    patches of all bands, one B2 launch, each band's weighting (group layout
    for chirp plans, (nband, nrow, nch_max) original layout for wplanes
    plans), one B1 launch, then each band's assembly, FFT and screens.
    ``x`` is (nband, nx, ny) or a sequence of nband (nx, ny) images.
    Returns (nband, nx, ny)."""
    p0 = mplan.plans[0]
    patches = torch.empty((2, mplan.nband * mplan.ngroups, p0.S, p0.S), dtype=p0.rdt, device=p0.device)
    for b, p in enumerate(mplan.plans):
        _idg_bins_to_grid_patches(p, x[b], out=patches[:, mplan.band(b)])
    vals = idg_fused.vals_from_patches(patches, mplan.scal, p0.wcu, p0.wcv, p0.S)
    del patches
    for b, p in enumerate(mplan.plans):
        sl = mplan.band(b)
        vals[:, sl] = _weighted_round_trip(p, vals[:, sl], None if wgt_g is None else wgt_g[b])
    patches = idg_fused.patches_from_vals(mplan.scal, vals, p0.wcu, p0.wcv, p0.S)
    del vals
    return torch.stack([_idg_finish(p, _idg_accumulate_bins(p, patches[:, mplan.band(b)]))
                        for b, p in enumerate(mplan.plans)])
