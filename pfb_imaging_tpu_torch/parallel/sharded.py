"""The multiband IDG residual (port of the multiband part of
pfb_imaging_tpu/parallel/sharded.py).

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

from ..ops import idg_fused
from ..ops.gridder_idg import (IDGPlan, _idg_accumulate_bins, _idg_bins_to_grid_patches, _idg_finish,
                               _weighted_round_trip, plan_idg, to_group_layout)

__all__ = ["MultibandIDGPlan", "plan_idg_multiband_freqs", "multiband_to_group_layout", "multiband_hessian_vis_idg"]


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
