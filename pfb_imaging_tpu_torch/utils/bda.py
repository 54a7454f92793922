"""Baseline-dependent time averaging (BDA) at ingest (the port's copy of
pfb_imaging_tpu/utils/bda.py, host numpy).

The reference delegates to africanus ``bda``/``time_and_channel``
(utils/stokes2vis_msv4.py:324-365) to shrink the row axis before gridding:
short baselines rotate slowly through the uv plane, so their integrations
can be averaged over much longer windows than the longest baseline's
without decorrelating the edge of the field. Re-derived here from the
standard smearing bound rather than ported:

    phase at the field edge rotates at ~ omega_E * |b|/lambda * sin(fov)
    turns/s; averaging a span dphi of phase multiplies the visibility by
    sinc(dphi/2), so requiring sinc >= R gives dphi <= sqrt(24 (1 - R))
    and a per-baseline window  dt_b = dphi / (2 pi rate).

Host-side, vectorised, runs once per partition at ingest (not in the hot
loop — matching the reference's placement).
"""

from __future__ import annotations

import numpy as np

from ..constants import LIGHTSPEED

OMEGA_EARTH = 7.2921e-5  # rad/s


def bda_window_lengths(uvw, freq_max: float, fov_radius: float, decorrelation: float, dt_int: float, max_window: int = 64):
    """Allowed averaging-window length (in integrations) per row."""
    bl = np.sqrt(uvw[:, 0] ** 2 + uvw[:, 1] ** 2) + 1e-9
    rate = OMEGA_EARTH * bl * (freq_max / LIGHTSPEED) * max(np.sin(fov_radius), 1e-9)  # turns/s
    dphi = np.sqrt(24.0 * max(1.0 - decorrelation, 1e-9))  # radians of span
    dt_b = dphi / (2.0 * np.pi * np.maximum(rate, 1e-12))
    return np.clip((dt_b / max(dt_int, 1e-9)).astype(np.int64), 1, max_window)


def bda_average(
    vis,
    wgt,
    mask,
    uvw,
    times,
    ant1,
    ant2,
    *,
    freq_max: float,
    fov_radius: float,
    decorrelation: float = 0.98,
    max_window: int = 64,
):
    """Average consecutive integrations per baseline within its window.

    vis/wgt/mask: (nrow, nchan); uvw: (nrow, 3); times/ant1/ant2: (nrow,).
    Returns (vis, wgt, mask, uvw, times) with nrow_out <= nrow. Weighted
    (wgt*mask) averages for VIS/UVW/TIME; WEIGHT sums (so wsum and the
    natural-weighted dirty image are preserved up to decorrelation).
    """
    vis = np.asarray(vis)
    wgt = np.asarray(wgt)
    mask = np.asarray(mask)
    uvw = np.asarray(uvw)
    times = np.asarray(times)
    nrow = vis.shape[0]
    ut = np.unique(times)
    dt_int = float(np.median(np.diff(ut))) if ut.size > 1 else 1.0

    key = np.asarray(ant1).astype(np.int64) * 100000 + np.asarray(ant2)
    order = np.lexsort((times, key))
    key_s = key[order]
    nwin = bda_window_lengths(uvw[order], freq_max, fov_radius, decorrelation, dt_int, max_window)

    # position within each baseline's run, then window id within the run
    boundaries = np.concatenate([[0], np.flatnonzero(np.diff(key_s)) + 1, [nrow]])
    pos = np.arange(nrow) - np.repeat(boundaries[:-1], np.diff(boundaries))
    # one window length per run (first row's — rows of a baseline share |b|)
    run_win = nwin[boundaries[:-1]]
    win_of = pos // np.repeat(run_win, np.diff(boundaries))
    run_id = np.repeat(np.arange(boundaries.size - 1), np.diff(boundaries))
    seg = run_id * (nrow + 1) + win_of
    _, seg_ids = np.unique(seg, return_inverse=True)
    nseg = int(seg_ids.max()) + 1

    wm = (wgt * mask)[order]
    w_out = np.zeros((nseg, vis.shape[1]))
    np.add.at(w_out, seg_ids, wm)
    v_out = np.zeros((nseg, vis.shape[1]), dtype=vis.dtype)
    np.add.at(v_out, seg_ids, wm * vis[order])
    with np.errstate(invalid="ignore", divide="ignore"):
        v_out = np.where(w_out > 0, v_out / np.where(w_out > 0, w_out, 1.0), 0.0)
    m_out = (w_out > 0).astype(np.uint8)

    # row-scalar averages use the channel-summed weights
    wrow = wm.sum(axis=1)
    wrow_out = np.bincount(seg_ids, weights=wrow, minlength=nseg)
    safe = np.where(wrow_out > 0, wrow_out, 1.0)
    uvw_out = np.stack(
        [np.bincount(seg_ids, weights=wrow * uvw[order][:, i], minlength=nseg) / safe for i in range(3)], axis=1
    )
    # unweighted fallback for fully-flagged segments (keep geometry sane)
    cnt = np.bincount(seg_ids, minlength=nseg).astype(float)
    uvw_plain = np.stack(
        [np.bincount(seg_ids, weights=uvw[order][:, i], minlength=nseg) / cnt for i in range(3)], axis=1
    )
    uvw_out = np.where(wrow_out[:, None] > 0, uvw_out, uvw_plain)
    t_out = np.bincount(seg_ids, weights=wrow * times[order], minlength=nseg) / safe
    t_plain = np.bincount(seg_ids, weights=times[order], minlength=nseg) / cnt
    t_out = np.where(wrow_out > 0, t_out, t_plain)
    return v_out, w_out, m_out, uvw_out, t_out
