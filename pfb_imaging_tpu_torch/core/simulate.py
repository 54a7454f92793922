"""Synthetic measurement simulator (port of pfb_imaging_tpu/core/simulate.py).

Writes the raw visibility container the JAX package defines (a TreeStore,
the measurement-set analogue), the same groups, arrays, dtypes and
attributes, so each package reads the other's stores:

    <name>.ms.tree/
      .attrs.json: ra, dec, freq, feed_type, ncorr, cell_rad, nx, ny, beam_diameter
      scan0000/ ... one group per partition with
        UVW (nrow, 3), TIME (nrow,), ANTENNA1/ANTENNA2 (nrow,),
        VIS (ncorr, nrow, nchan) complex128, WEIGHT (ncorr, nrow, nchan),
        FLAG (nrow, nchan) uint8, [JONES_P/JONES_Q when corrupted]

The sky's visibilities are predicted channel by channel by the exact DFT on
``device`` in f64 (over the model's nonzero pixels); the array, the noise
and the gains are drawn on the host from ``np.random.default_rng(seed)`` in
the JAX function's order (gain table, then per partition noise and
corrupting gains), so a seed gives the JAX store's values.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import resolve_device, to_host
from ..constants import LIGHTSPEED
from ..ops.dft import dirty2vis_dft
from ..utils.bda import OMEGA_EARTH
from ..utils.beam import gauss_beam
from ..utils.gains import gains_to_jones, save_gain_table
from ..utils.stokes import stokes_to_corr
from ..utils.store import TreeStore


def antenna_layout(nant: int, scale: float = 3e3, seed: int = 42) -> np.ndarray:
    rng = np.random.RandomState(seed)
    antennas = scale * rng.normal(size=(nant, 3))
    antennas[:, 2] *= 0.05
    return antennas


def snapshot_uvw(antennas: np.ndarray, hour_angle: float = 0.0, dec: float = -0.5) -> np.ndarray:
    """Project ENU-like antenna positions to uvw for one hour angle."""
    a1, a2 = np.asarray(list(itertools.combinations(range(len(antennas)), 2))).T
    bl = antennas[a1] - antennas[a2]
    ch, sh = np.cos(hour_angle), np.sin(hour_angle)
    cd, sd = np.cos(dec), np.sin(dec)
    rot = np.array(
        [
            [sh, ch, 0.0],
            [-sd * ch, sd * sh, cd],
            [cd * ch, -cd * sh, sd],
        ]
    )
    return bl @ rot.T


def simulate_vis_store(
    path,
    nant: int = 16,
    ntime: int = 3,
    nchan: int = 8,
    nx: int = 128,
    sources=((0.5, 0.5, 1.0, -0.7), (0.33, 0.66, 0.5, -0.4)),
    cell_factor: float = 2.0,
    freq0: float = 0.9e9,
    freq1: float = 1.1e9,
    noise: float = 0.0,
    ncorr: int = 2,
    feed_type: str = "linear",
    corrupt_gains: bool = False,
    gain_table_out: str | None = None,
    pol_fractions=(0.0, 0.0, 0.0),
    beam_diameter: float | None = None,
    times_per_scan: int = 1,
    tint: float | None = None,
    seed: int = 42,
    *,
    device="cuda",
):
    """Create a raw visibility container with known point sources.

    Sources are (xfrac, yfrac, flux, spectral_index) image-fraction tuples;
    ``pol_fractions`` = (Q/I, U/I, V/I) polarises every source;
    ``beam_diameter`` attenuates the sky by the Gaussian dish beam;
    ``times_per_scan`` stacks that many snapshots into one partition;
    ``gain_table_out`` corrupts the visibilities through smooth
    per-antenna gains on a coarse (time, freq) grid saved there as a gain
    table (``init(gain_table=...)`` undoes it); ``corrupt_gains`` writes
    per-row JONES_P/JONES_Q instead. Returns (store, truth) with truth =
    dict(model cube, cell_rad, freqs, nx).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    antennas = antenna_layout(nant, seed=seed)
    freqs = np.linspace(freq0, freq1, nchan)
    ref_freq = freqs[0]

    # hour angles at the sidereal rate, so TIME is consistent with the uvw
    # rotation (ingest-time BDA derives its windows from the same rate)
    if tint is None:
        tint = 0.4 / ((ntime - 1) * OMEGA_EARTH) if ntime > 1 else 60.0
    t_rel = (np.arange(ntime) - (ntime - 1) / 2.0) * tint
    uvw_t = [snapshot_uvw(antennas, ha) for ha in OMEGA_EARTH * t_rel]
    max_blength = max(np.abs(u).max() for u in uvw_t)
    cell_n = 1.0 / (2 * max_blength * freqs.max() / LIGHTSPEED)
    cell_rad = cell_n / cell_factor

    model = np.zeros((nchan, nx, nx))
    for xf, yf, flux, alpha in sources:
        p, q = int(xf * nx), int(yf * nx)
        model[:, p, q] += flux * (freqs / ref_freq) ** alpha

    # apparent sky = intrinsic model attenuated by the primary beam
    model_app = model
    if beam_diameter is not None:
        lg = (np.arange(nx) - nx // 2) * cell_rad
        ll, mm = np.meshgrid(lg, lg, indexing="ij")
        bcube = gauss_beam(ll, mm, freqs, diameter=beam_diameter)
        bcube = bcube[None] if bcube.ndim == 2 else bcube
        model_app = model * bcube

    store = TreeStore(path, mode="w")
    store.set_attrs(ra=0.0, dec=-0.5, freq=freqs.tolist(), feed_type=feed_type, ncorr=ncorr, cell_rad=cell_rad,
                    nx=nx, ny=nx, beam_diameter=beam_diameter)

    ant1, ant2 = np.asarray(list(itertools.combinations(range(nant), 2))).T

    # consecutive snapshots stacked into one partition (rows stacked)
    scans = [(s, np.concatenate(uvw_t[s: s + times_per_scan], axis=0)) for s in range(0, len(uvw_t), times_per_scan)]

    gains_tab = gt_time = gt_freq = None
    if gain_table_out is not None:
        # smooth per-antenna gains on a coarse solution grid (the table is
        # the truth; ingest maps it back with the same nearest bins)
        ntg = max(2, ntime // 2 + 1)
        nfg = max(2, nchan // 2)
        gt_time = np.linspace(0.0, ntime * tint, ntg)
        gt_freq = np.linspace(freq0, freq1, nfg)
        gains_tab = 1.0 + 0.15 * (rng.standard_normal((ntg, nfg, nant, ncorr))
                                  + 1j * rng.standard_normal((ntg, nfg, nant, ncorr)))

    for t, uvw in scans:
        nrow = uvw.shape[0]
        ntin = nrow // ant1.size
        times_row = np.repeat((t + np.arange(ntin)) * tint, ant1.size)
        uvw_d = torch.as_tensor(uvw, dtype=torch.float64, device=dev)
        stokes_vis = np.zeros((4, nrow, nchan), dtype=np.complex128)
        for c in range(nchan):
            vis_i = to_host(dirty2vis_dft(uvw_d, freqs[c: c + 1], model_app[c], nx=nx, ny=nx, cellx=cell_rad,
                                          celly=cell_rad, divide_by_n=False, device=dev))
            stokes_vis[0, :, c: c + 1] = vis_i
            for s, frac in enumerate(pol_fractions, start=1):
                if frac:
                    stokes_vis[s, :, c: c + 1] = frac * vis_i
        del uvw_d
        vis = stokes_to_corr(stokes_vis, feed_type=feed_type, ncorr=ncorr)
        del stokes_vis
        if gains_tab is not None:
            jp, jq = gains_to_jones(gains_tab, gt_time, gt_freq, times_row, np.tile(ant1, ntin), np.tile(ant2, ntin),
                                    freqs)
            vis = jp * np.conj(jq) * vis
        wgt = np.ones((ncorr, nrow, nchan))
        if noise > 0:
            vis = vis + noise * (rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape))
            wgt = wgt / noise**2

        g = store.group(f"scan{t:04d}")
        g.set_attrs(time=float(np.mean(times_row)), l0=0.0, m0=0.0)
        g.write("UVW", uvw)
        g.write("TIME", times_row)
        g.write("ANTENNA1", np.tile(ant1, ntin))
        g.write("ANTENNA2", np.tile(ant2, ntin))
        g.write("FLAG", np.zeros((nrow, nchan), dtype=np.uint8))
        if corrupt_gains:
            shape = (ncorr, nrow, nchan)
            gp = 1.0 + 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            gq = 1.0 + 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            vis = gp * np.conj(gq) * vis
            g.write("JONES_P", gp)
            g.write("JONES_Q", gq)
        g.write("VIS", vis)
        g.write("WEIGHT", wgt)

    if gains_tab is not None:
        save_gain_table(TreeStore(gain_table_out, mode="w"), gains_tab, gt_time, gt_freq)

    truth = dict(model=model, cell_rad=cell_rad, freqs=freqs, nx=nx)
    return store, truth
