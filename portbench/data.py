"""Inputs of every cell, made from the configuration and ``--seed``.

Copies of ``chip_smoke.py``'s makers (``synth_array``, ``channels``,
``point_sources``, ``point_sum_vis``), so that the benchmark reads nothing
outside its own folder. The array layout is fixed by the configuration's
``array_seed``: every seed of a cell plans the same groups and bins, and the
seed draws only the sky, the noise and the model cubes.
"""

from __future__ import annotations

import numpy as np
import torch

LIGHTSPEED = 299792458.0


def synth_array(nant: int, ntime: int, seed: int, wscale: float = 1.0, radius: float = 8000.0) -> np.ndarray:
    """uvw (ntime*nbl, 3) of a random array: antennas uniform in a disc of
    ``radius`` metres (baselines within twice that), hour angles over
    +-4 h at dec -30 deg, w scaled by ``wscale`` (1: the array's own w)."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.random(nant))
    th = 2 * np.pi * rng.random(nant)
    xy = np.stack([r * np.cos(th), r * np.sin(th)], -1)
    a1, a2 = np.triu_indices(nant, 1)
    bx, by = (xy[a1] - xy[a2]).T
    h = np.linspace(-np.pi / 3, np.pi / 3, ntime)[:, None]
    sd, cd = np.sin(np.deg2rad(-30.0)), np.cos(np.deg2rad(-30.0))
    u = np.sin(h) * bx + np.cos(h) * by
    v = -sd * np.cos(h) * bx + sd * np.sin(h) * by
    w = wscale * (cd * np.cos(h) * bx - cd * np.sin(h) * by)
    return np.stack([u.ravel(), v.ravel(), w.ravel()], -1)


def channels(nchan: int, fmin: float, fmax: float) -> np.ndarray:
    """Centres of ``nchan`` equal channels over [fmin, fmax] Hz."""
    edges = np.linspace(fmin, fmax, nchan + 1)
    return 0.5 * (edges[:-1] + edges[1:])


def band_freqs(cfg: dict) -> list:
    """The channel frequencies of each imaging band."""
    chans = channels(cfg["nchan"], cfg["fmin_hz"], cfg["fmax_hz"])
    return list(chans.reshape(cfg["nband"], -1))


def point_sources(nx: int, nsrc: int, seed: int) -> list:
    """``nsrc`` seeded (pixel x, pixel y, flux) sources in the inner half of
    an nx^2 image, fluxes uniform in [0.1, 1), at distinct pixels."""
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    while len(out) < nsrc:
        p, q = (int(a) for a in rng.integers(nx // 4, 3 * nx // 4, 2))
        f = float(rng.uniform(0.1, 1.0))
        if (p, q) not in seen:
            seen.add((p, q))
            out.append((p, q, f))
    return out


def pixel_lm(p, q, nx: int, cell: float):
    """(l, m) of pixel (p, q) of an nx^2 image (the pinned convention)."""
    return (p - nx // 2) * cell, (q - nx // 2) * cell


def point_sum_vis(uvw_d, freq, comps):
    """Noise-free visibilities (nrow, nchan) complex128 of point components
    ``comps`` = [(l, m, flux per channel)], summed directly in f64 on the
    device of ``uvw_d`` from the pinned convention (no 1/n):
    V = sum_k I_k exp(-2 pi i (u l - v m - w (n - 1)) f / c)."""
    dev = uvw_d.device
    nu = torch.as_tensor(np.asarray(freq), device=dev, dtype=torch.float64) / LIGHTSPEED
    acc = torch.zeros((uvw_d.shape[0], len(freq)), dtype=torch.complex128, device=dev)
    for l, m, flux in comps:
        geo = uvw_d @ torch.tensor([l, -m, -(np.sqrt(1.0 - l * l - m * m) - 1.0)], dtype=torch.float64, device=dev)
        ph = -2.0 * np.pi * geo[:, None] * nu[None, :]
        acc += torch.as_tensor(np.asarray(flux), device=dev, dtype=torch.float64)[None, :] * \
            torch.complex(torch.cos(ph), torch.sin(ph))
    return acc


def sky_vis(uvw_d, freq, srcs, cell: float, nx: int, noise: float, gen):
    """Flat-spectrum point sources plus complex Gaussian noise of ``noise``
    per part from ``gen``: (re, im) f32 tensors (nrow, nchan), the values
    the program is given and the reference reads."""
    comps = [(*pixel_lm(p, q, nx, cell), np.full(len(freq), flux)) for p, q, flux in srcs]
    vis = point_sum_vis(uvw_d, freq, comps)
    re, im = vis.real.clone(), vis.imag.clone()
    re += noise * torch.randn(re.shape, generator=gen, device=re.device, dtype=torch.float64)
    im += noise * torch.randn(im.shape, generator=gen, device=im.device, dtype=torch.float64)
    return re.float(), im.float()


def sparse_model_cubes(nmodel: int, nband: int, nx: int, srcs: list, nextra: int, seed: int) -> list:
    """``nmodel`` sparse (nband, nx, nx) model cubes: the sky's sources at
    fluxes scaled by U[0.5, 1.5) per band, plus ``nextra`` seeded pixels
    a band at U[0, 0.1), as a deconvolution's model holds them."""
    rng = np.random.default_rng([seed, 1])
    cubes = []
    for _ in range(nmodel):
        cube = np.zeros((nband, nx, nx))
        for p, q, f in srcs:
            cube[:, p, q] = f * rng.uniform(0.5, 1.5, nband)
        for b in range(nband):
            cube[b, rng.integers(nx // 8, 7 * nx // 8, nextra), rng.integers(nx // 8, 7 * nx // 8, nextra)] += \
                rng.uniform(0.0, 0.1, nextra)
        cubes.append(cube)
    return cubes


def sample_pixels(nx: int, srcs: list, nrandom: int, seed: int) -> np.ndarray:
    """(K, 2) pixels at which images are compared: every source pixel, then
    ``nrandom`` seeded pixels over the whole image."""
    rng = np.random.default_rng([seed, 3])
    pix = [(p, q) for p, q, *_ in srcs] + [tuple(int(a) for a in rng.integers(0, nx, 2)) for _ in range(nrandom)]
    return np.asarray(pix, dtype=np.int64)
