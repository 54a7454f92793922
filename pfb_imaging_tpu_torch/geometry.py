"""Image geometry and measurement-operator conventions (port of
pfb_imaging_tpu/geometry.py).

Convention (the JAX package's, pinned there against an explicit DFT):

    vis[r, f] = sum_pix I[x, y] * exp(-2*pi*j * phase) / n
    phase = (su*u*l + sv*v*m - sw*w*(n - 1)) / lambda
    l(x)  = -l0 + (x - nx/2) * cellx
    m(y)  =  m0 + (y - ny/2) * celly

``fitcleanbeam`` takes the gradient of the Gaussian misfit from
``torch.autograd`` in f64 on the CPU and drives the same
``scipy.optimize.fmin_l_bfgs_b`` as the JAX version.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .constants import LIGHTSPEED


def wgridder_conventions(l0: float, m0: float):
    """Return (flip_u, flip_v, flip_w, x0, y0) (the reference's ducc0 flips)."""
    return False, True, False, -l0, -m0


def conventions_signs(flip_u: bool = False, flip_v: bool = True, flip_w: bool = False):
    """Signs (su, sv, sw) entering the DFT phase for given flips."""
    return (-1.0 if flip_u else 1.0, -1.0 if flip_v else 1.0, -1.0 if flip_w else 1.0)


def good_size(n: int, even: bool = True) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n (even if ``even``)."""
    if n <= 2:
        return 2 if even else max(n, 1)
    best = None
    p2 = 1
    while p2 < 4 * n:
        p23 = p2
        while p23 < 4 * n:
            p235 = p23
            while p235 < n:
                p235 *= 5
            if (not even) or p235 % 2 == 0:
                if best is None or p235 < best:
                    best = p235
            p23 *= 3
        p2 *= 2
    return int(best)


@dataclasses.dataclass(frozen=True)
class ImageGeometry:
    """Static image geometry shared by all operators on a dataset."""

    nx: int
    ny: int
    nx_psf: int
    ny_psf: int
    cell_rad: float
    cell_deg: float
    cell_n: float  # Nyquist cell in radians
    l0: float = 0.0
    m0: float = 0.0


def set_image_size(max_blength: float, max_freq: float, field_of_view: float, super_resolution_factor: float,
                   cell_size: float | None = None, nx: int | None = None, ny: int | None = None,
                   psf_oversize: float = 2.0, l0: float = 0.0, m0: float = 0.0) -> ImageGeometry:
    """Image geometry: the Nyquist cell ``1 / (2 max_blength max_freq / c)``
    divided by ``super_resolution_factor`` unless ``cell_size`` (arcsec) is
    given; even 5-smooth pixel counts; a PSF grid ``psf_oversize`` larger."""
    cell_n = 1.0 / (2.0 * max_blength * max_freq / LIGHTSPEED)
    if cell_size is not None:
        cell_rad = cell_size * math.pi / 60 / 60 / 180
    else:
        cell_rad = cell_n / super_resolution_factor
        cell_size = cell_rad * 60 * 60 * 180 / math.pi
    if nx is None:
        nx = ny = good_size(int(field_of_view * 3600.0 / cell_size), even=True)
    else:
        ny = ny if ny is not None else nx
        if nx % 2 or ny % 2:
            raise NotImplementedError("Only even numbers of pixels are supported")
    if psf_oversize:
        nx_psf = good_size(int(psf_oversize * nx), even=True)
        ny_psf = good_size(int(psf_oversize * ny), even=True)
    else:
        nx_psf = ny_psf = good_size(128, even=True)
    return ImageGeometry(nx=nx, ny=ny, nx_psf=nx_psf, ny_psf=ny_psf, cell_rad=cell_rad,
                         cell_deg=math.degrees(cell_rad), cell_n=cell_n, l0=l0, m0=m0)


def lm_grid(nx: int, ny: int, cellx: float, celly: float, l0: float = 0.0, m0: float = 0.0):
    """Per-pixel (l, m, n) numpy arrays (l along axis 0, m along axis 1)."""
    ell = -l0 + (np.arange(nx) - nx // 2) * cellx
    emm = m0 + (np.arange(ny) - ny // 2) * celly
    ll = np.broadcast_to(ell[:, None], (nx, ny))
    mm = np.broadcast_to(emm[None, :], (nx, ny))
    nn = np.sqrt(np.maximum(1.0 - ell[:, None] ** 2 - emm[None, :] ** 2, 0.0))
    return ll, mm, nn


# ── clean-beam fitting ───────────────────────────────────────────────


def taperf(shape: tuple[int, int], taper_width: int) -> np.ndarray:
    """Cosine edge taper (a copy of the JAX ``geometry.taperf``)."""
    tapers1d = []
    for npix in shape:
        taper = np.ones(npix)
        taper[:taper_width] = 0.5 * (1 + np.cos(np.linspace(1.1 * np.pi, 2 * np.pi, taper_width)))
        taper[-taper_width:] = 0.5 * (1 + np.cos(np.linspace(0, 0.9 * np.pi, taper_width)))
        tapers1d.append(taper)
    return np.outer(*tapers1d)


def _psf_errorsq(params, data, xy):
    """Sum-of-squares misfit of a rotated-Gaussian mainlobe model with FWHMs
    (emaj, emin) and position angle pa (FITS rotation, t = pi/2 + pa)."""
    emaj, emin, pa = params[0], params[1], params[2]
    s, c = torch.sin(pa), torch.cos(pa)
    rmat = torch.stack([torch.stack([-s, -c]), torch.stack([c, -s])])
    amat = torch.diag(torch.stack([1.0 / emaj**2, 1.0 / emin**2]))
    bmat = rmat @ amat @ rmat.T
    qvec = torch.einsum("bn,bc,cn->n", xy, bmat, xy)
    fwhm_conv = 2 * math.sqrt(2 * math.log(2.0))
    res = data - torch.exp(-0.5 * fwhm_conv**2 * qvec)
    return (res * res).sum()


def fitcleanbeam(psf: np.ndarray, level: float = 0.5, pixsize: float = 1.0, nsigma: float = 10.0) -> np.ndarray:
    """Fit a Gaussian to the PSF mainlobe per band: (nband, nx, ny) ->
    (nband, 3) of (emaj, emin, pa); an all-zero band gives NaNs."""
    from scipy.ndimage import label
    from scipy.optimize import fmin_l_bfgs_b

    nband, nx, ny = psf.shape
    xx, yy = np.meshgrid(-(nx // 2) + np.arange(nx), -(ny // 2) + np.arange(ny), indexing="ij")
    gausspars = []
    for v in range(nband):
        if not psf[v].any():
            gausspars.append([np.nan, np.nan, np.nan])
            continue
        psfv = psf[v] / psf[v].max()
        islands, _ = label(np.where(psfv > level, 1.0, 0.0))
        centre = islands == islands[nx // 2, ny // 2]
        xs, ys, psftmp = xx[centre], yy[centre], psfv[centre]
        wsum = psftmp.sum()
        dx = xs - np.sum(psftmp * xs) / wsum
        dy = ys - np.sum(psftmp * ys) / wsum
        mxx = np.sum(psftmp * dx**2) / wsum
        myy = np.sum(psftmp * dy**2) / wsum
        mxy = np.sum(psftmp * dx * dy) / wsum
        pa0 = float(np.clip(np.pi / 2 + 0.5 * np.arctan2(2 * mxy, mxx - myy), 0.0, np.pi))
        t = np.pi / 2 + pa0
        dx_rot = np.cos(t) * dx + np.sin(t) * dy
        dy_rot = -np.sin(t) * dx + np.cos(t) * dy
        emaj0 = max(dx_rot.max() - dx_rot.min(), 1.0)
        emin0 = max(dy_rot.max() - dy_rot.min(), 1.0)
        sigma_est = emaj0 / (2 * np.sqrt(2 * np.log(2)))
        idxs = (xx**2 + yy**2) < (nsigma * sigma_est) ** 2
        data = torch.from_numpy(np.ascontiguousarray(psfv[idxs], np.float64))
        xy = torch.from_numpy(np.vstack((xx[idxs], yy[idxs])).astype(np.float64))

        def f(p, _data=data, _xy=xy):
            pt = torch.tensor(p, dtype=torch.float64, requires_grad=True)
            val = _psf_errorsq(pt, _data, _xy)
            (grad,) = torch.autograd.grad(val, pt)
            return float(val.detach()), grad.numpy().astype(np.float64)

        p, _, _ = fmin_l_bfgs_b(f, np.array((emaj0, emin0, pa0), dtype=np.float64),
                                bounds=((0, None), (0, None), (0, np.pi)), factr=1e7)
        if p[0] >= p[1]:
            emaj, emin, pa = p[0], p[1], p[2]
        else:
            emaj, emin, pa = p[1], p[0], p[2] + np.pi / 2
        gausspars.append([emaj * pixsize, emin * pixsize, pa])
    return np.array(gausspars)


def gaussian_kernel(xx: np.ndarray, yy: np.ndarray, gaussparf, normalise: bool = True) -> np.ndarray:
    """A rotated Gaussian with FWHM parameters (emaj, emin, pa) rendered on
    a pixel grid (the clean beam of ``restore`` and the Gaussian-ratio
    kernels of ``utils/restoration``); unit sum when ``normalise``."""
    emaj, emin, pa = gaussparf
    cosp, sinp = np.cos(pa), np.sin(pa)
    xr = -sinp * xx - cosp * yy
    yr = cosp * xx - sinp * yy
    fwhm_conv = 2 * np.sqrt(2 * np.log(2))
    q = (xr / emaj) ** 2 + (yr / emin) ** 2
    g = np.exp(-0.5 * fwhm_conv**2 * q)
    if normalise:
        s = g.sum()
        if s > 0:
            g = g / s
    return g
