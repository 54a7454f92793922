"""Component model <-> image-cube fitting (reference utils/modelspec.py:12-356).

``fit_image_cube`` fits per-pixel spectra over the (time, freq) axes onto a
Legendre basis in normalised coordinates by weighted least squares;
``eval_coeffs_to_slice``/``eval_coeffs_to_cube`` render the model back at
arbitrary (time, freq). The reference parametrises the basis with sympy
expressions stored in ``.mds`` attrs; here the basis is fixed to Legendre
polynomials in the normalised coordinate (the reference's default) and the
attrs store orders + normalisation constants — everything needed to
re-evaluate without a symbolic engine.
"""

from __future__ import annotations

import numpy as np
import torch


def _legendre_design(x: np.ndarray, order: int) -> np.ndarray:
    """(npts, order) Legendre Vandermonde on x in [-1, 1]."""
    return np.polynomial.legendre.legvander(x, order - 1)


def _normalise(v, vmin, vmax):
    if vmax == vmin:
        return np.zeros_like(np.asarray(v, dtype=float))
    return 2.0 * (np.asarray(v, dtype=float) - vmin) / (vmax - vmin) - 1.0


def fit_image_cube(times, freqs, image, wgt=None, nbasisf: int | None = None, nbasist: int = 1, method: str = "Legendre",
                   *, device):
    """Fit the (ntime, nband, nx, ny) image cube onto a t/f basis.

    Returns (coeffs, ix, iy, attrs): coefficients (nparam, ncomps) for the
    nonzero-pixel components at integer indices (ix, iy), plus the attrs
    dict needed by :func:`eval_coeffs_to_slice`. The least-squares solve
    runs in f64 on ``device``: the minimum-norm solution by the
    pseudo-inverse, at the cutoff of numpy's ``lstsq``.
    """
    image = np.asarray(image)
    if image.ndim == 3:
        image = image[None]
    ntime, nband, nx, ny = image.shape
    if nbasisf is None:
        nbasisf = nband
    nbasisf = min(nbasisf, nband)
    nbasist = min(nbasist, ntime)

    mask = np.any(image != 0, axis=(0, 1))
    ix, iy = np.nonzero(mask)
    ncomps = ix.size
    data = image[:, :, ix, iy].reshape(ntime * nband, ncomps)

    tmin, tmax = float(np.min(times)), float(np.max(times))
    fmin, fmax = float(np.min(freqs)), float(np.max(freqs))
    tnorm = _normalise(times, tmin, tmax)
    fnorm = _normalise(freqs, fmin, fmax)

    at = _legendre_design(tnorm, nbasist)  # (ntime, nbasist)
    af = _legendre_design(fnorm, nbasisf)  # (nband, nbasisf)
    design = np.einsum("ti,fj->tfij", at, af).reshape(ntime * nband, nbasist * nbasisf)

    if wgt is None:
        wgt = np.ones(ntime * nband)
    else:
        wgt = np.asarray(wgt, dtype=float).reshape(ntime * nband)
    w = np.sqrt(wgt)[:, None]
    a = torch.as_tensor(design * w, dtype=torch.float64, device=device)
    b = torch.as_tensor(data * w, dtype=torch.float64, device=device)
    coeffs = (torch.linalg.pinv(a) @ b).cpu().numpy()

    attrs = dict(
        method=method,
        nbasist=nbasist,
        nbasisf=nbasisf,
        tmin=tmin,
        tmax=tmax,
        fmin=fmin,
        fmax=fmax,
        nx=nx,
        ny=ny,
        ntime=ntime,
        nband=nband,
        times=np.asarray(times, dtype=float).tolist(),
        freqs=np.asarray(freqs, dtype=float).tolist(),
    )
    return coeffs, ix, iy, attrs


def eval_coeffs_to_slice(time, freq, coeffs, ix, iy, attrs, nxo: int | None = None, nyo: int | None = None):
    """Render the component model at one (time, freq) onto an (nxo, nyo) image
    (reference eval_coeffs_to_slice, modelspec.py:243-310)."""
    nx, ny = attrs["nx"], attrs["ny"]
    nxo = nx if nxo is None else nxo
    nyo = ny if nyo is None else nyo
    tnorm = _normalise(np.atleast_1d(time), attrs["tmin"], attrs["tmax"])
    fnorm = _normalise(np.atleast_1d(freq), attrs["fmin"], attrs["fmax"])
    at = _legendre_design(tnorm, attrs["nbasist"])[0]
    af = _legendre_design(fnorm, attrs["nbasisf"])[0]
    basis = np.outer(at, af).reshape(-1)  # (nparam,)
    vals = basis @ coeffs  # (ncomps,)
    out = np.zeros((nxo, nyo))
    # components land at the same integer pixel indices (padding centred
    # grids share the origin convention with the reference)
    out[ix, iy] = vals
    return out


def eval_coeffs_to_cube(times, freqs, coeffs, ix, iy, attrs):
    """(ntime, nband, nx, ny) cube render."""
    times = np.atleast_1d(times)
    freqs = np.atleast_1d(freqs)
    out = np.zeros((times.size, freqs.size, attrs["nx"], attrs["ny"]))
    for i, t in enumerate(times):
        for j, f in enumerate(freqs):
            out[i, j] = eval_coeffs_to_slice(t, f, coeffs, ix, iy, attrs)
    return out


def save_mds(store, coeffs, ix, iy, attrs) -> None:
    """Write the component model into a TreeStore node (the ``.mds`` analogue)."""
    store.write("coefficients", coeffs)
    store.write("location_x", ix)
    store.write("location_y", iy)
    store.set_attrs(**attrs)


def load_mds(store):
    return store.read("coefficients"), store.read("location_x"), store.read("location_y"), store.attrs
