"""Primary-beam models and interpolation onto the image grid (the port's
copy of pfb_imaging_tpu/utils/beam.py, host numpy): the analytic dish
beams ``init`` evaluates at ingest (Gaussian, and the cosine-tapered
MeerKAT-like model under its katbeam names), holography archives, the
small-grid -> image-grid interpolation the imager uses, a beam sampled at
parallactically rotated coordinates, and the reprojection of a beam image
between SIN-projected fields."""

from __future__ import annotations

import numpy as np

from ..constants import LIGHTSPEED


def gauss_beam(l_grid, m_grid, freq, diameter: float = 13.5):
    """Gaussian approximation to a dish primary beam at each frequency,
    FWHM ~ 1.18 lambda / D. Returns (nfreq, nx, ny), or (nx, ny) for a
    scalar freq."""
    freq = np.atleast_1d(freq)
    fwhm = 1.18 * (LIGHTSPEED / freq) / diameter
    sigma = fwhm / (2 * np.sqrt(2 * np.log(2)))
    r2 = l_grid**2 + m_grid**2
    beam = np.exp(-0.5 * r2[None] / sigma[:, None, None] ** 2)
    return beam[0] if beam.shape[0] == 1 else beam


def interp_beam(beam_small, l_small, m_small, l_image, m_image):
    """Linear regular-grid interpolation of a small-grid beam at the image
    points (l_image, m_image); zero outside the small grid."""
    from scipy.interpolate import RegularGridInterpolator

    interp = RegularGridInterpolator((l_small, m_small), beam_small, bounds_error=False, fill_value=0.0,
                                     method="linear")
    pts = np.stack(np.broadcast_arrays(l_image, m_image), axis=-1)
    return interp(pts)


def eval_beam(beam_small, l_small, m_small, xx, yy):
    """:func:`interp_beam` under the reference's name."""
    return interp_beam(beam_small, l_small, m_small, xx, yy)


# katbeam-equivalent parametric model: theta_FWHM = fwhm_scale * lambda / D
_KATBEAM_BANDS = {
    "kbl": dict(fwhm_scale=1.178, diameter=13.5, flo=0.856e9, fhi=1.712e9),
    "kbuhf": dict(fwhm_scale=1.178, diameter=13.5, flo=0.544e9, fhi=1.088e9),
}
_KATBEAM_ALIASES = {
    "kbl": "kbl", "kb_l": "kbl", "katbeam_l": "kbl",
    "kbuhf": "kbuhf", "kb_uhf": "kbuhf", "katbeam_uhf": "kbuhf",
}


def cosine_taper_beam(l_grid, m_grid, freq, diameter: float = 13.5, fwhm_scale: float = 1.178):
    """Cosine-tapered-aperture power beam P = E^2 with
    E(x) = cos(1.189 pi x) / (1 - 4 (1.189 x)^2), x = theta / theta_FWHM.
    Returns (nfreq, nx, ny), or (nx, ny) for a scalar freq."""
    freq = np.atleast_1d(np.asarray(freq, np.float64))
    fwhm = fwhm_scale * (LIGHTSPEED / freq) / diameter
    r = np.sqrt(l_grid**2 + m_grid**2)
    x = 1.189 * r[None] / fwhm[:, None, None]
    den = 1.0 - 4.0 * x**2
    # removable singularity at x = 1/2: E -> pi/4 sin(pi x) there
    near = np.abs(den) < 1e-8
    E = np.where(near, np.pi / 4.0 * np.sin(np.pi * x), np.cos(np.pi * x) / np.where(near, 1.0, den))
    beam = E**2
    return beam[0] if beam.shape[0] == 1 else beam


def load_holography_npz(path):
    """MeerKAT holography archive: ``abeam`` (ncorr, nfreq, nl, nm) complex
    Jones terms, ``ldeg``/``mdeg`` (deg), ``freq`` (Hz). Returns (power
    (nfreq, nl, nm), l (rad), m (rad), freq), power = (|J00|^2 + |J11|^2) / 2."""
    dct = np.load(path)
    beam = dct["abeam"]
    amp = (beam[0] * beam[0].conj() + beam[-1] * beam[-1].conj()).real / 2.0
    return amp, np.deg2rad(dct["ldeg"]), np.deg2rad(dct["mdeg"]), np.asarray(dct["freq"], np.float64)


def beam_at_freq(amp, freqs, freq):
    """Linear interpolation of an (nfreq, nl, nm) beam cube to one
    frequency (clamped at the band edges)."""
    freqs = np.asarray(freqs, np.float64)
    if freqs.size == 1:
        return amp[0]
    f = float(np.clip(freq, freqs.min(), freqs.max()))
    i = int(np.clip(np.searchsorted(freqs, f) - 1, 0, freqs.size - 2))
    t = (f - freqs[i]) / (freqs[i + 1] - freqs[i])
    return (1.0 - t) * amp[i] + t * amp[i + 1]


def eval_beam_model(btype, l_grid, m_grid, freq, diameter: float = 13.5):
    """A named primary-beam model on an (l, m) grid at one frequency:
    None/"none" -> ones; "gauss"; "kbl"/"kbuhf" (and their katbeam
    aliases) -> the cosine-tapered model; "<path>.npz" -> a holography
    archive interpolated to ``freq``."""
    if btype is None or str(btype).lower() == "none":
        return np.ones(np.broadcast_shapes(l_grid.shape, m_grid.shape))
    bl = str(btype).lower().replace("-", "_")
    if bl == "gauss":
        return gauss_beam(l_grid, m_grid, freq, diameter=diameter)
    if bl in _KATBEAM_ALIASES:
        p = _KATBEAM_BANDS[_KATBEAM_ALIASES[bl]]
        return cosine_taper_beam(l_grid, m_grid, freq, diameter=p["diameter"], fwhm_scale=p["fwhm_scale"])
    if str(btype).endswith(".npz"):
        amp, l_h, m_h, freqs = load_holography_npz(btype)
        return interp_beam(beam_at_freq(amp, freqs, freq), l_h, m_h, l_grid, m_grid)
    raise ValueError(f"Unknown beam model {btype!r}")


def rotate_beam(beam_small, l_small, m_small, parang, l_out, m_out):
    """A small-grid beam sampled at (l_out, m_out) rotated by the
    parallactic angle ``parang`` (radians)."""
    c, s = np.cos(parang), np.sin(parang)
    ll, mm = np.broadcast_arrays(l_out, m_out)
    return interp_beam(beam_small, l_small, m_small, c * ll - s * mm, s * ll + c * mm)


def reproject_beam(beam_in, cell_in, radec_in, radec_out, cell_out, nxo, nyo, fill: float = 0.0):
    """Reproject a beam image between SIN-projected tangent fields: each
    output pixel's sky direction under the target projection is mapped to
    the input projection's (l, m) and sampled bilinearly; directions off
    the input grid get ``fill``. ``beam_in`` is (nx, ny) or (nstokes, nx,
    ny); cells in radians, centres (ra, dec) in radians."""
    from scipy.interpolate import RegularGridInterpolator

    ra0, dec0 = radec_in
    raf, decf = radec_out
    single = beam_in.ndim == 2
    bin_ = beam_in[None] if single else beam_in
    nxi, nyi = bin_.shape[-2:]
    # target pixels' direction cosines about (raf, decf)
    lo = (np.arange(nxo) - nxo // 2) * cell_out
    mo = (np.arange(nyo) - nyo // 2) * cell_out
    ll, mm = np.meshgrid(lo, mo, indexing="ij")
    nn = np.sqrt(np.maximum(1.0 - ll**2 - mm**2, 0.0))
    # inverse SIN: the sky (ra, dec) of each target pixel
    dec = np.arcsin(np.clip(mm * np.cos(decf) + nn * np.sin(decf), -1.0, 1.0))
    ra = raf + np.arctan2(ll, nn * np.cos(decf) - mm * np.sin(decf))
    # forward SIN about the input centre
    dra = ra - ra0
    l_in = np.cos(dec) * np.sin(dra)
    m_in = np.sin(dec) * np.cos(dec0) - np.cos(dec) * np.sin(dec0) * np.cos(dra)
    li = (np.arange(nxi) - nxi // 2) * cell_in
    mi = (np.arange(nyi) - nyi // 2) * cell_in
    out = np.empty((bin_.shape[0], nxo, nyo), bin_.dtype)
    pts = np.stack([l_in, m_in], axis=-1)
    for k in range(bin_.shape[0]):
        it = RegularGridInterpolator((li, mi), bin_[k], bounds_error=False, fill_value=fill, method="linear")
        out[k] = it(pts)
    return out[0] if single else out
