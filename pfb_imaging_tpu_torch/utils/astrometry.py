"""Astrometry: uvw synthesis, phase rotation, rotation matrices (a copy of
pfb_imaging_tpu/utils/astrometry.py, numpy on the host)."""

from __future__ import annotations

import numpy as np

from ..constants import LIGHTSPEED


def synthesize_uvw(antpos: np.ndarray, times: np.ndarray, ant1, ant2, ra: float, dec: float, longitude: float = 21.443):
    """uvw from ITRF-ish antenna positions and hour angles.

    Args:
        antpos: (nant, 3) positions (metres, ENU or equatorial XYZ-like).
        times: (nrow,) time in seconds (used for earth rotation).
        ant1/ant2: (nrow,) antenna indices.
        ra/dec: phase centre (rad).
    """
    omega = 2 * np.pi / 86164.0905  # sidereal rate
    ha = omega * np.asarray(times) + np.deg2rad(longitude) - ra
    bl = antpos[np.asarray(ant1)] - antpos[np.asarray(ant2)]
    ch, sh = np.cos(ha), np.sin(ha)
    cd, sd = np.cos(dec), np.sin(dec)
    u = sh * bl[:, 0] + ch * bl[:, 1]
    v = -sd * ch * bl[:, 0] + sd * sh * bl[:, 1] + cd * bl[:, 2]
    w = cd * ch * bl[:, 0] - cd * sh * bl[:, 1] + sd * bl[:, 2]
    return np.stack([u, v, w], axis=1)


def cross_product_matrix(k: np.ndarray) -> np.ndarray:
    """Skew-symmetric [k]_x (reference create_cross_product_matrix)."""
    return np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])


def rotation_matrix_rodrigues(s0: np.ndarray, s1: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector s0 to s1 (reference Rodrigues form)."""
    k = np.cross(s0, s1)
    sk = np.linalg.norm(k)
    ck = np.dot(s0, s1)
    if sk < 1e-15:
        return np.eye(3) if ck > 0 else -np.eye(3)
    kx = cross_product_matrix(k / sk)
    return np.eye(3) + sk * kx + (1 - ck) * (kx @ kx)


def radec_to_lmn(ra, dec, ra0, dec0):
    """Direction cosines of (ra, dec) w.r.t. phase centre (ra0, dec0)."""
    dra = np.asarray(ra) - ra0
    ell = np.cos(dec) * np.sin(dra)
    emm = np.sin(dec) * np.cos(dec0) - np.cos(dec) * np.sin(dec0) * np.cos(dra)
    enn = np.sin(dec) * np.sin(dec0) + np.cos(dec) * np.cos(dec0) * np.cos(dra)
    return ell, emm, enn


def rephase(vis, uvw, freq, radec_new, radec_ref, phasesign: float = -1.0):
    """Rephase visibilities to a new phase centre (reference rephase).

    vis: (nrow, nchan); uvw: (nrow, 3) at the reference centre.
    """
    ell, emm, enn = radec_to_lmn(radec_new[0], radec_new[1], radec_ref[0], radec_ref[1])
    phase = uvw[:, 0] * ell + uvw[:, 1] * emm + uvw[:, 2] * (enn - 1.0)
    factor = np.exp(phasesign * 2j * np.pi * np.multiply.outer(phase, freq / LIGHTSPEED))
    return vis * factor


def change_phase_dir(vis, uvw, freq, radec_new, radec_ref, phasesign: float = -1.0):
    """Rephase AND rotate uvw to the new centre (reference change_phase_dir)."""
    vis_new = rephase(vis, uvw, freq, radec_new, radec_ref, phasesign)
    s0 = np.array(radec_to_lmn(radec_ref[0], radec_ref[1], radec_ref[0], radec_ref[1]))
    s0 = np.array([0.0, 0.0, 1.0])
    s1 = np.array(radec_to_lmn(radec_new[0], radec_new[1], radec_ref[0], radec_ref[1]))
    rot = rotation_matrix_rodrigues(s0, s1)
    return vis_new, uvw @ rot.T


def format_coords(ra0, dec0):
    """(ra, dec) in degrees -> sexagesimal ("HHhMMmSS.SSSs", "+DDdMMmSS.SSSs")
    strings (reference format_coords via astropy SkyCoord to_string)."""
    ra_h = (float(ra0) % 360.0) / 15.0
    hh = int(ra_h)
    mm = int((ra_h - hh) * 60.0)
    ss = (ra_h - hh - mm / 60.0) * 3600.0
    if ss > 59.9995:  # carry rounding across the field boundary
        ss = 0.0
        mm += 1
        if mm == 60:
            mm = 0
            hh = (hh + 1) % 24
    hms = f"{hh:02d}h{mm:02d}m{ss:06.3f}s"
    sgn = "-" if dec0 < 0 else "+"
    d = abs(float(dec0))
    dd = int(d)
    dm = int((d - dd) * 60.0)
    dsec = (d - dd - dm / 60.0) * 3600.0
    if dsec > 59.9995:
        dsec = 0.0
        dm += 1
        if dm == 60:
            dm = 0
            dd += 1
    dms = f"{sgn}{dd:02d}d{dm:02d}m{dsec:06.3f}s"
    return hms, dms


def sun_radec(mjd: float):
    """Geocentric apparent (ra, dec) of the Sun in radians at MJD (UTC days).

    Low-precision solar ephemeris (the Astronomical Almanac's standard
    formulas): mean longitude + equation-of-centre terms, mean obliquity.
    Accurate to ~0.01 deg over 1950-2050 — the use case (pointing a solar
    observation's phase centre at the Sun, reference get_coordinates /
    solarkat) needs arcminutes. Topocentric parallax (< 8.8 arcsec for the
    Sun) is below this budget and is not applied.
    """
    n = float(mjd) - 51544.5  # days since J2000.0
    L = np.deg2rad((280.460 + 0.9856474 * n) % 360.0)  # mean longitude
    g = np.deg2rad((357.528 + 0.9856003 * n) % 360.0)  # mean anomaly
    lam = L + np.deg2rad(1.915) * np.sin(g) + np.deg2rad(0.020) * np.sin(2 * g)
    eps = np.deg2rad(23.439 - 0.0000004 * n)  # mean obliquity
    ra = np.arctan2(np.cos(eps) * np.sin(lam), np.cos(lam)) % (2 * np.pi)
    dec = np.arcsin(np.sin(eps) * np.sin(lam))
    return float(ra), float(dec)


def get_coordinates(obs_time, obs_lat: float = -30.71323598930457,
                    obs_lon: float = 21.443001467965008, target: str = "Sun"):
    """(ra, dec) in radians of a solar-system target at an observation time
    (reference get_coordinates, utils/astrometry.py:158-177 — the solarkat
    phase-centre finder; lat/lon default to MeerKAT).

    ``obs_time`` is the weighted mean of the MS TIME column: seconds on the
    MJD epoch (the factor-86400 convention the reference uses). Only the
    Sun is implemented (the reference delegates other bodies to astropy's
    ephemerides, which this self-contained deployment does not carry);
    geocentric vs topocentric differs by < 8.8 arcsec for the Sun, below
    the ephemeris' ~0.01 deg budget, so the site arguments are accepted
    for signature parity but unused.
    """
    if target.lower() != "sun":
        raise NotImplementedError(
            f"ephemeris target {target!r}: only 'Sun' is supported (the "
            "reference's other targets come from astropy's solar-system "
            "ephemerides)"
        )
    del obs_lat, obs_lon
    return sun_radec(float(obs_time) / 86400.0)


def uvw_rotate(uvw, ra0, dec0, ra, dec):
    """Rotate uvw from phase centre (ra0, dec0) to (ra, dec) (reference
    uvw_rotate, utils/astrometry.py:295-337): the T(new) T(old)^T
    composition of Thompson/Moran/Swenson ch. 4 transforms, leaving the
    image tangent at the new delay centre.

    ``uvw`` is (3,) or (nrow, 3); returns the same shape.
    """
    uvw = np.asarray(uvw, np.float64)
    dra = ra - ra0
    cdr, sdr = np.cos(dra), np.sin(dra)
    cd0, sd0 = np.cos(dec0), np.sin(dec0)
    cd1, sd1 = np.cos(dec), np.sin(dec)
    rot = np.array(
        [
            [cdr, sd0 * sdr, -cd0 * sdr],
            [-sd1 * sdr, sd1 * sd0 * cdr + cd1 * cd0, -cd0 * sd1 * cdr + cd1 * sd0],
            [cd1 * sdr, -cd1 * sd0 * cdr + sd1 * cd0, cd1 * cd0 * cdr + sd1 * sd0],
        ]
    )
    if uvw.ndim == 1:
        return rot @ uvw
    return uvw @ rot.T


def parallactic_angles(times, ra: float, dec: float, longitude: float = 21.443, latitude: float = -30.713):
    """Parallactic angle per time sample for an alt-az dish
    (reference: africanus parallactic_angles via utils/beam.py:58-61;
    the reference takes the antenna mean — one site angle serves here).

    Uses the same sidereal hour-angle convention as ``synthesize_uvw``:
    HA = omega * t + longitude - ra.
    """
    omega = 2 * np.pi / 86164.0905
    ha = omega * np.asarray(times, np.float64) + np.deg2rad(longitude) - ra
    lat = np.deg2rad(latitude)
    return np.arctan2(
        np.cos(lat) * np.sin(ha),
        np.sin(lat) * np.cos(dec) - np.cos(lat) * np.sin(dec) * np.cos(ha),
    )
