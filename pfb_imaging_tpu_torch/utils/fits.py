"""FITS output with WCS headers (reference utils/fits.py:15-529).

Self-contained writer/reader (this image carries no astropy): primary-HDU
FITS with 2880-byte header blocks and big-endian data, plus the reference's
WCS conventions — RA---SIN/DEC--SIN/FREQ/STOKES axes, CDELT1 = -cell_deg,
CRPIX = (1 + nx//2, 1 + ny//2), and the (nx, ny, nchan, ncorr) -> FITS axis
transpose of the reference's ``save_fits`` (fits.py:42-51).
"""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np

from .. import __version__


def _card(key: str, value, comment: str = "") -> str:
    """Format one 80-char FITS header card."""
    if isinstance(value, bool):
        v = "T" if value else "F"
        s = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        s = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        s = f"{key:<8}= {value:>20.14E}"
    else:
        vs = f"'{str(value):<8}'"
        s = f"{key:<8}= {vs:>20}"
    if comment:
        s = f"{s} / {comment}"
    return s[:80].ljust(80)


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("'"):
        return raw.strip("'").strip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        if "." in raw or "E" in raw.upper():
            return float(raw)
        return int(raw)
    except ValueError:
        return raw


def to4d(data: np.ndarray) -> np.ndarray:
    if data.ndim == 4:
        return data
    if data.ndim == 3:
        return data[None]
    if data.ndim == 2:
        return data[None, None]
    if data.ndim == 1:
        return data[None, None, None]
    raise ValueError("Only arrays with ndim <= 4 can be broadcast to 4D.")


def set_wcs(
    cell_x: float,
    cell_y: float,
    nx: int,
    ny: int,
    radec,
    freq,
    unit: str = "Jy/beam",
    gausspar=None,
    ms_time=None,
    time_is_unix: bool = False,
    ncorr: int = 1,
) -> dict:
    """Build the FITS header dict (reference set_wcs, utils/fits.py:54-160).

    cell_x/cell_y in degrees; radec in radians; freq in Hz. ``time_is_unix``
    selects the MSv4 unix-seconds convention over MSv2 MJD seconds (D13).
    """
    freq = np.atleast_1d(np.asarray(freq, dtype=float))
    nchan = freq.size
    if nchan > 1:
        crpix3 = nchan // 2 + 1
        ref_freq = freq[crpix3 - 1]
        df = freq[1] - freq[0]
    else:
        crpix3 = 1
        ref_freq = freq[0]
        df = 1.0

    hdr = {
        "BUNIT": unit,
        "BTYPE": "Intensity",
        "EQUINOX": 2000.0,
        "CTYPE1": "RA---SIN",
        "CTYPE2": "DEC--SIN",
        "CTYPE3": "FREQ",
        "CTYPE4": "STOKES",
        "CRPIX1": 1 + nx // 2,
        "CRPIX2": 1 + ny // 2,
        "CRPIX3": crpix3,
        "CRPIX4": 1,
        "CRVAL1": radec[0] * 180.0 / np.pi,
        "CRVAL2": radec[1] * 180.0 / np.pi,
        "CRVAL3": ref_freq,
        "CRVAL4": 1.0,
        "CDELT1": -cell_x,
        "CDELT2": cell_y,
        "CDELT3": df,
        "CDELT4": 1.0,
        "CUNIT1": "deg",
        "CUNIT2": "deg",
        "CUNIT3": "Hz",
        "RESTFRQ": ref_freq,
        "SPECSYS": "TOPOCENT",
        "ORIGIN": f"pfb-imaging-tpu: v{__version__}",
    }
    if gausspar is not None:
        hdr["BMAJ"] = float(gausspar[0])
        hdr["BMIN"] = float(gausspar[1])
        hdr["BPA"] = float(np.rad2deg(gausspar[2]))
    if ms_time is not None:
        mjd_to_unix = 3506716800.0
        unix_time = float(ms_time) if time_is_unix else float(ms_time) - mjd_to_unix
        utc_iso = datetime.fromtimestamp(unix_time, tz=timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
        hdr["UTC_TIME"] = utc_iso
    return hdr


def save_fits(data: np.ndarray, name: str, hdr: dict, dtype=np.float32) -> None:
    """Write a primary-HDU FITS file.

    ``data`` is (ncorr, nchan, nx, ny) (or lower-dim, broadcast via to4d);
    the FITS fast-to-slow axis order becomes (nx, ny, nchan, ncorr) exactly
    as the reference's transpose does (fits.py:42-51).
    """
    data = np.transpose(to4d(np.asarray(data)), (1, 0, 3, 2))  # (nchan,ncorr,ny,nx)?
    # reference: np.transpose(to4d(data), axes=(1,0,3,2)) with FORTRAN order;
    # equivalently C-order with axes fully reversed relative to NAXIS order
    data = np.require(data, dtype=dtype, requirements="C")
    bitpix = {np.dtype(np.float32): -32, np.dtype(np.float64): -64}[np.dtype(dtype)]
    nax = data.ndim
    shape_fits = data.shape[::-1]  # NAXIS1 fastest

    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", bitpix, "array data type"),
        _card("NAXIS", nax, "number of array dimensions"),
    ]
    for i, size in enumerate(shape_fits, 1):
        cards.append(_card(f"NAXIS{i}", int(size), f"length of data axis {i}"))
    for k, v in hdr.items():
        cards.append(_card(k, v))
    cards.append("END".ljust(80))
    header = "".join(cards)
    header += " " * ((-len(header)) % 2880)

    be = data.astype(np.dtype(dtype).newbyteorder(">"))
    payload = be.tobytes()
    payload += b"\x00" * ((-len(payload)) % 2880)
    with open(name, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)


def load_fits(name: str, dtype=np.float32):
    """Read a primary-HDU FITS file -> ((ncorr, nchan, nx, ny) array, header dict)."""
    with open(name, "rb") as f:
        raw = f.read()
    hdr = {}
    pos = 0
    end = False
    while not end:
        block = raw[pos : pos + 2880].decode("ascii", errors="replace")
        pos += 2880
        for i in range(0, 2880, 80):
            card = block[i : i + 80]
            key = card[:8].strip()
            if key == "END":
                end = True
                break
            if "=" not in card:
                continue
            val = card[10:]
            if "/" in val and not val.strip().startswith("'"):
                val = val.split("/")[0]
            hdr[key] = _parse_value(val)
    nax = hdr["NAXIS"]
    shape_fits = tuple(hdr[f"NAXIS{i}"] for i in range(1, nax + 1))
    bitpix = hdr["BITPIX"]
    np_dtype = {-32: ">f4", -64: ">f8", 8: "u1", 16: ">i2", 32: ">i4"}[bitpix]
    count = int(np.prod(shape_fits))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=pos)
    data = data.reshape(shape_fits[::-1])  # C order, slowest first
    while data.ndim < 4:
        data = data[None]
    data = np.transpose(data, (1, 0, 3, 2))
    return np.require(data, dtype=dtype, requirements="C"), hdr
