"""Self-contained DS9 / CRTF region-file reader (a copy of
pfb_imaging_tpu/utils/regions.py, with one repair: a DS9 line that holds a
frame prefix or several regions, such as ``fk5; circle(...)``, is split on
``;``; the JAX copy drops such lines).

The reference consumes standard region files through ``regions.Regions.read``
(reference core/degrid.py:17,203); without astropy-regions, this module
parses the two formats astronomers actually ship — DS9 (``circle(x,y,r)`` /
``box`` / ``ellipse`` / ``polygon`` in ``image``, ``physical`` or
``fk5``/``icrs``/``j2000`` frames) and the basic CRTF shapes — and
rasterises them onto the model image grid.

Pixel conventions match this package's FITS writer (utils/fits.py):
image arrays are (nx, ny) with axis 0 = FITS axis 1 = RA (CDELT1 < 0,
CRPIX1 = 1 + nx//2) and axis 1 = FITS axis 2 = Dec. DS9 image coordinates
are 1-based with x along FITS axis 1, so DS9 (x, y) -> array (x-1, y-1).
Sky coordinates project through the same SIN (orthographic) WCS the FITS
headers declare.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

_SKY_FRAMES = {"fk5", "icrs", "j2000", "fk4", "galactic", "wcs"}
_PIX_FRAMES = {"image", "physical"}
_SHAPES = ("circle", "ellipse", "box", "polygon", "point")


@dataclasses.dataclass
class Region:
    shape: str  # circle | ellipse | box | polygon
    frame: str  # "image" (pixels, 1-based) or "sky" (radians)
    params: tuple  # shape-specific, see _mask_one
    exclude: bool = False


def _angle_value(tok: str, frame: str, *, is_radius: bool, is_ra: bool = False) -> float:
    """One coordinate/size token -> pixels-1-based-agnostic raw value.

    Returns pixels for pixel frames, RADIANS for sky frames. Handles DS9
    unit suffixes (" ' d r p i) and sexagesimal hh:mm:ss / dd:mm:ss as
    well as CRTF units (deg, arcmin, arcsec, rad, pix).
    """
    tok = tok.strip()
    m = re.fullmatch(r"([+-]?[\d.]+(?:[eE][+-]?\d+)?)\s*(deg|arcmin|arcsec|rad|pix|[\"'drpi]?)", tok)
    if m:
        val, unit = float(m.group(1)), m.group(2)
        if unit in ('"', "arcsec"):
            return np.deg2rad(val / 3600.0)
        if unit in ("'", "arcmin"):
            return np.deg2rad(val / 60.0)
        if unit in ("d", "deg"):
            return np.deg2rad(val)
        if unit in ("r", "rad"):
            return val
        if unit in ("p", "i", "pix"):
            return val  # pixels
        # bare number: pixels in pixel frames, degrees in sky frames
        if frame in _PIX_FRAMES:
            return val
        return np.deg2rad(val)
    # sexagesimal: 12:30:49.4 (hours for RA positions, degrees otherwise)
    # or 12h30m49.4s / +12d23m28s
    m = re.fullmatch(r"([+-]?)(\d+)[:h](\d+)[:m]([\d.]+)s?", tok)
    if m:
        sign = -1.0 if m.group(1) == "-" else 1.0
        v = float(m.group(2)) + float(m.group(3)) / 60.0 + float(m.group(4)) / 3600.0
        is_hours = "h" in tok or (is_ra and ":" in tok)
        return sign * np.deg2rad(v * (15.0 if is_hours else 1.0))
    m = re.fullmatch(r"([+-]?)(\d+)d(\d+)m([\d.]+)s?", tok)
    if m:
        sign = -1.0 if m.group(1) == "-" else 1.0
        v = float(m.group(2)) + float(m.group(3)) / 60.0 + float(m.group(4)) / 3600.0
        return sign * np.deg2rad(v)
    raise ValueError(f"cannot parse region coordinate {tok!r}")


def _parse_ds9(text: str) -> list[Region]:
    frame = "physical"  # DS9's default when no frame line appears
    out = []
    for raw in text.splitlines():
        # a line may hold a frame prefix and several regions: "fk5; circle(...)"
        for line in raw.split("#", 1)[0].split(";"):
            line = line.strip()
            if not line or line.startswith("global"):
                continue
            low = line.lower()
            if low in _SKY_FRAMES or low in _PIX_FRAMES:
                frame = low
                continue
            exclude = line.startswith("-")
            if exclude:
                line = line[1:].strip()
            m = re.match(r"([a-zA-Z]+)\s*\(([^)]*)\)", line)
            if not m:
                continue
            shape = m.group(1).lower()
            if shape not in _SHAPES:
                raise ValueError(f"unsupported DS9 region shape {shape!r}")
            toks = [t for t in m.group(2).split(",") if t.strip()]
            fr = "sky" if frame in _SKY_FRAMES else "image"
            out.append(Region(shape, fr, _shape_params(shape, toks, frame), exclude))
    return out


def _parse_crtf(text: str) -> list[Region]:
    """Basic CRTF: circle[[x, y], r] / box[[x1,y1],[x2,y2]] /
    ellipse[[x, y], [a, b], pa] with coordinate frame from 'coord=' or
    implicit J2000; 'pix' suffixed values are pixels."""
    out = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        exclude = line.startswith("-")
        if exclude:
            line = line[1:]
        m = re.match(r"(ann\s+)?([a-zA-Z]+)\s*\[(.*)\]\s*(?:,\s*coord=(\w+))?", line)
        if not m:
            continue
        shape = m.group(2).lower()
        if shape == "centerbox":
            shape = "box"
        if shape not in _SHAPES:
            raise ValueError(f"unsupported CRTF region shape {shape!r}")
        body = m.group(3)
        # tokens are either [a, b] pairs or scalars
        toks = re.findall(r"\[([^\[\]]*)\]|([^,\[\]]+)", body)
        flat = []
        for pair, scal in toks:
            if pair:
                flat.extend(t.strip() for t in pair.split(","))
            elif scal.strip():
                flat.append(scal.strip())
        frame = "image" if all(t.endswith("pix") for t in flat[:2]) else "fk5"
        fr = "image" if frame == "image" else "sky"
        if shape == "box":
            # CRTF box is corner-to-corner; convert to centre/size form
            x1 = _angle_value(flat[0], frame, is_radius=False, is_ra=fr == "sky")
            y1 = _angle_value(flat[1], frame, is_radius=False)
            x2 = _angle_value(flat[2], frame, is_radius=False, is_ra=fr == "sky")
            y2 = _angle_value(flat[3], frame, is_radius=False)
            params = ((x1 + x2) / 2, (y1 + y2) / 2, abs(x2 - x1), abs(y2 - y1), 0.0)
            out.append(Region("box", fr, params, exclude))
        else:
            out.append(Region(shape, fr, _shape_params(shape, flat, frame), exclude))
    return out


def _shape_params(shape: str, toks: list, frame: str) -> tuple:
    sky = frame in _SKY_FRAMES
    cx = _angle_value(toks[0], frame, is_radius=False, is_ra=sky)
    cy = _angle_value(toks[1], frame, is_radius=False)
    rest = toks[2:]
    if shape == "circle":
        return (cx, cy, _angle_value(rest[0], frame, is_radius=True))
    if shape == "ellipse":
        a = _angle_value(rest[0], frame, is_radius=True)
        b = _angle_value(rest[1], frame, is_radius=True)
        ang = float(rest[2]) if len(rest) > 2 else 0.0
        return (cx, cy, a, b, ang)
    if shape == "box":
        w = _angle_value(rest[0], frame, is_radius=True)
        h = _angle_value(rest[1], frame, is_radius=True)
        ang = float(rest[2]) if len(rest) > 2 else 0.0
        return (cx, cy, w, h, ang)
    if shape == "polygon":
        vals = [cx, cy]
        for i, t in enumerate(rest):
            vals.append(_angle_value(t, frame, is_radius=False, is_ra=sky and i % 2 == 0))
        return tuple(vals)
    if shape == "point":
        return (cx, cy)
    raise ValueError(shape)


def parse_regions(path_or_text: str) -> list[Region]:
    """Parse a DS9 or CRTF region file (path or literal text)."""
    try:
        with open(path_or_text) as f:
            text = f.read()
    except OSError:
        text = path_or_text
    if text.lstrip().lower().startswith("#crtf"):
        return _parse_crtf(text)
    return _parse_ds9(text)


def _sky_to_pix(ra, dec, nx, ny, cell_rad, radec):
    """SIN-projection sky->0-based array indices, matching utils/fits.set_wcs
    (CRPIX = 1 + n//2, CDELT1 = -cell, CDELT2 = +cell)."""
    ra0, dec0 = radec
    dra = np.asarray(ra) - ra0
    xp = np.cos(dec) * np.sin(dra)  # standard SIN x (east positive), rad
    yp = np.sin(dec) * np.cos(dec0) - np.cos(dec) * np.sin(dec0) * np.cos(dra)
    i0 = nx // 2 - xp / cell_rad  # CDELT1 < 0: east = decreasing axis-0 index
    i1 = ny // 2 + yp / cell_rad
    return i0, i1


def _region_pix(reg: Region, nx, ny, cell_rad, radec):
    """Region -> pixel-space params (0-based array indices, pixel sizes,
    angle CCW from array axis 0)."""
    if reg.frame == "image":
        p = reg.params
        if reg.shape == "polygon":
            pix = [v - 1.0 for v in p]
            return reg.shape, tuple(pix)
        cx, cy = p[0] - 1.0, p[1] - 1.0
        rest = tuple(p[2:])
        return reg.shape, (cx, cy) + rest
    if radec is None:
        raise ValueError(
            "sky-frame region needs the image phase centre (radec) to project"
        )
    p = reg.params
    if reg.shape == "polygon":
        xs, ys = _sky_to_pix(np.array(p[0::2]), np.array(p[1::2]), nx, ny, cell_rad, radec)
        return reg.shape, tuple(v for xy in zip(xs, ys) for v in xy)
    cx, cy = _sky_to_pix(p[0], p[1], nx, ny, cell_rad, radec)
    if reg.shape == "circle":
        return reg.shape, (float(cx), float(cy), p[2] / cell_rad)
    if reg.shape == "point":
        return reg.shape, (float(cx), float(cy))
    # ellipse / box: sizes to pixels; sky position angle theta (east of
    # north) -> array angle alpha = theta + 90 deg (east = -axis0,
    # north = +axis1)
    a, b, ang = p[2] / cell_rad, p[3] / cell_rad, p[4] + 90.0
    return reg.shape, (float(cx), float(cy), a, b, ang)


def _mask_one(shape, params, nx, ny):
    X, Y = np.meshgrid(np.arange(nx, dtype=np.float64), np.arange(ny, dtype=np.float64),
                       indexing="ij")
    if shape == "circle":
        cx, cy, r = params
        return (X - cx) ** 2 + (Y - cy) ** 2 <= r * r
    if shape == "point":
        cx, cy = params
        m = np.zeros((nx, ny), bool)
        ix, iy = int(round(cx)), int(round(cy))
        if 0 <= ix < nx and 0 <= iy < ny:
            m[ix, iy] = True
        return m
    if shape in ("ellipse", "box"):
        cx, cy, a, b, ang = params
        t = np.deg2rad(ang)
        xr = (X - cx) * np.cos(t) + (Y - cy) * np.sin(t)
        yr = -(X - cx) * np.sin(t) + (Y - cy) * np.cos(t)
        if shape == "ellipse":
            return (xr / max(a, 1e-12)) ** 2 + (yr / max(b, 1e-12)) ** 2 <= 1.0
        return (np.abs(xr) <= a / 2) & (np.abs(yr) <= b / 2)
    if shape == "polygon":
        xs = np.asarray(params[0::2])
        ys = np.asarray(params[1::2])
        # even-odd rule, vectorised over the grid
        inside = np.zeros((nx, ny), bool)
        j = len(xs) - 1
        for i in range(len(xs)):
            cond = (ys[i] > Y) != (ys[j] > Y)
            denom = np.where(ys[j] == ys[i], 1.0, ys[j] - ys[i])
            xint = xs[i] + (Y - ys[i]) / denom * (xs[j] - xs[i])
            inside ^= cond & (X < xint)
            j = i
        return inside
    raise ValueError(shape)


def region_masks(path_or_text: str, nx: int, ny: int, cell_rad: float,
                 radec=None) -> list[np.ndarray]:
    """Rasterise each (non-excluded) region of a DS9/CRTF file to a {0,1}
    mask on the (nx, ny) image grid. ``-`` exclusion regions subtract from
    every mask (DS9 semantics)."""
    regs = parse_regions(path_or_text)
    incl = [r for r in regs if not r.exclude]
    excl = [r for r in regs if r.exclude]
    if not incl:
        raise ValueError("no regions found")
    masks = [
        _mask_one(*_region_pix(r, nx, ny, cell_rad, radec), nx, ny).astype(np.float64)
        for r in incl
    ]
    for r in excl:
        em = _mask_one(*_region_pix(r, nx, ny, cell_rad, radec), nx, ny)
        masks = [np.where(em, 0.0, m) for m in masks]
    return masks
