"""The port's DS9 / CRTF region parser (``utils/regions.py``) against the
JAX copy on every case of ``tests/test_regions.py``, masks compared exactly,
and the one repair: DS9 lines that hold a frame prefix or several regions
(``fk5; circle(...)``), which the JAX copy drops."""

import dataclasses

import numpy as np
import pytest

from pfb_imaging_tpu.utils import regions as JR
from pfb_imaging_tpu_torch.utils import regions as TR

ARCSEC = np.deg2rad(1.0 / 3600.0)
RA0, DEC0 = np.deg2rad(30.0), np.deg2rad(-45.0)
RA_S, DEC_S = np.deg2rad(15.0 * (12 + 30 / 60 + 30 / 3600)), np.deg2rad(-(12 + 20 / 60 + 15 / 3600))
_OFF = 10.0 / 3600.0 / np.cos(DEC0)

# (text, nx, ny, cell_rad, radec): the cases of tests/test_regions.py
CASES = {
    "image_circle": ("# Region file format: DS9 version 4.1\nglobal color=green dashlist=8 3\nimage\n"
                     "circle(17,9,3)\n", 32, 32, 1.0, None),
    "box_ellipse": ("image\nbox(16,16,10,4,0)\nellipse(40,16,8,3,90)\n", 64, 32, 1.0, None),
    "polygon": ("image\npolygon(5,5,15,5,15,15,5,15)\n", 20, 20, 1.0, None),
    "exclusion": ("image\ncircle(16,16,8)\n-circle(16,16,3)\n", 32, 32, 1.0, None),
    "fk5_circles": (f"fk5\ncircle({np.rad2deg(RA0)},{np.rad2deg(DEC0)},3\")\n"
                    f"circle({np.rad2deg(RA0) + _OFF},{np.rad2deg(DEC0)},3\")\n", 64, 64, ARCSEC, (RA0, DEC0)),
    "sexagesimal": ('fk5\ncircle(12:30:30,-12:20:15,5")\n', 64, 64, ARCSEC, (RA_S, DEC_S)),
    "crtf_circle": ("#CRTFv0\ncircle[[17pix, 9pix], 3pix]\n", 32, 32, 1.0, None),
    "crtf_box": ("#CRTFv0\nbox[[5pix, 5pix], [15pix, 11pix]]\n", 32, 32, 1.0, None),
    "crtf_ellipse": ("#CRTFv0\nellipse[[17pix, 17pix], [6pix, 3pix], 0]\n", 32, 32, 1.0, None),
    "multiframe": ("# Region file format: DS9\nglobal width=2\nimage\ncircle(8,8,2)\nimage\nbox(24,24,4,4,0)\n",
                   32, 32, 1.0, None),
}


@pytest.mark.parametrize("case", CASES)
def test_masks_match_jax(case):
    text, nx, ny, cell, radec = CASES[case]
    mt = TR.region_masks(text, nx, ny, cell, radec=radec)
    mj = JR.region_masks(text, nx, ny, cell, radec=radec)
    assert len(mt) == len(mj) >= 1
    for a, b in zip(mt, mj):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    fields = lambda regs: [dataclasses.astuple(r) for r in regs]  # noqa: E731
    assert fields(TR.parse_regions(text)) == fields(JR.parse_regions(text))


def test_frame_prefix_line_is_parsed():
    """``fk5; circle(...)`` gives the mask of the same circle under an
    ``fk5`` line; the JAX copy finds no region in it."""
    one_line = f'fk5; circle({np.rad2deg(RA0)},{np.rad2deg(DEC0)},3")\n'
    two_lines = f'fk5\ncircle({np.rad2deg(RA0)},{np.rad2deg(DEC0)},3")\n'
    (m,) = TR.region_masks(one_line, 64, 64, ARCSEC, radec=(RA0, DEC0))
    (ref,) = TR.region_masks(two_lines, 64, 64, ARCSEC, radec=(RA0, DEC0))
    assert m.sum() > 0 and np.array_equal(m, ref)
    assert np.allclose(np.array(np.nonzero(m)).mean(axis=1), [32.0, 32.0], atol=0.6)
    assert JR.parse_regions(one_line) == []


def test_several_regions_on_one_line():
    text = "image; circle(8,8,2); box(24,24,4,4,0);\n-circle(8,8,1)\n"
    m1, m2 = TR.region_masks(text, 32, 32, 1.0)
    ref1, ref2 = TR.region_masks("image\ncircle(8,8,2)\nbox(24,24,4,4,0)\n-circle(8,8,1)\n", 32, 32, 1.0)
    assert np.array_equal(m1, ref1) and np.array_equal(m2, ref2)
    assert m1[7, 7] == 0.0 and m1[7, 9] == 1.0 and m2[23, 23] == 1.0


def test_sky_frame_without_radec_raises():
    with pytest.raises(ValueError, match="radec"):
        TR.region_masks("fk5; circle(30,-45,3\")\n", 32, 32, 1.0, radec=None)
