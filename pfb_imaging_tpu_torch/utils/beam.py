"""Primary-beam interpolation onto the image grid (the port's copy of
``interp_beam`` from pfb_imaging_tpu/utils/beam.py). The analytic beam
models used at ingest are not ported yet (ROADMAP.md, queue A: init and
simulate)."""

from __future__ import annotations

import numpy as np


def interp_beam(beam_small, l_small, m_small, l_image, m_image):
    """Linear regular-grid interpolation of a small-grid beam at the image
    points (l_image, m_image); zero outside the small grid."""
    from scipy.interpolate import RegularGridInterpolator

    interp = RegularGridInterpolator((l_small, m_small), beam_small, bounds_error=False, fill_value=0.0,
                                     method="linear")
    pts = np.stack(np.broadcast_arrays(l_image, m_image), axis=-1)
    return interp(pts)
