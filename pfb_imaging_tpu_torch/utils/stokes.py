"""Stokes -> correlation maps (numpy; port of the degrid half of
pfb_imaging_tpu/utils/stokes.py): the feed brightness maps and
``stokes_to_corr``, which renders Stokes model visibilities into instrument
correlations. ``weight_data`` and the Jones helpers belong to ``init`` and
are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import numpy as np

# brightness maps: v_c = sum_s T[c, s] * S_s with S ordered (I, Q, U, V)
_T_LINEAR = np.array(
    [
        [1, 1, 0, 0],  # XX = I + Q
        [0, 0, 1, 1j],  # XY = U + iV
        [0, 0, 1, -1j],  # YX = U - iV
        [1, -1, 0, 0],  # YY = I - Q
    ],
    dtype=np.complex128,
)
_T_CIRCULAR = np.array(
    [
        [1, 0, 0, 1],  # RR = I + V
        [0, 1, 1j, 0],  # RL = Q + iU
        [0, 1, -1j, 0],  # LR = Q - iU
        [1, 0, 0, -1],  # LL = I - V
    ],
    dtype=np.complex128,
)
_STOKES_IDX = {"I": 0, "Q": 1, "U": 2, "V": 3}


def brightness_map(feed_type: str, ncorr: int) -> np.ndarray:
    """T (ncorr, 4); 2-corr data carries the diagonal correlations only."""
    T = _T_LINEAR if feed_type.lower() == "linear" else _T_CIRCULAR
    if ncorr == 4:
        return T
    if ncorr == 2:
        return T[[0, 3]]
    if ncorr == 1:
        return T[[0]]
    raise ValueError(f"Unsupported ncorr {ncorr}")


def stokes_to_corr(stokes_vis: np.ndarray, feed_type: str = "linear", ncorr: int = 4) -> np.ndarray:
    """Map (4, nrow, nchan) Stokes visibilities (I, Q, U, V) to (ncorr, nrow,
    nchan) correlations, on the host where ``degrid`` assembles them."""
    return np.einsum("cs,s...->c...", brightness_map(feed_type, ncorr), stokes_vis)
