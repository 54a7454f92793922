"""Sign conventions and FFT sizes (copied from pfb_imaging_tpu/geometry.py).

Convention (the JAX package's, pinned there against an explicit DFT):

    vis[r, f] = sum_pix I[x, y] * exp(-2*pi*j * phase) / n
    phase = (su*u*l + sv*v*m - sw*w*(n - 1)) / lambda
    l(x)  = -l0 + (x - nx/2) * cellx
    m(y)  =  m0 + (y - ny/2) * celly
"""

from __future__ import annotations

import numpy as np


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
