"""Spectral-index fitting over imaging bands (a copy of
pfb_imaging_tpu/models/spi.py, numpy on the host): weighted log-space least
squares of I(nu) = I0 (nu/nu0)^alpha per component.
"""

from __future__ import annotations

import numpy as np


def fit_spi_components(data, weights, freqs, ref_freq, tol: float = 1e-8, maxiter: int = 100):
    """Fit (alpha, I0) per component.

    Args:
        data: (ncomp, nfreq) positive fluxes.
        weights: (ncomp, nfreq) or (nfreq,).
        freqs: (nfreq,), ref_freq: scalar.

    Returns:
        (alpha, alpha_err, i0, i0_err) arrays of shape (ncomp,).
    """
    data = np.asarray(data, dtype=float)
    ncomp, nfreq = data.shape
    w = np.broadcast_to(np.asarray(weights, dtype=float), data.shape).copy()
    x = np.log(np.asarray(freqs, dtype=float) / ref_freq)

    good = data > 0
    w = np.where(good, w, 0.0)
    logd = np.where(good, np.log(np.where(good, data, 1.0)), 0.0)

    alpha = np.zeros(ncomp)
    i0 = np.zeros(ncomp)
    alpha_err = np.zeros(ncomp)
    i0_err = np.zeros(ncomp)
    for c in range(ncomp):
        wc = w[c]
        sw = wc.sum()
        if sw == 0 or (wc > 0).sum() < 2:
            alpha[c] = np.nan
            i0[c] = np.nan
            continue
        xm = (wc * x).sum() / sw
        ym = (wc * logd[c]).sum() / sw
        sxx = (wc * (x - xm) ** 2).sum()
        sxy = (wc * (x - xm) * (logd[c] - ym)).sum()
        a = sxy / sxx
        b = ym - a * xm
        alpha[c] = a
        i0[c] = np.exp(b)
        alpha_err[c] = np.sqrt(1.0 / sxx)
        i0_err[c] = i0[c] * np.sqrt(1.0 / sw + xm**2 / sxx)
    return alpha, alpha_err, i0, i0_err
