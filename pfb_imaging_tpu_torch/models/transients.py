"""Synthetic transient dynamic spectra for injection into high-cadence
imaging (port of pfb_imaging_tpu/models/transients.py; numpy, host side)."""

from __future__ import annotations

import numpy as np


def transient_spectrum(times, freqs, kind: str = "gaussian", t0: float | None = None, width: float | None = None,
                       amplitude: float = 1.0, spectral_index: float = 0.0, ref_freq: float | None = None,
                       period: float | None = None):
    """(ntime, nfreq) dynamic spectrum of one transient source."""
    times = np.asarray(times, dtype=float)
    freqs = np.asarray(freqs, dtype=float)
    t0 = times.mean() if t0 is None else t0
    width = (times.max() - times.min()) / 10 or 1.0 if width is None else width
    ref_freq = freqs.mean() if ref_freq is None else ref_freq

    if kind == "gaussian":
        profile = np.exp(-0.5 * ((times - t0) / width) ** 2)
    elif kind == "exponential":
        profile = np.where(times >= t0, np.exp(-(times - t0) / width), 0.0)
    elif kind == "step":
        profile = (times >= t0).astype(float)
    elif kind == "periodic":
        period = width * 4 if period is None else period
        profile = 0.5 * (1 + np.cos(2 * np.pi * (times - t0) / period))
    else:
        raise ValueError(f"Unknown transient kind {kind}")
    spectrum = (freqs / ref_freq) ** spectral_index
    return amplitude * np.outer(profile, spectrum)
