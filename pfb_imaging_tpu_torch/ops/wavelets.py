"""Daubechies wavelet transforms for the SARA dictionary (port of
pfb_imaging_tpu/ops/wavelets.py).

Analysis is ``conv1d`` (cross-correlation with the reversed decomposition
filters, stride 2, zero-extension ``(k-2, 2c-n)``); synthesis is its exact
transpose, ``conv_transpose1d`` with the reconstruction filters, stride 2
and padding ``k-2`` — the same index bookkeeping as the JAX
``conv_general_dilated`` pair, so synthesis is the exact adjoint and left
inverse of analysis. Batch axes (bands, rows) ride the conv batch axis.

The filter banks are numpy, copied verbatim from the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb

import numpy as np
import torch
import torch.nn.functional as F

from .. import to_device


def coeff_size(nsignal: int, nfilter: int) -> int:
    return (nsignal + nfilter - 1) // 2


def signal_size(ncoeff: int, nfilter: int) -> int:
    return 2 * ncoeff - nfilter + 2


def dwt_max_level(n: int, filter_len: int) -> int:
    if filter_len <= 1 or n < filter_len - 1:
        return 0
    return int(np.log2(n / (filter_len - 1.0)))


@lru_cache(maxsize=None)
def daubechies(p: int) -> np.ndarray:
    """Minimal-phase Daubechies scaling filter with p vanishing moments
    (length 2p), normalised to sum sqrt(2). db1 == Haar.

    Spectral factorisation: the half-band polynomial
    P(y) = sum_k C(p-1+k, k) y^k with y = (2 - z - 1/z)/4; keep the z-roots
    inside the unit circle and multiply by (1+z)^p.
    """
    if p == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    coeffs = [comb(p - 1 + k, k) for k in range(p)]
    yroots = np.roots(list(reversed(coeffs)))
    zroots = []
    for y in yroots:
        b = 2.0 - 4.0 * y
        disc = np.sqrt(b * b - 4.0 + 0j)
        z1 = (b + disc) / 2.0
        z2 = (b - disc) / 2.0
        zroots.append(z1 if abs(z1) < 1 else z2)
    poly = np.poly1d([1.0])
    for _ in range(p):
        poly = poly * np.poly1d([1.0, 1.0])
    for z in zroots:
        poly = poly * np.poly1d([1.0, -z])
    h = np.real(poly.coeffs)
    h = h / h.sum() * np.sqrt(2.0)
    return h


@lru_cache(maxsize=None)
def filter_bank(base: str):
    """(dec_lo, dec_hi, rec_lo, rec_hi) for 'dbN', PyWavelets conventions:
    rec_lo = scaling filter h; dec_lo = reverse(rec_lo);
    rec_hi[n] = (-1)^n dec_lo[n]; dec_hi = reverse(rec_hi)."""
    if not base.startswith("db"):
        raise ValueError(f"Unknown wavelet base {base!r} (only dbN supported)")
    p = int(base[2:])
    h = daubechies(p)
    rec_lo = h
    dec_lo = rec_lo[::-1].copy()
    signs = (-1.0) ** np.arange(2 * p)
    rec_hi = signs * dec_lo
    dec_hi = rec_hi[::-1].copy()
    return dec_lo, dec_hi, rec_lo, rec_hi


# ── 1D building blocks (along the last axis) ─────────────────────────


def dwt1d(x: torch.Tensor, dec: torch.Tensor):
    """One analysis level along the last axis.

    ``dec`` is the (2, 1, k) conv weight ``stack([dec_lo, dec_hi])`` reversed
    along k. x: (..., n) -> (ca, cd) each (..., c), c = (n + k - 1)//2;
    out[o] = sum_j f[j] * x[2o + 1 - j] over the zero-extended signal.
    """
    k = dec.shape[-1]
    n = x.shape[-1]
    c = coeff_size(n, k)
    batch = x.shape[:-1]
    lhs = F.pad(x.reshape(-1, 1, n), (k - 2, 2 * c - n))
    out = F.conv1d(lhs, dec, stride=2).reshape(*batch, 2, c)
    return out[..., 0, :], out[..., 1, :]


def idwt1d(ca: torch.Tensor, cd: torch.Tensor, rec: torch.Tensor):
    """One synthesis level: the exact transpose (and left inverse) of
    :func:`dwt1d`. ``rec`` is the (2, 1, k) weight ``stack([rec_lo, rec_hi])``.
    (..., c) -> (..., 2c - k + 2)."""
    k = rec.shape[-1]
    c = ca.shape[-1]
    batch = ca.shape[:-1]
    lhs = torch.stack([ca, cd], dim=-2).reshape(-1, 2, c)
    out = F.conv_transpose1d(lhs, rec, stride=2, padding=k - 2)
    return out.reshape(*batch, signal_size(c, k))


def conv_weights(base: str, device, dtype):
    """(dec, rec) conv weights of basis ``base`` on ``device``."""
    dec_lo, dec_hi, rec_lo, rec_hi = filter_bank(base)
    dec = np.stack([dec_lo[::-1], dec_hi[::-1]])[:, None, :]
    rec = np.stack([rec_lo, rec_hi])[:, None, :]
    return to_device(dec, device, dtype), to_device(rec, device, dtype)


# ── 2D level transforms (x-major layout, leading batch axes) ─────────


def dwt2d_level(image: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """(..., nx, ny) -> (..., 2cx, 2cy) laid out [[LL, LH], [HL, HH]]."""
    la, ld = dwt1d(image, dec)
    row = torch.cat([la, ld], dim=-1)  # (..., nx, 2cy)
    ca, cd = dwt1d(row.transpose(-1, -2), dec)  # each (..., 2cy, cx)
    return torch.cat([ca, cd], dim=-1).transpose(-1, -2)


def idwt2d_level(block: torch.Tensor, rec: torch.Tensor, nx_out: int, ny_out: int) -> torch.Tensor:
    """Inverse of :func:`dwt2d_level`, cropped to (nx_out, ny_out)."""
    cx, cy = block.shape[-2] // 2, block.shape[-1] // 2
    t = block.transpose(-1, -2)
    x = idwt1d(t[..., :cx], t[..., cx:], rec)
    x = x[..., :nx_out].transpose(-1, -2)
    y = idwt1d(x[..., :cy], x[..., cy:], rec)
    return y[..., :ny_out]
