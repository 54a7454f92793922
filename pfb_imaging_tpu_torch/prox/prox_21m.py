"""The production SARA prox with a signed band sum (port of
pfb_imaging_tpu/prox/prox_21m.py). Coefficient cubes are
(nband, nbasis, nymax, nxmax); ``weight`` is (nbasis, nymax, nxmax)."""

from __future__ import annotations

import torch


def prox_21m(v, lam, sigma: float = 1.0, weight=None):
    """prox of (lam/sigma)*||W .||_{21m} evaluated at v/sigma."""
    if weight is None:
        weight = torch.ones_like(v[0])
    vbisum = v.sum(0) / sigma
    absv = vbisum.abs()
    soft = torch.clamp(absv - lam * weight / sigma, min=0.0)
    pos = absv > 0
    ratio = torch.where(pos, soft / torch.where(pos, absv, torch.ones_like(absv)), torch.zeros_like(absv))
    return v * ratio[None] / sigma


def dual_update(vp, v, lam, sigma: float = 1.0, weight=None):
    """v = vtilde * min(1, lam*w / |sum_b vtilde|), vtilde = vp + sigma*v."""
    if weight is None:
        weight = torch.ones_like(v[0])
    vtilde = vp + sigma * v
    band_sum = vtilde.sum(0).abs()
    threshold = lam * weight
    safe = torch.where(band_sum > 0, band_sum, torch.ones_like(band_sum))
    scale = torch.where(band_sum > threshold, threshold / safe, torch.ones_like(band_sum))
    return vtilde * scale[None]
