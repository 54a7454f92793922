"""The production SARA prox with a signed band sum (port of
pfb_imaging_tpu/prox/prox_21m.py). Coefficient cubes are
(nband, nbasis, nymax, nxmax); ``weight`` is (nbasis, nymax, nxmax). The
band sum is the only coupling between bands in the backward step: under a
band mesh (``mesh``) the cube is this rank's band slice, and the sum
gathers every band over the band group and adds them in band order
(``parallel.mesh.band_sum``)."""

from __future__ import annotations

import torch

from ..parallel.mesh import band_sum


def prox_21m(v, lam, sigma: float = 1.0, weight=None, *, mesh=None):
    """prox of (lam/sigma)*||W .||_{21m} evaluated at v/sigma."""
    if weight is None:
        weight = torch.ones_like(v[0])
    vbisum = band_sum(v, mesh) / sigma
    absv = vbisum.abs()
    soft = torch.clamp(absv - lam * weight / sigma, min=0.0)
    pos = absv > 0
    ratio = torch.where(pos, soft / torch.where(pos, absv, torch.ones_like(absv)), torch.zeros_like(absv))
    return v * ratio[None] / sigma


def dual_update(vp, v, lam, sigma: float = 1.0, weight=None, *, mesh=None):
    """v = vtilde * min(1, lam*w / |sum_b vtilde|), vtilde = vp + sigma*v."""
    if weight is None:
        weight = torch.ones_like(v[0])
    vtilde = vp + sigma * v
    vsum = band_sum(vtilde, mesh).abs()
    threshold = lam * weight
    safe = torch.where(vsum > 0, vsum, torch.ones_like(vsum))
    scale = torch.where(vsum > threshold, threshold / safe, torch.ones_like(vsum))
    return vtilde * scale[None]
