"""l2,1 prox with a true l2 norm over the band axis (port of
pfb_imaging_tpu/prox/prox_21.py), beside the production signed-sum
``prox_21m``."""

from __future__ import annotations

import torch


def prox_21(v, lam, sigma: float = 1.0, weight=None):
    """prox of (lam/sigma)*||W .||_{2,1} at v/sigma."""
    if weight is None:
        weight = torch.ones_like(v[0])
    l2 = torch.sqrt((v * v).sum(0)) / sigma
    soft = torch.clamp(l2 - lam * weight / sigma, min=0.0)
    pos = l2 > 0
    ratio = torch.where(pos, soft / torch.where(pos, l2, torch.ones_like(l2)), torch.zeros_like(l2))
    return v * ratio[None] / sigma


def dual_update_21(vp, v, lam, sigma: float = 1.0, weight=None):
    """Moreau dual update for the 2,1 norm: vtilde - sigma*prox(vtilde/sigma)."""
    if weight is None:
        weight = torch.ones_like(v[0])
    vtilde = vp + sigma * v
    return vtilde - sigma * prox_21(vtilde, lam, sigma=sigma, weight=weight)
