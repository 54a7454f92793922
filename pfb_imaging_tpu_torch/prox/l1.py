"""Weighted l1 regulariser, ISTA's prior when psi is the identity (port of
pfb_imaging_tpu/prox/l1.py)."""

from __future__ import annotations

import torch

from ..ops import PsiOperator, require_protocol


class L1:
    """R(alpha) = ||W alpha||_1 over the coefficients of ``psi``."""

    def __init__(self, psi, nu: float = 1.0):
        require_protocol(psi, PsiOperator, "psi")
        self.psi = psi
        self.nu = nu
        self.weight = torch.ones((psi.nbasis, psi.nymax, psi.nxmax), dtype=psi.dtype, device=psi.device)

    @staticmethod
    def prox_fn(v, lam, sigma: float = 1.0, weight=1.0):
        """Soft threshold: prox_{(lam/sigma)||W .||_1}(v/sigma)."""
        vout = v / sigma
        thresh = (lam / sigma) * weight
        return torch.sign(vout) * torch.clamp(vout.abs() - thresh, min=0.0)

    def prox(self, v, lam, sigma: float = 1.0):
        return self.prox_fn(v, lam, sigma=sigma, weight=self.weight)

    @property
    def l1weight(self):
        return self.weight
