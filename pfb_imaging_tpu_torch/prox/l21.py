"""Weighted l2,1 regulariser over a wavelet dictionary — the SARA prior
(port of pfb_imaging_tpu/prox/l21.py). Owns the l1-reweighting state.

Design D3 holds: ``nu`` is the squared frame bound ||Psi Psi^T|| = nbasis
for the SARA concatenation of orthonormal bases; presets pass
``nu=len(bases)``. Under a band mesh (``mesh``) ``psi`` spans this rank's
band slice, and every sum over the bands (the dual update's, the
reweighting's) is reduced over the band group.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..ops import PsiOperator, require_protocol
from ..parallel.mesh import band_sum
from .prox_21m import dual_update as _dual_update
from .prox_21m import prox_21m as _prox_21m


def l1reweight_func(mcomps, rmsfactor, rms_comps, alpha=4):
    """(1 + rmsfactor) / (1 + (|mcomps|/rms)^alpha)."""
    rms = torch.as_tensor(rms_comps, dtype=mcomps.dtype, device=mcomps.device)
    if rms.ndim == 1:
        rms = rms[:, None, None]
    return (1.0 + rmsfactor) / (1.0 + mcomps.abs() ** alpha / rms**alpha)


class L21:
    """R(x) = ||W Psi^T x||_{21m} over ``psi`` (a Psi on some device);
    ``bases`` names its bases (kept for the log, as in JAX)."""

    def __init__(self, psi, bases, nu: float = 1.0, rmsfactor: float = 1.0, alpha: float = 2.0, *, mesh=None):
        require_protocol(psi, PsiOperator, "psi")
        self.psi = psi
        self.mesh = mesh
        self.nu = nu
        self.bases = tuple(bases)
        self.rmsfactor = rmsfactor
        self.alpha = alpha
        self.l1weight = torch.ones((psi.nbasis, psi.nymax, psi.nxmax), dtype=psi.dtype, device=psi.device)
        self._rms_comps = None

    @property
    def prox_fn(self):
        return _prox_21m if self.mesh is None else partial(_prox_21m, mesh=self.mesh)

    @property
    def dual_update_fn(self):
        return _dual_update if self.mesh is None else partial(_dual_update, mesh=self.mesh)

    def prox(self, v, lam, sigma: float = 1.0):
        """prox_{(lam/sigma)||W .||_{21m}}(v/sigma)."""
        return self.prox_fn(v, lam, sigma=sigma, weight=self.l1weight)

    @property
    def reweight_active(self) -> bool:
        return self._rms_comps is not None

    def init_reweighting(self, update):
        """Per-basis rms of the update's nonzero coefficients; arms reweighting."""
        coeffs = band_sum(self.psi.dot(update), self.mesh).cpu().numpy()
        rms_comps = np.ones(self.psi.nbasis)
        for i in range(self.psi.nbasis):
            nonzero = coeffs[i][coeffs[i] != 0]
            if nonzero.size:
                rms_comps[i] = np.std(nonzero)
        self._rms_comps = rms_comps

    def update_weights(self, x):
        """Recompute l1 weights from the current iterate."""
        mcomps = band_sum(self.psi.dot(x), self.mesh).abs()
        self.l1weight = l1reweight_func(mcomps, self.rmsfactor, self._rms_comps, self.alpha)
