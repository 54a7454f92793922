"""Gaussian-process covariance operator with Kronecker fast paths (port of
pfb_imaging_tpu/ops/gauss.py).

K = K_f (x) K_l (x) K_m with squared-exponential factors; a matvec costs
O(N sum n_i) instead of O(N^2) by the Kronecker identity, one
``torch.tensordot`` per axis. The factors and their Cholesky factors are
formed on the host in f64, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import real_dtype, resolve_device, to_device


def expsq(x, xp, sigma_f: float, length: float):
    """Squared-exponential kernel matrix (numpy)."""
    d2 = (np.asarray(x)[:, None] - np.asarray(xp)[None, :]) ** 2
    return sigma_f**2 * np.exp(-d2 / (2 * length**2))


def kron_matvec(mats, x):
    """(kron_i A_i) vec(x) for square factors A_i (numpy or tensors).

    x has shape (n_0, n_1, ..., n_{k-1}) matching the factor sizes.
    """
    out = x
    for i, a in enumerate(mats):
        a = torch.as_tensor(a).to(device=x.device, dtype=x.dtype)
        # contract factor i against its axis, keep axis order
        out = torch.movedim(torch.tensordot(a, out, dims=([1], [i])), 0, i)
    return out


class Gauss:
    """GP prior operator over (nband, nx, ny) cubes on ``device``."""

    def __init__(self, freqs, xcoords, ycoords, sigma_f=1.0, lf=1.0, lx=1.0, ly=1.0, jitter=1e-10, *, device="cuda"):
        self.kf = expsq(freqs, freqs, sigma_f, lf) + jitter * np.eye(len(freqs))
        self.kx = expsq(xcoords, xcoords, 1.0, lx) + jitter * np.eye(len(xcoords))
        self.ky = expsq(ycoords, ycoords, 1.0, ly) + jitter * np.eye(len(ycoords))
        self.device = resolve_device(device)
        rdt = real_dtype(self.device)
        self._k = tuple(to_device(k, self.device, rdt) for k in (self.kf, self.kx, self.ky))
        self._chols = None

    def dot(self, x):
        return kron_matvec(self._k, x)

    def hdot(self, x):
        return self.dot(x)  # symmetric

    def sqrtdot(self, x):
        """L x with K = L L^T (Kronecker of Cholesky factors): white noise
        -> GP sample."""
        if self._chols is None:
            rdt = real_dtype(self.device)
            self._chols = tuple(to_device(np.linalg.cholesky(k), self.device, rdt)
                                for k in (self.kf, self.kx, self.ky))
        return kron_matvec(self._chols, x)
