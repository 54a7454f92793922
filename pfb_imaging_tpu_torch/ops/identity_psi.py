"""Trivial dictionary for image-domain l1 / ISTA (port of
pfb_imaging_tpu/ops/identity_psi.py)."""

from __future__ import annotations

import torch

from .. import real_dtype


class IdentityPsi:
    """Dictionary whose analysis and synthesis are the identity, with the
    coefficient layout (nband, 1, nx, ny) of the generic (nband, nbasis,
    nymax, nxmax) convention. ``device`` (and its working type) is that of
    the coefficient cubes a regulariser builds over it."""

    def __init__(self, nband: int, nx: int, ny: int, *, device):
        self.nband = nband
        self.nx = nx
        self.ny = ny
        self.nbasis = 1
        self.nymax = nx
        self.nxmax = ny
        self.device = torch.device(device)
        self.dtype = real_dtype(device)

    @staticmethod
    def dot(x):
        return x[:, None, :, :]

    @staticmethod
    def hdot(alpha):
        return alpha.sum(1)
