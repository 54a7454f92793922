"""The SARA wavelet dictionary Psi (port of pfb_imaging_tpu/ops/psi.py).

Analysis ``dot`` maps (nband, nx, ny) to (nband, nbasis, nymax, nxmax);
synthesis ``hdot`` is its exact adjoint. The band axis is the leading
batch axis of every conv (where JAX vmapped a single-band transform).
Packed multi-level layout as in the JAX package: level-i blocks of shape
(2cx_i, 2cy_i) at end indices ex/ey, deeper levels overwriting the
shallower approximation quadrants.
"""

from __future__ import annotations

import torch

from .. import real_dtype
from .wavelets import coeff_size, conv_weights, dwt2d_level, dwt_max_level, filter_bank, idwt2d_level


class _WaveletBook:
    """Static per-basis bookkeeping plus the conv weights on the device."""

    def __init__(self, base: str, nx: int, ny: int, nlevel: int, device, dtype):
        self.k = len(filter_bank(base)[0])
        self.dec, self.rec = conv_weights(base, device, dtype)
        maxlev = dwt_max_level(min(nx, ny), self.k)
        if nlevel > maxlev:
            raise ValueError(f"Decomposition level {nlevel} not possible for {base} on ({nx},{ny})")
        self.nlevel = nlevel
        cx, cy, insx, insy = [], [], [], []
        n1, n2 = nx, ny
        for _ in range(nlevel):
            insx.append(n1)
            insy.append(n2)
            n1, n2 = coeff_size(n1, self.k), coeff_size(n2, self.k)
            cx.append(n1)
            cy.append(n2)
        self.cx, self.cy, self.insx, self.insy = cx, cy, insx, insy
        ex = [0] * nlevel
        ey = [0] * nlevel
        lowx = ex[nlevel - 1] = 2 * cx[nlevel - 1]
        lowy = ey[nlevel - 1] = 2 * cy[nlevel - 1]
        for i in reversed(range(nlevel - 1)):
            ex[i] = lowx + cx[i]
            ey[i] = lowy + cy[i]
            lowx += cx[i]
            lowy += cy[i]
        self.ex, self.ey = ex, ey
        self.ntotx, self.ntoty = ex[0], ey[0]

    def slot(self, i):
        return (slice(self.ex[i] - 2 * self.cx[i], self.ex[i]), slice(self.ey[i] - 2 * self.cy[i], self.ey[i]))


class Psi:
    """SARA dictionary over an image cube on ``device``."""

    def __init__(self, nband: int, nx: int, ny: int, bases=("self", "db1", "db2", "db3"), nlevel: int = 2,
                 *, device):
        self.nband, self.nx, self.ny = nband, nx, ny
        self.bases = tuple(bases)
        self.nbasis = len(self.bases)
        self.nlevel = nlevel
        self.device = torch.device(device)
        self.dtype = dtype = real_dtype(device)
        self._books = {b: _WaveletBook(b, nx, ny, nlevel, device, dtype) for b in self.bases if b != "self"}
        # first packed axis is x-like, second y-like (JAX naming kept)
        self.nymax = max([nx] + [bk.ntotx for bk in self._books.values()])
        self.nxmax = max([ny] + [bk.ntoty for bk in self._books.values()])

    def dot(self, x: torch.Tensor) -> torch.Tensor:
        """Analysis: (nband, nx, ny) -> (nband, nbasis, nymax, nxmax)."""
        out = x.new_zeros((x.shape[0], self.nbasis, self.nymax, self.nxmax))
        for bi, base in enumerate(self.bases):
            if base == "self":
                out[:, bi, : self.nx, : self.ny] = x
                continue
            bk = self._books[base]
            approx = x
            blocks = []
            for i in range(bk.nlevel):
                block = dwt2d_level(approx, bk.dec)
                blocks.append(block)
                approx = block[..., : bk.cx[i], : bk.cy[i]]
            for i in range(bk.nlevel):  # shallow first; deeper overwrite
                sx, sy = bk.slot(i)
                out[:, bi, sx, sy] = blocks[i]
        return out

    def hdot(self, alpha: torch.Tensor) -> torch.Tensor:
        """Synthesis (adjoint): (nband, nbasis, nymax, nxmax) -> (nband, nx, ny)."""
        out = alpha.new_zeros((alpha.shape[0], self.nx, self.ny))
        for bi, base in enumerate(self.bases):
            if base == "self":
                out = out + alpha[:, bi, : self.nx, : self.ny]
                continue
            bk = self._books[base]
            i = bk.nlevel - 1
            sx, sy = bk.slot(i)
            approx = idwt2d_level(alpha[:, bi, sx, sy], bk.rec, bk.insx[i], bk.insy[i])
            for i in reversed(range(bk.nlevel - 1)):
                sx, sy = bk.slot(i)
                blk = alpha[:, bi, sx, sy].clone()
                blk[..., : bk.cx[i], : bk.cy[i]] = approx
                approx = idwt2d_level(blk, bk.rec, bk.insx[i], bk.insy[i])
            out = out + approx
        return out
