"""Explicit-DFT measurement operator (port of pfb_imaging_tpu/ops/dft.py).

The exact degridder and gridder under the pinned phase convention
(``geometry.py``):

    vis[r, f] = sum_pix I / n * exp(-2 pi j (su u l + sv v m - sw w (n - 1)) f / c)

The image's dtype sets the arithmetic, as in the JAX package: an f64 image
computes its phases in f64 on the card too (a phase of 1e4-1e5 cycles keeps
only about three decimals of a cycle in f32). ``dirty2vis_dft`` sums over
the image's nonzero pixels only (a zero pixel adds an exact zero, so this
is the same function with another summation order), which makes a
point-source sky cheap at any image size. Both functions work in row
blocks whose (rows, nchan, pixels) complex phase tensor stays within
``BLOCK_BYTES``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import complex_dtype, resolve_device
from ..constants import LIGHTSPEED
from ..geometry import conventions_signs

# bytes of one row block's complex phase tensor
BLOCK_BYTES = 1 << 30


def _geometry(uvw, freq, pix, nx, ny, cellx, celly, l0, m0, flips, rdt, dev):
    """(uvw with the signs folded in so the phase is a plain inner product
    with (l, m, n - 1), 1/lambda, and (l, m, n - 1) and n at the flat pixel
    indices ``pix``), by ``lm_grid``'s arithmetic in f64, then cast."""
    f64 = torch.float64
    ell = torch.as_tensor(-l0 + (np.arange(nx) - nx // 2) * cellx, dtype=f64, device=dev)
    emm = torch.as_tensor(m0 + (np.arange(ny) - ny // 2) * celly, dtype=f64, device=dev)
    lp, mp = ell[pix // ny], emm[pix % ny]
    nn = torch.sqrt(torch.clamp(1.0 - lp**2 - mp**2, min=0.0))
    su, sv, sw = conventions_signs(*flips)
    uvw_e = torch.as_tensor(uvw, device=dev).to(rdt) * torch.tensor([su, sv, -sw], dtype=rdt, device=dev)
    invlam = torch.as_tensor(freq, device=dev).to(rdt) / LIGHTSPEED
    return uvw_e, invlam, torch.stack([lp, mp, nn - 1.0], -1).to(rdt), nn.to(rdt)


def _rows_per_block(nchan: int, npix: int, cdt) -> int:
    return max(1, BLOCK_BYTES // max(1, nchan * npix * cdt.itemsize))


def dirty2vis_dft(uvw, freq, image, *, nx: int, ny: int, cellx: float, celly: float, l0: float = 0.0,
                  m0: float = 0.0, flip_u: bool = False, flip_v: bool = True, flip_w: bool = False,
                  divide_by_n: bool = True, device="cuda") -> torch.Tensor:
    """(nrow, nchan) visibilities of ``image`` (nx, ny), on ``device``, in
    the complex type of the image's dtype."""
    dev = resolve_device(device)
    img = torch.as_tensor(image, device=dev)
    rdt = img.dtype if img.is_floating_point() else torch.float64
    cdt = complex_dtype(rdt)
    ieff = img.reshape(-1).to(rdt)
    pix = torch.nonzero(ieff).reshape(-1)
    uvw_e, invlam, lmn, nn = _geometry(uvw, freq, pix, nx, ny, cellx, celly, l0, m0, (flip_u, flip_v, flip_w), rdt,
                                       dev)
    ieff = ieff[pix]
    if divide_by_n:
        ieff = torch.where(nn > 0, ieff / torch.where(nn > 0, nn, 1.0), 0.0)
    ieff = ieff.to(cdt)
    nrow, nchan = uvw_e.shape[0], invlam.shape[0]
    vis = torch.zeros((nrow, nchan), dtype=cdt, device=dev)
    if pix.numel() == 0:
        return vis
    rb = _rows_per_block(nchan, pix.numel(), cdt)
    for r0 in range(0, nrow, rb):
        a = uvw_e[r0:r0 + rb] @ lmn.T  # (rb, nnz) geometric phase in metres
        ph = (-2.0 * math.pi) * (a[:, None, :] * invlam[None, :, None])  # (rb, nchan, nnz) radians
        vis[r0:r0 + rb] = torch.polar(torch.ones_like(ph), ph) @ ieff
    return vis


def vis2dirty_dft(uvw, freq, vis, *, wgt=None, mask=None, nx: int, ny: int, cellx: float, celly: float,
                  l0: float = 0.0, m0: float = 0.0, flip_u: bool = False, flip_v: bool = True, flip_w: bool = False,
                  divide_by_n: bool = True, device="cuda") -> torch.Tensor:
    """Exact adjoint of :func:`dirty2vis_dft` with optional weights and mask:
    dirty[p] = sum_{r,f} Re[w vis exp(+2 pi j phase)] / n_p, an (nx, ny)
    image on ``device`` in the real type of ``vis``."""
    dev = resolve_device(device)
    wv = torch.as_tensor(vis, device=dev)
    cdt = wv.dtype if wv.is_complex() else complex_dtype(torch.float64)
    wv = wv.to(cdt)
    rdt = wv.real.dtype
    if wgt is not None:
        wv = wv * torch.as_tensor(wgt, device=dev).to(rdt)
    if mask is not None:
        wv = wv * torch.as_tensor(mask, device=dev).to(rdt)
    pix = torch.arange(nx * ny, device=dev)
    uvw_e, invlam, lmn, nn = _geometry(uvw, freq, pix, nx, ny, cellx, celly, l0, m0, (flip_u, flip_v, flip_w), rdt,
                                       dev)
    nrow, nchan = uvw_e.shape[0], invlam.shape[0]
    acc = torch.zeros(nx * ny, dtype=rdt, device=dev)
    rb = _rows_per_block(nchan, nx * ny, cdt)
    for r0 in range(0, nrow, rb):
        a = uvw_e[r0:r0 + rb] @ lmn.T
        ph = (2.0 * math.pi) * (a[:, None, :] * invlam[None, :, None])
        acc += torch.einsum("rf,rfp->p", wv[r0:r0 + rb], torch.polar(torch.ones_like(ph), ph)).real
    if divide_by_n:
        acc = torch.where(nn > 0, acc / torch.where(nn > 0, nn, 1.0), 0.0)
    return acc.reshape(nx, ny)
