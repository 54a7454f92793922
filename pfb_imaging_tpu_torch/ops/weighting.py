"""uv counts and Briggs imaging weights (port of
pfb_imaging_tpu/ops/weighting.py): nearest-neighbour counts with the
Hermitian v < 0 fold, Briggs ``counts_to_weights``,
``filter_extreme_counts``, the super-uniform ``box_sum_counts``, the
Student-t ``l2_reweight`` of the imager's model transfer, and the host
``reduce_counts`` that combines counts grids over bands or times.

The public functions take and return numpy arrays, as the imager holds
them. Counts and weights go to the host kernels of the port's ``native``
module, as in the JAX package; where the library is unavailable, the plain
torch versions (``compute_counts_torch``, ``counts_to_weights_torch``, also
the tests' reference) compute the same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import LIGHTSPEED


def _t(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float64))


def _uv_bins(uvw, freq, nx, ny, cell_size_x, cell_size_y, usign, vsign):
    """NN cell (iu, iv) and in-bounds mask, (nrow, nchan) each."""
    u_cell, v_cell = 1.0 / (nx * cell_size_x), 1.0 / (ny * cell_size_y)
    umax, vmax = abs(1.0 / cell_size_x / 2.0), abs(1.0 / cell_size_y / 2.0)
    nu = freq / LIGHTSPEED
    u = uvw[:, 0:1] * nu[None, :] * usign
    v = uvw[:, 1:2] * nu[None, :] * vsign
    neg = v < 0
    u = torch.where(neg, -u, u)
    v = torch.where(neg, -v, v)
    iu = torch.floor((u + umax) / u_cell).to(torch.int64)
    iv = torch.floor((v + vmax) / v_cell).to(torch.int64)
    return iu, iv, (iu >= 0) & (iu < nx) & (iv >= 0) & (iv < ny)


def compute_counts_torch(uvw, freq, mask, wgt, nx, ny, cell_size_x, cell_size_y, usign=1.0, vsign=-1.0):
    """Plain version of :func:`compute_counts` on tensors: (ncorr, nx, ny)."""
    uvw, freq, mask, wgt = (_t(a) for a in (uvw, freq, mask, wgt))
    iu, iv, ok = _uv_bins(uvw, freq, nx, ny, cell_size_x, cell_size_y, usign, vsign)
    sel = (ok & (mask != 0)).reshape(-1)
    idx = (iu * ny + iv).reshape(-1)[sel]
    out = wgt.new_zeros((wgt.shape[0], nx * ny))
    for c in range(wgt.shape[0]):
        out[c].index_add_(0, idx, wgt[c].reshape(-1)[sel])
    return out.reshape(-1, nx, ny)


def compute_counts(uvw, freq, mask, wgt, nx: int, ny: int, cell_size_x: float, cell_size_y: float,
                   usign: float = 1.0, vsign: float = -1.0) -> np.ndarray:
    """Sum weights (ncorr, nrow, nchan) onto the (ncorr, nx, ny) uv grid with
    NN binning; out-of-bounds samples are dropped. Numpy in, numpy out."""
    from ..native import counts_nn

    out = counts_nn(uvw, freq, mask, wgt, nx, ny, cell_size_x, cell_size_y, usign, vsign, 1.0 / LIGHTSPEED)
    if out is None:
        out = compute_counts_torch(uvw, freq, mask, wgt, nx, ny, cell_size_x, cell_size_y, usign, vsign).numpy()
    return out


def _briggs(counts: np.ndarray, robust: float) -> np.ndarray:
    """counts * ssq + 1 with ssq = (5 10^-robust)^2 sum(c) / sum(c^2) per
    corr; unchanged for robust <= -2 (uniform)."""
    if robust <= -2:
        return counts
    numsqrt = 5 * 10 ** (-robust)
    num = (counts * counts).sum(axis=(1, 2))
    den = counts.sum(axis=(1, 2))
    ssq = numsqrt * numsqrt * den / np.where(num > 0, num, 1.0)
    return counts * ssq[:, None, None] + 1.0


def counts_to_weights_torch(counts, uvw, freq, weight, mask, nx, ny, cell_size_x, cell_size_y, robust,
                            usign=1.0, vsign=-1.0):
    """Plain version of :func:`counts_to_weights` on CPU tensors, with the
    Briggs factor from the same numpy sums as the native path."""
    counts, uvw, freq, weight, mask = (_t(a) for a in (counts, uvw, freq, weight, mask))
    if not bool((counts != 0).any()):
        return weight
    counts = torch.from_numpy(_briggs(counts.numpy(), robust))
    iu, iv, ok = _uv_bins(uvw, freq, nx, ny, cell_size_x, cell_size_y, usign, vsign)
    sel = ok & (mask != 0)
    iu, iv = iu.clamp(0, nx - 1), iv.clamp(0, ny - 1)
    out = []
    for c in range(weight.shape[0]):
        cval = counts[c][iu, iv]
        keep = sel & (cval > 0)
        out.append(torch.where(keep, weight[c] / torch.where(cval > 0, cval, torch.ones_like(cval)), weight[c]))
    return torch.stack(out)


def counts_to_weights(counts, uvw, freq, weight, mask, nx: int, ny: int, cell_size_x: float, cell_size_y: float,
                      robust: float, usign: float = 1.0, vsign: float = -1.0) -> np.ndarray:
    """Imaging weights (ncorr, nrow, nchan): each weight divided by the
    Briggs-adjusted count of its cell (robust <= -2: uniform). An all-zero
    counts grid leaves the weights unchanged. Numpy in, numpy out."""
    from ..native import weights_from_counts

    counts = np.asarray(counts, np.float64)
    if not np.any(counts != 0):
        return weight
    out = weights_from_counts(_briggs(counts, robust), uvw, freq, mask, weight, nx, ny, cell_size_x, cell_size_y,
                              usign, vsign, 1.0 / LIGHTSPEED)
    if out is None:
        out = counts_to_weights_torch(counts, uvw, freq, weight, mask, nx, ny, cell_size_x, cell_size_y, robust,
                                      usign, vsign).numpy()
    return out


def filter_extreme_counts(counts: np.ndarray, level: float = 10.0) -> np.ndarray:
    """Floor nonzero counts at (median of the nonzero counts) / level."""
    if not level:
        return counts
    c = _t(counts)
    nz = c > 0
    vals = torch.sort(c[nz]).values
    n = vals.numel()
    if n == 0:
        return counts
    med = 0.5 * (vals[(n - 1) // 2] + vals[n // 2])  # numpy's median of an even count
    return torch.where(nz, torch.clamp(c, min=float(med / level)), c).numpy()


def box_sum_counts(counts: np.ndarray, npix_super: int) -> np.ndarray:
    """Box sum over a (2 npix_super + 1)^2 window (super-uniform weighting),
    zero-padded at the edges."""
    if npix_super is None or npix_super <= 0:
        return counts
    c = _t(counts)
    size = 2 * npix_super + 1

    def box1d(x, axis):
        pad = [0, 0] * x.ndim
        pad[2 * (x.ndim - 1 - (axis % x.ndim)) : 2 * (x.ndim - 1 - (axis % x.ndim)) + 2] = [npix_super, npix_super]
        cs = torch.cumsum(torch.nn.functional.pad(x, pad), dim=axis)
        cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
        n = cs.shape[axis]
        return cs.narrow(axis, size, n - size) - cs.narrow(axis, 0, n - size)

    return box1d(box1d(c, -2), -1).numpy()


def l2_reweight(residual_vis, wgt, mask, dof: float, wgt_prev=1.0) -> np.ndarray:
    """Student-t (L2) visibility reweighting: natural weights scaled by
    (dof + 2) / (dof + |r|^2 w_prev / ovar), ovar the mean residual power
    over unflagged samples (per correlation for (ncorr, nrow, nchan)
    input); weights stay as they are where ovar is 0. Numpy in, numpy out."""
    r = torch.as_tensor(np.asarray(residual_vis))
    ressq = (r * wgt_prev * r.conj()).real
    msk = torch.as_tensor(np.asarray(mask)) > 0
    ssq = torch.where(msk[None] if ressq.ndim == 3 else msk, ressq, torch.zeros_like(ressq)).sum(dim=(-2, -1))
    ovar = (ssq / max(int(msk.sum()), 1)).reshape((-1,) + (1,) * (ressq.ndim - 1))
    w = _t(wgt)
    return torch.where(ovar > 0, w * (dof + 2) / (dof + ressq / ovar), w).numpy()


def reduce_counts(counts: dict, grouping: str) -> dict:
    """Combine per-(band, time) counts grids by a grouping strategy:
    "per-band-time" (identity), "mfs"/"per-time" (sum over bands within
    each time), "per-band" (sum over times within each band)."""
    valid = ("per-band-time", "mfs", "per-band", "per-time")
    if grouping == "per-band-time":
        return dict(counts)
    if grouping in ("mfs", "per-time", "per-band"):
        fix_band = grouping == "per-band"
        sums = {}
        for (b, t), grid in counts.items():
            key = b if fix_band else t
            sums[key] = grid.copy() if key not in sums else sums[key] + grid
        return {(b, t): sums[b if fix_band else t] for (b, t) in counts}
    raise ValueError(f"Unknown weight grouping {grouping!r}; expected one of {valid}")
