"""Stokes <-> correlation conversion (port of pfb_imaging_tpu/utils/stokes.py).

``weight_data`` converts correlations to one Stokes product on ``device``
by weighted least squares (``init``'s conversion). For correlation c with
response a_c = g_p[c] conj(g_q[c]) T[c, s] (T the feed-to-Stokes brightness
map), the single-product estimate and its weight are

    S_s = sum_c w_c conj(a_c) v_c / sum_c w_c |a_c|^2,   W_s = sum_c w_c |a_c|^2

which reduces to I = (XX + YY)/2 for identity Jones. ``stokes_to_corr``
renders Stokes model visibilities into correlations on the host, where
``degrid`` assembles them; the Jones/Mueller beam helpers are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

# brightness maps: v_c = sum_s T[c, s] * S_s with S ordered (I, Q, U, V)
_T_LINEAR = np.array(
    [
        [1, 1, 0, 0],  # XX = I + Q
        [0, 0, 1, 1j],  # XY = U + iV
        [0, 0, 1, -1j],  # YX = U - iV
        [1, -1, 0, 0],  # YY = I - Q
    ],
    dtype=np.complex128,
)
_T_CIRCULAR = np.array(
    [
        [1, 0, 0, 1],  # RR = I + V
        [0, 1, 1j, 0],  # RL = Q + iU
        [0, 1, -1j, 0],  # LR = Q - iU
        [1, 0, 0, -1],  # LL = I - V
    ],
    dtype=np.complex128,
)
_STOKES_IDX = {"I": 0, "Q": 1, "U": 2, "V": 3}


def brightness_map(feed_type: str, ncorr: int) -> np.ndarray:
    """T (ncorr, 4); 2-corr data carries the diagonal correlations only."""
    T = _T_LINEAR if feed_type.lower() == "linear" else _T_CIRCULAR
    if ncorr == 4:
        return T
    if ncorr == 2:
        return T[[0, 3]]
    if ncorr == 1:
        return T[[0]]
    raise ValueError(f"Unsupported ncorr {ncorr}")


def weight_data(vis, wgt, jones_p=None, jones_q=None, product: str = "I", feed_type: str = "linear", *,
                device="cuda"):
    """Convert correlations to one Stokes product with weights, on ``device``
    in complex128/f64 (the JAX function's types under x64).

    Args:
        vis: (ncorr, nrow, nchan) complex correlations.
        wgt: (ncorr, nrow, nchan) real weights.
        jones_p/jones_q: optional Jones terms for antennas p and q of each
            row: diagonal, shape (ncorr, nrow, nchan), or full 2x2, shape
            (2, 2, nrow, nchan) with ncorr = 4.
        product: one of "I", "Q", "U", "V".
        feed_type: "linear" or "circular".

    Returns:
        (vis_s, wgt_s): (nrow, nchan) complex128 and f64 tensors on ``device``.
    """
    dev = resolve_device(device)
    c128 = lambda a: torch.as_tensor(a, device=dev).to(torch.complex128)  # noqa: E731
    vis = c128(vis)
    wgt = torch.as_tensor(wgt, device=dev).to(torch.float64)
    ncorr = vis.shape[0]
    T = torch.as_tensor(brightness_map(feed_type, ncorr)[:, _STOKES_IDX[product]], device=dev)
    if jones_p is not None and jones_p.ndim == 4 and tuple(jones_p.shape[:2]) == (2, 2):
        if ncorr != 4:
            raise ValueError("full 2x2 Jones requires 4-correlation data")
        # response of corr (i, k) to unit S_s through Jp Bs Jq^H, Bs the
        # product's brightness matrix: the per-row Mueller least squares
        jp, jq = c128(jones_p), c128(jones_q)
        a = torch.einsum("ij...,jl,kl...->ik...", jp, T.reshape(2, 2), jq.conj())
        a = a.reshape((4,) + tuple(jp.shape[2:]))
    elif jones_p is not None:
        a = c128(jones_p) * c128(jones_q).conj() * T[:, None, None]
    else:
        a = T[:, None, None].expand(vis.shape)
    den = (wgt * a.abs() ** 2).sum(0)
    num = (wgt * a.conj() * vis).sum(0)
    ok = den > 0
    vis_s = torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)
    return vis_s, den


def stokes_to_corr(stokes_vis: np.ndarray, feed_type: str = "linear", ncorr: int = 4) -> np.ndarray:
    """Map (4, nrow, nchan) Stokes visibilities (I, Q, U, V) to (ncorr, nrow,
    nchan) correlations, on the host where ``degrid`` assembles them."""
    return np.einsum("cs,s...->c...", brightness_map(feed_type, ncorr), stokes_vis)


# ── Jones/Mueller beam conversions (host numpy) ──────────────────────


def jones_to_mueller(jp, jq):
    """Mueller matrix M = Jp (x) conj(Jq): (2, 2, ...) x2 -> (4, 4, ...).

    Correlation (i, k) responds to brightness (j, l) through
    M[(i,k), (j,l)] = Jp[i,j] conj(Jq[k,l]) (vec of V = Jp B Jq^H).
    """
    jp = np.asarray(jp)
    out = np.einsum("ij...,kl...->ikjl...", jp, np.conjugate(np.asarray(jq)))
    return out.reshape((4, 4) + jp.shape[2:])


def mueller_to_stokes_diag(mueller, feed_type: str = "linear"):
    """Per-Stokes beam response: the diagonal of the Mueller matrix in the
    Stokes basis, shape (4, ...) real ([I, Q, U, V] attenuation images)."""
    T = _T_LINEAR if feed_type.lower() == "linear" else _T_CIRCULAR
    return np.einsum("ij...,ji->i...", mueller, T).real


def jones_beam_to_stokes(jones, product: str = "I", feed_type: str = "linear"):
    """(2, 2, nx, ny) Jones beam -> (nstokes, nx, ny) Stokes responses for
    the characters of ``product``."""
    s = mueller_to_stokes_diag(jones_to_mueller(jones, jones), feed_type)
    return s[[_STOKES_IDX[p] for p in product]]
