"""Image-domain gridding (IDG): the chirp and windowed w-plane modes (port
of pfb_imaging_tpu/ops/gridder_idg.py).

Host planning (numpy, f64): visibilities are bucketed into ``half``-cell uv
tiles; each <= G visibility chunk of a (w-bin, bucket) becomes a group whose
footprint fits an S x S subgrid. ``w_mode`` picks how w is handled, with the
JAX planner's slot-unit cost model under "auto":
  chirp    w-bins plus a per-visibility quadratic chirp (one slot per
           visibility; native OpenMP bucketing where the port's ``native``
           module loads, a vectorised numpy pass otherwise);
  wplanes  improved w-stacking over the patch machinery: each visibility
           sits on ``w_support`` adjacent w-planes with ES-kernel weights in
           w. Visibilities are sorted by (bucket, base plane), so each
           (plane, bucket) group is a contiguous window of the sorted table
           (``win_start``/``win_off``/``win_len``); the per-slot constants
           are expanded from the per-visibility table on the device, in f64,
           then cast.
Per slot the plan keeps only the angles ``scal`` = [2 pi du/S, phi_u, 2 pi
dv/S, phi_v] (phi = 0 in wplanes mode); the taper-DFT factors ``wcu``/``wcv``
= W diag(c) come from the free-taper fit (``fit_taper``, copied with its
disk cache). The image arrays (n-1, the 1/(Tu Tv) correction, times
dw / khat_w(n-1 - z0) in wplanes mode, the w screens) are computed directly
in f64 and cast to the working dtype.

Runtime (torch, per w-bin or w-plane loop):
  adjoint  vis -> group values (one gather) -> patches (CUDA kernel B1,
           ``idg_fused.patches_from_vals``) -> each bin's uv grid (kernel K1,
           ``assemble_bin``: every cell summed in a fixed
           order, so two runs give the same bits) -> ifft2 -> crop ->
           screen -> sum over bins -> correction;
  forward  its exact transpose: correction -> screen -> fft2 -> each
           group's periodic window (kernel K2, ``extract_bin``)
           -> patches -> group values (kernel B2,
           ``idg_fused.vals_from_patches``) -> slot phase and hermitian
           sign -> back to the visibilities (``dirty2vis_idg``): one scatter
           in chirp mode, a gather of each visibility's ``w_support``
           replica slots (``rep_idx``) and their sum in wplanes mode.
The production major cycle keeps chirp-mode weights in group layout
(``to_group_layout``) so ``hessian_vis_idg`` runs gather-free; wplanes
plans weight the replica sum, so they take original-layout weights.

Left out, because the card does not need them: the TPU's one-hot assembly
matmuls, the batched/compact/``lax.scan`` bin variants, bf16 and Veltkamp
splits, split-f32 phase evaluation (phases are f64 until the cast), and the
packed-row window gathers (a windowed plan is held as the per-slot
``cg_idx`` map, whose windows keep the JAX planner's 8-aligned starts).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import weakref
from pathlib import Path

import numpy as np
import torch

from .. import complex_dtype, real_dtype, to_device
from ..constants import LIGHTSPEED
from ..geometry import conventions_signs, good_size
from . import idg_fused
from .gridder import _kernel_ft, _kernel_params, es_kernel

__all__ = ["IDGPlan", "plan_idg", "vis2dirty_idg", "vis2dirty_idg_grouped", "dirty2vis_idg", "dirty2vis_idg_grouped",
           "to_group_layout", "hessian_vis_idg", "delivered_accuracy", "plan_from_jax", "idg_slot_factor",
           "IDG_MIN_EPS"]

IDG_MIN_EPS = 1e-8  # tightest epsilon the adaptive-subgrid fit covers
CHIRP_BUDGET = 0.1  # max |image chirp phase| (rad) the taper fit absorbs
W_RESID_FRACTION = 1.0  # fraction of epsilon budgeted to the w-phase residual
# cache the per-bin w screens on the device up to this many bytes
_SCREEN_CACHE_BYTES = 256 << 20
_MAX_BINS = 4096
W_MODES = ("auto", "chirp", "wplanes")
W_SIGMA = 2.0  # w-axis kernel oversampling: plane spacing 1/(2 W_SIGMA (n-1 halfrange))
# windowed plans: window starts aligned down to a multiple of this (the JAX
# planner's pack width, kept so the two planners build the same groups)
_WIN_ALIGN = 8
# groups per slab of the windowed plan's device expansion (bounds its f64
# (slab, G) temporaries to ~70 MB each)
_WIN_SLAB = 1 << 16


# ── free-taper separable fit (numpy, copied from the JAX package) ────

_FIT_CACHE: dict = {}


def _fit_rows(S, xis, dus, phis, xc, ks, F):
    """Demodulated response rows: R(xi; du, phi) = row . c."""
    blocks = []
    for xi in xis:
        M = np.exp(2j * np.pi * ks * xi) @ F
        rows = []
        for du in dus:
            for phi in phis:
                a = np.exp(2j * np.pi * xc * du / S + 1j * phi * xc**2)
                demod = np.exp(-2j * np.pi * du * xi - 1j * phi * (xi * S) ** 2)
                rows.append(M * a * demod)
        blocks.append(np.array(rows))
    return blocks


def fit_taper(S: int, half: int, ximax: float, chirp_max: float = CHIRP_BUDGET, tol: float | None = None,
              *, widen: bool = False):
    """Joint (taper c, band response T) optimisation; returns (c, T_of_xi, err).

    Minimises the deviation of the patch's demodulated image response from
    a separable band response T(xi) over the offset range, image band and
    chirp budget, in the SVD subspace of the smallest deviation directions;
    with ``tol`` it bisects a flatness penalty to the flattest taper whose
    deviation stays <= tol (see the JAX ``fit_taper`` for the derivation).

    The JAX bisection searches the penalty weight lam in [1e-2, 1e16]. Where
    even lam = 1e16 misses ``tol`` (the chirp-free S = 32 fit below epsilon
    ~3e-7, which wplanes plans take), it keeps the unflattened taper: 1/T
    ~940 at the image edge per axis, ~9e5 at the corners, which multiplies
    the f32 substrate noise there. ``widen`` then bisects on in [1e16,
    1e24]; f32 plans ask for it, f64 plans keep the JAX taper. Fits that
    the JAX bracket serves come out the same either way.
    """
    key = (S, half, round(ximax, 4), round(chirp_max, 4),
           None if tol is None else float(np.format_float_scientific(tol, 2))) + (("widen",) if widen else ())
    if key in _FIT_CACHE:
        return _FIT_CACHE[key]
    disk = _fit_disk_load().get(key)
    if disk is not None:
        c, err = disk
        _FIT_CACHE[key] = (c, _make_T(S, half, c), err)
        return _FIT_CACHE[key]
    import scipy.linalg as sla

    k0_off = (S - half) // 2
    xc = np.fft.fftfreq(S) * S
    ks = np.arange(S)
    F = np.exp(-2j * np.pi * np.outer(ks, xc) / S)
    nxi = 2 * int(S * ximax * 4) + 9
    xis = np.linspace(-ximax, ximax, nxi)
    dus = np.linspace(k0_off, k0_off + half, 33)
    phimax = chirp_max / (S * ximax) ** 2 if chirp_max > 0 else 0.0
    phis = np.linspace(-phimax, phimax, 7) if chirp_max > 0 else [0.0]
    blocks = _fit_rows(S, xis, dus, phis, xc, ks, F)
    C = np.concatenate([B - B.mean(axis=0) for B in blocks], axis=0)
    Mn = np.array([B.mean(axis=0) for B in blocks])
    ksub = min(10, S)
    _, sv, Vh = np.linalg.svd(C, full_matrices=False)
    Vk = Vh[-ksub:].conj().T
    Hk = np.diag(sv[-ksub:] ** 2)
    MV = Mn @ Vk
    Gk = MV.conj().T @ MV
    Gk = 0.5 * (Gk + Gk.conj().T)
    Dk = MV - MV.mean(axis=0)[None]
    Qk = Dk.conj().T @ Dk
    Qk = 0.5 * (Qk + Qk.conj().T)
    Greg = Gk + 1e-30 * np.eye(ksub)

    def _solve(lam):
        A = lam * Hk + Qk
        _, Y = sla.eigh(0.5 * (A + A.conj().T), Greg)
        return Vk @ Y[:, 0]

    dus_v = np.linspace(k0_off + 0.0137, k0_off + half - 0.0119, 71)
    phis_v = np.linspace(-phimax, phimax, 11) if chirp_max > 0 else [0.0]
    xis_v = np.linspace(-ximax * 0.999, ximax * 0.999, 2 * nxi + 7)
    vblocks = _fit_rows(S, xis_v, dus_v, phis_v, xc, ks, F)

    def _validate(c):
        errs, Ts = [], []
        for B in vblocks:
            r = B @ c
            Ts.append(r.mean())
            errs.append(np.abs(r - r.mean()).max())
        return max(errs) / np.abs(Ts).max(), Ts

    _, Y = sla.eigh(Hk, Greg)
    c = Vk @ Y[:, 0]
    err, Ts = _validate(c)
    if tol is not None and err <= tol:
        brackets = [(-2.0, 16.0)] + ([(16.0, 24.0)] if widen else [])  # log10(lam)
        for lo, hi in brackets:
            top = hi
            for _ in range(18):
                mid = 0.5 * (lo + hi)
                cm = _solve(10.0**mid)
                em, Tm = _validate(cm)
                if em <= tol:
                    hi, c, err, Ts = mid, cm, em, Tm
                else:
                    lo = mid
            if hi < top:  # a weight inside this bracket met tol
                break
    c = c / Ts[len(Ts) // 2]  # T(0) ~ 1
    _FIT_CACHE[key] = (c, _make_T(S, half, c), err)
    _fit_disk_put(key, c, err)
    return _FIT_CACHE[key]


def _make_T(S: int, half: int, c: np.ndarray):
    """Band response T(xi) of taper ``c`` (mean over reference offsets)."""
    k0_off = (S - half) // 2
    xc = np.fft.fftfreq(S) * S
    ks = np.arange(S)
    F = np.exp(-2j * np.pi * np.outer(ks, xc) / S)

    def T_of_xi(xi_arr):
        xi_arr = np.atleast_1d(np.asarray(xi_arr, np.float64))
        du_ref = np.linspace(k0_off + 0.1, k0_off + half - 0.1, 5)
        out = np.zeros(xi_arr.shape, complex)
        for i, xi in enumerate(xi_arr):
            M = np.exp(2j * np.pi * ks * xi) @ F
            acc = 0.0
            for du in du_ref:
                a = np.exp(2j * np.pi * xc * du / S)
                acc += (M * a) @ c * np.exp(-2j * np.pi * du * xi)
            out[i] = acc / du_ref.size
        return out

    return T_of_xi


# Taper fits cost seconds each and are pure functions of their key: a disk
# cache under the checkout's build/ directory (PFB_TORCH_FIT_CACHE
# overrides the file) shares them across processes.
_FIT_DISK_PATH = os.environ.get(
    "PFB_TORCH_FIT_CACHE", str(Path(__file__).resolve().parents[2] / "build" / "taper_fits.pkl")
)
_FIT_DISK: dict | None = None


def _fit_disk_load() -> dict:
    global _FIT_DISK
    if _FIT_DISK is None:
        try:
            with open(_FIT_DISK_PATH, "rb") as f:
                _FIT_DISK = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):
            _FIT_DISK = {}
    return _FIT_DISK


def _fit_disk_put(key, c, err) -> None:
    disk = _fit_disk_load()
    disk[key] = (np.asarray(c), float(err))
    try:
        os.makedirs(os.path.dirname(_FIT_DISK_PATH), exist_ok=True)
        tmp = f"{_FIT_DISK_PATH}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(disk, f)
        os.replace(tmp, _FIT_DISK_PATH)
    except OSError:
        pass


# ── plan ─────────────────────────────────────────────────────────────


@dataclasses.dataclass(eq=False)  # plans hash by identity (the assembly's CSR cache)
class IDGPlan:
    """Static layout + device tensors for one (uvw, freq) layout.

    Tensors (``rdt`` = f64 on CPU, f32 on CUDA):
        scal (4, ng, G) per-slot angles; wcu, wcv (2, S, S) taper-DFT [re, im];
        sg (ng, G) hermitian-fold conjugation signs; cg_idx (ng, G) int64
        original flat (row*chan) index of each slot (nvis = empty slot);
        bid (ng,) int64 bucket id bu*nbv + bv; phase_re/phase_im (ng, G)
        forward per-slot phase (ES w-weighted in wplanes mode); corr_re/
        corr_im (nx, ny) image correction; nm1 (nx, ny) f64 n-1; scr
        (nbins, nx, ny) complex cached sign=-1 screens or None; rep_idx
        (nvis, w_support) int64 flat slot of each visibility's replicas,
        plane by plane (wplanes mode only, else None).
    ``w_support`` is 1 in chirp mode, where bins are w-bins; in wplanes mode
    it is the w-kernel support and the bins are w-planes.
    """

    nx: int
    ny: int
    nbig_x: int
    nbig_y: int
    S: int
    half: int
    G: int
    ngroups: int
    nbu: int
    nbv: int
    k0_off: int
    nrow: int
    nchan: int
    nbins: int
    bin_gstart: tuple
    bin_gcount: tuple
    bin_wc: tuple
    do_wgridding: bool
    hermitian: bool
    epsilon: float
    scal: torch.Tensor
    wcu: torch.Tensor
    wcv: torch.Tensor
    sg: torch.Tensor
    cg_idx: torch.Tensor
    bid: torch.Tensor
    phase_re: torch.Tensor
    phase_im: torch.Tensor
    corr_re: torch.Tensor
    corr_im: torch.Tensor
    nm1: torch.Tensor
    scr: torch.Tensor | None = None
    w_support: int = 1
    rep_idx: torch.Tensor | None = None

    @property
    def device(self):
        return self.scal.device

    @property
    def rdt(self):
        return self.scal.dtype

    @property
    def nbytes(self) -> int:
        fields = (getattr(self, f.name) for f in dataclasses.fields(self))
        return sum(t.numel() * t.element_size() for t in fields if isinstance(t, torch.Tensor))


def _good_multiple(n: int, m: int) -> int:
    """Smallest 5-smooth size >= n that is a multiple of m."""
    s = good_size(n)
    while s % m:
        s = good_size(s + 1)
    return s


def _check_slot_budget(ng, G, nvis, nbins, max_slot_factor):
    """Refuse plans whose group padding explodes the slot count."""
    if max_slot_factor is None or nvis == 0:
        return
    sf = ng * G / nvis
    if sf > max_slot_factor:
        raise ValueError(
            f"IDG slot padding {sf:.0f}x the visibility count (ngroups={ng}, G={G}, nvis={nvis}, "
            f"nbins={nbins}): w-bin x uv-bucket occupancy too sparse for this field"
        )


def _bucket_numpy(uvw, invlam, signs, cux, cvy, l0, m0, nbins, edges, wc, do_w, alpha, blsu, bmsv, chiru,
                  chirv, nbig_x, nbig_y, half, nbu, nbv, k0_off):
    """Vectorised numpy bucketing: (order, uniq, starts, counts, payload) in
    the layout of ``native.idg_bucket_group``."""
    su, sv, sw = signs
    u_l = su * np.multiply.outer(uvw[:, 0], invlam)
    v_l = sv * np.multiply.outer(uvw[:, 1], invlam)
    w_lam = (sw * np.multiply.outer(uvw[:, 2], invlam)).ravel()
    shift_cycles = u_l.ravel() * (-l0) + v_l.ravel() * m0
    nvis = w_lam.size
    if do_w:
        bin_of = np.clip(np.searchsorted(edges, w_lam, side="right") - 1, 0, nbins - 1)
        dw = w_lam - wc[bin_of]
    else:
        bin_of = np.zeros(nvis, np.int64)
        dw = np.zeros(nvis)
    ph = 2.0 * np.pi * (dw * alpha - shift_cycles)
    um = np.mod(u_l.ravel() * cux - dw * blsu, nbig_x)
    vm = np.mod(v_l.ravel() * cvy - dw * bmsv, nbig_y)
    bu = np.minimum((um // half).astype(np.int64), nbu - 1)
    bv = np.minimum((vm // half).astype(np.int64), nbv - 1)
    key = (bin_of * nbu + bu) * nbv + bv
    order = np.argsort(key, kind="stable")
    uniq, starts, counts = np.unique(key[order], return_index=True, return_counts=True)
    payload = dict(du=um - (bu * half - k0_off), dv=vm - (bv * half - k0_off), phiu=chiru * dw, phiv=chirv * dw,
                   ph_re=np.cos(ph), ph_im=np.sin(ph))
    return order, uniq, starts, counts, payload


def _fill_numpy(order, starts, counts, gbase, G, ng, nvis, payload):
    """Group-layout fill in the layout of ``native.idg_fill_groups``."""
    pos = np.arange(nvis) - np.repeat(starts, counts)
    g_of = np.repeat(gbase, counts) + pos // G
    slot_of = pos % G
    cg_idx = np.full((ng, G), nvis, np.int64)
    cg_idx[g_of, slot_of] = order
    out = []
    for name in ("du", "dv", "phiu", "phiv"):
        a = np.zeros((ng, G))
        a[g_of, slot_of] = payload[name][order]
        out.append(a)
    phase = np.zeros((ng, G), complex)
    phase[g_of, slot_of] = payload["ph_re"][order] + 1j * payload["ph_im"][order]
    inv_orig = np.empty(nvis, np.int64)
    inv_orig[order] = g_of * G + slot_of
    return (cg_idx, *out, phase, inv_orig)


def _lattice(nx: int, ny: int, S: int, half: int, sigma: float):
    """(nbig_x, nbig_y): the oversampled grid, 5-smooth multiples of ``half``."""
    return (_good_multiple(max(int(np.ceil(sigma * nx)), nx + 2 * S), half),
            _good_multiple(max(int(np.ceil(sigma * ny)), ny + 2 * S), half))


def _windowed_layout(uvw, invlam, signs, cux, cvy, l0, m0, nbig_x, nbig_y, half, nbu, nbv, k0_off, G, nbins, Ws,
                     w0, dw, count_only):
    """The JAX planner's windowed wplanes layout (host numpy, f64).

    Visibilities (not replicas) are sorted by (bucket, base plane i0); a
    visibility touches planes i0 .. i0+Ws-1, and i0 is monotone in w inside a
    bucket, so each (bucket, plane) pair's members are one contiguous window
    of the sorted table, cut into <= G slot groups ordered by (plane,
    bucket). Returns the per-bin group counts, and unless ``count_only`` the
    per-group windows (``win_start``/``win_off``/``win_len``, ``plane_g``,
    ``bid_g``) and the sorted per-visibility table (``order``, ``i0``, ``du``,
    ``dv``, ``wfrac`` relative to the base plane, ``ph`` the phase-centre
    shift)."""
    su, sv, sw = signs
    u_l = su * np.multiply.outer(uvw[:, 0], invlam)
    v_l = sv * np.multiply.outer(uvw[:, 1], invlam)
    w_lam = (sw * np.multiply.outer(uvw[:, 2], invlam)).ravel()
    um = np.mod((u_l * cux).ravel(), nbig_x)
    vm = np.mod((v_l * cvy).ravel(), nbig_y)
    shift_cycles = u_l.ravel() * (-l0) + v_l.ravel() * m0
    del u_l, v_l
    bu = np.minimum((um // half).astype(np.int64), nbu - 1)
    bv = np.minimum((vm // half).astype(np.int64), nbv - 1)
    i0 = np.floor((w_lam - w0) / dw - Ws / 2.0).astype(np.int64) + 1
    i0 = np.clip(i0, 0, max(nbins - Ws, 0))
    bkey = bu * nbv + bv
    order = np.lexsort((i0, bkey))
    bkey_s, i0_s = bkey[order], i0[order]
    ub, bstart, bcount = np.unique(bkey_s, return_index=True, return_counts=True)
    # candidate (bucket, plane) pairs: the planes each bucket's members touch
    pl_lo = i0_s[bstart]
    span = (i0_s[bstart + bcount - 1] + Ws - 1 - pl_lo + 1).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(span)])
    pair_bi = np.repeat(np.arange(ub.size), span)
    pair_p = np.arange(int(cum[-1])) - cum[pair_bi] + pl_lo[pair_bi]
    # plane p's members have i0 in [p - Ws + 1, p]: one searchsorted over the
    # composite (bucket, i0) key, sorted by construction
    P = nbins + 2 * Ws + 2
    K = bkey_s * P + (i0_s + Ws)
    pb = ub[pair_bi] * P
    lo = np.searchsorted(K, pb + (pair_p + 1), side="left")
    cnt = np.searchsorted(K, pb + (pair_p + Ws), side="right") - lo
    keep = cnt > 0
    pair_p, lo, cnt, pair_bkey = pair_p[keep], lo[keep], cnt[keep], ub[pair_bi[keep]]
    ord2 = np.lexsort((pair_bkey, pair_p))  # groups by (plane, bucket): planes stay contiguous
    pair_p, lo, cnt, pair_bkey = pair_p[ord2], lo[ord2], cnt[ord2], pair_bkey[ord2]
    a0 = (lo // _WIN_ALIGN) * _WIN_ALIGN
    gper = -(-(lo + cnt - a0) // G)
    gbase = np.concatenate([[0], np.cumsum(gper)])
    bin_gcount = np.zeros(nbins, np.int64)
    np.add.at(bin_gcount, pair_p, gper)
    if count_only:
        return dict(bin_gcount=bin_gcount)
    gi_of = np.repeat(np.arange(pair_p.size), gper)
    win_start = a0[gi_of] + (np.arange(int(gbase[-1])) - gbase[:-1][gi_of]) * G
    win_off = np.maximum(lo[gi_of] - win_start, 0)
    win_len = np.minimum(lo[gi_of] + cnt[gi_of], win_start + G) - np.maximum(lo[gi_of], win_start)
    return dict(bin_gcount=bin_gcount, win_start=win_start, win_off=win_off, win_len=win_len,
                plane_g=pair_p[gi_of], bid_g=pair_bkey[gi_of], order=order, i0=i0_s,
                du=(um - (bu * half - k0_off))[order], dv=(vm - (bv * half - k0_off))[order],
                wfrac=((w_lam - w0) / dw)[order] - i0_s, ph=np.exp(-2j * np.pi * shift_cycles[order]))


def _window_constants(lay, nvis, G, Ws, S, wk, sflat, dev, rdt):
    """Per-slot constants of a windowed plan, expanded on ``dev`` in f64 from
    the sorted per-visibility table and the group windows, then cast:
    (cg_idx, scal, phase_re, phase_im, sg, rep_idx). Slot (g, k) holds sorted
    visibility win_start[g] + k when win_off[g] <= k < win_off[g] + win_len[g]
    and is dead (cg_idx = nvis, zero angles and phase) otherwise; its phase is
    the shift phase times the ES w-weight ES(2 dfr / Ws) and the recentring
    e^{2 pi i dfr dw z0}, dfr = wfrac - (plane - i0). ``rep_idx`` lists each
    visibility's Ws live slots in slot order, which is plane order."""
    f64 = torch.float64

    def tab(a, dt=f64, fill=0):  # one sentinel entry at nvis for dead slots
        return to_device(np.append(np.asarray(a), fill), dev, dt)

    order = tab(lay["order"], torch.int64, nvis)
    du, dv, wfrac = tab(lay["du"]), tab(lay["dv"]), tab(lay["wfrac"])
    i0 = tab(lay["i0"], torch.int64)
    ph_re, ph_im = tab(lay["ph"].real), tab(lay["ph"].imag)
    ws, wo, wl, pg = (to_device(lay[k], dev, torch.int64) for k in ("win_start", "win_off", "win_len", "plane_g"))
    ng = ws.shape[0]
    lane = torch.arange(G, device=dev)
    cg_idx = torch.empty((ng, G), dtype=torch.int64, device=dev)
    scal = torch.zeros((4, ng, G), dtype=rdt, device=dev)
    phase_re = torch.empty((ng, G), dtype=rdt, device=dev)
    phase_im = torch.empty((ng, G), dtype=rdt, device=dev)
    tfac = 2.0 * np.pi / S
    for s in range(0, ng, _WIN_SLAB):
        e = min(ng, s + _WIN_SLAB)
        live = (lane >= wo[s:e, None]) & (lane < (wo + wl)[s:e, None])
        pos = torch.where(live, ws[s:e, None] + lane, nvis)
        cg_idx[s:e] = order[pos]
        scal[0, s:e] = tfac * du[pos]
        scal[2, s:e] = tfac * dv[pos]
        dfr = wfrac[pos] - (pg[s:e, None] - i0[pos]).to(f64)
        wt = torch.where(live, es_kernel(2.0 * dfr / Ws, wk["beta"]), 0.0)
        rot = (2.0 * np.pi) * (dfr * wk["dw"]) * wk["z0"]
        c, sn = torch.cos(rot), torch.sin(rot)
        phase_re[s:e] = (ph_re[pos] * c - ph_im[pos] * sn) * wt
        phase_im[s:e] = (ph_re[pos] * sn + ph_im[pos] * c) * wt
    sg = to_device(sflat, dev, rdt)[cg_idx]
    flat = cg_idx.reshape(-1)
    rep = torch.sort(flat, stable=True).indices[: nvis * Ws]
    if nvis and not bool((flat[rep] == torch.arange(nvis, device=dev).repeat_interleave(Ws)).all()):
        raise RuntimeError("windowed layout: a visibility does not have exactly w_support replica slots")
    return cg_idx, scal, phase_re, phase_im, sg, rep.reshape(nvis, Ws)


def _pad_to_caps(bin_gstart, bin_gcount, bin_gcap, arrays: dict):
    """Pad every bin's group block to its capacity ``bin_gcap`` with empty
    groups: (new bin_gstart, new bin_gcount, padded arrays); ``arrays`` maps
    name -> (array with the group axis first, fill)."""
    cap = np.asarray([int(x) for x in bin_gcap], np.int64)
    if cap.size != len(bin_gcount) or np.any(cap < np.asarray(bin_gcount)):
        raise ValueError("bin_gcap smaller than this layout's group count")
    new_start = np.concatenate([[0], np.cumsum(cap)])[:-1]
    ng = int(sum(bin_gcount))
    remap = np.empty(ng, np.int64)
    for b, (s, c) in enumerate(zip(bin_gstart, bin_gcount)):
        remap[s : s + c] = new_start[b] + np.arange(c)
    out = {}
    for name, (a, fill) in arrays.items():
        p = np.full((int(cap.sum()),) + a.shape[1:], fill, a.dtype)
        p[remap] = a
        out[name] = p
    return new_start, cap, out


def plan_idg(uvw, freq, *, nx: int, ny: int, cellx: float, celly: float, l0: float = 0.0, m0: float = 0.0,
             flip_u: bool = False, flip_v: bool = True, flip_w: bool = False, epsilon: float = 1e-5,
             do_wgridding: bool = True, divide_by_n: bool = True, sigma: float | None = None,
             dtype: torch.dtype | None = None, subgrid: int | None = None, half: int | None = None,
             group_size: int = 128, max_bins: int = _MAX_BINS, force_w_range: tuple | None = None,
             bin_gcap: tuple | None = None, count_only: bool | str = False, eval_backend: str = "auto",
             hermitian: bool = True, max_slot_factor: float | None = None, w_mode: str = "auto",
             device="cuda") -> IDGPlan:
    """Host-side IDG planning onto ``device``: the JAX ``plan_idg``, its
    arguments and defaults. ``flip_u/v/w`` set the sign conventions
    (``geometry.conventions_signs``). ``divide_by_n`` (default True, as in
    JAX) folds the 1/n of the DFT convention into the image correction; the
    imager, the residual and degrid plan with ``divide_by_n=False``.
    ``hermitian`` folds the v < 0 rows onto v >= 0 (their values conjugate
    at run time); False plans every row as it is.

    ``subgrid`` (S) and ``half`` (the bucket width, default S // 2; S must
    be a multiple of it) default to the epsilon-adaptive tiers: S = 16 /
    half = 8 down to epsilon 4e-6, S = 32 / half = 16 below. ``sigma``
    (the lattice oversampling) defaults to the JAX tiers: 1.5 at S >= 32,
    1.75 at S = 24, at S = 16 1.5 down to epsilon 2e-5 and 1.75 below.
    The card's kernels serve S in {16, 24, 32} and groups of 128 slots:
    another ``subgrid`` or ``group_size`` raises ``ValueError``, and so does
    an ``eval_backend`` other than "auto" or "fused" (the JAX "einsum" and
    "onfly" backends are the TPU's; here every plan takes the kernels on the
    card and their plain versions on the CPU).

    ``w_mode``: "chirp", "wplanes" or "auto" (the JAX slot-unit cost model:
    per-visibility slots plus a lattice-area cost per bin or plane). A
    wplanes plan with the adaptive subgrid moves to the S = 32 / half = 16 /
    sigma 1.5 tier; an explicit ``subgrid`` or ``half`` keeps its own. A
    chirp layout that needs more than ``max_bins`` w-bins raises.
    ``force_w_range=(wmin, wmax, nbins)`` and ``bin_gcap`` (per-bin group
    capacities, padded with empty groups) give several layouts one bin grid
    and one group layout, as the multiband planner needs. ``max_slot_factor``
    refuses layouts whose group padding exceeds it. ``dtype`` defaults to
    f32 on CUDA (the kernels' type) and f64 on the CPU. ``count_only`` stops
    after the bucket pass and returns (nbins, per-bin group counts, (wlo,
    whi, w_support)), as the JAX count pass does; ``count_only="w"`` stops
    before it, once the w scheme is chosen, and returns (nbins, None, (wlo,
    whi, w_support))."""
    if w_mode not in W_MODES:
        raise ValueError(f"w_mode {w_mode!r} not in {W_MODES}")
    G = idg_fused.G
    if eval_backend not in ("auto", "fused") or int(group_size) != G:
        raise ValueError(f"the IDG kernels take eval_backend 'auto' or 'fused' and group_size {G}; got "
                         f"{eval_backend!r}, {group_size}")
    rdt = dtype or real_dtype(device)
    uvw = np.asarray(uvw, np.float64)
    freq = np.asarray(freq, np.float64)
    nrow, nchan = uvw.shape[0], freq.shape[0]
    su, sv, sw = conventions_signs(flip_u, flip_v, flip_w)
    if hermitian:
        # v < 0 rows mirror onto v >= 0; their values conjugate
        v_row = sv * uvw[:, 1]
        fold_row = (v_row < 0) | ((v_row == 0) & (su * uvw[:, 0] < 0))
        uvw = np.where(fold_row[:, None], -uvw, uvw)
    else:
        fold_row = np.zeros(nrow, bool)
    if epsilon < IDG_MIN_EPS:
        raise ValueError(f"IDG accuracy envelope stops at epsilon={IDG_MIN_EPS}")
    subgrid_auto = subgrid is None and half is None
    if subgrid is None:
        # epsilon-adaptive subgrid: S=16/half=8 down to 4e-6, S=32/half=16 below
        subgrid = 16 if epsilon >= 4e-6 else 32
        if half is None:
            half = 8 if subgrid == 16 else 16
    S = int(subgrid)
    half = int(half) if half is not None else S // 2
    if S not in idg_fused.SUPPORTED_S:
        raise ValueError(f"the IDG kernels take subgrid in {idg_fused.SUPPORTED_S}; got {S}")
    if S % half:
        raise ValueError("subgrid must be a multiple of half")
    if sigma is None:
        sigma = 1.5 if S >= 32 else 1.75 if S == 24 else 1.5 if epsilon >= 2e-5 else 1.75
    nbig_x, nbig_y = _lattice(nx, ny, S, half, sigma)
    invlam = freq / LIGHTSPEED
    nvis = nrow * nchan
    if nvis:
        wext = np.array([(sw * uvw[:, 2]).min(), (sw * uvw[:, 2]).max()])
        wall = np.concatenate([wext * invlam.min(), wext * invlam.max()])
        w_min_all, w_max_all = float(wall.min()), float(wall.max())
    else:
        w_min_all = w_max_all = 0.0
    ell1 = -l0 + (np.arange(nx) - nx // 2) * cellx
    emm1 = m0 + (np.arange(ny) - ny // 2) * celly

    # separable quadratic model of n-1 (IRLS toward minimax); the remainder
    # bounds the chirp-mode w-bin width
    do_w = bool(do_wgridding) and max(abs(w_min_all), abs(w_max_all)) > 0
    ix = np.unique(np.append(np.arange(0, nx, max(1, nx // 256)), nx - 1))
    iy = np.unique(np.append(np.arange(0, ny, max(1, ny // 256)), ny - 1))
    JX = np.broadcast_to(((ix - nx // 2) * cellx)[:, None], (ix.size, iy.size)).ravel()
    JY = np.broadcast_to(((iy - ny // 2) * celly)[None, :], (ix.size, iy.size)).ravel()
    basis = np.stack([np.ones_like(JX), JX, JY, JX * JX, JY * JY], axis=-1)
    target = (np.sqrt(np.maximum(1.0 - (ell1[ix][:, None] ** 2 + emm1[iy][None, :] ** 2), 0.0)) - 1.0).ravel()
    wt = np.ones_like(target)
    for _ in range(3):
        coef, *_ = np.linalg.lstsq(basis * wt[:, None], target * wt, rcond=None)
        r = target - basis @ coef
        rmax = np.abs(r).max()
        if rmax == 0.0:
            break
        wt = (0.1 + (np.abs(r) / rmax) ** 2) ** 2
    alpha, bl, bm, gl, gm = (float(v) for v in coef)
    resid_max = float(np.abs(target - basis @ coef).max())
    if nx > 256 or ny > 256:
        resid_max *= 1.1

    if force_w_range is not None:
        do_w = True
    w_support = 1
    wk = None  # wplanes: the w kernel (plane spacing dw, first plane w0, recentring z0, ES beta)
    edges = None
    if do_w:
        wmin, wmax = w_min_all, w_max_all
        if force_w_range is not None:
            fw0, fw1, _ = force_w_range
            if nvis and (wmin < fw0 - 1e-9 or wmax > fw1 + 1e-9):
                raise ValueError("force_w_range does not cover this layout's w range")
            wmin, wmax = float(fw0), float(fw1)
        ximax_x = nx / (2.0 * nbig_x) + 0.01
        ximax_y = ny / (2.0 * nbig_y) + 0.01
        tol_resid = max(epsilon * W_RESID_FRACTION, 1e-13)
        c1 = tol_resid / (2.0 * np.pi * resid_max) if resid_max > 0 else np.inf
        chirp_l = 2.0 * np.pi * abs(gl) * (nbig_x * cellx * ximax_x) ** 2
        chirp_m = 2.0 * np.pi * abs(gm) * (nbig_y * celly * ximax_y) ** 2
        delta = min(c1, CHIRP_BUDGET / max(chirp_l, chirp_m))
        nbins_chirp = max(1, int(np.ceil((wmax - wmin) / (2.0 * delta)))) if wmax > wmin else 1
        # wplanes: an ES kernel along w, one support point over the uv rule;
        # the plane spacing is set by the n-1 halfrange alone
        ws_cand, _ = _kernel_params(epsilon, W_SIGMA)
        ws_cand += 1
        r2_min = float((ell1**2).min() + (emm1**2).min())
        r2_max = float((ell1**2).max() + (emm1**2).max())
        z_lo = float(np.sqrt(max(1.0 - r2_max, 0.0)) - 1.0)
        z_hi = float(np.sqrt(max(1.0 - r2_min, 0.0)) - 1.0)
        dw = 1.0 / (2.0 * W_SIGMA * max(0.5 * (z_hi - z_lo), 1e-12))
        shift = int(np.floor(-ws_cand / 2.0)) + 1
        nplanes = int(np.floor((wmax - wmin) / dw - ws_cand / 2.0)) + 1 - shift + ws_cand
        if w_mode == "auto":
            # slot-unit cost model: per-vis slots + per-bin (big iFFT +
            # assembly ~ lattice area / 4 slots)
            fbin = nbig_x * nbig_y / 4.0
            mode = "wplanes" if ws_cand * nvis + nplanes * fbin < nvis + nbins_chirp * fbin else "chirp"
        else:
            mode = w_mode
        if mode == "wplanes":
            if subgrid_auto and S != 32:  # the coarse-lattice tier: fewer, fuller (plane, bucket) groups
                S, half, sigma = 32, 16, 1.5
                nbig_x, nbig_y = _lattice(nx, ny, S, half, sigma)
            w_support = ws_cand
            nbins = nplanes
            if force_w_range is not None and int(force_w_range[2]) != nbins:
                raise ValueError(f"force_w_range nbins={int(force_w_range[2])} != derived wplane count {nbins}")
            wk = dict(dw=dw, w0=wmin + shift * dw, z0=0.5 * (z_lo + z_hi), beta=2.30 * ws_cand)
            wc = wk["w0"] + np.arange(nbins) * dw
        else:
            nbins = int(force_w_range[2]) if force_w_range is not None else nbins_chirp
            if nbins > max_bins:
                raise ValueError(f"IDG needs {nbins} w-bins (> {max_bins}); field too wide")
            edges = np.linspace(wmin, wmax, nbins + 1)
            wc = 0.5 * (edges[:-1] + edges[1:])
    else:
        wmin = wmax = 0.0
        nbins = 1
        wc = np.zeros(1)
    wlo, whi = (w_min_all, w_max_all) if do_w else (0.0, 0.0)
    if count_only == "w":
        return nbins, None, (wlo, whi, w_support)

    k0_off = (S - half) // 2
    nbu, nbv = nbig_x // half, nbig_y // half
    cux, cvy = cellx * nbig_x, celly * nbig_y
    sflat = np.ones(nvis + 1)
    sflat[:nvis] = np.where(np.repeat(fold_row, nchan), -1.0, 1.0)
    if w_support > 1:
        lay = _windowed_layout(uvw, invlam, (su, sv, sw), cux, cvy, l0, m0, nbig_x, nbig_y, half, nbu, nbv, k0_off,
                               G, nbins, w_support, wk["w0"], wk["dw"], count_only)
        bin_gcount = lay["bin_gcount"]
        if count_only:
            return nbins, tuple(int(x) for x in bin_gcount), (wlo, whi, w_support)
        bin_gstart = np.concatenate([[0], np.cumsum(bin_gcount)])[:-1]
        ng = int(bin_gcount.sum())
        _check_slot_budget(ng, G, nvis * w_support, nbins, max_slot_factor)
        if bin_gcap is not None:
            keys = ("win_start", "win_off", "win_len", "plane_g", "bid_g")
            bin_gstart, bin_gcount, padded = _pad_to_caps(bin_gstart, bin_gcount, bin_gcap,
                                                          {k: (lay[k], 0) for k in keys})
            lay.update(padded)
            ng = int(bin_gcount.sum())
        bid_g = lay["bid_g"]
    else:
        blsu = bl * nbig_x * cellx
        bmsv = bm * nbig_y * celly
        chiru = -2.0 * np.pi * gl * (nbig_x * cellx) ** 2 / S**2
        chirv = -2.0 * np.pi * gm * (nbig_y * celly) ** 2 / S**2
        binw = (wmax - wmin) / nbins if do_w else 0.0

        # ── bucketing + grouping (numpy when the native library is missing) ──
        from ..native import idg_bucket_group, idg_fill_groups

        nat = idg_bucket_group(
            uvw, invlam, (su, sv, sw), cux, cvy, l0, m0, nbins, float(wmin) if do_w else 0.0, float(binw),
            float(alpha), float(blsu), float(bmsv), float(chiru), float(chirv), nbig_x, nbig_y, half, nbu, nbv,
            k0_off, G,
        )
        if nat is None:
            nat = _bucket_numpy(uvw, invlam, (su, sv, sw), cux, cvy, l0, m0, nbins, edges, wc, do_w, alpha, blsu,
                                bmsv, chiru, chirv, nbig_x, nbig_y, half, nbu, nbv, k0_off)
            fill = _fill_numpy
        else:
            fill = idg_fill_groups
        order, uniq, starts, counts, payload = nat
        gper = -(-counts // G)
        gbase = np.concatenate([[0], np.cumsum(gper)])
        ng = int(gbase[-1])
        bin_gcount = np.zeros(nbins, np.int64)
        np.add.at(bin_gcount, uniq // (nbu * nbv), gper)
        bin_gstart = np.concatenate([[0], np.cumsum(bin_gcount)])[:-1]
        if count_only:
            return nbins, tuple(int(x) for x in bin_gcount), (wlo, whi, 1)
        _check_slot_budget(ng, G, nvis, nbins, max_slot_factor)
        cg_idx, du_g, dv_g, phiu_g, phiv_g, phase_g, _ = fill(order, starts, counts, gbase[:-1], G, ng, nvis,
                                                              payload)
        bid_g = np.repeat(uniq % (nbu * nbv), gper)
        if bin_gcap is not None:
            arrays = dict(cg_idx=(cg_idx, nvis), du=(du_g, 0.0), dv=(dv_g, 0.0), phiu=(phiu_g, 0.0),
                          phiv=(phiv_g, 0.0), phase=(phase_g, 0.0), bid=(bid_g, 0))
            bin_gstart, bin_gcount, p = _pad_to_caps(bin_gstart, bin_gcount, bin_gcap, arrays)
            cg_idx, du_g, dv_g, phiu_g, phiv_g, phase_g, bid_g = (p[k] for k in arrays)
            ng = int(bin_gcount.sum())

    # ── taper fit, taper-DFT constants ───────────────────────────────
    chirp = CHIRP_BUDGET if (do_w and w_support == 1) else 0.0
    widen = rdt == torch.float32
    cu, Tu_fn, _ = fit_taper(S, half, nx / (2.0 * nbig_x) + 0.01, chirp, tol=0.25 * epsilon, widen=widen)
    cv, Tv_fn, _ = fit_taper(S, half, ny / (2.0 * nbig_y) + 0.01, chirp, tol=0.25 * epsilon, widen=widen)
    W = np.exp(-2j * np.pi * np.outer(np.arange(S), np.arange(S)) / S)

    # ── image arrays in f64: n-1, 1/(Tu Tv) [/ n] [x dw / khat_w(n-1 - z0)] ──
    nn = np.sqrt(np.maximum(1.0 - ell1[:, None] ** 2 - emm1[None, :] ** 2, 0.0))
    nm1 = nn - 1.0
    corr = 1.0 / np.outer(Tu_fn((np.arange(nx) - nx // 2) / nbig_x), Tv_fn((np.arange(ny) - ny // 2) / nbig_y))
    if divide_by_n:
        corr = np.where(nn > 0, corr / np.where(nn > 0, nn, 1.0), 0.0)
    if w_support > 1:
        corr = corr * (wk["dw"] / _kernel_ft(nm1 - wk["z0"], w_support, wk["beta"], delta=wk["dw"]))

    dev = torch.device(device)
    as_t = lambda a, t=rdt: to_device(a, dev, t)  # noqa: E731
    rep_idx = None
    if w_support > 1:
        cg_idx_t, scal_t, phre_t, phim_t, sg_t, rep_idx = _window_constants(lay, nvis, G, w_support, S, wk, sflat,
                                                                            dev, rdt)
    else:
        scal_t = as_t(np.stack([2.0 * np.pi / S * du_g, phiu_g, 2.0 * np.pi / S * dv_g, phiv_g]))
        cg_idx_t, sg_t = as_t(cg_idx, torch.int64), as_t(sflat[cg_idx])
        phre_t, phim_t = as_t(phase_g.real), as_t(phase_g.imag)
    plan = IDGPlan(
        nx=nx, ny=ny, nbig_x=nbig_x, nbig_y=nbig_y, S=S, half=half, G=G, ngroups=ng, nbu=nbu, nbv=nbv,
        k0_off=k0_off, nrow=nrow, nchan=nchan, nbins=nbins,
        bin_gstart=tuple(int(x) for x in bin_gstart), bin_gcount=tuple(int(x) for x in bin_gcount),
        bin_wc=tuple(float(x) for x in wc), do_wgridding=do_w, hermitian=bool(hermitian), epsilon=float(epsilon),
        scal=scal_t, wcu=as_t(np.stack([(W * cu).real, (W * cu).imag])),
        wcv=as_t(np.stack([(W * cv).real, (W * cv).imag])), sg=sg_t, cg_idx=cg_idx_t,
        bid=as_t(bid_g, torch.int64), phase_re=phre_t, phase_im=phim_t,
        corr_re=as_t(corr.real), corr_im=as_t(corr.imag), nm1=as_t(nm1, torch.float64),
        w_support=int(w_support), rep_idx=rep_idx,
    )
    return _with_screens(plan)


def idg_slot_factor(uvw, freq, **kw):
    """IDG viability probe (the JAX ``idg_slot_factor``): (padding factor,
    nbins) from the bucket/count pass of :func:`plan_idg` alone, for
    ``gridder="auto"`` routing. The factor is slots per visibility over the
    chosen w scheme's own slots per visibility (``w_support`` replicas in
    wplanes mode)."""
    nvis = uvw.shape[0] * freq.shape[0]
    if nvis == 0:
        return 1.0, 1
    kw = dict(kw, count_only=True)
    kw.pop("max_slot_factor", None)
    kw.setdefault("device", "cpu")
    nbins, gcount, (_, _, ws) = plan_idg(uvw, freq, **kw)
    return sum(gcount) * idg_fused.G / (nvis * ws), nbins


def _screen(plan: IDGPlan, b: int, sign: float) -> torch.Tensor:
    """Bin screen e^{i sign 2 pi w_c (n-1)}, phase in f64, cast to complex."""
    if plan.scr is not None:
        return plan.scr[b] if sign < 0 else plan.scr[b].conj()
    ph = (sign * 2.0 * np.pi * plan.bin_wc[b]) * plan.nm1
    return torch.polar(torch.ones_like(ph), ph).to(complex_dtype(plan.rdt))


def _with_screens(plan: IDGPlan) -> IDGPlan:
    """Cache the sign=-1 screens on the device when they are small."""
    nbytes = plan.nbins * plan.nx * plan.ny * 2 * torch.finfo(plan.rdt).bits // 8
    if plan.do_wgridding and plan.nbins > 1 and nbytes <= _SCREEN_CACHE_BYTES:
        plan.scr = torch.stack([_screen(plan, b, -1.0) for b in range(plan.nbins)])
    return plan


def delivered_accuracy(plan: IDGPlan) -> dict:
    """Per-plan accuracy budget (the JAX ``delivered_accuracy``): rel-Linf
    ``interior`` and ``edge`` budgets against an f64 oracle. The f32
    substrate floor (~2e-7) is amplified toward the image edge by the
    correction 1/T (``edge_amp``)."""
    corr = torch.complex(plan.corr_re.double(), plan.corr_im.double()).abs().cpu().numpy()
    c0 = float(corr[plan.nx // 2, plan.ny // 2])
    amp = float(corr.max() / max(c0, 1e-300))
    substrate = 2e-7 if plan.rdt == torch.float32 else 2e-16
    eps_alg = 2.0 * plan.epsilon
    return dict(edge_amp=amp, substrate=substrate, interior=eps_alg + 5.0 * substrate,
                edge=eps_alg + 5.0 * substrate * amp)


# ── runtime: the patch assembly (K1) and its transpose (K2) ──────────
#
# Group g of a bin, with bucket (bu, bv) = divmod(bid[g], nbv), carries an
# S x S patch whose element (su, sv) lands on the grid cell
#     ((bu half + su - k0_off) mod nbig_x, (bv half + sv - k0_off) mod nbig_y):
# the closed form of the JAX ``_assemble_bin`` (pfb_imaging_tpu/ops/
# gridder_idg.py:2026: a scatter of each patch onto its bucket's lattice
# cell, the r x r quarters of every cell, r = S / half, shift-added into the
# extended plane, which folds periodically onto the grid) and of its
# transpose ``_extract_bin`` (:2482). ``_assemble_bin`` /
# ``_extract_bin`` are the plain versions in the JAX formula (``index_add_``
# onto the lattice, in order on the CPU); ``assemble_bin_gather_ref`` /
# ``extract_bin_gather_ref`` the plain versions in the kernels' closed form,
# CSR, chunks and order of sums, so that the CPU tests check the kernels'
# index arithmetic; ``assemble_bin`` / ``extract_bin`` the wrappers, which
# run the JAX-formula plain versions for CPU tensors and launch the CUDA
# kernels (``csrc/idg_assemble.cu``, f32) for CUDA tensors or raise.
#
# What bounds K1 is bytes, once the work is spread: bucket sizes are skewed,
# and a padded plan (``bin_gcap``, the multiband plans) puts all its empty
# groups, thousands a bin, in bucket 0, whose cells would each add them one
# after another while the rest of the card idles. So every bucket with more
# than ``LONG_BUCKET`` groups is cut at plan time into chunks of
# ``chunk_length(n)`` consecutive CSR entries (a function of the bucket's
# count alone, so of the plan alone: any card gives the same bits), and K1
# is two launches: ``idg_chunk_sums`` sums each chunk's patches element by
# element, in CSR order, into a scratch partial (blocks a chunk and a tile of
# its elements, so a 6,000-group bucket becomes ~64 chains of ~96 side by
# side over the whole card), then ``idg_assemble`` writes each grid cell
# once, from the one thread that owns it, with no zeroing and no atomics.
# Its blocks are pairs of lattice cells of the extended plane's first wrap,
# so the threads of a cell share their buckets. A cell sums, from 0, by
# wrap (u, then v), then quarter (a, then b), then in
# the bucket either its groups in CSR order (short) or its chunk partials in
# chunk order (long), so two runs give the same bits. ``LAUNCHES`` counts
# kernel launches: K1 is ``idg_chunk_sums`` (bins with a long bucket) and
# ``idg_assemble``, K2 ``idg_extract``.

LAUNCHES = {"idg_chunk_sums": 0, "idg_assemble": 0, "idg_extract": 0}


def _ext_dims(plan):
    r = plan.S // plan.half
    return (plan.nbu + r - 1) * plan.half, (plan.nbv + r - 1) * plan.half


def _fold_extended(plan, ext):
    """Periodic fold of the (ext_u, ext_v) extended plane onto the big grid
    (absolute cell of extended index t is t - k0_off)."""
    ext_u, ext_v = _ext_dims(plan)
    ko, nbx, nby = plan.k0_off, plan.nbig_x, plan.nbig_y
    fu = ext[ko : ko + nbx, :].clone()
    fu[nbx - ko :, :] += ext[:ko, :]
    if ext_u - nbx - ko > 0:
        fu[: ext_u - nbx - ko, :] += ext[ko + nbx :, :]
    fv = fu[:, ko : ko + nby].clone()
    fv[:, nby - ko :] += fu[:, :ko]
    if ext_v - nby - ko > 0:
        fv[:, : ext_v - nby - ko] += fu[:, ko + nby :]
    return fv


def _assemble_bin(plan, p_b, bid_b):
    """One bin's (2, gc, S, S) patches -> complex (nbig_x, nbig_y) uv grid:
    ``index_add_`` of each group's patch onto its bucket's lattice cell,
    then the r x r quarters of every cell shift-add into the blocked grid,
    which unblocks to the extended plane and folds periodically."""
    S, half = plan.S, plan.half
    r = S // half
    nbu, nbv = plan.nbu, plan.nbv
    R_u, R_v = nbu + r - 1, nbv + r - 1
    gc = p_b.shape[1]
    planes = []
    for c in range(2):
        orig = p_b.new_zeros((nbu * nbv, S * S)).index_add_(0, bid_b, p_b[c].reshape(gc, S * S))
        O4 = orig.view(nbu, nbv, S, S)
        L = p_b.new_zeros((R_u, R_v, half, half))
        for a in range(r):
            for b in range(r):
                L[a : a + nbu, b : b + nbv] += O4[:, :, a * half : (a + 1) * half, b * half : (b + 1) * half]
        planes.append(_fold_extended(plan, L.permute(0, 2, 1, 3).reshape(R_u * half, R_v * half)))
    return torch.complex(planes[0], planes[1])


def _extract_bin(plan, grid, bid_b):
    """Transpose of :func:`_assemble_bin`: per-group S x S windows of the
    periodically extended grid. Returns (2, gc, S, S)."""
    S, half = plan.S, plan.half
    r = S // half
    ko, nbx, nby = plan.k0_off, plan.nbig_x, plan.nbig_y
    nbu, nbv = plan.nbu, plan.nbv
    ext_u, ext_v = _ext_dims(plan)
    R_u, R_v = nbu + r - 1, nbv + r - 1
    fu = torch.cat([grid[nbx - ko :, :], grid] + ([grid[: ext_u - nbx - ko, :]] if ext_u - nbx - ko > 0 else []), 0)
    out = torch.cat([fu[:, nby - ko :], fu] + ([fu[:, : ext_v - nby - ko]] if ext_v - nby - ko > 0 else []), 1)
    planes = []
    for arr in (out.real, out.imag):
        L = arr.reshape(R_u, half, R_v, half).permute(0, 2, 1, 3)
        orig = arr.new_zeros((nbu, nbv, S, S))
        for a in range(r):
            for b in range(r):
                orig[:, :, a * half : (a + 1) * half, b * half : (b + 1) * half] += L[a : a + nbu, b : b + nbv]
        planes.append(orig.reshape(nbu * nbv, S, S)[bid_b])
    return torch.stack(planes)


# ── the per-plan CSR: each bin's groups by bucket, long buckets in chunks ─

# A bucket with more groups than this is summed in chunks (K1's first
# launch); of 8, 16, 24, 32 and 64, 16 and 8 gave K1's least time at both
# multiband launches of chip_smoke.py on an H100 (PERF.md, section 6)
LONG_BUCKET = 16
# chunk lengths are multiples of this (a warp)
CHUNK_QUANTUM = 32


def chunk_length(n):
    """Groups in each chunk of a long bucket of ``n`` groups (an int or an
    integer array): ceil(sqrt(n)) rounded up to a multiple of
    ``CHUNK_QUANTUM``, so a chunk's chain and the chain of its bucket's
    partials grow alike; the last chunk takes the rest."""
    n = np.asarray(n, dtype=np.int64)
    s = np.sqrt(n.astype(np.float64)).astype(np.int64)  # floor(sqrt(n)), exact after the two corrections
    s -= s * s > n
    s += (s + 1) * (s + 1) <= n
    s += s * s < n
    return -(-s // CHUNK_QUANTUM) * CHUNK_QUANTUM


def _chunk_table(starts: np.ndarray):
    """The chunks of the long buckets of a CSR ``starts`` (int64, every bin
    and bucket): (pstarts, chunks), where bucket k's chunks are
    ``chunks[pstarts[k] : pstarts[k + 1]]`` (none for a short bucket), each
    a [lo, hi) range of CSR entries, consecutive and in CSR order. A
    function of the counts alone."""
    counts = np.diff(starts)
    long = np.flatnonzero(counts > LONG_BUCKET)
    n = counts[long]
    length = chunk_length(n)
    nch = -(-n // length)
    pcount = np.zeros(len(counts), np.int64)
    pcount[long] = nch
    pstarts = np.concatenate([[0], np.cumsum(pcount)])
    j = np.arange(int(nch.sum())) - np.repeat(pstarts[long], nch)  # chunk index within its bucket
    lo = np.repeat(starts[long], nch) + j * np.repeat(length, nch)
    hi = np.minimum(lo + np.repeat(length, nch), np.repeat(starts[long + 1], nch))
    return pstarts, np.stack([lo, hi], 1)


@dataclasses.dataclass(frozen=True, eq=False)
class BucketCSR:
    """Each bin's groups by bucket: those of bucket k in bin b are
    ``order[starts[b * nb + k] : starts[b * nb + k + 1]]`` (nb = nbu nbv),
    ascending. ``order`` (ng,) int32 is None where the plan's groups already
    lie in (bin, bucket) order, as the chirp and wplanes planners lay them;
    a padded plan (``bin_gcap``, the multiband plans) ends each bin's block
    with empty bucket-0 groups, and then ``order`` is the stable permutation
    into that order, and ``first`` (nbins nb,) int32 holds, for each bucket
    whose groups are consecutive (every bucket but a padded bucket 0), its
    first group, so that K1 reads no ``order`` entry for it (-1 elsewhere).
    ``starts`` (nbins nb + 1,) int32: 4 bytes a bucket and bin, 1 / (2 S^2)
    of the lattice the JAX formula fills a bin. The long buckets' chunks
    (:func:`_chunk_table`): ``chunks`` (nchunks, 2) int32 CSR ranges and
    ``pstarts`` (nbins nb + 1,) int32 each bucket's first chunk, both None
    where no bucket is long; ``bin_chunk0`` (nbins + 1, host ints) each
    bin's first chunk. ``bid`` and ``bins`` are the plan's when it was built
    (a plan padded in place gets a new CSR)."""

    bid: torch.Tensor
    bins: tuple
    order: torch.Tensor | None
    first: torch.Tensor | None
    starts: torch.Tensor
    pstarts: torch.Tensor | None
    chunks: torch.Tensor | None
    bin_chunk0: tuple


_CSR: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def bucket_csr(plan) -> BucketCSR:
    """The plan's :class:`BucketCSR`, on its device, cached by plan
    identity; an entry leaves the cache with its plan."""
    bins = (plan.bin_gstart, plan.bin_gcount)
    csr = _CSR.get(plan)
    if csr is None or csr.bid is not plan.bid or csr.bins != bins:
        csr = _CSR[plan] = _build_csr(plan, bins)
    return csr


def _build_csr(plan, bins) -> BucketCSR:
    dev, nb, ng = plan.bid.device, plan.nbu * plan.nbv, plan.ngroups
    if plan.bid.dtype != torch.int64 or not plan.bid.is_contiguous():
        raise ValueError("plan.bid must be a contiguous int64 tensor")
    if ng and not bool(((plan.bid >= 0) & (plan.bid < nb)).all()):
        raise ValueError(f"plan bucket ids outside [0, {nb})")
    bin_of = torch.full((ng,), -1, dtype=torch.int64, device=dev)  # groups outside every bin sort first
    for b, (gs, gc) in enumerate(zip(*bins)):
        bin_of[gs : gs + gc] = b
    key, perm = torch.sort(bin_of * nb + plan.bid, stable=True)
    starts = torch.searchsorted(key, torch.arange(plan.nbins * nb + 1, device=dev))
    identity = torch.equal(perm, torch.arange(ng, device=dev))
    pstarts, chunks = _chunk_table(starts.cpu().numpy())
    has = len(chunks) > 0
    return BucketCSR(bid=plan.bid, bins=bins, order=None if identity else perm.to(torch.int32),
                     first=None if identity else _first_of_runs(perm, starts), starts=starts.to(torch.int32),
                     pstarts=torch.as_tensor(pstarts, dtype=torch.int32, device=dev) if has else None,
                     chunks=torch.as_tensor(chunks, dtype=torch.int32, device=dev) if has else None,
                     bin_chunk0=tuple(int(c) for c in pstarts[::nb]))


def _first_of_runs(perm, starts):
    """Each bucket's first group where its groups ``perm[starts[k] :
    starts[k + 1]]`` are consecutive, else -1 (int32)."""
    counts = starts.diff()
    s0, s1 = int(starts[0]), int(starts[-1])
    bucket = torch.repeat_interleave(torch.arange(len(counts), device=perm.device), counts)
    step = perm[s0 + 1 : s1] - perm[s0 : s1 - 1]
    gaps = torch.zeros_like(counts).index_add_(0, bucket[1:], ((step != 1) & (bucket[1:] == bucket[:-1])).long())
    head = perm[starts[:-1].clamp(max=max(len(perm) - 1, 0))] if len(perm) else torch.zeros_like(counts)
    return torch.where((gaps == 0) & (counts > 0), head, -1).to(torch.int32)


# ── the plain versions in the kernels' closed form ────────────────────


def _axis_terms(n: int, nbk: int, ext: int, half: int, r: int, ko: int, dev):
    """Along one axis of length ``n``: for each wrap, for each quarter, the
    (valid, bucket row, patch row) of every cell, as K1 enumerates them."""
    t0 = (torch.arange(n, device=dev) + ko) % n
    wraps = []
    for w in range(-(-ext // n)):
        t = t0 + w * n
        quarters = []
        for a in range(r):
            bk = t // half - a
            ok = (t < ext) & (bk >= 0) & (bk < nbk)
            quarters.append((ok, bk.clamp(0, nbk - 1), t - bk * half))  # patch row in [0, S)
        wraps.append(quarters)
    return wraps


def chunk_sums_ref(plan, patches, b: int):
    """Plain version of K1's first launch: bin ``b``'s chunk partials (2,
    nchunk, S, S), each the sum from 0 of its chunk's patches in CSR order."""
    csr = bucket_csr(plan)
    c0, c1 = csr.bin_chunk0[b], csr.bin_chunk0[b + 1]
    part = patches.new_zeros((2, c1 - c0, plan.S, plan.S))
    if c1 == c0:
        return part
    lo, hi = (csr.chunks[c0:c1, i].to(torch.int64) for i in range(2))
    order = None if csr.order is None else csr.order.to(torch.int64)
    for j in range(int((hi - lo).max())):
        live = (j < hi - lo)[:, None, None]
        i = torch.where(live[:, 0, 0], lo + j, lo)
        g = i if order is None else order[i]
        part = torch.where(live, part + patches[:, g], part)
    return part


def assemble_bin_gather_ref(plan, patches, b: int):
    """Plain version of K1 in its own closed form, CSR, chunks and order of
    sums: bin ``b``'s complex (nbig_x, nbig_y) grid from the plan's (2, ng,
    S, S) patches, each cell the sum from 0, by wrap, then quarter, then in
    the bucket its groups (short) or its chunk partials (long), of the
    patch elements landing on it."""
    S, half, ko = plan.S, plan.half, plan.k0_off
    r, nb = S // half, plan.nbu * plan.nbv
    ext_u, ext_v = (plan.nbu + r - 1) * half, (plan.nbv + r - 1) * half
    dev = patches.device
    csr = bucket_csr(plan)
    starts = csr.starts[b * nb : (b + 1) * nb + 1].to(torch.int64)
    order = None if csr.order is None else csr.order.to(torch.int64)
    c0 = csr.bin_chunk0[b]
    part = chunk_sums_ref(plan, patches, b)
    if part.shape[1]:
        pst = csr.pstarts[b * nb : (b + 1) * nb + 1].to(torch.int64) - c0
    else:
        pst, part = torch.zeros_like(starts), patches.new_zeros((2, 1, S, S))  # no long bucket: never read
    npart = pst[1:] - pst[:-1]
    terms = torch.where(npart > 0, npart, starts[1:] - starts[:-1])
    max_terms = int(terms.max()) if nb else 0
    acc = [patches.new_zeros((plan.nbig_x, plan.nbig_y)) for _ in range(2)]
    terms_u = _axis_terms(plan.nbig_x, plan.nbu, ext_u, half, r, ko, dev)
    terms_v = _axis_terms(plan.nbig_y, plan.nbv, ext_v, half, r, ko, dev)
    for wu in terms_u:
        for wv in terms_v:
            for oku, bu, su in wu:
                for okv, bv, sv in wv:
                    k = bu[:, None] * plan.nbv + bv[None, :]
                    lo, plo, long = starts[k], pst[k], npart[k] > 0
                    cnt = torch.where(oku[:, None] & okv[None, :], terms[k], 0)
                    for j in range(max_terms):
                        live = j < cnt
                        i = torch.where(live & ~long, lo + j, 0)
                        g = i if order is None else order[i]
                        c = torch.where(live & long, plo + j, 0)
                        for ri in range(2):
                            val = torch.where(long, part[ri][c, su[:, None], sv[None, :]],
                                              patches[ri][g, su[:, None], sv[None, :]])
                            acc[ri] = torch.where(live, acc[ri] + val, acc[ri])
    return torch.complex(acc[0], acc[1])


def extract_bin_gather_ref(plan, grid, b: int):
    """Plain version of K2 in its closed form: bin ``b``'s (2, gc, S, S)
    patches gathered from the complex (nbig_x, nbig_y) grid."""
    gs, gc = plan.bin_gstart[b], plan.bin_gcount[b]
    bid = plan.bid[gs : gs + gc]
    s = torch.arange(plan.S, device=grid.device)
    x = (torch.div(bid, plan.nbv, rounding_mode="floor")[:, None] * plan.half + s - plan.k0_off) % plan.nbig_x
    y = ((bid % plan.nbv)[:, None] * plan.half + s - plan.k0_off) % plan.nbig_y
    v = grid[x[:, :, None], y[:, None, :]]
    return torch.stack([v.real, v.imag])


# ── the wrappers ──────────────────────────────────────────────────────


def _check_patches(plan, patches) -> None:
    S = plan.S
    if patches.device != plan.bid.device:
        raise ValueError(f"patches are on {patches.device}, the plan on {plan.bid.device}")
    if patches.dtype != torch.float32:
        raise TypeError(f"patches: the CUDA kernel takes float32, got {patches.dtype}")
    if tuple(patches.shape) != (2, plan.ngroups, S, S) or patches.stride()[1:] != (S * S, S, 1):
        raise ValueError(f"patches: shape {tuple(patches.shape)} != {(2, plan.ngroups, S, S)} or its groups "
                         "not contiguous")


def _check_grid(plan, grid) -> None:
    if grid.device != plan.bid.device:
        raise ValueError(f"grid is on {grid.device}, the plan on {plan.bid.device}")
    if grid.dtype != torch.complex64:
        raise TypeError(f"grid: the CUDA kernel takes complex64, got {grid.dtype}")
    if tuple(grid.shape) != (plan.nbig_x, plan.nbig_y) or not grid.is_contiguous():
        raise ValueError(f"grid: shape {tuple(grid.shape)} != {(plan.nbig_x, plan.nbig_y)} or not contiguous")


def _check_k1_layout(plan) -> None:
    """K1's blocks are half x half threads (at least a warp) over whole
    lattice cells, its terms even offsets, and a warp sets up 2 (S / half)^2
    buckets: so half is even and at least 6, S / half at most 4, and the
    grid's sides multiples of half (the planner's half 8, 12 and 16 are)."""
    S, half = plan.S, plan.half
    if half < 6 or half % 2 or S // half > 4 or plan.nbig_x % half or plan.nbig_y % half:
        raise ValueError(f"K1 takes an even half >= 6 with S / half <= 4 and grid sides multiples of half; got "
                         f"S {S}, half {half}, grid {(plan.nbig_x, plan.nbig_y)}")


def _launch_chunk_sums(plan, patches, csr, b: int, lib):
    """Bin ``b``'s chunk partials by K1's first kernel (arguments checked by
    the caller), or None where the bin has no long bucket."""
    c0, c1 = csr.bin_chunk0[b], csr.bin_chunk0[b + 1]
    if c1 == c0:
        return None
    if patches.data_ptr() % 16 or patches.stride(0) % 4:
        raise ValueError("patches: K1 reads 16-byte vectors; the tensor's start or plane stride is not aligned to them")
    part = torch.empty((2, c1 - c0, plan.S, plan.S), dtype=torch.float32, device=patches.device)  # written whole
    from ..kernels.build import check

    code = lib.pfb_idg_chunk_sums(
        patches.data_ptr(), patches.stride(0), None if csr.order is None else csr.order.data_ptr(),
        csr.chunks.data_ptr() + 8 * c0, c1 - c0, part.data_ptr(), part.stride(0), plan.S,
        idg_fused._stream(patches.device),
    )
    check(code, "idg_chunk_sums")
    LAUNCHES["idg_chunk_sums"] += 1
    return part


def chunk_sums(plan, patches, b: int):
    """K1's first launch: bin ``b``'s chunk partials (2, nchunk, S, S), or
    None where the bin has no long bucket; the plain version for CPU
    tensors, else the kernel (f32)."""
    if patches.device.type == "cpu":
        csr = bucket_csr(plan)
        return chunk_sums_ref(plan, patches, b) if csr.bin_chunk0[b + 1] > csr.bin_chunk0[b] else None
    _check_patches(plan, patches)
    from ..kernels.build import load

    return _launch_chunk_sums(plan, patches, bucket_csr(plan), b, load())


def assemble_bin(plan, patches, b: int):
    """Bin ``b``'s complex (nbig_x, nbig_y) uv grid from the plan's (2, ng,
    S, S) patches (the groups may be a view into a larger tensor along the
    first axis): the plain version for CPU tensors, else K1 (f32): the chunk
    sums of the bin's long buckets, where it has any, then the assembly."""
    gs, gc = plan.bin_gstart[b], plan.bin_gcount[b]
    if patches.device.type == "cpu":
        return _assemble_bin(plan, patches[:, gs : gs + gc], plan.bid[gs : gs + gc])
    _check_patches(plan, patches)
    _check_k1_layout(plan)
    from ..kernels.build import check, load

    lib, csr, nb = load(), bucket_csr(plan), plan.nbu * plan.nbv
    part = _launch_chunk_sums(plan, patches, csr, b, lib)
    out = torch.empty((plan.nbig_x, plan.nbig_y), dtype=torch.complex64, device=patches.device)  # written whole
    code = lib.pfb_idg_assemble(
        patches.data_ptr(), patches.stride(0), None if csr.order is None else csr.order.data_ptr(),
        csr.starts.data_ptr() + 4 * b * nb, None if csr.first is None else csr.first.data_ptr() + 4 * b * nb,
        None if part is None else part.data_ptr(), 0 if part is None else part.stride(0),
        None if part is None else csr.pstarts.data_ptr() + 4 * b * nb, csr.bin_chunk0[b], out.data_ptr(),
        plan.nbig_x, plan.nbig_y, plan.S, plan.half, plan.k0_off, plan.nbu, plan.nbv,
        idg_fused._stream(patches.device),
    )
    check(code, "idg_assemble")
    LAUNCHES["idg_assemble"] += 1
    return out


def extract_bin(plan, grid, b: int, out):
    """Bin ``b``'s (2, gc, S, S) patches of the complex (nbig_x, nbig_y) uv
    grid, written into its groups of ``out`` (2, ng, S, S), which is
    returned: the plain version for CPU tensors, else K2 (f32)."""
    gs, gc = plan.bin_gstart[b], plan.bin_gcount[b]
    if grid.device.type == "cpu":
        out[:, gs : gs + gc] = _extract_bin(plan, grid, plan.bid[gs : gs + gc])
        return out
    _check_grid(plan, grid)
    _check_patches(plan, out)
    if gc:
        from ..kernels.build import check, load

        S = plan.S
        code = load().pfb_idg_extract(
            grid.data_ptr(), plan.bid.data_ptr() + 8 * gs, out.data_ptr() + 4 * gs * S * S, out.stride(0), gc, S,
            plan.half, plan.k0_off, plan.nbv, plan.nbig_x, plan.nbig_y, idg_fused._stream(grid.device),
        )
        check(code, "idg_extract")
        LAUNCHES["idg_extract"] += 1
    return out


# ── runtime: adjoint (vis -> dirty) ──────────────────────────────────


def _crop(plan, big):
    px0 = plan.nbig_x // 2 - plan.nx // 2
    py0 = plan.nbig_y // 2 - plan.ny // 2
    return big[..., px0 : px0 + plan.nx, py0 : py0 + plan.ny]


def _idg_prepare(plan: IDGPlan, vis_re, vis_im, wgt=None):
    """Weighted, conj-phased, group-gathered values: (2, ng, G)."""
    wre = vis_re.to(plan.rdt).reshape(-1)
    wim = vis_im.to(plan.rdt).reshape(-1)
    if wgt is not None:
        w = wgt.to(plan.rdt).reshape(-1)
        wre, wim = wre * w, wim * w
    zero = wre.new_zeros(1)
    g0 = torch.cat([wre, zero])[plan.cg_idx]
    g1 = torch.cat([wim, zero])[plan.cg_idx]
    if plan.hermitian:
        g1 = g1 * plan.sg
    pre, pim = plan.phase_re, plan.phase_im
    return torch.stack([g0 * pre + g1 * pim, g1 * pre - g0 * pim])


def _idg_accumulate_bins(plan: IDGPlan, patches):
    """Sum of per-bin images: assemble -> ifft2 -> fftshift -> crop -> screen."""
    acc = torch.zeros((plan.nx, plan.ny), dtype=complex_dtype(plan.rdt), device=plan.device)
    for b in range(plan.nbins):
        if plan.bin_gcount[b] == 0:
            continue
        grid = assemble_bin(plan, patches, b)
        big = torch.fft.ifft2(grid) * (plan.nbig_x * plan.nbig_y)
        a = _crop(plan, torch.fft.fftshift(big))
        if plan.do_wgridding:
            a = a * _screen(plan, b, -1.0)
        acc += a
    return acc


def _idg_finish(plan: IDGPlan, acc):
    return (acc * torch.complex(plan.corr_re, plan.corr_im)).real


def vis2dirty_idg_grouped(plan: IDGPlan, vals):
    """Adjoint from group-layout values (2, ng, G) — zero gathers."""
    patches = idg_fused.patches_from_vals(plan.scal, vals.contiguous(), plan.wcu, plan.wcv, plan.S)
    return _idg_finish(plan, _idg_accumulate_bins(plan, patches))


def vis2dirty_idg(plan: IDGPlan, vis, wgt=None, mask=None, vis_im=None):
    """Grid (nrow, nchan) visibilities to an (nx, ny) dirty image (adjoint).

    ``vis`` is complex, or its real part with ``vis_im`` the imaginary part;
    ``wgt`` and ``mask`` multiply each visibility (the mask multiplies the
    weight, as in JAX).
    """
    if vis_im is None:
        vis, vis_im = vis.real, vis.imag
    if mask is not None:
        mask = torch.as_tensor(mask).to(device=plan.device, dtype=plan.rdt)
        wgt = mask if wgt is None else wgt.to(plan.rdt) * mask
    return vis2dirty_idg_grouped(plan, _idg_prepare(plan, vis, vis_im, wgt))


# ── runtime: forward (dirty -> vis), exact conj-transpose ────────────


def _idg_bins_to_grid_patches(plan: IDGPlan, image, out=None):
    """Forward: image -> (2, ng, S, S) patch uv samples, bin-contiguous,
    written into ``out`` when it is given."""
    cdt = complex_dtype(plan.rdt)
    y = image.to(plan.rdt).to(cdt) * torch.complex(plan.corr_re, plan.corr_im).conj()
    # every group lies in one bin, so the bins write every patch
    patches = torch.empty((2, plan.ngroups, plan.S, plan.S), dtype=plan.rdt, device=plan.device) if out is None else out
    px0 = plan.nbig_x // 2 - plan.nx // 2
    py0 = plan.nbig_y // 2 - plan.ny // 2
    for b in range(plan.nbins):
        if plan.bin_gcount[b] == 0:
            continue
        yb = y * _screen(plan, b, 1.0) if plan.do_wgridding else y
        padded = torch.zeros((plan.nbig_x, plan.nbig_y), dtype=cdt, device=plan.device)
        padded[px0 : px0 + plan.nx, py0 : py0 + plan.ny] = yb
        grid = torch.fft.fft2(torch.fft.ifftshift(padded))
        extract_bin(plan, grid, b, patches)
    return patches


def dirty2vis_idg_grouped(plan: IDGPlan, image):
    """Forward to group-layout values (2, ng, G) — the exact conj-transpose
    of :func:`vis2dirty_idg_grouped`."""
    patches = _idg_bins_to_grid_patches(plan, image)
    return idg_fused.vals_from_patches(patches, plan.scal, plan.wcu, plan.wcv, plan.S)


def _slots_to_vis(plan: IDGPlan, vals):
    """Group values (2, ng, G) -> (2, nvis) visibilities: the slot phase, the
    hermitian sign on the imaginary part, then each visibility's slot (one
    scatter; empty slots land on a dropped extra entry) or, in wplanes mode,
    the sum of its ``w_support`` replica slots (one gather of ``rep_idx``
    and a sum: no atomics, so the sums do not depend on the order of adds)."""
    pre, pim = plan.phase_re, plan.phase_im
    vre = vals[0] * pre - vals[1] * pim
    vim = vals[0] * pim + vals[1] * pre
    if plan.hermitian:
        vim = vim * plan.sg
    flat = torch.stack([vre.reshape(-1), vim.reshape(-1)])
    if plan.rep_idx is not None:
        return flat[:, plan.rep_idx].sum(-1)
    nvis = plan.nrow * plan.nchan
    out = vals.new_zeros((2, nvis + 1))
    out[:, plan.cg_idx.reshape(-1)] = flat
    return out[:, :nvis]


def dirty2vis_idg(plan: IDGPlan, image, mask=None, split: bool = False):
    """Degrid an (nx, ny) image to (nrow, nchan) visibilities, the exact
    conjugate transpose of :func:`vis2dirty_idg`. Complex, or (2, nrow,
    nchan) with ``split``."""
    image = torch.as_tensor(image).to(device=plan.device, dtype=plan.rdt)
    out = _slots_to_vis(plan, dirty2vis_idg_grouped(plan, image)).reshape(2, plan.nrow, plan.nchan)
    if mask is not None:
        out = out * torch.as_tensor(mask).to(device=plan.device, dtype=plan.rdt)[None]
    return out if split else torch.complex(out[0], out[1])


def to_group_layout(plan: IDGPlan, arr):
    """(nrow, nchan) real array -> (ng, G) group layout (one gather; empty
    slots get 0)."""
    flat = arr.to(device=plan.device, dtype=plan.rdt).reshape(-1)
    return torch.cat([flat, flat.new_zeros(1)])[plan.cg_idx]


def _weighted_round_trip(plan: IDGPlan, vals, wgt):
    """R R^H step between B2 and B1 of the vis-space Hessian: chirp plans
    multiply the group values by ``wgt`` in group layout; wplanes plans sum
    each visibility's replicas, weight the sum by ``wgt`` in original
    (nrow, nchan) layout and spread it back to the replicas."""
    if plan.w_support == 1:
        return vals if wgt is None else vals * wgt[None]
    mvis = _slots_to_vis(plan, vals)
    if wgt is not None:
        mvis = mvis * wgt.to(plan.rdt).reshape(1, -1)
    return _idg_prepare(plan, mvis[0], mvis[1])


def hessian_vis_idg(plan: IDGPlan, x, wgt_g=None, beam=None, eta: float = 0.0, wsum=None):
    """Exact vis-space Hessian B R^H W R B x / wsum + eta x. ``wgt_g`` is the
    masked weight: in group layout (:func:`to_group_layout`) for chirp
    plans, whose round trip is then gather-free; in original (nrow, nchan)
    layout for wplanes plans, where the weight applies to the replica sum,
    so the round trip pays the replica gather each way. ``beam``, ``wsum``
    and ``eta`` are applied around the round trip only when given."""
    xin = x if beam is None else x * beam
    vals = _weighted_round_trip(plan, dirty2vis_idg_grouped(plan, xin), wgt_g)
    conv = vis2dirty_idg_grouped(plan, vals)
    if wsum is not None:
        conv = conv / wsum
    if beam is not None:
        conv = conv * beam
    if eta:
        conv = conv + eta * x
    return conv


# ── carrying a JAX plan across ───────────────────────────────────────


def plan_from_jax(leaves: dict, meta: dict, *, device="cuda") -> IDGPlan:
    """The port's IDGPlan from the numpy leaves and static fields of a JAX
    ``IDGPlan`` (e.g. ``{f.name: np.asarray(getattr(p, f.name))}``), chirp
    or windowed wplanes.

    A fused plan carries its angles (``scal``) and permuted-kron constants
    (``wcu8``/``wcv8``, unpacked by ``wc_from_perm_kron``). An einsum plan
    stores only A~ = W diag(c) Z: the taper c comes from the same fit
    (``fit_taper`` on the plan's geometry) and the angles are read off
    Z = diag(1/c) W^-1 A~: phi = arg(Z[1] Z[-1]) / 2, du = arg(Z[1]) - phi
    (mod 2 pi, all the rotation recurrence needs). A windowed plan's slot
    map comes from its windows: slot (g, k) holds ``sort_idx[win_start[g] +
    k]`` where ``win_off[g] <= k < win_off[g] + win_len[g]``; its signs
    ``sg`` are per visibility, and ``rep_idx`` lists the replica slots.
    """
    rdt = real_dtype(device)
    dev = torch.device(device)
    as_t = lambda a, t=rdt: to_device(a, dev, t)  # noqa: E731
    S, half, nx, ny = int(meta["S"]), int(meta["half"]), int(meta["nx"]), int(meta["ny"])
    ng, G = int(meta["ngroups"]), int(meta["G"])
    ws = int(meta.get("w_support", 1))
    nvis = int(meta["nrow"]) * int(meta["nchan"])
    if meta["fused"]:
        scal = np.asarray(leaves["scal"], np.float64)
        wcu = idg_fused.wc_from_perm_kron(leaves["wcu8"], S)
        wcv = idg_fused.wc_from_perm_kron(leaves["wcv8"], S)
    else:
        if meta.get("onfly", False):
            raise NotImplementedError("onfly JAX plans: convert a fused or einsum plan")
        chirp = CHIRP_BUDGET if meta["do_wgridding"] and ws == 1 else 0.0
        eps = float(meta["epsilon"])
        W = np.exp(-2j * np.pi * np.outer(np.arange(S), np.arange(S)) / S)
        scal = np.zeros((4, ng, G))
        wcs = []
        for ax, (n, nbig, re, im) in enumerate(((nx, meta["nbig_x"], "au_re", "au_im"),
                                               (ny, meta["nbig_y"], "av_re", "av_im"))):
            c, _, _ = fit_taper(S, half, n / (2.0 * nbig) + 0.01, chirp, tol=0.25 * eps)
            A = np.asarray(leaves[re], np.float64) + 1j * np.asarray(leaves[im], np.float64)  # (ng, S, G)
            Z = np.einsum("xk,gkv->gxv", np.linalg.inv(W), A) / c[None, :, None]
            phi = 0.5 * np.angle(Z[:, 1] * Z[:, S - 1])
            scal[2 * ax] = np.mod(np.angle(Z[:, 1]) - phi, 2.0 * np.pi)
            scal[2 * ax + 1] = phi
            wcs.append(np.stack([(W * c).real, (W * c).imag]))
        wcu, wcv = wcs
    if ws > 1:
        lane = np.arange(G)
        wo, wl = np.asarray(leaves["win_off"], np.int64), np.asarray(leaves["win_len"], np.int64)
        live = (lane >= wo[:, None]) & (lane < (wo + wl)[:, None])
        sort_idx = np.append(np.asarray(leaves["sort_idx"], np.int64), nvis)
        cg_idx = sort_idx[np.where(live, np.asarray(leaves["win_start"], np.int64)[:, None] + lane, nvis)]
        sgv = np.asarray(leaves["sg"], np.float64) if meta["hermitian"] else np.ones(nvis)
        sg = np.append(sgv, 1.0)[cg_idx]
        rep_idx = as_t(leaves["rep_idx"], torch.int64)
    else:
        cg_idx = np.asarray(leaves["cg_idx"], np.int64)
        sg = np.asarray(leaves["sg"]) if meta["hermitian"] else np.ones((ng, G))
        rep_idx = None
    nm1 = np.asarray(leaves["nm1"], np.float64) + np.asarray(leaves["nm1_lo"], np.float64)
    plan = IDGPlan(
        nx=nx, ny=ny, nbig_x=int(meta["nbig_x"]), nbig_y=int(meta["nbig_y"]), S=S, half=half, G=G, ngroups=ng,
        nbu=int(meta["nbu"]), nbv=int(meta["nbv"]), k0_off=int(meta["k0_off"]), nrow=int(meta["nrow"]),
        nchan=int(meta["nchan"]), nbins=int(meta["nbins"]), bin_gstart=tuple(meta["bin_gstart"]),
        bin_gcount=tuple(meta["bin_gcount"]), bin_wc=tuple(meta["bin_wc"]), do_wgridding=bool(meta["do_wgridding"]),
        hermitian=bool(meta["hermitian"]), epsilon=float(meta["epsilon"]), scal=as_t(scal), wcu=as_t(wcu),
        wcv=as_t(wcv), sg=as_t(sg), cg_idx=as_t(cg_idx, torch.int64), bid=as_t(leaves["bid"], torch.int64),
        phase_re=as_t(leaves["phase_re"]), phase_im=as_t(leaves["phase_im"]), corr_re=as_t(leaves["corr_re"]),
        corr_im=as_t(leaves["corr_im"]), nm1=as_t(nm1, torch.float64), w_support=ws, rep_idx=rep_idx,
    )
    return _with_screens(plan)
