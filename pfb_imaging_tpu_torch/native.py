"""ctypes bindings for the host planning kernels (``csrc/plan_kernels.cpp``,
the port's copy of the JAX package's ``native/plan_kernels.cpp``).

At first use ``g++ -O3 -march=native -fopenmp -shared -fPIC`` builds the
source into ``build/torch_kernels/`` at the repository root
(``PFB_TORCH_BUILD_DIR`` overrides it), under a name that carries a hash of
the source. This is host code (bucketing, counting sorts, NN histograms):
where ``g++`` is missing or fails, every entry point keeps the reference's
numpy fallback. The recorder (``utils/profiling``) counts which planner
served each call: ``plan.native`` or ``plan.numpy``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .kernels.build import build_dir
from .utils.profiling import count

SRC = Path(__file__).resolve().parent / "csrc" / "plan_kernels.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_LIB = None
_TRIED = False
_LOCK = threading.Lock()  # the imager plans on a thread pool


def _build_and_load():
    with _LOCK:
        return _build_and_load_locked()


def _build_and_load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = build_dir() / f"libpfb_plan_{hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]}.so"
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.uvw_to_pix.argtypes = [f64p, f64p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_double] * 8 + [f64p] * 5
    lib.wplane_buckets.argtypes = [i64p] + [ctypes.c_int64] * 4 + [i64p] * 3
    lib.idg_coords.argtypes = (
        [f64p] * 2
        + [ctypes.c_int64] * 2
        + [ctypes.c_double] * 7
        + [ctypes.c_int64] * 1
        + [ctypes.c_double] * 7
        + [ctypes.c_int64] * 6
        + [i64p]
        + [f64p] * 6
    )
    lib.key_sort_counts.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64] + [i64p] * 4 + [ctypes.POINTER(ctypes.c_int64)]
    lib.fill_groups.argtypes = (
        [i64p] * 4 + [ctypes.c_int64] * 2 + [f64p] * 6 + [i64p] + [f64p] * 6 + [i64p]
    )
    lib.counts_nn.argtypes = [f64p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_double] * 5 + [f64p]
    lib.weights_from_counts.argtypes = [f64p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_double] * 5 + [f64p]
    _LIB = lib
    return lib


def _lib():
    """The loaded library or None, counting which planner serves the call."""
    lib = _build_and_load()
    count("plan.numpy" if lib is None else "plan.native")
    return lib


def have_native() -> bool:
    """Whether the host planning library built and loaded."""
    return _build_and_load() is not None


def uvw_to_pix(uvw, freq, su, sv, sw, scale_u, scale_v, inv_c, l_shift, m_shift):
    """Fused coordinate conversion of (nrow, 3) uvw at each channel; returns
    flat (u_pix, v_pix, w_lam, phase_shift), phase_shift = exp(-2 pi i (u
    l_shift + v m_shift)) in wavelengths."""
    lib = _lib()
    nrow, nchan = uvw.shape[0], freq.shape[0]
    if lib is None:
        u_l = su * np.multiply.outer(uvw[:, 0], freq * inv_c)
        v_l = sv * np.multiply.outer(uvw[:, 1], freq * inv_c)
        w_l = sw * np.multiply.outer(uvw[:, 2], freq * inv_c)
        shift = np.exp(-2j * np.pi * (u_l * l_shift + v_l * m_shift))
        return (u_l * scale_u).ravel(), (v_l * scale_v).ravel(), w_l.ravel(), shift.ravel()
    n = nrow * nchan
    u_pix, v_pix, w_lam, sre, sim = (np.empty(n) for _ in range(5))
    lib.uvw_to_pix(np.ascontiguousarray(uvw, dtype=np.float64), np.ascontiguousarray(freq, dtype=np.float64), nrow,
                   nchan, su, sv, sw, scale_u, scale_v, inv_c, l_shift, m_shift, u_pix, v_pix, w_lam, sre, sim)
    return u_pix, v_pix, w_lam, sre + 1j * sim


def wplane_buckets(i0, nw: int, w_supp: int):
    """Stable counting sort by plane + bucket ranges; returns
    (perm, starts, counts)."""
    lib = _lib()
    i0 = np.ascontiguousarray(i0, dtype=np.int64)
    n = i0.size
    n_i0 = int(i0.max()) + 1 if n else 1
    if lib is None:
        perm = np.argsort(i0, kind="stable")
        i0s = i0[perm]
        starts = np.searchsorted(i0s, np.arange(nw) - w_supp + 1, side="left")
        ends = np.searchsorted(i0s, np.arange(nw), side="right")
        return perm, starts, ends - starts
    perm = np.empty(n, dtype=np.int64)
    starts = np.empty(nw, dtype=np.int64)
    counts = np.empty(nw, dtype=np.int64)
    lib.wplane_buckets(i0, n, n_i0, nw, w_supp, perm, starts, counts)
    return perm, starts, counts


def idg_bucket_group(uvw, invlam, signs, cux, cvy, l0, m0, nbins, wmin, binw, alpha,
                     blsu, bmsv, chiru, chirv, nbig_x, nbig_y, half, nbu, nbv, k0_off, G):
    """Fused IDG bucketing/grouping (native only; plan_idg falls back to
    its vectorised numpy path when the library is unavailable).

    Takes the RAW (nrow, 3) uvw + per-channel 1/lambda so the per-vis
    coordinate outer products and shift phases never materialise in numpy.
    Returns (order, uniq, starts, counts, per-vis payload dict) ready for
    the group-layout fill — see native/plan_kernels.cpp:idg_coords.
    """
    lib = _lib()
    if lib is None:
        return None
    nrow, nchan = uvw.shape[0], invlam.shape[0]
    n = nrow * nchan
    su, sv, sw = signs
    c = np.ascontiguousarray
    key = np.empty(n, np.int64)
    du = np.empty(n)
    dv = np.empty(n)
    phiu = np.empty(n)
    phiv = np.empty(n)
    ph_re = np.empty(n)
    ph_im = np.empty(n)
    lib.idg_coords(
        c(uvw, dtype=np.float64), c(invlam, dtype=np.float64), nrow, nchan,
        float(su), float(sv), float(sw), float(cux), float(cvy), float(l0), float(m0),
        nbins, float(wmin), float(binw), float(alpha), float(blsu), float(bmsv),
        float(chiru), float(chirv), nbig_x, nbig_y, half, nbu, nbv, k0_off,
        key, du, dv, phiu, phiv, ph_re, ph_im,
    )
    nkeys = nbins * nbu * nbv
    if nkeys > (1 << 27):
        return None  # histogram too large; numpy argsort path instead
    order = np.empty(n, np.int64)
    uniq = np.empty(n, np.int64)
    starts = np.empty(n, np.int64)
    counts = np.empty(n, np.int64)
    noccup = ctypes.c_int64(0)
    lib.key_sort_counts(key, n, nkeys, order, uniq, starts, counts, ctypes.byref(noccup))
    m = noccup.value
    payload = dict(du=du, dv=dv, phiu=phiu, phiv=phiv, ph_re=ph_re, ph_im=ph_im, key=key)
    return order, uniq[:m].copy(), starts[:m].copy(), counts[:m].copy(), payload


def counts_nn(uvw, freq, mask, wgt, nx, ny, cellx, celly, usign, vsign, inv_c):
    """Host NN-binned counts histogram; returns (ncorr, nx, ny) f64 or
    None when the library is unavailable (callers fall back to torch)."""
    lib = _lib()
    if lib is None:
        return None
    c = np.ascontiguousarray
    wgt = c(wgt, dtype=np.float64)
    ncorr, nrow, nchan = wgt.shape
    out = np.zeros((ncorr, nx, ny))
    lib.counts_nn(
        c(uvw, dtype=np.float64), c(freq, dtype=np.float64), c(mask, dtype=np.float64),
        wgt, ncorr, nrow, nchan, nx, ny,
        float(cellx), float(celly), float(usign), float(vsign), float(inv_c), out,
    )
    return out


def weights_from_counts(counts, uvw, freq, mask, wgt, nx, ny, cellx, celly,
                        usign, vsign, inv_c):
    """Per-sample weight division by the (adjusted) counts grid; returns
    the new (ncorr, nrow, nchan) f64 weights or None (fallback)."""
    lib = _lib()
    if lib is None:
        return None
    c = np.ascontiguousarray
    out = np.array(wgt, dtype=np.float64, order="C", copy=True)
    ncorr, nrow, nchan = out.shape
    lib.weights_from_counts(
        c(counts, dtype=np.float64), c(uvw, dtype=np.float64),
        c(freq, dtype=np.float64), c(mask, dtype=np.float64),
        ncorr, nrow, nchan, nx, ny,
        float(cellx), float(celly), float(usign), float(vsign), float(inv_c), out,
    )
    return out


def idg_fill_groups(order, starts, counts, gbase, G, ng, nvis, payload):
    """Group-layout fill (native pass). Returns (cg_idx, du_g, dv_g,
    phiu_g, phiv_g, phase_g, inv_orig)."""
    lib = _build_and_load()
    noccup = starts.size
    cg_idx = np.full(ng * G, nvis, np.int64)
    du_g = np.zeros(ng * G)
    dv_g = np.zeros(ng * G)
    phiu_g = np.zeros(ng * G)
    phiv_g = np.zeros(ng * G)
    phre_g = np.zeros(ng * G)
    phim_g = np.zeros(ng * G)
    inv_orig = np.empty(nvis, np.int64)
    c = np.ascontiguousarray
    lib.fill_groups(
        c(order), c(starts), c(counts), c(gbase, dtype=np.int64), noccup, G,
        payload["du"], payload["dv"], payload["phiu"], payload["phiv"],
        payload["ph_re"], payload["ph_im"],
        cg_idx, du_g, dv_g, phiu_g, phiv_g, phre_g, phim_g, inv_orig,
    )
    shape = (ng, G)
    return (
        cg_idx.reshape(shape),
        du_g.reshape(shape),
        dv_g.reshape(shape),
        phiu_g.reshape(shape),
        phiv_g.reshape(shape),
        (phre_g + 1j * phim_g).reshape(shape),
        inv_orig,
    )
