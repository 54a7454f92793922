"""The SARA wavelet dictionary Psi (port of pfb_imaging_tpu/ops/psi.py).

Analysis ``dot`` maps (nband, nx, ny) to (nband, nbasis, nymax, nxmax);
synthesis ``hdot`` is its exact adjoint. The band axis is the leading
batch axis of every conv (where JAX vmapped a single-band transform).
Packed multi-level layout as in the JAX package: level-i blocks of shape
(2cx_i, 2cy_i) at end indices ex/ey, deeper levels overwriting the
shallower approximation quadrants.

CPU tensors take the plain torch path below (a conv chain per basis and
level). CUDA tensors take the hand-written kernels of
``csrc/psi_wavelets.cu``, P1 ``psi_analysis`` and P2 ``psi_synthesis``: one
launch a level for every basis and band, reading and writing the packed
layout directly, f32 only, no fallback. Their per-level tables
(:func:`kernel_levels`) go to each launch by value.

``hdot_extrapolated(vn, v)`` is ``hdot(2 vn - v)``, the synthesis a
primal-dual iteration asks for: on the card P2 reads both cubes and forms
``2 vn - v`` as it stages them (the same bits as torch's ``2.0 * vn - v``
through P2), so the extrapolated cube is never written; its launches count
under ``launch.psi_synthesis_ext``, and each call once in the counter
``psi.extrap``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import real_dtype
from ..utils import profiling
from .wavelets import coeff_size, conv_weights, dwt2d_level, dwt_max_level, filter_bank, idwt2d_level

# csrc/psi_wavelets.cu's limits, checked when a Psi for the card is built:
# PSI_KMAX taps (db16), PSI_MAXB bases
KMAX = 32
MAXB = 16


class PsiMember(ctypes.Structure):
    """One basis of a level, as the kernels take it (``PsiMember``)."""

    _fields_ = [(n, ctypes.c_int) for n in ("k", "plane", "scr", "nin_x", "nin_y", "cx", "cy", "s", "t")]
    _fields_ += [("lo", ctypes.c_float * KMAX)]


class PsiLevel(ctypes.Structure):
    """One level's launch, as the kernels take it (``PsiLevel``)."""

    _fields_ = [(n, ctypes.c_int) for n in ("nmem", "nbasis", "nx", "ny", "nymax", "nxmax", "first", "last", "kmax",
                                            "img_x", "img_y", "ll_x", "ll_y")]
    _fields_ += [("m", PsiMember * MAXB)]


class _WaveletBook:
    """Static per-basis bookkeeping, and the plain path's conv weights for
    each device and dtype it runs on (the card's kernels take the taps by
    value)."""

    def __init__(self, base: str, nx: int, ny: int, nlevel: int):
        self.base = base
        self.k = len(filter_bank(base)[0])
        self._weights = {}
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

    def weights(self, device, dtype):
        """(dec, rec) conv weights on ``device`` in ``dtype``, made at first use."""
        key = (device, dtype)
        if key not in self._weights:
            self._weights[key] = conv_weights(self.base, device, dtype)
        return self._weights[key]


class Psi:
    """SARA dictionary over an image cube on ``device``."""

    def __init__(self, nband: int, nx: int, ny: int, bases=("self", "db1", "db2", "db3"), nlevel: int = 2,
                 *, device):
        self.nband, self.nx, self.ny = nband, nx, ny
        self.bases = tuple(bases)
        self.nbasis = len(self.bases)
        self.nlevel = nlevel
        self.device = torch.device(device)
        self.dtype = real_dtype(device)
        self._books = {b: _WaveletBook(b, nx, ny, nlevel) for b in self.bases if b != "self"}
        # first packed axis is x-like, second y-like (JAX naming kept)
        self.nymax = max([nx] + [bk.ntotx for bk in self._books.values()])
        self.nxmax = max([ny] + [bk.ntoty for bk in self._books.values()])
        self._levels = kernel_levels(self) if self.device.type == "cuda" else None

    def dot(self, x: torch.Tensor) -> torch.Tensor:
        """Analysis: (nband, nx, ny) -> (nband, nbasis, nymax, nxmax): the plain
        path for CPU tensors, else the kernels (f32)."""
        return self.dot_plain(x) if x.device.type == "cpu" else self._dot_cuda(x)

    def hdot(self, alpha: torch.Tensor) -> torch.Tensor:
        """Synthesis (adjoint): (nband, nbasis, nymax, nxmax) -> (nband, nx, ny):
        the plain path for CPU tensors, else the kernels (f32)."""
        return self.hdot_plain(alpha) if alpha.device.type == "cpu" else self._hdot_cuda(alpha)

    def hdot_extrapolated(self, vn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``hdot(2 vn - v)``: the plain path on ``2.0 * vn - v`` for CPU
        tensors, else P2 forming ``2 vn - v`` from both cubes as it stages
        them (f32; both cubes at the same address modulo 16 bytes)."""
        profiling.count("psi.extrap", 1)
        if vn.device.type == "cpu":
            return self.hdot_plain(2.0 * vn - v)
        return self._hdot_cuda(vn, v)

    def dot_plain(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`dot` by the plain conv chain, on ``x``'s device and dtype."""
        out = x.new_zeros((x.shape[0], self.nbasis, self.nymax, self.nxmax))
        for bi, base in enumerate(self.bases):
            if base == "self":
                out[:, bi, : self.nx, : self.ny] = x
                continue
            bk = self._books[base]
            dec = bk.weights(x.device, x.dtype)[0]
            approx = x
            blocks = []
            for i in range(bk.nlevel):
                block = dwt2d_level(approx, dec)
                blocks.append(block)
                approx = block[..., : bk.cx[i], : bk.cy[i]]
            for i in range(bk.nlevel):  # shallow first; deeper overwrite
                sx, sy = bk.slot(i)
                out[:, bi, sx, sy] = blocks[i]
        return out

    def hdot_plain(self, alpha: torch.Tensor) -> torch.Tensor:
        """:meth:`hdot` by the plain conv chain, on ``alpha``'s device and dtype."""
        out = alpha.new_zeros((alpha.shape[0], self.nx, self.ny))
        for bi, base in enumerate(self.bases):
            if base == "self":
                out = out + alpha[:, bi, : self.nx, : self.ny]
                continue
            bk = self._books[base]
            rec = bk.weights(alpha.device, alpha.dtype)[1]
            i = bk.nlevel - 1
            sx, sy = bk.slot(i)
            approx = idwt2d_level(alpha[:, bi, sx, sy], rec, bk.insx[i], bk.insy[i])
            for i in reversed(range(bk.nlevel - 1)):
                sx, sy = bk.slot(i)
                blk = alpha[:, bi, sx, sy].clone()
                blk[..., : bk.cx[i], : bk.cy[i]] = approx
                approx = idwt2d_level(blk, rec, bk.insx[i], bk.insy[i])
            out = out + approx
        return out

    # ── the card: csrc/psi_wavelets.cu ──

    def _check_cuda(self, t: torch.Tensor, name: str, tail: tuple) -> None:
        if self._levels is None:
            raise ValueError(f"{name} is on {t.device}; this Psi was built for {self.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
        if t.dim() != len(tail) + 1 or tuple(t.shape[1:]) != tail or t.shape[0] < 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)} is not (nband >= 1, {', '.join(map(str, tail))})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def _scratch(self, nband: int, device) -> list:
        """Each level's LL but the deepest's, (nwavelet, nband, rows, row stride)."""
        nwav = sum(b != "self" for b in self.bases)
        return [torch.empty((nwav, nband, lv.ll_x, lv.ll_y), dtype=torch.float32, device=device)
                for lv in self._levels[:-1]]

    def _dot_cuda(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels.build import check, load, stream

        self._check_cuda(x, "x", (self.nx, self.ny))
        nband = x.shape[0]
        out = torch.empty((nband, self.nbasis, self.nymax, self.nxmax), dtype=torch.float32, device=x.device)
        scr = self._scratch(nband, x.device)  # the cube is written whole, margins included
        lib, st = load(), stream(x.device)
        for i, lv in enumerate(self._levels):
            code = lib.pfb_psi_analysis(ctypes.addressof(lv), nband, x.data_ptr(), out.data_ptr(),
                                        scr[i - 1].data_ptr() if i else None,
                                        scr[i].data_ptr() if i < len(scr) else None, st)
            check(code, "psi_analysis")
        return out

    def _hdot_cuda(self, alpha: torch.Tensor, v: torch.Tensor | None = None) -> torch.Tensor:
        """P2 on ``alpha``, or with ``v`` on ``2 alpha - v``."""
        from ..kernels.build import check, load, stream

        tail = (self.nbasis, self.nymax, self.nxmax)
        self._check_cuda(alpha, "alpha", tail)
        key = "psi_synthesis"
        if v is not None:
            self._check_cuda(v, "v", tail)
            if v.shape != alpha.shape or v.device != alpha.device:
                raise ValueError(f"v: {tuple(v.shape)} on {v.device} is not vn's {tuple(alpha.shape)} on "
                                 f"{alpha.device}")
            if (v.data_ptr() - alpha.data_ptr()) % 16:
                raise ValueError("vn and v must lie at the same address modulo 16 bytes")
            key = "psi_synthesis_ext"
        nband = alpha.shape[0]
        out = torch.empty((nband, self.nx, self.ny), dtype=torch.float32, device=alpha.device)
        scr = self._scratch(nband, alpha.device)
        lib, st = load(), stream(alpha.device)
        for i in reversed(range(len(self._levels))):
            code = lib.pfb_psi_synthesis(ctypes.addressof(self._levels[i]), nband, alpha.data_ptr(),
                                         None if v is None else v.data_ptr(),
                                         scr[i].data_ptr() if i < len(scr) else None,
                                         scr[i - 1].data_ptr() if i else None, out.data_ptr(), st)
            check(code, key)
        return out


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def kernel_levels(psi: Psi) -> list:
    """The card's per-level tables of ``psi``: a :class:`PsiLevel` a level,
    level 0 with every basis ("self" with k = 0), the deeper levels with the
    wavelet bases, in the dictionary's order; each basis's taps, level sizes
    and slot from its book. The kernels derive dec_hi from dec_lo by the
    quadrature mirror relation, which every ``dbN`` bank meets exactly."""
    if psi.nbasis > MAXB:
        raise ValueError(f"{psi.nbasis} bases: the card's Psi kernels take at most {MAXB}")
    wav = [b for b in psi.bases if b != "self"]
    for b in wav:
        dec_lo, dec_hi = filter_bank(b)[:2]
        if len(dec_lo) > KMAX:
            raise ValueError(f"basis {b} has {len(dec_lo)} taps: the card's Psi kernels take at most {KMAX} "
                             f"(db{KMAX // 2})")
        if not np.array_equal(dec_hi, (-1.0) ** (np.arange(len(dec_lo)) + 1) * dec_lo[::-1]):
            raise ValueError(f"basis {b}: dec_hi is not the quadrature mirror of dec_lo")
    nlev = psi.nlevel if wav else 1
    ll = [(max(psi._books[b].cx[i] for b in wav), 4 * _ceil(max(psi._books[b].cy[i] for b in wav), 4))
          for i in range(nlev - 1)]
    levels = []
    for i in range(nlev):
        mem = [(bi, b) for bi, b in enumerate(psi.bases) if i == 0 or b != "self"]
        lv = PsiLevel(nmem=len(mem), nbasis=psi.nbasis, nx=psi.nx, ny=psi.ny, nymax=psi.nymax, nxmax=psi.nxmax,
                      first=int(i == 0), last=int(i == nlev - 1))
        lv.img_x, lv.img_y = ll[i - 1] if i else (0, 0)
        lv.ll_x, lv.ll_y = ll[i] if i < nlev - 1 else (0, 0)
        kmax = 2
        for m, (bi, b) in enumerate(mem):
            e = lv.m[m]
            e.plane = bi
            if b == "self":
                e.k, e.nin_x, e.nin_y = 0, psi.nx, psi.ny
                continue
            bk = psi._books[b]
            sx, sy = bk.slot(i)
            e.k, e.scr = bk.k, sum(c != "self" for c in psi.bases[:bi])
            e.nin_x, e.nin_y, e.cx, e.cy, e.s, e.t = bk.insx[i], bk.insy[i], bk.cx[i], bk.cy[i], sx.start, sy.start
            for j, v in enumerate(filter_bank(b)[0]):
                e.lo[j] = v
            kmax = max(kmax, bk.k)
        lv.kmax = kmax
        levels.append(lv)
    return levels
