"""Cube-level PSF-Hessian preconditioner with an approximate inverse (port
of pfb_imaging_tpu/ops/precond.py).

``dot`` is the per-band FFT PSF convolution plus ``eta_b x``; ``idot``
approximately inverts it, by a CG solve per band (``mode="psf"``) or by the
tapered spectral division (``mode="direct"``).

JAX runs the per-band solves as a vmapped ``lax.while_loop``: each band stops
at its own iteration while the others go on. Here the bands run as one
batched CG over the cube with per-band ``alpha``/``beta``, per-band
``eps``/stall counters and a per-band ``live`` flag (each band's loop
condition on its carried state): a band past its stop keeps its state
unchanged, so every band ends where a solve of that band alone ends. The
loop body runs on the device in blocks of ``BLOCK`` iterations and the host
reads the condition once a block.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import as_device, real_dtype, resolve_device
from ..geometry import taperf
from .hessian import hess_direct, hessian_psf

__all__ = ["HessPSF"]

# CG iterations run between two reads of the loop condition on the host
BLOCK = 32


def _bdot(a, b):
    """Per-band real inner product over the image axes: (nband,)."""
    return (a.conj() * b).real.sum(dim=(-2, -1))


class HessPSF:
    """Preconditioner over an (nband, nx, ny) image cube.

    Args:
        abspsfhat: (nband, nx_psf, ny_psf//2+1) |PSFHAT| per band,
            wsum-normalised.
        nx_psf, ny_psf: padded PSF grid.
        beam: (nband, nx, ny) or None.
        eta: (nband,) or scalar Tikhonov term (relative to the PSF peak).
        cg_*: inner-solve controls for mode="psf".
        taper_width: cosine edge taper width for mode="direct".
        device: where the operator's tensors live (the card by default).
    """

    def __init__(self, abspsfhat, nx_psf: int, ny_psf: int, beam=None, eta=1e-5, cg_tol: float = 1e-4,
                 cg_maxit: int = 100, cg_minit: int = 1, taper_width: int = 32, *, device="cuda"):
        dev = resolve_device(device)
        rdt = real_dtype(dev)
        self.abspsfhat = as_device(abspsfhat, dev, rdt)
        self.nband = self.abspsfhat.shape[0]
        self.nx_psf, self.ny_psf = int(nx_psf), int(ny_psf)
        self.beam = None if beam is None else as_device(beam, dev, rdt)
        eta = np.broadcast_to(np.asarray(eta, dtype=float), (self.nband,))
        self.eta = as_device(eta, dev, rdt)
        self.cg_tol, self.cg_maxit, self.cg_minit = cg_tol, cg_maxit, cg_minit
        self._taper_width = taper_width
        self._taper = None
        self.niter_last = [0] * self.nband  # CG iterations per band of the last idot(mode="psf")

    # ── forward ──────────────────────────────────────────────────────

    def dot(self, x):
        """(nband, nx, ny) -> beam*(|PSFHAT| conv (beam*x)) + eta*x."""
        return hessian_psf(x, self.abspsfhat, self.nx_psf, self.ny_psf, beam=self.beam) + self.eta[:, None, None] * x

    hdot = dot  # self-adjoint

    # ── approximate inverse ──────────────────────────────────────────

    def idot(self, x, mode: str = "psf", x0=None):
        """Approximate H^-1 x: a CG solve per band against :meth:`dot`
        (``mode="psf"``, the bands batched), or pointwise spectral division
        under an edge taper (``mode="direct"``)."""
        if mode == "psf":
            x0 = torch.zeros_like(x) if x0 is None else x0
            return self._cg(x, x0)
        if mode == "direct":
            if self._taper is None:
                self._taper = as_device(taperf(tuple(x.shape[-2:]), self._taper_width), x.device, x.dtype)
            out = hess_direct(x, self.abspsfhat, self._taper, self.nx_psf, self.ny_psf, eta=self.eta[:, None, None],
                              mode="backward")
            if self.beam is not None:
                # beam^2 unwind with the reference's min_beam clamp 5e-3
                out = out / self.beam.clamp(min=5e-3) ** 2
            return out
        raise ValueError(f"unknown idot mode '{mode}'")

    def _cg(self, b, x0):
        """The JAX ``pcg`` (no preconditioner) on every band at once, each
        band with its own stop; the iterations per band go to
        ``niter_last``."""
        tol, maxit, minit = self.cg_tol, self.cg_maxit, self.cg_minit
        bc = lambda v: v[:, None, None]  # noqa: E731
        r = self.dot(x0) - b
        nonzero = (r != 0).flatten(1).any(dim=1)
        x, p = x0, -r
        rnorm = _bdot(r, r)
        nb = b.shape[0]
        k = torch.zeros(nb, dtype=torch.int64, device=b.device)
        eps = torch.ones(nb, dtype=rnorm.dtype, device=b.device)
        stall = torch.zeros_like(k)
        while True:
            for _ in range(BLOCK):
                live = ((eps > tol) | (k < minit)) & (k < maxit) & (stall < 5) & nonzero
                ap = self.dot(p)
                # a band past its stop divides by 1 and keeps its state
                alpha = torch.where(live, rnorm, 0.0) / torch.where(live, _bdot(p, ap), 1.0)
                xn = x + bc(alpha) * p
                rn = r + bc(alpha) * ap
                rnorm_next = _bdot(rn, rn)
                beta = rnorm_next / torch.where(live, rnorm, 1.0)
                pn = bc(beta) * p - rn
                d = xn - x
                eps_n = torch.sqrt(_bdot(d, d) / _bdot(xn, xn).clamp(min=1e-12))
                lb = bc(live)
                x, r, p = torch.where(lb, xn, x), torch.where(lb, rn, r), torch.where(lb, pn, p)
                stall = stall + (live & ((eps - eps_n).abs() < 1e-3 * tol)).to(stall.dtype)
                rnorm = torch.where(live, rnorm_next, rnorm)
                eps = torch.where(live, eps_n, eps)
                k = k + live.to(k.dtype)
            if not bool((((eps > tol) | (k < minit)) & (k < maxit) & (stall < 5) & nonzero).any()):
                break
        self.niter_last = [int(v) for v in k.tolist()]
        # zero initial residual -> x0 (reference pcg.py:121-124)
        return torch.where(bc(nonzero), x, x0)
