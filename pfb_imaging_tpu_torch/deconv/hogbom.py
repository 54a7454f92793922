"""Hogbom CLEAN minor cycle (port of pfb_imaging_tpu/deconv/hogbom.py).

The JAX package runs the minor cycle as one ``lax.while_loop``. Here the
loop body runs on the device in blocks of ``BLOCK`` iterations with a
device-side ``live`` flag (the loop condition on the carried state) that
turns each iteration past the end into an exact no-op: its update is
multiplied by 0 and its counters do not move. The host reads the condition
once a block, not once an iteration. The peak stays on the device as a flat
index, and the PSF window is gathered around it with the start clamped as
``lax.dynamic_slice`` clamps it, so no iteration waits for the host.

Peak search is over the MFS residual ``(sum_b residual)^2``.
"""

from __future__ import annotations

import torch

# iterations run between two reads of the loop condition on the host
BLOCK = 32


def peak(power: torch.Tensor, ny: int):
    """Flat argmax (a 1-element tensor, the first maximum as ``jnp.argmax``),
    its row and column and sqrt of the peak power, all on the device."""
    flat = power.reshape(-1)
    pq = flat.argmax().reshape(1)
    return pq, pq // ny, pq % ny, flat.index_select(0, pq).sqrt()[0]


def psf_window(psf: torch.Tensor, p, q, nx: int, ny: int) -> torch.Tensor:
    """``psf[..., nx0 - p : nx0 - p + nx, ny0 - q : ny0 - q + ny]`` with the
    start clamped into the PSF as ``lax.dynamic_slice`` clamps it; ``p`` and
    ``q`` are 1-element device tensors."""
    nx_psf, ny_psf = psf.shape[-2:]
    sx = (nx_psf // 2 - p).clamp(0, nx_psf - nx)
    sy = (ny_psf // 2 - q).clamp(0, ny_psf - ny)
    rows = torch.arange(nx, device=psf.device) + sx
    cols = torch.arange(ny, device=psf.device) + sy
    return psf[..., rows[:, None], cols[None, :]]


def pixel(cube: torch.Tensor, pq) -> torch.Tensor:
    """``cube[..., p, q]`` at the flat index ``pq`` (a 1-element tensor)."""
    return cube.reshape(*cube.shape[:-2], -1).index_select(-1, pq)[..., 0]


def add_at_pixel(cube: torch.Tensor, pq, val: torch.Tensor) -> torch.Tensor:
    """``cube.at[..., p, q].add(val)`` at the flat index ``pq``, in place."""
    flat = cube.view(*cube.shape[:-2], -1)
    flat.index_add_(flat.ndim - 1, pq, val[..., None])
    return cube


def hogbom(dirty, psf, threshold: float = 0.0, gamma: float = 0.1, pf: float = 0.1, maxit: int = 10000,
           info: dict | None = None):
    """Returns (model, residual, status) with status 0 on convergence, 1 on
    maxit or stall. ``dirty`` (nband, nx, ny) and ``psf`` (nband, nx_psf,
    ny_psf) are tensors on one device; ``info["niter"]``, when a dict is
    passed, gets the iterations run."""
    nband, nx, ny = dirty.shape
    wsums = psf.amax(dim=(1, 2))
    fsel = wsums > 0
    safe_wsums = torch.where(fsel, wsums, torch.ones_like(wsums))
    zero = torch.zeros_like(wsums)

    def mfs_power(res):
        return res.sum(0) ** 2

    pq, p, q, rmax = peak(mfs_power(dirty), ny)
    tol = torch.clamp(pf * rmax, min=threshold)
    model, residual = torch.zeros_like(dirty), dirty.clone()
    k = torch.zeros((), dtype=torch.int64, device=dirty.device)
    stall = torch.zeros_like(k)

    def live_now():
        return (rmax > tol) & (k < maxit) & (stall < 5)

    while bool(live_now()):
        for _ in range(BLOCK):
            live = live_now()
            xhat = torch.where(fsel, pixel(residual, pq) / safe_wsums, zero)
            step = gamma * xhat * live
            add_at_pixel(model, pq, step)
            residual = residual - step[:, None, None] * psf_window(psf, p, q, nx, ny)
            pq, p, q, rmax_n = peak(mfs_power(residual), ny)
            stall = stall + (live & ((rmax - rmax_n).abs() / rmax.abs() < 5e-3))
            rmax, k = rmax_n, k + live
    if info is not None:
        info["niter"] = int(k)
    status = int((k >= maxit) | (stall >= 5))
    return model, residual, status
