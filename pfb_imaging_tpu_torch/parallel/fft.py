"""Row-sharded 2D real FFT and PSF convolution, the 8k-image axis (port of
pfb_imaging_tpu/parallel/fft.py).

The padded PSF grid's rows are split over a mesh's row group and the
transform runs the classic distributed-FFT transpose:

    rows sharded: local rfft along y
      -> all_to_all (transpose: shard y, gather x)
    cols sharded: local fft along x
      -> pointwise * |PSFHAT| in the TRANSPOSED layout
    inverse: ifft along x -> all_to_all back -> irfft along y

Each rank holds 1/d of the padded grid; the two ``all_to_all_single`` calls
over the row group are the only communication of the transform. The
half-spectrum axis (ny//2+1) is zero-padded to a multiple of d, and |PSFHAT|
is stored padded and transposed (:func:`psfhat_transposed`) so that the
convolution is a local multiply. The ``*_local`` functions take this
rank's rows (with any leading batch axes); ``psf_convolve_sharded`` and
``hessian_psf_sharded`` take the whole image, present on every rank of the
row group, and return it whole on every rank (one all_gather of the
cropped rows).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "psfhat_transposed",
    "rfft2_t_local",
    "irfft2_t_local",
    "psf_convolve_local",
    "psf_convolve_sharded",
    "hessian_psf_sharded",
]


def _nyh_padded(ny_psf: int, d: int) -> int:
    nyh = ny_psf // 2 + 1
    return ((nyh + d - 1) // d) * d


def psfhat_transposed(abspsfhat, d: int) -> np.ndarray:
    """|PSFHAT| (..., nx_psf, nyh) -> transposed padded (..., nyh_p, nx_psf),
    on the host, once per dataset."""
    abspsfhat = np.asarray(abspsfhat)
    nyh = abspsfhat.shape[-1]
    nyh_p = _nyh_padded((nyh - 1) * 2, d)
    pad = [(0, 0)] * (abspsfhat.ndim - 2) + [(0, 0), (0, nyh_p - nyh)]
    return np.swapaxes(np.pad(abspsfhat, pad), -1, -2)


def rfft2_t_local(x_rows: torch.Tensor, mesh, nx_psf: int, ny_psf: int) -> torch.Tensor:
    """This rank's leg of the sharded rfft2, returning the TRANSPOSED
    spectrum: x_rows (..., nx_psf/d, ny_psf), this rank's rows of the padded
    input -> (..., nyh_p/d, nx_psf), its rows of the padded transposed
    half-spectrum."""
    d = mesh.row_size
    nyh_p = _nyh_padded(ny_psf, d)
    c = nyh_p // d
    batch, r = x_rows.shape[:-2], x_rows.shape[-2]
    xh = torch.fft.rfft(x_rows, n=ny_psf, dim=-1)
    if nyh_p > xh.shape[-1]:
        xh = torch.cat([xh, xh.new_zeros(batch + (r, nyh_p - xh.shape[-1]))], dim=-1)
    # chunk j of the y-spectrum goes to row rank j; what comes back is every
    # source's rows of this rank's chunk, source-major == global x order
    recv = mesh.row_all_to_all(xh.reshape(batch + (r, d, c)).movedim(-2, 0))
    xt = recv.movedim(0, -3).reshape(batch + (nx_psf, c)).transpose(-1, -2)
    return torch.fft.fft(xt, dim=-1)


def irfft2_t_local(yh_t: torch.Tensor, mesh, nx_psf: int, ny_psf: int) -> torch.Tensor:
    """Inverse of :func:`rfft2_t_local` (the 1/N convention of irfft2):
    yh_t (..., nyh_p/d, nx_psf) -> (..., nx_psf/d, ny_psf) rows of the
    padded spatial result."""
    d = mesh.row_size
    nyh = ny_psf // 2 + 1
    nyh_p = _nyh_padded(ny_psf, d)
    c, r = nyh_p // d, nx_psf // d
    batch = yh_t.shape[:-2]
    yh = torch.fft.ifft(yh_t, dim=-1).transpose(-1, -2)  # (..., nx, c)
    # row block j goes back to row rank j; source s sent y-chunk s
    recv = mesh.row_all_to_all(yh.reshape(batch + (d, r, c)).movedim(-3, 0))
    yh = recv.movedim(0, -2).reshape(batch + (r, nyh_p))[..., :nyh]
    return torch.fft.irfft(yh, n=ny_psf, dim=-1)


def psf_convolve_local(x_rows, abspsfhat_t_rows, mesh, nx_psf: int, ny_psf: int) -> torch.Tensor:
    """PSF * x for this rank's rows: x_rows (..., nx_psf/d, ny_psf) padded
    input rows, abspsfhat_t_rows (..., nyh_p/d, nx_psf) this rank's share of
    the transposed |PSFHAT|."""
    spec = rfft2_t_local(x_rows, mesh, nx_psf, ny_psf)
    return irfft2_t_local(spec * abspsfhat_t_rows, mesh, nx_psf, ny_psf)


def _check(mesh, nx_psf: int, ny_psf: int, axis: str) -> int:
    if axis != "row":
        raise ValueError(f"the sharded FFT splits the mesh's 'row' axis, not {axis!r}")
    d = mesh.row_size
    if nx_psf % d:
        raise ValueError(f"nx_psf={nx_psf} must divide by the {d}-way 'row' mesh axis")
    return d


def pad_rows(x: torch.Tensor, mesh, nx_psf: int, ny_psf: int) -> torch.Tensor:
    """This rank's rows (..., nx_psf/d, ny_psf) of ``x`` (..., nx, ny)
    zero-padded to (nx_psf, ny_psf)."""
    rows = nx_psf // mesh.row_size
    r0 = mesh.row_index * rows
    nx, ny = x.shape[-2], x.shape[-1]
    out = x.new_zeros(x.shape[:-2] + (rows, ny_psf))
    n_in = max(0, min(nx - r0, rows))
    out[..., :n_in, :ny] = x[..., r0:r0 + n_in, :]
    return out


def gather_rows(out_rows: torch.Tensor, mesh, nx: int, ny: int) -> torch.Tensor:
    """The cropped (..., nx, ny) image on every rank of the row group from
    each rank's (..., nx_psf/d, ny_psf) rows."""
    d, rows = mesh.row_size, out_rows.shape[-2]
    parts = mesh.row_all_gather(out_rows[..., :ny])  # (d, ..., rows, ny)
    full = parts.movedim(0, -3).reshape(out_rows.shape[:-2] + (d * rows, ny))
    return full[..., :nx, :]


def psfhat_rows(abspsfhat_t, mesh, device, dtype) -> torch.Tensor:
    """This rank's rows (..., nyh_p/d, nx_psf) of the whole transposed
    |PSFHAT| (..., nyh_p, nx_psf) of :func:`psfhat_transposed`, on
    ``device``."""
    c = abspsfhat_t.shape[-2] // mesh.row_size
    ph = abspsfhat_t[..., mesh.row_index * c:(mesh.row_index + 1) * c, :]
    if torch.is_tensor(ph):
        return ph.to(device=device, dtype=dtype)
    return torch.as_tensor(np.ascontiguousarray(ph), dtype=dtype, device=device)


def psf_convolve_sharded(mesh, x, abspsfhat_t, nx: int, ny: int, nx_psf: int, ny_psf: int,
                         axis: str = "row") -> torch.Tensor:
    """Convolve an (nx, ny) image with the PSF, the padded grid's rows
    split over the mesh's row group. ``abspsfhat_t`` is the transposed
    padded spectrum of :func:`psfhat_transposed`, whole. Returns the
    (nx, ny) image on every rank of the group."""
    _check(mesh, nx_psf, ny_psf, axis)
    ph = psfhat_rows(abspsfhat_t, mesh, x.device, x.dtype)
    out = psf_convolve_local(pad_rows(x, mesh, nx_psf, ny_psf), ph, mesh, nx_psf, ny_psf)
    return gather_rows(out, mesh, nx, ny)


def hessian_psf_sharded(mesh, x, abspsfhat_t, nx_psf: int, ny_psf: int, beam=None, eta: float = 0.0,
                        axis: str = "row") -> torch.Tensor:
    """Row-sharded Tikhonov PSF Hessian beam*(|PSFHAT| conv (beam*x)) + eta*x:
    the sharded counterpart of ``ops.hessian.hessian_psf``."""
    nx, ny = x.shape[-2], x.shape[-1]
    xin = x if beam is None else x * beam
    out = psf_convolve_sharded(mesh, xin, abspsfhat_t, nx, ny, nx_psf, ny_psf, axis=axis)
    if beam is not None:
        out = out * beam
    if eta:
        out = out + eta * x
    return out
