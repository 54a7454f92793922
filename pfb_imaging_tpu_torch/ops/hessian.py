"""Hessian approximations of the measurement operator (port of
pfb_imaging_tpu/ops/hessian.py):
  * ``hessian_vis``: the exact vis-space Hessian ``B^T R^H W R B x (+ eta x)``
    by a classic ES degrid/grid round trip (``ops/gridder.py``);
  * ``hessian_psf``: the FFT PSF-convolution approximation;
  * ``hess_direct``: the tapered direct Hessian or its pointwise inverse;
  * ``hessian_tree_dot`` / ``HessianCube``: the sum-over-partitions PSF
    Hessian of the deconv minor cycle.

Design D4 is kept: normalisation by the TOTAL wsum across bands and
per-band ``eta_b = eta * wsum_b / wsum_tot``. Under a band mesh the cube
holds this rank's band slice, and ``wsum_tot`` / ``eta_b`` come from the
global wsums before the slice is taken. With a mesh whose row axis is
larger than 1 the matvec runs the distributed FFT of ``parallel/fft.py``
over the row group (the 8k-image axis).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import as_device, real_dtype, to_device
from ..utils.profiling import count
from .gridder import WGridderPlan, dirty2vis, vis2dirty
from .psf import psf_convolve


def hessian_vis(plan: WGridderPlan, x, wgt=None, mask=None, beam=None, eta: float = 0.0, wsum=None):
    """Exact vis-space Hessian on one (nx, ny) image on the plan's device.
    The plan must be built with ``divide_by_n=False``."""
    xin = x if beam is None else x * beam
    conv = vis2dirty(plan, dirty2vis(plan, xin, mask=mask), wgt=wgt, mask=mask)
    if wsum is not None:
        conv = conv / wsum
    if beam is not None:
        conv = conv * beam
    if eta:
        conv = conv + eta * x
    return conv


def hessian_psf(x, abspsfhat, nx_psf: int, ny_psf: int, beam=None, eta: float = 0.0):
    """Tikhonov-regularised FFT PSF Hessian: beam * (|PSFHAT| conv (beam*x)) + eta*x."""
    xin = x if beam is None else x * beam
    out = psf_convolve(xin, abspsfhat, nx_psf, ny_psf)
    if beam is not None:
        out = out * beam
    if eta:
        out = out + eta * x
    return out


def hess_direct(x, abspsfhat, taperxy, nx_psf: int, ny_psf: int, eta: float = 1.0, mode: str = "forward"):
    """Tapered direct Hessian (``mode="forward"``) or its inverse
    (``"backward"``); ``eta`` is relative to wsum (the PSF peak).
    x: (..., nx, ny)."""
    nx, ny = x.shape[-2], x.shape[-1]
    xhat = torch.fft.rfft2(x * taperxy, s=(nx_psf, ny_psf), dim=(-2, -1))
    xhat = xhat * (abspsfhat + eta) if mode == "forward" else xhat / (abspsfhat + eta)
    big = torch.fft.irfft2(xhat, s=(nx_psf, ny_psf), dim=(-2, -1))
    return big[..., :nx, :ny] * taperxy


def hessian_tree_dot(x, abspsfhat_parts, beam_parts, wsum, nx_psf: int, ny_psf: int, eta: float = 0.0):
    """H x = (1/wsum) sum_p B_p^T (PSF_p * (B_p x)) + eta x for one band image.

    x: (nx, ny); abspsfhat_parts: (npart, nx_psf, ny_psf//2+1);
    beam_parts: (npart, nx, ny) or None. The partition axis is batched
    through one FFT call.
    """
    xin = x[None] if beam_parts is None else x[None] * beam_parts
    terms = psf_convolve(xin, abspsfhat_parts, nx_psf, ny_psf)
    if beam_parts is not None:
        terms = terms * beam_parts
    out = terms.sum(0) / wsum
    if eta:
        out = out + eta * x
    return out


@dataclasses.dataclass
class HessianCube:
    """Cube-level PSF Hessian over (nband, nx, ny) images: this rank's band
    slice of them under a band mesh.

    Fields:
        abspsfhat: (nband, npart, nx_psf, ny_psf//2+1) |PSFHAT| per
            partition; row-sharded, the partitions' sum in the transposed
            padded layout of ``parallel.fft.psfhat_transposed``, this rank's
            rows of it: (nband, 1, nyh_p/d, nx_psf).
        beam: (nband, npart, nx, ny) or None.
        wsum_tot: total weight across all bands (0-d tensor).
        eta_b: (nband,) per-band Tikhonov parameters.
        mesh: the mesh whose row group runs the distributed FFT, or None.
    """

    nx_psf: int
    ny_psf: int
    abspsfhat: torch.Tensor
    beam: torch.Tensor | None
    wsum_tot: torch.Tensor
    eta_b: torch.Tensor
    mesh: object = None

    @classmethod
    def build(cls, abspsfhat, wsums, eta: float, nx_psf: int, ny_psf: int, beam=None, mesh=None,
              row_axis: str = "row", band_axis: str = "band", transposed: bool = False, *, device="cuda"):
        """From numpy |PSFHAT| and the (nband,) per-band wsums of ALL bands,
        onto ``device``. With ``mesh``, ``abspsfhat`` and ``beam`` are this
        rank's band slice. A mesh with a row axis larger than 1 selects the
        row-sharded matvec; ``transposed=True`` says ``abspsfhat`` is then
        already this rank's rows of the ``psfhat_transposed`` layout. The
        port's mesh has fixed axis names: ``row_axis`` and ``band_axis``
        (the JAX signature's) accept only "row" and "band"."""
        if (row_axis, band_axis) != ("row", "band"):
            raise ValueError(f"the mesh's axes are 'row' and 'band', not {row_axis!r} and {band_axis!r}")
        dtype = real_dtype(device)
        wsums = to_device(wsums, device, dtype)
        wsum_tot = wsums.sum()
        eta_b = eta * wsums / wsum_tot
        band = slice(0, wsums.shape[0]) if mesh is None else mesh.band_slice(wsums.shape[0])
        if mesh is not None and mesh.row_size > 1:
            if beam is not None:
                raise NotImplementedError("row-sharded HessianCube with per-partition beams: pad the beams into "
                                          "the convolution or use the unsharded path")
            from ..parallel.fft import psfhat_rows, psfhat_transposed

            ph = as_device(abspsfhat, device, dtype) if transposed else \
                psfhat_rows(psfhat_transposed(abspsfhat, mesh.row_size), mesh, device, dtype)
            # one transform a band: the partitions' spectra sum before it
            ph = ph.sum(1, keepdim=True)
        else:
            mesh = None
            ph = as_device(abspsfhat, device, dtype)
        return cls(nx_psf=int(nx_psf), ny_psf=int(ny_psf), abspsfhat=ph,
                   beam=None if beam is None else as_device(beam, device, dtype), wsum_tot=wsum_tot,
                   eta_b=eta_b[band], mesh=mesh)

    def dot(self, x):
        return hess_cube_dot(self, x)

    def hdot(self, x):
        return hess_cube_dot(self, x)


def hess_cube_dot(h: HessianCube, x: torch.Tensor) -> torch.Tensor:
    """(nband, nx, ny) -> (nband, nx, ny): per-band sum over partitions; a
    band's transforms are counted as ``hess.band``. On the card every band
    goes through one batched FFT pair (:func:`_hess_cube_batched`), so a
    cube of many small bands takes the launches of one of a few large ones.
    On the CPU the bands go one at a time: there the FFT library's inverse
    of a single transform has other bits than the same transform in a
    batch, and every band split must give the same bits."""
    if h.mesh is not None:
        return _hess_cube_dot_rowsharded(h, x)
    count("hess.band", x.shape[0])
    if x.is_cuda:
        return _hess_cube_batched(h, x)
    out = torch.empty_like(x)
    for b in range(x.shape[0]):
        bm = None if h.beam is None else h.beam[b]
        out[b] = hessian_tree_dot(x[b], h.abspsfhat[b], bm, h.wsum_tot, h.nx_psf, h.ny_psf)
    return out + h.eta_b[:, None, None] * x


def _hess_cube_batched(h: HessianCube, x: torch.Tensor) -> torch.Tensor:
    """``hess_cube_dot`` with every band's and partition's FFT pair in one
    batched call."""
    xin = x[:, None] if h.beam is None else x[:, None] * h.beam
    terms = psf_convolve(xin, h.abspsfhat, h.nx_psf, h.ny_psf)
    if h.beam is not None:
        terms = terms * h.beam
    return terms.sum(1) / h.wsum_tot + h.eta_b[:, None, None] * x


def _hess_cube_dot_rowsharded(h: HessianCube, x: torch.Tensor) -> torch.Tensor:
    """The (band, row)-sharded cube matvec: this rank's bands, each padded
    grid's rows split over the row group. All bands go through each of the
    distributed FFT's two all_to_alls together, and one all_gather of the
    cropped rows returns every rank of the row group the whole images."""
    from ..parallel.fft import gather_rows, pad_rows, psf_convolve_local

    nx, ny = x.shape[-2], x.shape[-1]
    mesh = h.mesh
    out = psf_convolve_local(pad_rows(x, mesh, h.nx_psf, h.ny_psf), h.abspsfhat[:, 0], mesh, h.nx_psf, h.ny_psf)
    return gather_rows(out, mesh, nx, ny) / h.wsum_tot + h.eta_b[:, None, None] * x
