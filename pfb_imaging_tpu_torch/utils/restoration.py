"""Restored-image construction (port of pfb_imaging_tpu/utils/restoration.py).

``restore_image`` convolves the model with the clean beam (the Gaussian
fit to the PSF mainlobe) and adds the residual, optionally taking the
residual to the clean beam's resolution with a Gaussian-ratio kernel. The
convolutions are zero-padded FFTs by ``torch.fft`` on ``device``, in the
device's working type (f64 on the CPU, f32 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import real_dtype, resolve_device, to_device, to_host
from ..geometry import gaussian_kernel


def _gauss_ft(gausspar, nx_pad: int, ny_pad: int, dev, rdt) -> torch.Tensor:
    """rfft2 of the unit-sum rotated Gaussian centred on the padded grid."""
    x = np.arange(nx_pad) - nx_pad // 2
    y = np.arange(ny_pad) - ny_pad // 2
    xx, yy = np.meshgrid(x, y, indexing="ij")
    g = to_device(gaussian_kernel(xx, yy, gausspar, normalise=True), dev, rdt)
    return torch.fft.rfft2(torch.fft.ifftshift(g))


def convolve2gaussres(image, gausspar, gausspari=None, pfrac: float = 0.5, *, device="cuda") -> np.ndarray:
    """Convolve ``image`` (nband, nx, ny) to the resolution ``gausspar``;
    with ``gausspari`` (the image's own resolution per band) the kernel is
    the Gaussian ratio ghat / ghati. Returns an f64 numpy array."""
    dev = resolve_device(device)
    rdt = real_dtype(dev)
    image = np.asarray(image)
    nband, nx, ny = image.shape
    nx_pad, ny_pad = int(nx * (1 + pfrac)) // 2 * 2, int(ny * (1 + pfrac)) // 2 * 2
    ghat = _gauss_ft(gausspar, nx_pad, ny_pad, dev, rdt)
    out = np.zeros(image.shape)
    for b in range(nband):
        pad = torch.zeros((nx_pad, ny_pad), dtype=rdt, device=dev)
        pad[:nx, :ny] = to_device(image[b], dev, rdt)
        kernel = ghat
        if gausspari is not None:
            ghati = _gauss_ft(gausspari[b], nx_pad, ny_pad, dev, rdt)
            kernel = torch.where(ghati.abs() > 1e-12, ghat / ghati, ghat)
        conv = torch.fft.irfft2(torch.fft.rfft2(pad) * kernel, s=(nx_pad, ny_pad))[:nx, :ny]
        out[b] = to_host(conv.contiguous())
    return out


def restore_image(model, residual, cleanbeam_par, intrinsic_pars=None, wsum: float = 1.0, *,
                  device="cuda") -> np.ndarray:
    """model (x) clean beam, scaled to unit peak (Jy/beam), + residual / wsum.

    Args:
        model: (nband, nx, ny) model in Jy/pixel.
        residual: (nband, nx, ny) raw residual (divided by wsum here).
        cleanbeam_par: (emaj, emin, pa) in pixels from ``fitcleanbeam``.
        intrinsic_pars: optional per-band PSF parameters; the residual is
            then taken to the clean beam's resolution.
    """
    conv_model = convolve2gaussres(model, cleanbeam_par, device=device)
    # a unit point source restores to peak 1
    nxk = int(max(cleanbeam_par[0], cleanbeam_par[1]) * 4) + 8
    x = np.arange(-nxk, nxk + 1)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    conv_model = conv_model / gaussian_kernel(xx, yy, cleanbeam_par, normalise=True).max()
    resid = residual / wsum
    if intrinsic_pars is not None:
        resid = convolve2gaussres(resid, cleanbeam_par, intrinsic_pars, device=device)
    return conv_model + resid
