"""Padded-FFT PSF convolution (port of pfb_imaging_tpu/ops/psf.py).

Unnormalised forward / 1/N inverse FFT pair, so a PSF whose FT is
``psfhat`` convolves with no extra scaling.
"""

from __future__ import annotations

import torch


def psf_to_psfhat(psf: torch.Tensor) -> torch.Tensor:
    """PSFHAT = rfft2(ifftshift(PSF)) over the last two axes."""
    return torch.fft.rfft2(torch.fft.ifftshift(psf, dim=(-2, -1)), dim=(-2, -1))


def psf_convolve(x: torch.Tensor, psfhat: torch.Tensor, nx_psf: int, ny_psf: int) -> torch.Tensor:
    """PSF * x on a zero-padded (nx_psf, ny_psf) grid, cropped back to x's shape."""
    nx, ny = x.shape[-2], x.shape[-1]
    xhat = torch.fft.rfft2(x, s=(nx_psf, ny_psf), dim=(-2, -1))
    big = torch.fft.irfft2(xhat * psfhat, s=(nx_psf, ny_psf), dim=(-2, -1))
    return big[..., :nx, :ny]
