"""The production SARA prox with a signed band sum (port of
pfb_imaging_tpu/prox/prox_21m.py). Coefficient cubes are
(nband, nbasis, nymax, nxmax); ``weight`` is (nbasis, nymax, nxmax). The
band sum is the only coupling between bands in the backward step: under a
band mesh (``mesh``) the cube is this rank's band slice, and the sum
gathers every band over the band group and adds them in band order
(``parallel.mesh.band_sum``).

PD's dual update on the card is the hand-written kernel of
``csrc/prox_21m.cu`` (``launch.dual_update_21m``, one a call): one pass over
the cube, the composition's bits. Under a band-split mesh the kernel takes
the band sum that ``band_sum`` gathers and adds. CPU tensors take the
composition, ``dual_update_plain``."""

from __future__ import annotations

import torch

from ..parallel.mesh import band_sum
from ..utils.profiling import count


def prox_21m(v, lam, sigma: float = 1.0, weight=None, *, mesh=None):
    """prox of (lam/sigma)*||W .||_{21m} evaluated at v/sigma."""
    if weight is None:
        weight = torch.ones_like(v[0])
    vbisum = band_sum(v, mesh) / sigma
    absv = vbisum.abs()
    soft = torch.clamp(absv - lam * weight / sigma, min=0.0)
    pos = absv > 0
    ratio = torch.where(pos, soft / torch.where(pos, absv, torch.ones_like(absv)), torch.zeros_like(absv))
    return v * ratio[None] / sigma


def dual_update(vp, v, lam, sigma: float = 1.0, weight=None, *, mesh=None):
    """v = vtilde * min(1, lam*w / |sum_b vtilde|), vtilde = vp + sigma*v: the
    kernel for a cube on the card (f32, contiguous, else it raises), given
    the gathered band sum under a band split; the composition on the CPU."""
    if vp.device.type == "cpu":
        return dual_update_plain(vp, v, lam, sigma, weight, mesh=mesh)
    vsum = band_sum(vp + sigma * v, mesh) if mesh is not None and mesh.band_size > 1 else None
    return _dual_update_cuda(vp, v, lam, sigma, weight, vsum)


def dual_update_plain(vp, v, lam, sigma: float = 1.0, weight=None, *, mesh=None):
    """:func:`dual_update` by torch ops, on any device and dtype."""
    if weight is None:
        weight = torch.ones_like(v[0])
    vtilde = vp + sigma * v
    vsum = band_sum(vtilde, mesh).abs()
    threshold = lam * weight
    safe = torch.where(vsum > 0, vsum, torch.ones_like(vsum))
    scale = torch.where(vsum > threshold, threshold / safe, torch.ones_like(vsum))
    return vtilde * scale[None]


def _dual_update_cuda(vp, v, lam, sigma, weight, vsum=None):
    """``csrc/prox_21m.cu`` on the cubes (nband, ...), the weight plane and,
    under a band split, the band sum plane ``vsum``; without it, counts the
    bands it sums as ``band.sum``, as ``band_sum`` does."""
    from ..kernels.build import check, load, stream

    planes = {"weight": weight, "vsum": vsum}
    for name, t in {"vp": vp, "v": v, **{k: t for k, t in planes.items() if t is not None}}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"dual_update: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dual_update: {name} must be contiguous")
        if t.device != vp.device:
            raise ValueError(f"dual_update: {name} is on {t.device}, vp on {vp.device}")
    if v.shape != vp.shape or vp.dim() < 1 or vp.shape[0] < 1:
        raise ValueError(f"dual_update: v {tuple(v.shape)} is not vp's {tuple(vp.shape)} (nband >= 1, ...)")
    for name, t in planes.items():
        if t is not None and t.shape != vp.shape[1:]:
            raise ValueError(f"dual_update: {name} {tuple(t.shape)} is not a band's {tuple(vp.shape[1:])}")
    nband = vp.shape[0]
    out = torch.empty_like(vp)
    if vsum is None:
        count("band.sum", nband)
    ptr = [None if t is None else t.data_ptr() for t in (weight, vsum)]
    code = load().pfb_dual_update_21m(vp.data_ptr(), v.data_ptr(), *ptr, out.data_ptr(), nband, vp[0].numel(),
                                      float(sigma), float(lam), stream(vp.device))
    check(code, "dual_update_21m")
    return out
