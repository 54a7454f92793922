"""Classic ES w-stacking gridder (port of pfb_imaging_tpu/ops/gridder.py).

Exponential-of-semicircle (ES) kernel resampling on an oversampled uv grid
plus improved w-stacking: visibilities are sorted and bucketed by their base
w-plane on the host, and each plane's bucket is gridded (on the card by
the scatter kernel B3 of ``gridder_pallas``, in a fixed order; on the CPU
by ``index_add_``) or degridded (gather by advanced indexing), with one
``torch.fft`` transform and an image-space w-screen per plane.

What differs from the JAX plan, for accuracy and not for speed: the plan
keeps each visibility's integer window start (``iu0``/``iv0``) and its
offset inside the window (``du``/``dv`` = u - iu0, computed in f64 on the
host) instead of absolute grid coordinates, and its w as ``w_rel`` =
(w - w0) / dw in plane units. An absolute f32 coordinate on an 8192 grid
keeps only ~5e-4 cell; the window-relative one keeps ~1e-7 cell, so f32
plans stay accurate at the port's large grids. The w-screen phases are
evaluated in f64 (``nm1`` is kept in f64) and rounded once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import complex_dtype, real_dtype, to_device
from ..constants import LIGHTSPEED
from ..geometry import conventions_signs, good_size, lm_grid

__all__ = ["WGridderPlan", "plan_wgridder", "dirty2vis", "vis2dirty", "wgridder_plan_from_jax", "es_kernel"]

# visibilities per stencil chunk (bounds the (2, n, W, W) temporaries)
_CHUNK = 1 << 19


# ── ES kernel ─────────────────────────────────────────────────────────


def es_kernel(x, beta):
    """exp(beta (sqrt(1 - x^2) - 1)) on |x| < 1, else 0 (tensor or ndarray)."""
    if isinstance(x, torch.Tensor):
        x2 = x * x
        inside = x2 < 1.0
        arg = torch.sqrt(torch.where(inside, 1.0 - x2, torch.zeros_like(x2)))
        return torch.where(inside, torch.exp(beta * (arg - 1.0)), torch.zeros_like(x2))
    x2 = x * x
    inside = x2 < 1.0
    arg = np.sqrt(np.where(inside, 1.0 - x2, 0.0))
    return np.where(inside, np.exp(beta * (arg - 1.0)), 0.0)


def _kernel_params(epsilon: float, sigma: float = 2.0) -> tuple[int, float]:
    """ES support W = ceil(log10(1/eps)) + 1 (clamped to 4..16), beta = 2.3 W."""
    w = int(np.ceil(-np.log10(epsilon))) + 1
    w = max(4, min(w, 16))
    return w, 2.30 * w


def _kernel_ft(xi: np.ndarray, support: int, beta: float, delta: float = 1.0, nquad: int = 64) -> np.ndarray:
    """Fourier transform of the gridded ES kernel at ``xi`` (Gauss-Legendre
    quadrature; above 2^21 points, linear interpolation on an 8193-node grid,
    as in the JAX version)."""
    q, wq = np.polynomial.legendre.leggauss(nquad)
    wphi = wq * np.exp(beta * (np.sqrt(1.0 - q * q) - 1.0))
    half = support * delta / 2.0
    xi = np.asarray(xi)
    shape = xi.shape
    flat = xi.ravel()

    def direct(pts):
        out = np.empty(pts.shape[0])
        for i in range(0, pts.shape[0], 1 << 16):
            out[i : i + (1 << 16)] = np.cos(np.pi * support * delta * np.multiply.outer(pts[i : i + (1 << 16)], q)) @ wphi
        return half * out

    if flat.size > (1 << 21):
        lo, hi = float(flat.min()), float(flat.max())
        if hi == lo:
            return np.full(shape, direct(np.array([lo]))[0])
        grid = np.linspace(lo, hi, 8193)
        return np.interp(flat, grid, direct(grid)).reshape(shape)
    return direct(flat).reshape(shape)


# ── plan ──────────────────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True, eq=False)  # plans hash by identity (tile cache)
class WGridderPlan:
    """Static layout + tensors for one (uvw, freq) layout.

    Tensors (``rdt`` the working dtype; the stream is w-sorted):
        iu0, iv0 (nvis,) int64 window starts (unwrapped); du, dv (nvis,) rdt
        offsets u - iu0, v - iv0; w_rel (nvis,) rdt (w - w0) / dw (raw w
        when ``do_wgridding`` is False); sort_idx (nvis,) int64 original
        (row*chan) index; phase_re/phase_im (nvis,) rdt phase-centre shift;
        corr_img, cw_img (nx, ny) rdt; nm1 (nx, ny) f64.
    ``plane_start``/``plane_count`` (host ints): plane p's bucket of the
    sorted stream (base planes p - w_support + 1 .. p).
    """

    nx: int
    ny: int
    nbig_x: int
    nbig_y: int
    cellx: float
    celly: float
    support: int
    beta: float
    nw: int
    w_support: int
    capacity: int
    do_wgridding: bool
    divide_by_n: bool
    nrow: int
    nchan: int
    w0: float
    dw: float
    plane_start: tuple
    plane_count: tuple
    iu0: torch.Tensor
    iv0: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    w_rel: torch.Tensor
    sort_idx: torch.Tensor
    phase_re: torch.Tensor
    phase_im: torch.Tensor
    corr_img: torch.Tensor
    nm1: torch.Tensor
    cw_img: torch.Tensor

    @property
    def device(self):
        return self.du.device

    @property
    def rdt(self):
        return self.du.dtype

    @property
    def nvis(self) -> int:
        return self.sort_idx.shape[0]

    @property
    def nbytes(self) -> int:
        fields = (getattr(self, f.name) for f in dataclasses.fields(self))
        return sum(t.numel() * t.element_size() for t in fields if isinstance(t, torch.Tensor))


def _as_torch_dtype(dtype, device) -> torch.dtype:
    if dtype is None:
        return real_dtype(device)
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.float32 if np.dtype(dtype) == np.float32 else torch.float64


def _build_plan(*, u_pix, v_pix, w_lam, sort_idx, starts, counts, phase, corr, nm1, cw, w0, dw, nw, w_support,
                do_wgridding, rdt, device, **static) -> WGridderPlan:
    """Window starts/offsets and w in plane units (host, f64), then the
    plan on ``device``. ``u_pix``/``v_pix``/``w_lam`` are in sorted order."""
    support = static["support"]
    iu0 = np.floor(u_pix - support / 2.0).astype(np.int64) + 1
    iv0 = np.floor(v_pix - support / 2.0).astype(np.int64) + 1
    w_rel = (w_lam - w0) / dw if do_wgridding else w_lam
    dev = torch.device(device)
    as_t = lambda a, t=rdt: to_device(a, dev, t)  # noqa: E731
    return WGridderPlan(
        **static, nw=int(nw), w_support=int(w_support), capacity=int(max(counts)) if len(counts) else 0,
        do_wgridding=bool(do_wgridding), w0=float(w0), dw=float(dw),
        plane_start=tuple(int(x) for x in starts), plane_count=tuple(int(x) for x in counts),
        iu0=as_t(iu0, torch.int64), iv0=as_t(iv0, torch.int64), du=as_t(u_pix - iu0), dv=as_t(v_pix - iv0),
        w_rel=as_t(w_rel), sort_idx=as_t(sort_idx, torch.int64), phase_re=as_t(np.real(phase)),
        phase_im=as_t(np.imag(phase)), corr_img=as_t(corr), nm1=as_t(nm1, torch.float64), cw_img=as_t(cw),
    )


def plan_wgridder(uvw, freq, *, nx: int, ny: int, cellx: float, celly: float, l0: float = 0.0, m0: float = 0.0,
                  flip_u: bool = False, flip_v: bool = True, flip_w: bool = False, epsilon: float = 1e-7,
                  do_wgridding: bool = True, divide_by_n: bool = True, sigma: float = 2.0, w_sigma: float = 2.0,
                  dtype=None, force_w_grid: tuple | None = None, device="cuda") -> WGridderPlan:
    """Host planning onto ``device``: kernel selection, image corrections,
    w-plane layout and bucketing (the JAX ``plan_wgridder``). ``dtype`` is
    the working real dtype (numpy or torch; default f32 on CUDA, f64 on
    the CPU). ``force_w_grid`` (w0, dw, nw) replaces the data's w-plane grid,
    so that row shards share one (``parallel.sharded.plan_wgridder_sharded``)."""
    from ..native import wplane_buckets

    rdt = _as_torch_dtype(dtype, device)
    uvw = np.asarray(uvw, dtype=np.float64)
    freq = np.asarray(freq, dtype=np.float64)
    nrow, nchan = uvw.shape[0], freq.shape[0]
    su, sv, sw = conventions_signs(flip_u, flip_v, flip_w)
    support, beta = _kernel_params(epsilon, sigma)
    nbig_x = good_size(max(int(np.ceil(sigma * nx)), nx + 2 * support))
    nbig_y = good_size(max(int(np.ceil(sigma * ny)), ny + 2 * support))

    invlam = freq / LIGHTSPEED
    u_l = su * np.multiply.outer(uvw[:, 0], invlam)
    v_l = sv * np.multiply.outer(uvw[:, 1], invlam)
    w_lam = (sw * np.multiply.outer(uvw[:, 2], invlam)).ravel()
    u_pix = (u_l * cellx * nbig_x).ravel()
    v_pix = (v_l * celly * nbig_y).ravel()
    phase = np.exp(-2j * np.pi * (u_l.ravel() * (-l0) + v_l.ravel() * m0))
    del u_l, v_l
    nvis = u_pix.size

    _, _, nn = lm_grid(nx, ny, cellx, celly, l0, m0)
    nm1 = nn - 1.0
    cx = _kernel_ft((np.arange(nx) - nx // 2) / nbig_x, support, beta)
    cy = _kernel_ft((np.arange(ny) - ny // 2) / nbig_y, support, beta)
    corr = 1.0 / np.outer(cx, cy)
    if divide_by_n:
        with np.errstate(divide="ignore"):
            corr = np.where(nn > 0, corr / nn, 0.0)

    static = dict(nx=nx, ny=ny, nbig_x=nbig_x, nbig_y=nbig_y, cellx=cellx, celly=celly, support=support, beta=beta,
                  divide_by_n=divide_by_n, nrow=nrow, nchan=nchan)
    if do_wgridding and (np.any(np.abs(w_lam) > 0) or force_w_grid is not None):
        w_supp = support
        if force_w_grid is not None:
            w0, dw, nw = force_w_grid
            nw = int(nw)
            i0 = np.floor((w_lam - w0) / dw - w_supp / 2.0).astype(np.int64) + 1
            if i0.size and (i0.min() < 0 or int(i0.max()) + w_supp > nw):
                raise ValueError("force_w_grid does not cover this shard's w range")
        else:
            dw = 1.0 / (2.0 * w_sigma * max(float(np.abs(nm1).max()), 1e-12))
            wmin = float(w_lam.min())
            # base plane i0: the kernel support covers planes i0 .. i0 + W - 1
            i0 = np.floor((w_lam - wmin) / dw - w_supp / 2.0).astype(np.int64) + 1
            shift = i0.min()
            i0 = i0 - shift
            w0 = wmin + shift * dw
            nw = int(i0.max()) + w_supp
        perm, starts, counts = wplane_buckets(i0, nw, w_supp)
        cw = dw / _kernel_ft(nm1, w_supp, beta, delta=dw)
        return _build_plan(u_pix=u_pix[perm], v_pix=v_pix[perm], w_lam=w_lam[perm], sort_idx=perm, starts=starts,
                           counts=counts, phase=phase[perm], corr=corr, nm1=nm1, cw=cw, w0=w0, dw=dw, nw=nw,
                           w_support=w_supp, do_wgridding=True, rdt=rdt, device=device, **static)
    return _build_plan(u_pix=u_pix, v_pix=v_pix, w_lam=w_lam, sort_idx=np.arange(nvis), starts=[0], counts=[nvis],
                       phase=phase, corr=corr, nm1=nm1, cw=np.ones((nx, ny)), w0=0.0, dw=1.0, nw=1, w_support=1,
                       do_wgridding=False, rdt=rdt, device=device, **static)


def wgridder_plan_from_jax(leaves: dict, meta: dict, *, device="cuda") -> WGridderPlan:
    """The port's plan from the numpy leaves and static fields of a JAX
    ``WGridderPlan`` (``{f: np.asarray(getattr(p, f))}`` over its data and
    meta fields). The working dtype is that of the JAX plan's ``u_pix``."""
    nvis = int(np.asarray(leaves["sort_idx"]).size)
    rdt = torch.float32 if np.asarray(leaves["u_pix"]).dtype == np.float32 else torch.float64
    keys = ("nx", "ny", "nbig_x", "nbig_y", "cellx", "celly", "support", "beta", "divide_by_n", "nrow", "nchan")
    static = {k: meta[k] for k in keys}
    f64 = lambda name: np.asarray(leaves[name], np.float64)  # noqa: E731
    return _build_plan(
        u_pix=f64("u_pix")[:nvis], v_pix=f64("v_pix")[:nvis], w_lam=f64("w_lam")[:nvis],
        sort_idx=np.asarray(leaves["sort_idx"], np.int64), starts=np.asarray(leaves["plane_start"]),
        counts=np.asarray(leaves["plane_count"]), phase=f64("phase_re") + 1j * f64("phase_im"),
        corr=f64("corr_img"), nm1=f64("nm1"), cw=f64("cw_img"), w0=meta["w0"], dw=meta["dw"], nw=meta["nw"],
        w_support=meta["w_support"], do_wgridding=meta["do_wgridding"], rdt=rdt, device=device, **static,
    )


# ── stencils on the sorted stream ────────────────────────────────────


def _uv_stencil(plan: WGridderPlan, sl: slice, dtype=None):
    """Wrapped cell indices and ES weights of the visibilities ``sl`` of the
    sorted stream: (iu, iv, ku, kv), each (n, W). ``dtype`` (default the
    plan's) is the type the weights are evaluated in."""
    w = plan.support
    offs = torch.arange(w, device=plan.device)
    iu = torch.remainder(plan.iu0[sl, None] + offs, plan.nbig_x)
    iv = torch.remainder(plan.iv0[sl, None] + offs, plan.nbig_y)
    dt = dtype or plan.rdt
    offs_f = offs.to(dt)
    ku = es_kernel(2.0 * (plan.du[sl, None].to(dt) - offs_f) / w, plan.beta)
    kv = es_kernel(2.0 * (plan.dv[sl, None].to(dt) - offs_f) / w, plan.beta)
    return iu, iv, ku, kv


def _w_weight(plan: WGridderPlan, w_rel, p: int):
    """ES weight of plane ``p`` for visibilities at ``w_rel``; ones when the
    plan has no w-gridding."""
    if not plan.do_wgridding:
        return torch.ones_like(w_rel)
    return es_kernel(2.0 * (w_rel - p) / plan.w_support, plan.beta)


def _chunks(plan: WGridderPlan, p: int):
    """Slices of plane ``p``'s bucket, at most ``_CHUNK`` visibilities each."""
    s, c = plan.plane_start[p], plan.plane_count[p]
    return [slice(a, min(a + _CHUNK, s + c)) for a in range(s, s + c, _CHUNK)]


def _scatter_plane(plan: WGridderPlan, vals, p: int, out=None):
    """Plane ``p``'s (2, nbig_x, nbig_y) uv grid from sorted-stream values
    ``vals`` (2, nvis), accumulated with ``index_add_`` in ``vals``' dtype."""
    dt = vals.dtype
    if out is None:
        out = torch.zeros((2, plan.nbig_x, plan.nbig_y), dtype=dt, device=vals.device)
    flat = out.view(2, -1)
    for sl in _chunks(plan, p):
        iu, iv, ku, kv = _uv_stencil(plan, sl, dt)
        ww = _w_weight(plan, plan.w_rel[sl].to(dt), p)
        contrib = (vals[:, sl] * ww)[:, :, None, None] * (ku[:, :, None] * kv[:, None, :])[None]
        idx = iu[:, :, None] * plan.nbig_y + iv[:, None, :]
        flat.index_add_(1, idx.reshape(-1), contrib.reshape(2, -1))
    return out


def _pad_center(plan: WGridderPlan, img):
    px0 = plan.nbig_x // 2 - plan.nx // 2
    py0 = plan.nbig_y // 2 - plan.ny // 2
    big = img.new_zeros((plan.nbig_x, plan.nbig_y))
    big[px0 : px0 + plan.nx, py0 : py0 + plan.ny] = img
    return big


def _crop_center(plan: WGridderPlan, big):
    px0 = plan.nbig_x // 2 - plan.nx // 2
    py0 = plan.nbig_y // 2 - plan.ny // 2
    return big[..., px0 : px0 + plan.nx, py0 : py0 + plan.ny]


def _screen(plan: WGridderPlan, p: int, sign: float):
    """w-screen e^{i sign 2 pi w_p (n-1)}, phase in f64, rounded once."""
    ph = (sign * 2.0 * np.pi * (plan.w0 + p * plan.dw)) * plan.nm1
    return torch.polar(torch.ones_like(ph), ph).to(complex_dtype(plan.rdt))


def _vis2dirty_prepare(plan: WGridderPlan, vis_re, vis_im, wgt=None, mask=None):
    """Sorted-stream (2, nvis) weighted values with the conjugate phase
    shift applied, in the plan's dtype."""
    wre = vis_re.to(device=plan.device, dtype=plan.rdt).reshape(-1)
    wim = vis_im.to(device=plan.device, dtype=plan.rdt).reshape(-1)
    for m in (wgt, mask):
        if m is not None:
            m = m.to(device=plan.device, dtype=plan.rdt).reshape(-1)
            wre, wim = wre * m, wim * m
    sre, sim = wre[plan.sort_idx], wim[plan.sort_idx]
    pre, pim = plan.phase_re, plan.phase_im
    return torch.stack([sre * pre + sim * pim, sim * pre - sre * pim])


def _plane_image(plan: WGridderPlan, grid_ri, p: int):
    """Complexify, inverse FFT, shift/crop, apply plane ``p``'s w-screen:
    the (nx, ny) complex image of one plane's uv grid."""
    grid = torch.complex(grid_ri[0], grid_ri[1])
    big = torch.fft.ifft2(grid) * (plan.nbig_x * plan.nbig_y)
    a = _crop_center(plan, torch.fft.fftshift(big))
    if plan.do_wgridding:
        a = a * _screen(plan, p, -1.0)
    return a


def _vis2dirty_finish(plan: WGridderPlan, acc):
    return acc.real * plan.corr_img * plan.cw_img


def _as_ri(vis, vis_im):
    """(real, imag) of complex ``vis``, or ``vis`` and ``vis_im``."""
    if vis_im is None:
        vis = torch.as_tensor(vis)
        return vis.real, vis.imag
    return torch.as_tensor(vis), torch.as_tensor(vis_im)


def vis2dirty(plan: WGridderPlan, vis, wgt=None, mask=None, vis_im=None):
    """Grid (nrow, nchan) visibilities to an (nx, ny) dirty image (the exact
    adjoint of :func:`dirty2vis`). ``vis`` is complex, or its real part
    with ``vis_im`` the imaginary part.

    On the card the scatter is the CUDA kernel B3
    (``gridder_pallas.vis2dirty_scatter``), which adds in a fixed order, so
    two runs give the same bits; it takes f32 plans and raises on others.
    On the CPU it is :func:`vis2dirty_plain`."""
    if plan.device.type == "cpu":
        return vis2dirty_plain(plan, vis, wgt, mask, vis_im)
    from .gridder_pallas import vis2dirty_scatter  # imported here: gridder_pallas imports this module

    if plan.rdt != torch.float32:
        raise ValueError(f"on the card the classic scatter is the f32 kernel B3; this plan is {plan.rdt}: plan "
                         "with dtype=np.float32")
    return vis2dirty_scatter(plan, vis, wgt, mask, vis_im)


def vis2dirty_plain(plan: WGridderPlan, vis, wgt=None, mask=None, vis_im=None):
    """Plain version of :func:`vis2dirty`: each plane's bucket scattered by
    ``index_add_`` (:func:`_scatter_plane`), in the plan's dtype."""
    vals = _vis2dirty_prepare(plan, *_as_ri(vis, vis_im), wgt, mask)
    acc = torch.zeros((plan.nx, plan.ny), dtype=complex_dtype(plan.rdt), device=plan.device)
    for p in range(plan.nw):
        if plan.plane_count[p]:
            acc += _plane_image(plan, _scatter_plane(plan, vals, p), p)
    return _vis2dirty_finish(plan, acc)


def _dirty2vis_finish_ri(plan: WGridderPlan, vis_ri, mask=None):
    """Unsort + phase shift in real arithmetic; returns (2, nrow, nchan)."""
    pre, pim = plan.phase_re, plan.phase_im
    out = torch.empty_like(vis_ri)
    out[0, plan.sort_idx] = vis_ri[0] * pre - vis_ri[1] * pim
    out[1, plan.sort_idx] = vis_ri[0] * pim + vis_ri[1] * pre
    out = out.reshape(2, plan.nrow, plan.nchan)
    if mask is not None:
        out = out * mask.to(device=plan.device, dtype=plan.rdt)[None]
    return out


def _dirty2vis_prepare(plan: WGridderPlan, image):
    """The corrected image ``image * corr * cw`` as a complex tensor."""
    ieff = image.to(device=plan.device, dtype=plan.rdt) * plan.corr_img * plan.cw_img
    return ieff.to(complex_dtype(plan.rdt))


def _plane_grid(plan: WGridderPlan, ieff, p: int):
    """Plane ``p``'s complex (nbig_x, nbig_y) uv grid of the corrected image:
    w-screen, pad, ifftshift, fft2."""
    a = ieff * _screen(plan, p, 1.0) if plan.do_wgridding else ieff
    return torch.fft.fft2(torch.fft.ifftshift(_pad_center(plan, a)))


def dirty2vis(plan: WGridderPlan, image, mask=None):
    """Degrid an (nx, ny) image to complex (nrow, nchan) visibilities."""
    ieff = _dirty2vis_prepare(plan, image)
    vis_ri = torch.zeros((2, plan.nvis), dtype=plan.rdt, device=plan.device)
    for p in range(plan.nw):
        if not plan.plane_count[p]:
            continue
        grid = _plane_grid(plan, ieff, p)
        grid_ri = torch.stack([grid.real, grid.imag])
        for sl in _chunks(plan, p):
            iu, iv, ku, kv = _uv_stencil(plan, sl)
            g = grid_ri[:, iu[:, :, None], iv[:, None, :]]
            kw2 = (ku[:, :, None] * kv[:, None, :]) * _w_weight(plan, plan.w_rel[sl], p)[:, None, None]
            vis_ri[:, sl] += (g * kw2[None]).sum(dim=(2, 3))
    out = _dirty2vis_finish_ri(plan, vis_ri, mask)
    return torch.complex(out[0], out[1])
