"""The plain reference that decides ``correct``: plain PyTorch, written from
the configuration's mathematics, importing nothing of the program.

Conventions (the configuration's, pinned by the imaging package against a
direct DFT): a pixel (p, q) of an nx^2 image at cell ``cell`` sits at
l = (p - nx//2) cell, m = (q - nx//2) cell; a visibility is
V = sum_pix I exp(-2 pi i (u l - v m - w (n - 1)) f / c), with no 1/n; the
dirty image is sum_vis w Re(V exp(+2 pi i (...) f / c)).

``prec`` selects the arithmetic: "f64", or "tf32", the control, which is the
same code in float32 with TF32 allowed in matrix products and convolutions
(on the card; elsewhere it is plain float32).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LIGHTSPEED = 299792458.0
# rows of visibilities a DFT block takes (bounds the block's memory)
DFT_ROWS = 8192


def dtype_of(prec: str) -> torch.dtype:
    return {"f64": torch.float64, "tf32": torch.float32}[prec]


@contextlib.contextmanager
def precision(prec: str):
    """TF32 allowed inside for the control, the defaults restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield dtype_of(prec)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def lmn(pix: np.ndarray, nx: int, cell: float, dev, dtype) -> torch.Tensor:
    """(3, K) [l, -m, -(n - 1)] of pixels (K, 2): the phase is uvw @ this."""
    l = (torch.as_tensor(pix[:, 0], device=dev, dtype=torch.float64) - nx // 2) * cell
    m = (torch.as_tensor(pix[:, 1], device=dev, dtype=torch.float64) - nx // 2) * cell
    n1 = torch.sqrt(1.0 - l * l - m * m) - 1.0
    return torch.stack([l, -m, -n1]).to(dtype)


def image_at(uvw, freq, vis_w, pix: np.ndarray, nx: int, cell: float, prec: str = "f64") -> torch.Tensor:
    """sum_vis Re(vis_w exp(+2 pi i phase(pix))) at pixels ``pix`` (K, 2):
    the dirty image of weighted visibilities ``vis_w`` (nrow, nchan,
    complex) at those pixels. Returns (K,) float64."""
    with precision(prec) as dt:
        dev = vis_w.device
        geo = lmn(pix, nx, cell, dev, dt)
        u = torch.as_tensor(uvw, device=dev).to(dt)
        acc = torch.zeros(pix.shape[0], dtype=dt, device=dev)
        for c, f in enumerate(np.asarray(freq)):
            k = 2.0 * math.pi * f / LIGHTSPEED
            for s in range(0, u.shape[0], DFT_ROWS):
                ph = k * (u[s : s + DFT_ROWS] @ geo)
                vv = vis_w[s : s + DFT_ROWS, c]
                acc += vv.real.to(dt) @ torch.cos(ph) - vv.imag.to(dt) @ torch.sin(ph)
        return acc.double()


def vis_of_image(uvw, freq, image, nx: int, cell: float, prec: str = "f64") -> torch.Tensor:
    """V = sum_pix I exp(-2 pi i phase) over the nonzero pixels of ``image``
    (nx, nx) at every visibility (nrow, nchan). Returns complex128."""
    with precision(prec) as dt:
        img = torch.as_tensor(image)
        dev = img.device if img.is_cuda else torch.as_tensor(uvw).device
        img = img.to(dev)
        nz = torch.nonzero(img).cpu().numpy()
        flux = img[nz[:, 0], nz[:, 1]].to(dt)
        geo = lmn(nz, nx, cell, dev, dt)
        u = torch.as_tensor(uvw, device=dev).to(dt)
        out = torch.zeros((u.shape[0], len(freq)), dtype=torch.complex128, device=dev)
        block = max(1, DFT_ROWS * 64 // max(1, nz.shape[0]))
        for c, f in enumerate(np.asarray(freq)):
            k = 2.0 * math.pi * f / LIGHTSPEED
            for s in range(0, u.shape[0], block):
                ph = k * (u[s : s + block] @ geo)
                out[s : s + block, c] = torch.complex((torch.cos(ph) @ flux).double(), -(torch.sin(ph) @ flux).double())
        return out


# the exponential-of-semicircle kernel of the type-2 NUFFT below: support
# W grid cells, beta = 2.30 W on a grid oversampled 2x (error ~1e-11)
NUFFT_W = 12
NUFFT_SIGMA = 2.0
# visibilities a gather block of the NUFFT takes (a block holds W^2 values each)
NUFFT_BLOCK = 1 << 17


def _es(z, W: int):
    """The kernel at offsets z (grid cells), zero outside |z| < W/2."""
    t = (2.0 * z / W).clamp(-1.0, 1.0)
    return torch.where((2.0 * z / W).abs() < 1.0, torch.exp(2.30 * W * (torch.sqrt(1.0 - t * t) - 1.0)),
                       torch.zeros_like(z))


def _es_hat(t, W: int):
    """Its Fourier transform int psi(z) cos(2 pi z t) dz, by Gauss-Legendre."""
    x, wq = np.polynomial.legendre.leggauss(4 * W + 64)
    z = torch.as_tensor(x * W / 2.0, dtype=torch.float64, device=t.device)
    wq = torch.as_tensor(wq * W / 2.0, dtype=torch.float64, device=t.device)
    psi = _es(z, W)
    return (torch.cos(2.0 * math.pi * t.double()[..., None] * z) * (wq * psi)).sum(-1)


def vis_nufft(uvw, freq, image, nx: int, cell: float, prec: str = "f64") -> torch.Tensor:
    """V = sum_pix I exp(-2 pi i phase) at every visibility (nrow, nchan),
    complex128, by a type-2 non-uniform FFT with w-stacking: the image,
    corrected by the kernel's transform in l, m and n - 1 and multiplied by
    each w plane's screen, is Fourier transformed on a grid oversampled
    NUFFT_SIGMA times, and each visibility sums NUFFT_W^3 grid values
    weighted by the separable kernel. For a dense image, where the direct
    sum costs pixels x visibilities."""
    with precision(prec) as dt:
        img = torch.as_tensor(image).to(torch.float64)
        dev = img.device
        cdt = torch.complex128 if dt == torch.float64 else torch.complex64
        W, N = NUFFT_W, int(2 * math.ceil(NUFFT_SIGMA * nx / 2))
        t = torch.arange(nx, device=dev, dtype=torch.float64) - nx // 2
        l = t * cell
        xi = torch.sqrt(1.0 - l[:, None] ** 2 - l[None, :] ** 2) - 1.0  # n - 1 <= 0
        xc = float(xi.min()) / 2.0
        half = max(-xc, 1e-300)
        dw = 1.0 / (2.0 * NUFFT_SIGMA * half)
        corr = _es_hat(t / N, W)
        base = img / (corr[:, None] * corr[None, :] * _es_hat(dw * (xi - xc), W))
        u = torch.as_tensor(uvw, device=dev).to(torch.float64)
        f = torch.as_tensor(np.asarray(freq), device=dev, dtype=torch.float64) / LIGHTSPEED
        su = ((u[:, 0:1] * f) * cell * N).reshape(-1)
        sv = (-(u[:, 1:2] * f) * cell * N).reshape(-1)
        wv = (u[:, 2:3] * f).reshape(-1)
        sw = wv / dw
        out = torch.zeros(su.shape[0], dtype=torch.complex128, device=dev)
        ar = torch.arange(W, device=dev)
        for j in range(int(math.floor(float(sw.min()) - W / 2)), int(math.ceil(float(sw.max()) + W / 2)) + 1):
            sel = torch.nonzero((sw - j).abs() < W / 2).reshape(-1)
            if sel.numel() == 0:
                continue
            grid = torch.zeros((N, N), dtype=torch.complex128, device=dev)
            grid[:nx, :nx] = base * torch.exp(2j * math.pi * j * dw * (xi - xc))
            gj = torch.fft.fft2(torch.roll(grid, (-(nx // 2), -(nx // 2)), (0, 1))).to(cdt)
            for s0 in range(0, sel.numel(), NUFFT_BLOCK):
                idx = sel[s0 : s0 + NUFFT_BLOCK]
                ku = torch.floor(su[idx] - W / 2).long() + 1
                kv = torch.floor(sv[idx] - W / 2).long() + 1
                pu = _es(su[idx, None] - (ku[:, None] + ar), W).to(dt)
                pv = _es(sv[idx, None] - (kv[:, None] + ar), W).to(dt)
                patch = gj[((ku[:, None] + ar) % N)[:, :, None], ((kv[:, None] + ar) % N)[:, None, :]]
                val = torch.einsum("nab,na,nb->n", patch, pu.to(cdt), pv.to(cdt))
                out[idx] += (_es(sw[idx] - j, W) * torch.exp(2j * math.pi * wv[idx] * xc)) * val.to(torch.complex128)
        return out.reshape(u.shape[0], len(f))


def image_nufft(uvw, freq, vis_w, nx: int, cell: float, prec: str = "f64") -> torch.Tensor:
    """sum_vis Re(vis_w exp(+2 pi i phase)) at every pixel of an nx^2 image:
    the dirty image of weighted visibilities ``vis_w`` (nrow, nchan,
    complex), as the adjoint of ``vis_nufft`` (each visibility spread over
    NUFFT_W^3 cells of the w planes' grids, each grid transformed back,
    multiplied by its plane's conjugate screen and summed, then divided by
    the kernel's transform). Returns (nx, nx) float64."""
    with precision(prec) as dt:
        dev = vis_w.device
        cdt = torch.complex128 if dt == torch.float64 else torch.complex64
        W, N = NUFFT_W, int(2 * math.ceil(NUFFT_SIGMA * nx / 2))
        t = torch.arange(nx, device=dev, dtype=torch.float64) - nx // 2
        l = t * cell
        xi = torch.sqrt(1.0 - l[:, None] ** 2 - l[None, :] ** 2) - 1.0
        xc = float(xi.min()) / 2.0
        dw = 1.0 / (2.0 * NUFFT_SIGMA * max(-xc, 1e-300))
        u = torch.as_tensor(uvw, device=dev).to(torch.float64)
        f = torch.as_tensor(np.asarray(freq), device=dev, dtype=torch.float64) / LIGHTSPEED
        su = ((u[:, 0:1] * f) * cell * N).reshape(-1)
        sv = (-(u[:, 1:2] * f) * cell * N).reshape(-1)
        wv = (u[:, 2:3] * f).reshape(-1)
        sw = wv / dw
        vals = vis_w.reshape(-1).to(torch.complex128)
        acc = torch.zeros((nx, nx), dtype=torch.complex128, device=dev)
        ar = torch.arange(W, device=dev)
        for j in range(int(math.floor(float(sw.min()) - W / 2)), int(math.ceil(float(sw.max()) + W / 2)) + 1):
            sel = torch.nonzero((sw - j).abs() < W / 2).reshape(-1)
            if sel.numel() == 0:
                continue
            grid = torch.zeros(N * N, dtype=cdt, device=dev)
            for s0 in range(0, sel.numel(), NUFFT_BLOCK):
                idx = sel[s0 : s0 + NUFFT_BLOCK]
                ku = torch.floor(su[idx] - W / 2).long() + 1
                kv = torch.floor(sv[idx] - W / 2).long() + 1
                pu = _es(su[idx, None] - (ku[:, None] + ar), W).to(dt)
                pv = _es(sv[idx, None] - (kv[:, None] + ar), W).to(dt)
                coef = (_es(sw[idx] - j, W) * torch.exp(-2j * math.pi * wv[idx] * xc)) * vals[idx]
                spread = coef.to(cdt)[:, None, None] * (pu[:, :, None] * pv[:, None, :]).to(cdt)
                cells_ = ((ku[:, None] + ar) % N)[:, :, None] * N + ((kv[:, None] + ar) % N)[:, None, :]
                torch.view_as_real(grid).index_add_(0, cells_.reshape(-1), torch.view_as_real(spread.reshape(-1)))
            back = torch.fft.ifft2(grid.reshape(N, N)) * float(N * N)
            back = torch.roll(back, (nx // 2, nx // 2), (0, 1))[:nx, :nx].to(torch.complex128)
            acc += back * torch.exp(-2j * math.pi * j * dw * (xi - xc))
        corr = _es_hat(t / N, W)
        return (acc / (corr[:, None] * corr[None, :] * _es_hat(dw * (xi - xc), W))).real


# ── the minor cycle ──────────────────────────────────────────────────


class PsfHessian:
    """H x = PSF (*) x / wsum_tot + eta_b x per band: the PSF image of each
    band (nx, nx), zero-padded and centred on an (nx_psf, nx_psf) grid, as a
    linear convolution; eta_b = eta wsum_b / wsum_tot. With ``lowp`` the
    transform's input and output are rounded to bfloat16: the control's
    precision for float32 outside matrix products."""

    def __init__(self, psf, wsums, eta: float, nx_psf: int, dtype, lowp: bool = False):
        nband, nx, _ = psf.shape
        o = (nx_psf - nx) // 2
        pad = torch.zeros((nband, nx_psf, nx_psf), dtype=dtype, device=psf.device)
        pad[:, o : o + nx, o : o + nx] = psf.to(dtype)
        self.psfhat = torch.fft.rfft2(torch.fft.ifftshift(pad, dim=(-2, -1))).abs()
        w = torch.as_tensor(np.asarray(wsums, dtype=float), device=psf.device, dtype=dtype)
        self.wsum = w.sum()
        self.eta = (eta * w / self.wsum)[:, None, None]
        self.nx_psf, self.lowp = nx_psf, lowp

    def _round(self, t):
        return t.to(torch.bfloat16).to(t.dtype) if self.lowp else t

    def __call__(self, x):
        nx, ny = x.shape[-2:]
        xh = torch.fft.rfft2(self._round(x), s=(self.nx_psf, self.nx_psf))
        conv = torch.fft.irfft2(xh * self.psfhat, s=(self.nx_psf, self.nx_psf))[..., :nx, :ny]
        return self._round(conv) / self.wsum + self.eta * x


def _band_dot(a, b):
    """<a, b> taken band by band and the bands added in order."""
    per = (a * b).reshape(a.shape[0], -1).sum(-1)
    out = per[0]
    for i in range(1, per.shape[0]):
        out = out + per[i]
    return out


def power_norm(hess, b0, tol: float, maxit: int) -> float:
    """Largest eigenvalue of ``hess`` by the power method from ``b0``, the
    relative change of the Rayleigh quotient under ``tol`` ends it."""
    b = b0 / torch.sqrt(_band_dot(b0, b0))
    beta, k, eps = torch.ones((), dtype=b.dtype, device=b.device), 0, 1.0
    while eps > tol and k < maxit:
        bn = hess(b)
        betan = _band_dot(b, bn) / _band_dot(b, b)
        b = bn / torch.sqrt(_band_dot(bn, bn))
        eps = float((betan - beta).abs() / beta.clamp(min=1e-300))
        beta, k = betan, k + 1
    return float(beta)


def cg(hess, rhs, tol: float, minit: int, maxit: int):
    """Conjugate gradients from zero on hess x = rhs; stops when the relative
    change of x ||x_k - x_{k-1}|| / ||x_k|| falls under ``tol`` (after
    ``minit`` iterations), after ``maxit``, or after 5 stalls. Returns
    (x, iterations)."""
    x = torch.zeros_like(rhs)
    r = -rhs
    rnorm = _band_dot(r, r)
    if not bool(rnorm > 0):
        return x, 0
    p = -r
    k, eps, stall = 0, 1.0, 0
    while (eps > tol or k < minit) and k < maxit and stall < 5:
        ap = hess(p)
        alpha = rnorm / _band_dot(p, ap)
        xn = x + alpha * p
        r = r + alpha * ap
        rn = _band_dot(r, r)
        p = (rn / rnorm) * p - r
        rnorm = rn
        d = xn - x
        eps_n = float(torch.sqrt(_band_dot(d, d) / _band_dot(xn, xn).clamp(min=1e-12)))
        stall += int(abs(eps - eps_n) < 1e-3 * tol)
        x, eps, k = xn, eps_n, k + 1
    return x, k


def daubechies(n: int) -> list:
    """The scaling filter (rec_lo, summing to sqrt 2) of Daubechies' dbN by
    spectral factorisation: the half-band polynomial
    P(y) = sum_k C(n - 1 + k, k) y^k in y = (2 - z - 1/z) / 4, each of its
    roots taken to the root z inside the unit circle (the extremal-phase
    factor), times (1 + z)^n."""
    ys = np.roots([math.comb(n - 1 + k, k) for k in range(n)][::-1]) if n > 1 else []
    zs = []
    for y in ys:
        pair = np.roots([1.0, -(2.0 - 4.0 * y), 1.0])
        zs.append(pair[np.argmin(np.abs(pair))])
    h = np.real(np.convolve(np.poly(zs) if zs else [1.0], [math.comb(n, k) for k in range(n + 1)]))
    return list(h * math.sqrt(2.0) / h.sum())


def _analysis_1d(x, weight):
    """One level along the last axis with zero extension, as a strided
    convolution: c = (n + k - 1)//2 coefficients, out[o] = sum_j f[j]
    x[2o + 1 - j] for f = dec_lo and dec_hi (``weight`` holds them reversed,
    (2, 1, k))."""
    k, n = weight.shape[-1], x.shape[-1]
    c = (n + k - 1) // 2
    lead = x.shape[:-1]
    out = F.conv1d(F.pad(x.reshape(-1, 1, n), (k - 2, 2 * c - n)), weight, stride=2).reshape(*lead, 2, c)
    return out[..., 0, :], out[..., 1, :]


def _analysis_2d(img, weight):
    """(LL, LH, HL, HH) of one level: along the last axis, then the other."""
    a, d = _analysis_1d(img, weight)
    aa, ad = _analysis_1d(a.transpose(-1, -2), weight)
    da, dd = _analysis_1d(d.transpose(-1, -2), weight)
    return aa.transpose(-1, -2), ad.transpose(-1, -2), da.transpose(-1, -2), dd.transpose(-1, -2)


class Dictionary:
    """The SARA analysis operator Psi^T over a cube (nband, nx, ny): for each
    basis, the image itself ("self") or its ``nlevel``-level Daubechies
    decomposition (every detail band of every level and the last level's
    approximation) as a list of coefficient cubes. Synthesis is the exact
    adjoint, taken by automatic differentiation of the analysis."""

    def __init__(self, bases, nlevel: int, dtype, device):
        self.bases, self.nlevel = tuple(bases), nlevel
        self.filters = {}
        for b in self.bases:
            if b == "self":
                continue
            rec_lo = daubechies(int(b[2:]))
            dec_lo = rec_lo[::-1]
            dec_hi = [(-1.0) ** (len(rec_lo) - 1 - j) * rec_lo[j] for j in range(len(rec_lo))]
            self.filters[b] = torch.tensor([dec_lo[::-1], dec_hi[::-1]], dtype=dtype, device=device)[:, None, :]
        self.nu = len(self.bases)

    def dot(self, x) -> list:
        out = []
        for b in self.bases:
            if b == "self":
                out.append(x)
                continue
            approx = x
            for lev in range(self.nlevel):
                ll, lh, hl, hh = _analysis_2d(approx, self.filters[b])
                out += [lh, hl, hh]
                approx = ll
            out.append(approx)
        return out

    def hdot(self, coeffs: list, like):
        x = torch.zeros_like(like, requires_grad=True)
        with torch.enable_grad():
            outs = self.dot(x)
            (g,) = torch.autograd.grad(outs, x, grad_outputs=coeffs)
        return g


def dual_update(vp: list, a: list, lam: float, sigma: float) -> list:
    """v = vt min(1, lam / |sum_b vt|), vt = vp + sigma a: the dual step of
    lam ||sum_b (Psi^T x)_b||_1 (unit weights)."""
    out = []
    for v0, ai in zip(vp, a):
        vt = v0 + sigma * ai
        s = vt.sum(0).abs()
        scale = torch.where(s > lam, lam / torch.where(s > 0, s, torch.ones_like(s)), torch.ones_like(s))
        out.append(vt * scale[None])
    return out


def primal_dual(hess, psi: Dictionary, xtilde, lam: float, hess_norm: float, gamma: float, tol: float,
                maxit: int, minit: int = 1):
    """PDHG from x = 0 and a zero dual on
    min_x (x - xtilde)^T H (x - xtilde) / (2 gamma) + lam sum |sum_b Psi^T x| subject to x >= 0,
    sigma = hess_norm / (2 gamma) / nu, tau = 0.98 / (hess_norm / (2 gamma) + sigma nu^2);
    stops when ||x_k - x_{k-1}|| / ||x_k|| < tol or after ``maxit``.
    Returns (x, iterations)."""
    nu = psi.nu
    sigma = hess_norm / (2.0 * gamma) / nu
    tau = 0.98 / (hess_norm / (2.0 * gamma) + sigma * nu**2)
    x = torch.zeros_like(xtilde)
    v = [torch.zeros_like(c) for c in psi.dot(x)]
    k, eps = 0, 1.0
    while (eps > tol or k < minit) and k < maxit:
        vn = dual_update(v, psi.dot(x), lam, sigma)
        grad = -hess(xtilde - x) / gamma
        xn = (x - tau * (psi.hdot([2.0 * a - b for a, b in zip(vn, v)], x) + grad)).clamp(min=0.0)
        d = xn - x
        nn = _band_dot(xn, xn)
        eps = float(torch.sqrt(_band_dot(d, d) / nn.clamp(min=1e-12))) if bool(nn > 0) else 1.0
        x, v, k = xn, vn, k + 1
    return x, k
