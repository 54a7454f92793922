"""PD's dual update for SARA's signed-sum l2,1 prior
(``prox/prox_21m.dual_update``): the kernel of ``csrc/prox_21m.cu`` on the
card, under a band split given the gathered band sum; the composition
``dual_update_plain`` on the CPU.

On the CPU: a CPU cube takes the composition, the same bits, no
``launch.dual_update_21m``, ``band.sum`` nband; the dispatch (a stand-in for
the kernel's wrapper, on ``meta`` tensors, which are neither CPU nor card):
the wrapper on this rank's whole band set, and under a band-split mesh stub
the wrapper given the band sum of the gathered bands; the composition with
its gather on a CPU band split; the wrapper on CPU memory through a stand-in
for the library that does the kernel's arithmetic in numpy float32, one
rounding an operation in the kernel's order: the composition's bits at
nband 1, 3, 4, 16 and 17 and on a rank's bands of a split (the sum given),
one launch counted a call and ``band.sum`` nband where the wrapper sums.

On the card (``gpu``; each test skips without one: the kernel has no CPU
mode): the kernel bit for bit the composition at nband 1, 3, 4, 16 and 17
(past the 16 held in registers), odd and even planes, the sara cells'
(4, 9, 2077, 2077) and (16, 9, 1053, 1053) among them, with and without a
weight; its output from an allocation left full of NaN; one launch a call;
two calls the same bits; a rank's bands of a split (a mesh stub) bit for bit
that rank's slice of the unsplit composition, one launch; float64 and
non-contiguous cubes refused; five PD iterations at both cells' shapes the
same ``x`` and ``v`` bits with the kernel and with ``dual_update_plain``
passed in as ``dual_update``.

This file imports no JAX, so it runs where only PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_dual_update.py``.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_recorder import launches, recording

from pfb_imaging_tpu_torch.kernels import build
from pfb_imaging_tpu_torch.parallel.mesh import band_sum
from pfb_imaging_tpu_torch.prox import prox_21m as P

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(nband, tail, seed, device="cpu"):
    """vp, v and weight (float32 on ``device``), sigma, and a lam at the
    median |band sum|, so both branches of the scale are taken; weights in
    [0.25, 1.75], and 0 at every 7th position whose |band sum| passes twice
    the median (scale 0); one position with every band 0 (band sum 0)."""
    g = torch.Generator(device=device).manual_seed(seed)
    vp = torch.randn((nband,) + tail, generator=g, device=device)
    v = torch.randn((nband,) + tail, generator=g, device=device)
    vp.view(nband, -1)[:, 0] = 0.0
    v.view(nband, -1)[:, 0] = 0.0
    sigma = 0.7
    s = (vp.double() + sigma * v.double()).sum(0).abs()
    w = torch.rand(tail, generator=g, device=device) * 1.5 + 0.25
    med = s.median()
    w.view(-1)[torch.nonzero(s.flatten() > 2 * med).flatten()[::7]] = 0.0
    return vp, v, w, sigma, float(med)


# ── the CPU ──


@pytest.mark.parametrize("nband", [1, 3, 4, 16])
def test_cpu_cube_takes_the_composition(nband):
    vp, v, w, sigma, lam = _inputs(nband, (3, 13, 11), nband)
    with recording() as got:
        out = P.dual_update(vp, v, lam, sigma, w)
    assert torch.equal(out, P.dual_update_plain(vp, v, lam, sigma, w))
    assert launches(got["counters"]) == {}
    assert got["counters"]["band.sum"] == nband


class _BandSplit:
    """A band-split mesh stub: this rank's bands come back from the gather
    between ``before`` and ``after``, the other ranks' bands."""

    def __init__(self, before, after, band_size=2):
        self.before, self.after, self.band_size, self.gathers = before, after, band_size, 0

    def band_all_gather(self, t):
        self.gathers += 1
        return torch.cat([self.before, t, self.after])


def _split(vp, v, sigma, lo, hi, band_size):
    """Bands lo:hi of (vp, v) and the stub that gathers the rest's vtilde."""
    vt = vp + sigma * v
    return vp[lo:hi], v[lo:hi], _BandSplit(vt[:lo], vt[hi:], band_size)


def test_dispatch_by_device_and_band_split(monkeypatch):
    calls = []

    def wrapper(vp, v, lam, sigma, weight, vsum=None):
        calls.append((vp.shape, lam, sigma, weight is None, None if vsum is None else vsum.shape))
        return torch.empty_like(vp)

    monkeypatch.setattr(P, "_dual_update_cuda", wrapper)
    vp, v = torch.empty((4, 9, 31, 31), device="meta"), torch.empty((4, 9, 31, 31), device="meta")
    # the whole band set on this rank: the kernel's wrapper, summing itself
    P.dual_update(vp, v, 0.5, 0.3)
    P.dual_update(vp, v, 0.5, 0.3, torch.empty((9, 31, 31), device="meta"), mesh=SimpleNamespace(band_size=1))
    assert calls == [((4, 9, 31, 31), 0.5, 0.3, True, None), ((4, 9, 31, 31), 0.5, 0.3, False, None)]
    # a band split: the kernel's wrapper, given the sum of the gathered bands
    mesh = _BandSplit(torch.empty((0, 9, 31, 31), device="meta"), torch.empty((4, 9, 31, 31), device="meta"))
    with recording() as got:
        out = P.dual_update(vp, v, 0.5, 0.3, mesh=mesh)
    assert calls[2:] == [((4, 9, 31, 31), 0.5, 0.3, True, (9, 31, 31))]
    assert mesh.gathers == 1 and out.shape == vp.shape
    assert got["counters"]["band.sum"] == 8
    # the CPU: the composition
    cpu = _inputs(3, (2, 5, 7), 1)
    P.dual_update(*cpu[:2], cpu[4], cpu[3], cpu[2])
    assert len(calls) == 3


def test_band_split_composition_sums_the_gathered_bands():
    vp, v, w, sigma, lam = _inputs(6, (3, 9, 7), 2)
    mvp, mv, mesh = _split(vp, v, sigma, 0, 3, 2)
    with recording() as got:
        mine = P.dual_update(mvp, mv, lam, sigma, w, mesh=mesh)
    assert mesh.gathers == 1 and launches(got["counters"]) == {} and got["counters"]["band.sum"] == 6
    assert torch.equal(mine, P.dual_update_plain(vp, v, lam, sigma, w)[:3])


class _Arithmetic:
    """A stand-in for the kernel library on CPU memory: the kernel's
    arithmetic in numpy float32, each operation rounded once, in its order
    (csrc/prox_21m.cu's header), through the pointers the wrapper passes."""

    def __init__(self):
        self.calls = []

    def pfb_dual_update_21m(self, vp, v, w, vsum, out, nband, plane, sigma, lam, stream):
        self.calls.append(dict(nband=nband, plane=plane, sigma=sigma, lam=lam, weight=w is not None,
                               vsum=vsum is not None, stream=stream))

        def view(ptr, n):
            return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))

        n = nband * plane
        a, c, o = (view(p, n).reshape(nband, plane) for p in (vp, v, out))
        sigma32, lam32 = np.float32(sigma), np.float32(lam)
        vt = a + sigma32 * c
        if vsum is not None:
            s = view(vsum, plane)
        else:
            s = vt[0].copy()
            for b in range(1, nband):
                s = s + vt[b]
        thr = lam32 * view(w, plane) if w is not None else np.full(plane, lam32)
        mag = np.abs(s)
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.where(mag > thr, thr / np.where(mag > 0, mag, np.float32(1)), np.float32(1))
        o[:] = vt * k.astype(np.float32)
        return 0


@pytest.mark.parametrize("weighted", [True, False], ids=["weight", "ones"])
@pytest.mark.parametrize("nband", [1, 3, 4, 16, 17])
def test_wrapper_marshals_the_kernels_arithmetic(monkeypatch, nband, weighted):
    lib = _Arithmetic()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "stream", lambda dev: 12345)
    vp, v, w, sigma, lam = _inputs(nband, (3, 17, 15), 10 + nband)
    w = w if weighted else None
    with recording() as got:
        out = P._dual_update_cuda(vp, v, lam, sigma, w)
    assert lib.calls == [dict(nband=nband, plane=3 * 17 * 15, sigma=sigma, lam=lam, weight=weighted, vsum=False,
                              stream=12345)]
    assert launches(got["counters"]) == {"dual_update_21m": 1}
    assert got["counters"]["band.sum"] == nband
    assert torch.equal(out, P.dual_update_plain(vp, v, lam, sigma, w))


@pytest.mark.parametrize("nband,lo,hi,band_size", [(4, 2, 4, 2), (16, 4, 8, 4), (34, 0, 17, 2)],
                         ids=["4_rank1of2", "16_rank1of4", "34_rank0of2_two_pass"])
def test_wrapper_marshals_a_band_splits_sum(monkeypatch, nband, lo, hi, band_size):
    lib = _Arithmetic()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "stream", lambda dev: 12345)
    vp, v, w, sigma, lam = _inputs(nband, (3, 17, 15), 30 + nband)
    mvp, mv, mesh = _split(vp, v, sigma, lo, hi, band_size)
    with recording() as got:
        out = P._dual_update_cuda(mvp, mv, lam, sigma, w, band_sum(mvp + sigma * mv, mesh))
    assert lib.calls == [dict(nband=hi - lo, plane=3 * 17 * 15, sigma=sigma, lam=lam, weight=True, vsum=True,
                              stream=12345)]
    assert launches(got["counters"]) == {"dual_update_21m": 1}
    assert got["counters"]["band.sum"] == nband  # band_sum's, the wrapper's none
    assert torch.equal(out, P.dual_update_plain(vp, v, lam, sigma, w)[lo:hi])


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(build, "load", lambda: pytest.fail("the library was reached"))
    vp, v, w, sigma, lam = _inputs(2, (2, 5, 7), 3)
    with pytest.raises(TypeError, match="float32"):
        P._dual_update_cuda(vp.double(), v.double(), lam, sigma, w)
    with pytest.raises(TypeError, match="float32"):
        P._dual_update_cuda(vp, v, lam, sigma, w.double())
    with pytest.raises(ValueError, match="contiguous"):
        P._dual_update_cuda(vp.transpose(2, 3), v.transpose(2, 3), lam, sigma, None)
    with pytest.raises(ValueError, match="not vp's"):
        P._dual_update_cuda(vp, v[:1], lam, sigma, w)
    with pytest.raises(ValueError, match="a band's"):
        P._dual_update_cuda(vp, v, lam, sigma, w[:1])
    with pytest.raises(ValueError, match="vsum"):
        P._dual_update_cuda(vp, v, lam, sigma, w, w[:1])
    with pytest.raises(TypeError, match="float32"):
        P._dual_update_cuda(vp, v, lam, sigma, w, w.double())


# ── the card ──

CARD_CASES = {
    "nb1_odd": (1, (3, 37, 41)),
    "nb3_odd": (3, (9, 65, 67)),
    "nb4_even": (4, (9, 64, 64)),
    "nb16_even": (16, (9, 32, 48)),
    "nb17_two_pass": (17, (2, 31, 33)),
    "sara_2k_cell": (4, (9, 2077, 2077)),
    "sara_1k16_cell": (16, (9, 1053, 1053)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False], ids=["weight", "ones"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_same_bits_as_the_composition(case, weighted):
    dev = _cuda()
    nband, tail = CARD_CASES[case]
    vp, v, w, sigma, lam = _inputs(nband, tail, len(case), device=dev)
    w = w if weighted else None
    # leave the allocator's next block of the cube's size full of NaN
    junk = torch.full_like(vp, float("nan"))
    del junk
    with recording() as got:
        k1 = P.dual_update(vp, v, lam, sigma, w)
    assert launches(got["counters"]) == {"dual_update_21m": 1}
    assert got["counters"]["band.sum"] == nband
    k2 = P.dual_update(vp, v, lam, sigma, w)
    plain = P.dual_update_plain(vp, v, lam, sigma, w)
    torch.cuda.synchronize()
    assert not k1.isnan().any()
    assert torch.equal(k1, k2)
    assert torch.equal(k1, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("nband,tail,lo,hi,band_size", [(4, (9, 2077, 2077), 2, 4, 2), (16, (9, 1053, 1053), 8, 12, 4),
                                                         (34, (2, 31, 33), 17, 34, 2)],
                         ids=["sara_2k_cell_rank1of2", "sara_1k16_cell_rank2of4", "34_rank1of2_two_pass"])
def test_kernel_under_a_band_split_same_bits_as_the_composition(nband, tail, lo, hi, band_size):
    dev = _cuda()
    vp, v, w, sigma, lam = _inputs(nband, tail, nband + lo, device=dev)
    mvp, mv, mesh = _split(vp, v, sigma, lo, hi, band_size)
    with recording() as got:
        mine = P.dual_update(mvp, mv, lam, sigma, w, mesh=mesh)
    assert mesh.gathers == 1 and launches(got["counters"]) == {"dual_update_21m": 1}
    assert got["counters"]["band.sum"] == nband
    plain = P.dual_update_plain(vp, v, lam, sigma, w)
    torch.cuda.synchronize()
    assert torch.equal(mine, plain[lo:hi])


@pytest.mark.gpu
def test_kernel_refuses_f64_and_non_contiguous():
    dev = _cuda()
    vp, v, w, sigma, lam = _inputs(4, (9, 33, 35), 5, device=dev)
    with pytest.raises(TypeError, match="float32"):
        P.dual_update(vp.double(), v.double(), lam, sigma, w)
    with pytest.raises(ValueError, match="contiguous"):
        P.dual_update(vp.transpose(2, 3), v.transpose(2, 3), lam, sigma)


@pytest.mark.gpu
@pytest.mark.parametrize("nband,nx", [(4, 2048), (16, 1024)], ids=["sara_2k_cell", "sara_1k16_cell"])
def test_pd_iterations_same_bits_with_the_kernel_and_the_composition(nband, nx):
    from pfb_imaging_tpu_torch.ops.psi import Psi
    from pfb_imaging_tpu_torch.opt.primal_dual import primal_dual_loop
    from pfb_imaging_tpu_torch.prox.positivity import positivity

    dev = _cuda()
    psi = Psi(nband, nx, nx, bases=("self",) + tuple(f"db{p}" for p in range(1, 9)), nlevel=2, device=dev)
    g = torch.Generator(device=dev).manual_seed(nband)
    b = torch.randn((nband, nx, nx), generator=g, device=dev).abs()
    l1w = torch.rand((psi.nbasis, psi.nymax, psi.nxmax), generator=g, device=dev) + 0.5
    v0 = torch.zeros((nband, psi.nbasis, psi.nymax, psi.nxmax), device=dev)
    with recording() as got:
        runs = [primal_dual_loop(torch.zeros_like(b), v0, 1e-3, l1w, 0.1, 0.5, lambda z: z - b, psi_dot=psi.dot,
                                 psi_hdot=psi.hdot, primal_prox=positivity, dual_update=fn, tol=0.0, maxit=5,
                                 psi_hdot_ext=psi.hdot_extrapolated)
                for fn in (P.dual_update, P.dual_update_plain)]
    torch.cuda.synchronize()
    assert got["counters"]["launch.dual_update_21m"] == 5
    assert got["counters"]["band.sum"] == 2 * 2 * 5 * nband  # the dual update's and the stop test's, both runs
    (xa, va, ka, _), (xb, vb, kb, _) = runs
    assert ka == kb == 5
    assert torch.equal(xa, xb) and torch.equal(va, vb)
    assert bool((xa != 0).any())
    # both branches of the scale taken in the last iteration: |sum_b vn| is
    # lam w where the scale was applied, below it where it was not
    mag, thr = va.double().sum(0).abs(), 1e-3 * l1w.double()
    assert bool(((mag - thr).abs() <= 1e-5 * thr).any()) and bool((mag < 0.99 * thr).any())
