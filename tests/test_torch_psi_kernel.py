"""Psi's CUDA kernels P1 ``psi_analysis`` and P2 ``psi_synthesis``
(csrc/psi_wavelets.cu, through ``Psi.dot`` / ``Psi.hdot`` on CUDA tensors),
on a CUDA card only (``gpu``; each test skips without one: the kernels have
no CPU mode, and ``tests/test_torch_ops.py`` checks their tables on the CPU).

Against the plain path (``Psi.dot_plain`` / ``hdot_plain``, the conv chain
CPU tensors take) run in f64 on the same card from the same f32 input, at
odd and non-square shapes, 1-4 levels, with and without "self", db1-db8 and
db12 (the kernels' loop for filters past 16 taps), nband 1 and 4 and a basis
order other than the default. Tolerance 2e-6 relative L-inf: the kernels
round the taps to f32 (~6e-8 relative each) and sum at most 2 k <= 32
products a pass in f32, two passes a level, ~1e-7 relative each, which
grows with the levels; the f64 plain path's own rounding is ~1e-15. The
adjoint identity and the frame identity hdot(dot(x)) = nbasis x in f32
(sums in f64) to 1e-5; the cube's cells that no slot covers exactly 0 from
an allocation left full of NaN; two calls the same bits; nlevel launches a
call (the recorder's ``launch.psi_analysis`` / ``launch.psi_synthesis``);
f64 and non-contiguous input refused.

The two-cube P2 (``Psi.hdot_extrapolated(vn, v)``, PD's ``hdot(2 vn - v)``)
at every case above and at the sara cells' shapes (4 x 2048^2 and 16 x
1024^2, nine bases): within 2e-6 of the f64 plain path on ``2 vn - v``, the
same bits as the one-cube P2 on torch's ``2.0 * vn - v`` and from call to
call, its output and scratch from allocations left full of NaN,
nlevel launches a call of ``psi_synthesis_ext`` (none of the one-cube
``psi_synthesis``); and five PD iterations at the 2k cell's shape the same bits
with and without it.

This file imports no JAX, so it runs where only PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_psi_kernel.py``.
"""

import numpy as np
import pytest
import torch
from torch_recorder import launches, recording

from pfb_imaging_tpu_torch.ops import psi as P

torch.set_num_threads(1)
SARA = ("self",) + tuple(f"db{p}" for p in range(1, 9))
# (bases, nlevel, (nx, ny), nband)
CASES = {
    "sara_odd_nonsquare": (SARA, 2, (131, 97), 4),
    "order_one_level": (("db8", "self", "db3"), 1, (64, 80), 1),
    "db1_four_levels": (("db1",), 4, (128, 120), 1),
    "no_self_three_levels": (("db2", "db6", "db4"), 3, (150, 94), 4),
    "db12_loop": (("db12", "self", "db5"), 2, (210, 203), 1),
    "sara_default_order_square": (SARA, 2, (256, 256), 4),
}
REL = 2e-6
# the sara cells' shapes
EXT_CASES = {**CASES, "sara_2k_cell": (SARA, 2, (2048, 2048), 4), "sara_1k16_cell": (SARA, 2, (1024, 1024), 16)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _setup(case, dev):
    bases, nlevel, shape, nband = EXT_CASES[case]
    psi = P.Psi(nband, *shape, bases=bases, nlevel=nlevel, device=dev)
    rng = np.random.default_rng(len(case))
    x = torch.as_tensor(rng.standard_normal((nband,) + shape), dtype=torch.float32, device=dev)
    alpha = torch.as_tensor(rng.standard_normal((nband, psi.nbasis, psi.nymax, psi.nxmax)), dtype=torch.float32,
                            device=dev)
    return psi, x, alpha


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_f64(case):
    dev = _cuda()
    psi, x, alpha = _setup(case, dev)
    a, h = psi.dot(x), psi.hdot(alpha)
    torch.cuda.synchronize()
    assert _rel(a, psi.dot_plain(x.double())) < REL
    assert _rel(h, psi.hdot_plain(alpha.double())) < REL


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_adjoint_frame_margins_bits_launches(case):
    dev = _cuda()
    psi, x, alpha = _setup(case, dev)
    nlevel = psi.nlevel if any(b != "self" for b in psi.bases) else 1
    # leave the allocator's next block of the cube's size full of NaN
    junk = torch.full((x.shape[0], psi.nbasis, psi.nymax, psi.nxmax), float("nan"), device=dev)
    del junk
    with recording() as got:
        a1 = psi.dot(x)
    assert launches(got["counters"]) == {"psi_analysis": nlevel}
    with recording() as got:
        h1 = psi.hdot(alpha)
    assert launches(got["counters"]) == {"psi_synthesis": nlevel}
    a2, h2 = psi.dot(x), psi.hdot(alpha)
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(h1, h2)
    assert not a1.isnan().any() and not h1.isnan().any()
    # cells no slot covers: exactly 0 (the plain path's zeros)
    structural = psi.dot_plain(torch.ones_like(x.double()) + x.double().abs()) == 0
    assert structural.any()
    assert (a1[structural] == 0).all()
    # <Psi x, alpha> = <x, Psi^H alpha>, and hdot(dot(x)) = nbasis x
    lhs = float((a1.double() * alpha.double()).sum())
    rhs = float((x.double() * h1.double()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-5
    assert _rel(psi.hdot(a1), psi.nbasis * x) < 1e-5


@pytest.mark.gpu
def test_kernels_refuse_f64_and_non_contiguous():
    dev = _cuda()
    psi, x, alpha = _setup("order_one_level", dev)
    with pytest.raises(TypeError, match="float32"):
        psi.dot(x.double())
    with pytest.raises(TypeError, match="float32"):
        psi.hdot(alpha.double())
    with pytest.raises(ValueError, match="contiguous"):
        psi.dot(x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        psi.hdot(alpha[..., :].transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="shape"):
        psi.dot(x[:, :-1].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EXT_CASES))
def test_extrapolated_synthesis(case):
    dev = _cuda()
    psi, _, vn = _setup(case, dev)
    g = torch.Generator(device=dev).manual_seed(len(case) + 1)
    v = torch.randn(vn.shape, generator=g, device=dev)
    nband = vn.shape[0]
    nlevel = psi.nlevel if any(b != "self" for b in psi.bases) else 1
    # leave the allocator's next blocks of the output's and the scratch's sizes full of NaN
    junk = [torch.full((nband, psi.nx, psi.ny), float("nan"), device=dev)]
    junk += [torch.full_like(t, float("nan")) for t in psi._scratch(nband, dev)]
    del junk
    with recording() as got:
        h1 = psi.hdot_extrapolated(vn, v)
    assert got["counters"]["launch.psi_synthesis_ext"] == nlevel
    assert got["counters"].get("launch.psi_synthesis", 0) == 0
    h2 = psi.hdot_extrapolated(vn, v)
    h_one = psi.hdot(2.0 * vn - v)
    torch.cuda.synchronize()
    assert not h1.isnan().any()
    assert torch.equal(h1, h2) and torch.equal(h1, h_one)
    assert _rel(h1, psi.hdot_plain(2.0 * vn.double() - v.double())) < REL


@pytest.mark.gpu
def test_pd_iterations_same_bits_with_and_without_the_fused_synthesis():
    from pfb_imaging_tpu_torch.opt.primal_dual import primal_dual_loop
    from pfb_imaging_tpu_torch.prox.positivity import positivity
    from pfb_imaging_tpu_torch.prox.prox_21m import dual_update

    dev = _cuda()
    psi, x, _ = _setup("sara_2k_cell", dev)
    b = x.abs()
    l1w = torch.ones((psi.nbasis, psi.nymax, psi.nxmax), device=dev)
    v0 = torch.zeros((x.shape[0], psi.nbasis, psi.nymax, psi.nxmax), device=dev)
    with recording() as got:
        runs = [primal_dual_loop(torch.zeros_like(b), v0, 1e-3, l1w, 0.1, 0.5, lambda z: z - b, psi_dot=psi.dot,
                                 psi_hdot=psi.hdot, primal_prox=positivity, dual_update=dual_update, tol=0.0,
                                 maxit=5, psi_hdot_ext=ext)
                for ext in (None, psi.hdot_extrapolated)]
    torch.cuda.synchronize()
    assert got["counters"]["launch.psi_synthesis_ext"] == 5 * psi.nlevel
    (xa, va, ka, _), (xb, vb, kb, _) = runs
    assert ka == kb == 5
    assert torch.equal(xa, xb) and torch.equal(va, vb)
    assert bool((xa != 0).any())
