"""Port parity: PSF, Hessian, wavelets, Psi and the proxes of
pfb_imaging_tpu_torch against the JAX package, in f64 on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The FFT,
conv and reduction orders differ between XLA and PyTorch, so f64 results
agree to rounding (tolerances 1e-10 for transforms, 1e-12 for the
elementwise proxes)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_recorder import launches, recording

from pfb_imaging_tpu.ops import hessian as jhess
from pfb_imaging_tpu.ops import psf as jpsf
from pfb_imaging_tpu.ops import wavelets as jwav
from pfb_imaging_tpu.ops.psi import Psi as JPsi
from pfb_imaging_tpu.prox import positivity as j_pos
from pfb_imaging_tpu.prox import positivity_band as j_pos_band
from pfb_imaging_tpu.prox.prox_21m import dual_update as j_dual_update
from pfb_imaging_tpu.prox.prox_21m import prox_21m as j_prox_21m
from pfb_imaging_tpu.prox.l21 import l1reweight_func as j_l1rw
from pfb_imaging_tpu_torch.ops import hessian as thess
from pfb_imaging_tpu_torch.ops import psf as tpsf
from pfb_imaging_tpu_torch.ops import wavelets as twav
from pfb_imaging_tpu_torch.ops import psi as tpsi
from pfb_imaging_tpu_torch.ops.psi import Psi as TPsi
from pfb_imaging_tpu_torch.prox import positivity as tpos
from pfb_imaging_tpu_torch.prox import prox_21m as tp21
from pfb_imaging_tpu_torch.prox.l21 import l1reweight_func as t_l1rw

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_port_runtime_imports_no_jax():
    code = "import pfb_imaging_tpu_torch.core.deconv, sys; assert 'jax' not in sys.modules, 'jax imported'"
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("shape,psf_shape", [((24, 24), (48, 48)), ((20, 28), (40, 56))])
def test_psf_convolve_matches_jax(shape, psf_shape):
    rng = np.random.default_rng(1)
    psf = rng.standard_normal((2,) + psf_shape)
    x = rng.standard_normal((2,) + shape)
    ph_j = np.asarray(jpsf.psf_to_psfhat(jnp.asarray(psf)))
    ph_t = tpsf.psf_to_psfhat(_t(psf)).numpy()
    assert _rel(ph_t, ph_j) < 1e-10
    out_j = jpsf.psf_convolve(jnp.asarray(x), jnp.asarray(ph_j), *psf_shape)
    out_t = tpsf.psf_convolve(_t(x), _t(ph_j), *psf_shape)
    assert _rel(out_t, out_j) < 1e-10


@pytest.mark.parametrize("with_beam", [False, True])
def test_hessian_cube_matches_jax(with_beam):
    rng = np.random.default_rng(2)
    nband, npart, nx, nxp = 2, 2, 24, 48
    abspsfhat = np.abs(rng.standard_normal((nband, npart, nxp, nxp // 2 + 1)))
    wsums = rng.uniform(1.0, 3.0, nband)
    beam = rng.uniform(0.5, 1.0, (nband, npart, nx, nx)) if with_beam else None
    x = rng.standard_normal((nband, nx, nx))
    hj = jhess.HessianCube.build(abspsfhat, wsums, 1e-3, nxp, nxp, beam=beam)
    ht = thess.HessianCube.build(abspsfhat, wsums, 1e-3, nxp, nxp, beam=beam, device=CPU)
    np.testing.assert_allclose(ht.eta_b.numpy(), np.asarray(hj.eta_b), rtol=1e-14)
    assert _rel(ht.dot(_t(x)), jhess.hess_cube_dot(hj, jnp.asarray(x))) < 1e-10


@pytest.mark.parametrize("with_beam", [False, True])
def test_hessian_cube_batched_matches_the_band_loop(with_beam):
    """The card's path, every band's FFT pair in one batched call, against
    the CPU's band loop."""
    rng = np.random.default_rng(3)
    nband, npart, nx, nxp = 5, 2, 24, 48
    abspsfhat = np.abs(rng.standard_normal((nband, npart, nxp, nxp // 2 + 1)))
    beam = rng.uniform(0.5, 1.0, (nband, npart, nx, nx)) if with_beam else None
    ht = thess.HessianCube.build(abspsfhat, rng.uniform(1.0, 3.0, nband), 1e-3, nxp, nxp, beam=beam, device=CPU)
    x = _t(rng.standard_normal((nband, nx, nx)))
    assert _rel(thess._hess_cube_batched(ht, x), ht.dot(x)) < 1e-14


def test_hessian_tree_dot_matches_jax():
    rng = np.random.default_rng(3)
    ph = np.abs(rng.standard_normal((3, 32, 17)))
    x = rng.standard_normal((16, 16))
    out_j = jhess.hessian_tree_dot(jnp.asarray(x), jnp.asarray(ph), None, 2.5, 32, 32, eta=0.1)
    out_t = thess.hessian_tree_dot(_t(x), _t(ph), None, 2.5, 32, 32, eta=0.1)
    assert _rel(out_t, out_j) < 1e-10


@pytest.mark.parametrize("base", ["db1", "db2", "db3", "db4"])
@pytest.mark.parametrize("n", [37, 64])
def test_dwt1d_idwt1d_match_jax(base, n):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, n))
    dl, dh, rl, rh = twav.filter_bank(base)
    dec, rec = twav.conv_weights(base, CPU, torch.float64)
    ca_j, cd_j = jwav.dwt1d(jnp.asarray(x), jnp.asarray(dl), jnp.asarray(dh))
    ca_t, cd_t = twav.dwt1d(_t(x), dec)
    assert _rel(ca_t, ca_j) < 1e-10 and _rel(cd_t, cd_j) < 1e-10
    c = rng.standard_normal((2, 3, ca_t.shape[-1]))
    y_j = jwav.idwt1d(jnp.asarray(c[0]), jnp.asarray(c[1]), jnp.asarray(rl), jnp.asarray(rh))
    y_t = twav.idwt1d(_t(c[0]), _t(c[1]), rec)
    assert _rel(y_t, y_j) < 1e-10
    # perfect reconstruction
    assert _rel(twav.idwt1d(ca_t, cd_t, rec)[..., :n], x) < 1e-10


PSI_CASES = [
    (("self", "db1", "db2"), 2, (32, 32)),
    (("self", "db1", "db2", "db3"), 2, (30, 36)),
    (("db4",), 2, (64, 48)),
    (("db1",), 4, (64, 64)),
]
SARA_BASES = ("self",) + tuple(f"db{p}" for p in range(1, 9))


@pytest.mark.parametrize("bases,nlevel,shape", PSI_CASES)
def test_psi_dot_hdot_match_jax(bases, nlevel, shape):
    rng = np.random.default_rng(5)
    nband = 2
    pj = JPsi(nband, *shape, bases=bases, nlevel=nlevel)
    pt = TPsi(nband, *shape, bases=bases, nlevel=nlevel, device=CPU)
    assert (pt.nymax, pt.nxmax) == (pj.nymax, pj.nxmax)
    x = rng.standard_normal((nband,) + shape)
    a_t = pt.dot(_t(x))
    assert _rel(a_t, pj.dot(jnp.asarray(x))) < 1e-10
    alpha = rng.standard_normal(tuple(a_t.shape))
    h_t = pt.hdot(_t(alpha))
    assert _rel(h_t, pj.hdot(jnp.asarray(alpha))) < 1e-10
    # exact adjoint: <Psi x, alpha> == <x, Psi^H alpha>
    lhs = float((a_t * _t(alpha)).sum())
    rhs = float((_t(x) * h_t).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-10


def _quadrants(lv, m):
    """The packed cells (rows, columns) that level ``lv``'s member ``m``
    writes as coefficients: its LL only at the deepest level."""
    e = lv.m[m]
    if e.k == 0:
        return [(slice(0, lv.nx), slice(0, lv.ny))]
    rows = (slice(e.s, e.s + e.cx), slice(e.s + e.cx, e.s + 2 * e.cx))
    cols = (slice(e.t, e.t + e.cy), slice(e.t + e.cy, e.t + 2 * e.cy))
    return [(rows[a], cols[b]) for a in (0, 1) for b in (0, 1) if a or b or lv.last]


def _zero_strips(lv, m):
    """The cells the kernels' zero blocks write for level ``lv``'s member
    ``m`` (csrc/psi_wavelets.cu, zero_margins)."""
    e = lv.m[m]
    if e.k == 0:
        return [(slice(lv.nx, lv.nymax), slice(0, lv.nxmax)), (slice(0, lv.nx), slice(lv.ny, lv.nxmax))]
    out = [(slice(0, e.s), slice(e.t + e.cy, e.t + 2 * e.cy)), (slice(e.s + e.cx, e.s + 2 * e.cx), slice(0, e.t))]
    if lv.first:
        out += [(slice(e.s + 2 * e.cx, lv.nymax), slice(0, lv.nxmax)),
                (slice(0, e.s + 2 * e.cx), slice(e.t + 2 * e.cy, lv.nxmax))]
    return out


@pytest.mark.parametrize("bases,nlevel,shape", PSI_CASES + [(SARA_BASES, 2, (2048, 2048))])
def test_psi_kernel_tables(bases, nlevel, shape):
    """The tables the card's kernels take by value (``kernel_levels``),
    against ``_WaveletBook``: each basis's taps (dec_hi the quadrature mirror
    of dec_lo, which the kernels rely on), level sizes and slot; the scratch
    sizes cover every basis; and over the levels every cell of each
    basis's plane is written once, as a coefficient of the plain path's
    layout or as a zero."""
    pt = TPsi(2, *shape, bases=bases, nlevel=nlevel, device=CPU)
    levels = tpsi.kernel_levels(pt)
    wav = [b for b in bases if b != "self"]
    assert len(levels) == nlevel
    planes = {bi: np.zeros((pt.nymax, pt.nxmax), np.int8) for bi in range(len(bases))}
    coeff = {bi: np.zeros((pt.nymax, pt.nxmax), bool) for bi in range(len(bases))}
    for i, lv in enumerate(levels):
        mem = [(bi, b) for bi, b in enumerate(bases) if i == 0 or b != "self"]
        assert (lv.nmem, lv.nbasis, lv.nx, lv.ny, lv.nymax, lv.nxmax, lv.first, lv.last) == (
            len(mem), len(bases), *shape, pt.nymax, pt.nxmax, i == 0, i == nlevel - 1)
        assert lv.kmax == max([2] + [pt._books[b].k for b in wav])
        for m, (bi, b) in enumerate(mem):
            e = lv.m[m]
            if b == "self":
                assert (e.k, e.plane, e.nin_x, e.nin_y) == (0, bi, *shape)
            else:
                bk = pt._books[b]
                sx, sy = bk.slot(i)
                assert (e.k, e.plane, e.scr) == (bk.k, bi, wav.index(b))
                assert (e.nin_x, e.nin_y, e.cx, e.cy) == (bk.insx[i], bk.insy[i], bk.cx[i], bk.cy[i])
                assert (e.s, e.s + 2 * e.cx, e.t, e.t + 2 * e.cy) == (sx.start, sx.stop, sy.start, sy.stop)
                dec_lo, dec_hi = twav.filter_bank(b)[:2]
                taps = np.array(e.lo[:], np.float32)
                assert np.array_equal(taps[: bk.k], dec_lo.astype(np.float32)) and not taps[bk.k :].any()
                assert np.array_equal((-1.0) ** (np.arange(bk.k) + 1) * dec_lo[::-1], dec_hi)
                if i < nlevel - 1:  # the LL goes to scratch, which the level below reads
                    assert e.cx <= lv.ll_x and e.cy <= lv.ll_y and lv.ll_y % 4 == 0
                    assert (levels[i + 1].img_x, levels[i + 1].img_y) == (lv.ll_x, lv.ll_y)
            for sl in _quadrants(lv, m):
                planes[bi][sl] += 1
                coeff[bi][sl] = True
            for sl in _zero_strips(lv, m):
                planes[bi][sl] += 1
    assert all((c == 1).all() for c in planes.values())
    if shape[0] <= 64:  # the coefficients are the plain path's nonzero cells
        a = pt.dot(_t(np.random.default_rng(8).standard_normal((2,) + shape))).numpy()
        for bi in planes:
            assert np.array_equal(a[0, bi] != 0, coeff[bi]) and np.array_equal(a[1, bi] != 0, coeff[bi])


@pytest.mark.parametrize("bases,nlevel,shape", PSI_CASES)
def test_psi_on_cpu_takes_the_plain_path(bases, nlevel, shape):
    """CPU tensors launch no kernel and give the bits of the plain level loop
    (dwt2d_level / idwt2d_level, each basis's slots written shallow first)."""
    rng = np.random.default_rng(9)
    pt = TPsi(2, *shape, bases=bases, nlevel=nlevel, device=CPU)
    x = _t(rng.standard_normal((2,) + shape))
    with recording() as got:
        a = pt.dot(x)
    alpha = _t(rng.standard_normal(tuple(a.shape)))
    with recording() as got_h:
        h = pt.hdot(alpha)
    assert launches(got["counters"]) == launches(got_h["counters"]) == {}
    ref_a = torch.zeros_like(a)
    ref_h = torch.zeros_like(x)
    for bi, b in enumerate(bases):
        if b == "self":
            ref_a[:, bi, : shape[0], : shape[1]] = x
            ref_h = ref_h + alpha[:, bi, : shape[0], : shape[1]]
            continue
        bk = pt._books[b]
        dec, rec = twav.conv_weights(b, CPU, torch.float64)
        approx, blocks = x, []
        for i in range(nlevel):
            blocks.append(twav.dwt2d_level(approx, dec))
            approx = blocks[-1][..., : bk.cx[i], : bk.cy[i]]
        for i in range(nlevel):
            ref_a[(slice(None), bi) + bk.slot(i)] = blocks[i]
        y = twav.idwt2d_level(alpha[(slice(None), bi) + bk.slot(nlevel - 1)], rec, bk.insx[-1], bk.insy[-1])
        for i in reversed(range(nlevel - 1)):
            blk = alpha[(slice(None), bi) + bk.slot(i)].clone()
            blk[..., : bk.cx[i], : bk.cy[i]] = y
            y = twav.idwt2d_level(blk, rec, bk.insx[i], bk.insy[i])
        ref_h = ref_h + y
    assert torch.equal(a, ref_a) and torch.equal(h, ref_h)


def test_psi_card_limits_raise_at_construction():
    """A Psi for the card takes filters of up to KMAX taps and up to MAXB
    bases, and says so when it is built (no card needed: only the tables are
    made); the CPU path has neither limit."""
    assert len(twav.filter_bank("db16")[0]) == tpsi.KMAX
    TPsi(1, 256, 256, bases=("self", "db16"), nlevel=1, device="cuda")
    with pytest.raises(ValueError, match="db17 has 34 taps"):
        TPsi(1, 256, 256, bases=("self", "db17"), nlevel=1, device="cuda")
    many = ("self",) + tuple(f"db{p}" for p in range(1, tpsi.MAXB + 1))
    with pytest.raises(ValueError, match=f"{tpsi.MAXB + 1} bases"):
        TPsi(1, 256, 256, bases=many, nlevel=1, device="cuda")
    pt = TPsi(1, 256, 256, bases=many[:2] + ("db17",), nlevel=1, device=CPU)
    assert pt.dot(torch.ones((1, 256, 256), dtype=torch.float64)).shape[1] == 3
    with pytest.raises(ValueError, match="built for cpu"):
        pt._dot_cuda(torch.ones((1, 256, 256)))


def test_psi_hdot_left_inverse():
    """hdot(dot(x)) = nbasis * x for the SARA concatenation (frame bound D3)."""
    rng = np.random.default_rng(6)
    pt = TPsi(1, 40, 40, bases=("self", "db1", "db2"), nlevel=2, device=CPU)
    x = _t(rng.standard_normal((1, 40, 40)))
    assert _rel(pt.hdot(pt.dot(x)), 3 * x) < 1e-10


# (sigma, cube shape, lam at the median |band sum| with some weights 0):
# the last four odd planes, both branches of the scale taken, scale 0 where
# a weight is 0
PROX_21M_CASES = [(1.0, (3, 2, 10, 12), False), (0.7, (3, 2, 10, 12), False), (0.7, (1, 3, 21, 19), True),
                  (0.7, (3, 9, 33, 35), True), (0.7, (4, 9, 41, 41), True), (0.7, (16, 9, 17, 23), True)]


@pytest.mark.parametrize("sigma,shape,median", PROX_21M_CASES,
                         ids=["1.0", "0.7"] + [f"0.7-odd{s[0]}x{s[2]}x{s[3]}" for _, s, _ in PROX_21M_CASES[2:]])
def test_prox_21m_and_dual_update_match_jax(sigma, shape, median):
    rng = np.random.default_rng(7)
    v = rng.standard_normal(shape)
    vp = rng.standard_normal(shape)
    w = rng.uniform(0.5, 2.0, shape[1:])
    v[:, 0, 0, 0] = 0.0  # exercise the zero-band-sum branch
    vp[:, 0, 0, 0] = 0.0
    lam = 0.8
    if median:
        mag = np.abs((vp + sigma * v).sum(0))
        lam = float(np.median(mag))
        w[(mag > 2 * lam) & (rng.uniform(size=mag.shape) < 0.2)] = 0.0
        over = mag > lam * w
        assert over.sum() > 20 and (~over).sum() > 20 and (over & (w == 0)).any()
    assert _rel(tp21.prox_21m(_t(v), lam, sigma, _t(w)), j_prox_21m(jnp.asarray(v), lam, sigma, jnp.asarray(w))) < 1e-12
    assert _rel(tp21.prox_21m(_t(v), lam, sigma), j_prox_21m(jnp.asarray(v), lam, sigma)) < 1e-12
    got = tp21.dual_update(_t(vp), _t(v), lam, sigma, _t(w))
    ref = j_dual_update(jnp.asarray(vp), jnp.asarray(v), lam, sigma, jnp.asarray(w))
    assert _rel(got, ref) < 1e-12


def test_positivity_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 9, 9))
    assert _rel(tpos.positivity(_t(x)), j_pos(jnp.asarray(x))) < 1e-12
    assert _rel(tpos.positivity_band(_t(x)), j_pos_band(jnp.asarray(x))) < 1e-12
    assert tpos.positivity_prox(0) is None
    with pytest.raises(ValueError):
        tpos.positivity_prox(3)


def test_l1reweight_matches_jax():
    rng = np.random.default_rng(9)
    m = rng.standard_normal((3, 8, 8))
    rms = rng.uniform(0.5, 1.5, 3)
    assert _rel(t_l1rw(_t(m), 1.0, rms, 2.0), j_l1rw(jnp.asarray(m), 1.0, rms, 2.0)) < 1e-12


def test_tf32_is_off():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
