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


@pytest.mark.parametrize("bases,nlevel,shape", [
    (("self", "db1", "db2"), 2, (32, 32)),
    (("self", "db1", "db2", "db3"), 2, (30, 36)),
    (("db4",), 2, (64, 48)),
    (("db1",), 4, (64, 64)),
])
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


def test_psi_hdot_left_inverse():
    """hdot(dot(x)) = nbasis * x for the SARA concatenation (frame bound D3)."""
    rng = np.random.default_rng(6)
    pt = TPsi(1, 40, 40, bases=("self", "db1", "db2"), nlevel=2, device=CPU)
    x = _t(rng.standard_normal((1, 40, 40)))
    assert _rel(pt.hdot(pt.dot(x)), 3 * x) < 1e-10


@pytest.mark.parametrize("sigma", [1.0, 0.7])
def test_prox_21m_and_dual_update_match_jax(sigma):
    rng = np.random.default_rng(7)
    v = rng.standard_normal((3, 2, 10, 12))
    vp = rng.standard_normal((3, 2, 10, 12))
    w = rng.uniform(0.5, 2.0, (2, 10, 12))
    v[:, 0, 0, 0] = 0.0  # exercise the zero-band-sum branch
    vp[:, 0, 0, 0] = 0.0
    lam = 0.8
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
