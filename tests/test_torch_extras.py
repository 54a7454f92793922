"""Port parity of the small modules against the JAX package: Gauss and
``kron_matvec``, Mask, the spectral-index fit, every astrometry function,
the naming helpers and ``geometry.taperf``; and the operator protocols.

Tolerances: 1e-12 relative for products (Gauss, kron, Mask: the same sums
in another order), exact for copies of numpy code (spi, astrometry,
naming, taperf)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu import geometry as JG
from pfb_imaging_tpu.models import spi as JS
from pfb_imaging_tpu.ops import gauss as JGa
from pfb_imaging_tpu.ops.mask import Mask as JMask
from pfb_imaging_tpu.utils import astrometry as JA
from pfb_imaging_tpu.utils import naming as JN
from pfb_imaging_tpu_torch import geometry as TG
from pfb_imaging_tpu_torch.models import spi as TS
from pfb_imaging_tpu_torch.ops import LinearOperator, Preconditioner
from pfb_imaging_tpu_torch.ops import gauss as TGa
from pfb_imaging_tpu_torch.ops.mask import Mask
from pfb_imaging_tpu_torch.ops.precond import HessPSF
from pfb_imaging_tpu_torch.utils import astrometry as TA
from pfb_imaging_tpu_torch.utils import naming as TN

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_kron_matvec_matches_jax_and_dense():
    rng = np.random.default_rng(1)
    mats = (rng.standard_normal((3, 3)), rng.standard_normal((4, 4)), rng.standard_normal((2, 2)))
    x = rng.standard_normal((3, 4, 2))
    out = TGa.kron_matvec(mats, torch.as_tensor(x))
    assert _rel(out, JGa.kron_matvec(mats, jnp.asarray(x))) < 1e-12
    dense = np.kron(np.kron(mats[0], mats[1]), mats[2]) @ x.reshape(-1)
    assert _rel(out.reshape(-1), dense) < 1e-12


def test_gauss_matches_jax():
    args = (np.linspace(1, 2, 3), np.arange(4.0), np.arange(5.0))
    kw = dict(lf=0.5, lx=2.0, ly=2.0)
    gj, gt = JGa.Gauss(*args, **kw), TGa.Gauss(*args, device=CPU, **kw)
    np.testing.assert_array_equal(gt.kx, gj.kx)
    x = np.random.default_rng(2).standard_normal((3, 4, 5))
    for op in ("dot", "hdot", "sqrtdot"):
        assert _rel(getattr(gt, op)(torch.as_tensor(x)), getattr(gj, op)(jnp.asarray(x))) < 1e-12, op
    assert float((torch.as_tensor(x) * gt.dot(torch.as_tensor(x))).sum()) > 0  # PSD
    np.testing.assert_array_equal(TGa.expsq(args[1], args[1], 1.3, 2.0), JGa.expsq(args[1], args[1], 1.3, 2.0))


def test_mask_matches_jax_and_is_adjoint():
    rng = np.random.default_rng(0)
    m = rng.uniform(size=(8, 8)) > 0.5
    op, oj = Mask(m, device=CPU), JMask(m)
    x = rng.standard_normal((8, 8))
    beta = op.dot(torch.as_tensor(x))
    assert op.nnz == oj.nnz and beta.shape == (op.nnz,)
    np.testing.assert_array_equal(beta.numpy(), np.asarray(oj.dot(jnp.asarray(x))))
    back = op.hdot(beta)
    np.testing.assert_array_equal(back.numpy(), x * m)
    np.testing.assert_array_equal(back.numpy(), np.asarray(oj.hdot(jnp.asarray(beta.numpy()))))
    y = torch.as_tensor(rng.standard_normal(op.nnz))
    lhs = float((op.dot(torch.as_tensor(x)) * y).sum())
    assert lhs == pytest.approx(float((torch.as_tensor(x) * op.hdot(y)).sum()), rel=1e-12)


def test_operator_protocols():
    ph = np.ones((1, 8, 5))
    hp = HessPSF(ph, 8, 8, device=CPU)
    assert isinstance(hp, LinearOperator) and isinstance(hp, Preconditioner)
    assert isinstance(TGa.Gauss(np.ones(1), np.arange(2.0), np.arange(2.0), device=CPU), LinearOperator)
    assert isinstance(Mask(np.ones((4, 4)), device=CPU), LinearOperator)
    assert not isinstance(object(), LinearOperator)


def test_spi_fit_matches_jax():
    freqs = np.linspace(0.8e9, 1.6e9, 8)
    rng = np.random.default_rng(3)
    data = rng.uniform(0.5, 3.0, (6, 8)) * (freqs / 1e9) ** rng.uniform(-1, 0, (6, 1))
    data[2, :7] = -1.0  # one usable channel: no fit (NaN), as JAX
    w = rng.uniform(0.5, 1.5, (6, 8))
    for a, b in zip(TS.fit_spi_components(data, w, freqs, 1e9), JS.fit_spi_components(data, w, freqs, 1e9)):
        np.testing.assert_array_equal(a, b)
    alpha, _, i0, _ = TS.fit_spi_components((2.5 * (freqs / 1e9) ** -0.7)[None], np.ones(8), freqs, 1e9)
    assert alpha[0] == pytest.approx(-0.7, abs=1e-10) and i0[0] == pytest.approx(2.5, rel=1e-10)


def test_astrometry_matches_jax():
    rng = np.random.default_rng(4)
    antpos = rng.standard_normal((5, 3)) * 1e3
    times = np.linspace(0, 3600, 10)
    a1, a2 = np.zeros(10, int), np.ones(10, int)
    np.testing.assert_array_equal(TA.synthesize_uvw(antpos, times, a1, a2, 0.3, -0.6),
                                  JA.synthesize_uvw(antpos, times, a1, a2, 0.3, -0.6))
    k = rng.standard_normal(3)
    np.testing.assert_array_equal(TA.cross_product_matrix(k), JA.cross_product_matrix(k))
    s0, s1 = np.array([0.0, 0.0, 1.0]), np.array([0.1, -0.2, np.sqrt(1 - 0.05)])
    for a, b in ((s0, s1), (s0, s0), (s0, -s0)):
        np.testing.assert_array_equal(TA.rotation_matrix_rodrigues(a, b), JA.rotation_matrix_rodrigues(a, b))
    np.testing.assert_array_equal(TA.radec_to_lmn(0.51, -0.41, 0.5, -0.4), JA.radec_to_lmn(0.51, -0.41, 0.5, -0.4))
    vis = rng.standard_normal((20, 3)) + 1j * rng.standard_normal((20, 3))
    uvw = rng.uniform(-100, 100, (20, 3))
    freq = np.linspace(1e9, 1.2e9, 3)
    args = (vis, uvw, freq, (0.501, -0.401), (0.5, -0.4))
    np.testing.assert_array_equal(TA.rephase(*args), JA.rephase(*args))
    for a, b in zip(TA.change_phase_dir(*args), JA.change_phase_dir(*args)):
        np.testing.assert_array_equal(a, b)
    for ra, dec in ((15.0, -30.5), (359.999999, 10.999999), (123.456, 0.0001)):
        assert TA.format_coords(ra, dec) == JA.format_coords(ra, dec)
    assert TA.sun_radec(61212.3507) == JA.sun_radec(61212.3507)
    assert TA.get_coordinates(61119.6153 * 86400.0) == JA.get_coordinates(61119.6153 * 86400.0)
    with pytest.raises(NotImplementedError):
        TA.get_coordinates(0.0, target="Moon")
    np.testing.assert_array_equal(TA.uvw_rotate(uvw, 0.8, -0.6, 0.81, -0.62), JA.uvw_rotate(uvw, 0.8, -0.6, 0.81, -0.62))
    np.testing.assert_array_equal(TA.uvw_rotate(uvw[0], 0.8, -0.6, 0.81, -0.62),
                                  JA.uvw_rotate(uvw[0], 0.8, -0.6, 0.81, -0.62))
    t = np.linspace(0, 86164, 7)
    np.testing.assert_array_equal(TA.parallactic_angles(t, 0.2, -0.6), JA.parallactic_angles(t, 0.2, -0.6))


def test_naming_matches_jax(tmp_path):
    assert TN.output_name("out/run", "dirty", "b1") == JN.output_name("out/run", "dirty", "b1") == "out/run_DIRTY_b1.dt"
    assert TN.output_name("run", "model", ext="mds") == JN.output_name("run", "model", ext="mds")
    opts = {"nx": 64, "nworkers": 4, "eps": 1e-7}
    url = str(tmp_path / "prod.dt")
    assert TN.get_opts(url) is None and not TN.opts_match(opts, url)
    TN.cache_opts(opts, url)
    assert TN.get_opts(url) == JN.get_opts(url) == opts
    assert TN.opts_match(dict(opts, nworkers=1), url) and JN.opts_match(dict(opts, nworkers=1), url)
    assert not TN.opts_match(dict(opts, nx=128), url)


def test_taperf_matches_jax():
    np.testing.assert_array_equal(TG.taperf((40, 24), 8), JG.taperf((40, 24), 8))
