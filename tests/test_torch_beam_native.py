"""The port's copies of the JAX package's beam helpers (``eval_beam``,
``rotate_beam``, ``reproject_beam``) and native helpers (``have_native``,
``uvw_to_pix``), held to the JAX package on ``tests/test_beam.py``'s and
``tests/test_native.py``'s inputs (f64 host code: 1e-12 relative), and the
native ``uvw_to_pix`` to its numpy fallback (reached by emptying
``native._LIB``, as ``test_torch_weighting.py`` does)."""

import numpy as np
import pytest
import torch
from torch_recorder import recording

from pfb_imaging_tpu import native as JN
from pfb_imaging_tpu.utils import beam as JB
from pfb_imaging_tpu_torch import native as TN
from pfb_imaging_tpu_torch.utils import beam as TB

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _grid(n, ext):
    g = np.linspace(-ext, ext, n)
    return (g,) + tuple(np.meshgrid(g, g, indexing="ij"))


def _ellipse():
    """``test_rotate_beam_quarter_turn``'s beam, elongated along l."""
    lg, ll, mm = _grid(129, 0.05)
    return lg, ll, mm, np.exp(-0.5 * ((ll / 0.02) ** 2 + (mm / 0.01) ** 2))


def test_eval_beam_matches_jax():
    lg, ll, mm, ell = _ellipse()
    out = 0.7 * ll + 0.2 * mm  # off the small grid's nodes, partly outside it
    got = TB.eval_beam(ell, lg, lg, out, mm)
    assert _rel(got, JB.eval_beam(ell, lg, lg, out, mm)) <= 1e-12
    assert _rel(got, TB.interp_beam(ell, lg, lg, out, mm)) == 0.0


@pytest.mark.parametrize("parang", [np.pi / 2, 0.3])
def test_rotate_beam_matches_jax(parang):
    lg, ll, mm, ell = _ellipse()
    got = TB.rotate_beam(ell, lg, lg, parang, ll, mm)
    assert _rel(got, JB.rotate_beam(ell, lg, lg, parang, ll, mm)) <= 1e-12
    if parang == np.pi / 2:  # the quarter turn maps l onto m (interpolation error only)
        assert np.abs(got - np.exp(-0.5 * ((mm / 0.02) ** 2 + (ll / 0.01) ** 2))).max() < 5e-4


@pytest.mark.parametrize("offset_px", [0, 10])
def test_reproject_beam_matches_jax(offset_px):
    """``test_reproject_beam_identity_and_shift``'s beam, onto the same
    centre and one 10 pixels off in dec; and a 2-Stokes cube."""
    n = 97
    cell = np.deg2rad(0.02)
    lg = (np.arange(n) - n // 2) * cell
    ll, mm = np.meshgrid(lg, lg, indexing="ij")
    beam = JB.cosine_taper_beam(ll, mm, 1.2e9)
    radec, radec_t = (0.3, -0.5), (0.3, -0.5 + offset_px * cell)
    got = TB.reproject_beam(beam, cell, radec, radec_t, cell, n, n)
    assert _rel(got, JB.reproject_beam(beam, cell, radec, radec_t, cell, n, n)) <= 1e-12
    cube = np.stack([beam, beam**2])
    got = TB.reproject_beam(cube, cell, radec, radec_t, cell, 64, 80, fill=-1.0)
    assert got.shape == (2, 64, 80)
    assert _rel(got, JB.reproject_beam(cube, cell, radec, radec_t, cell, 64, 80, fill=-1.0)) <= 1e-12


def test_have_native():
    assert TN.have_native()


def _uvw_args():
    """``tests/test_native.py::test_uvw_to_pix_parity``'s inputs."""
    rng = np.random.default_rng(1)
    uvw = rng.uniform(-100, 100, (500, 3))
    freq = np.linspace(1e9, 1.2e9, 4)
    return uvw, freq, 1.0, -1.0, 1.0, 2.5, 3.5, 1.0 / 299792458.0, 0.01, -0.02


def test_uvw_to_pix_native_matches_fallback_and_jax(monkeypatch):
    args = _uvw_args()
    with recording() as got:
        native = TN.uvw_to_pix(*args)
    assert got["counters"]["plan.native"] == 1
    for got, want in zip(native, JN.uvw_to_pix(*args)):
        assert _rel(got, want) <= 1e-14
    monkeypatch.setattr(TN, "_LIB", None)
    monkeypatch.setattr(TN, "_TRIED", True)
    with recording() as got:
        fallback = TN.uvw_to_pix(*args)
    assert got["counters"]["plan.numpy"] == 1
    for got, want in zip(native[:3], fallback[:3]):
        np.testing.assert_allclose(got, want, rtol=1e-14)
    np.testing.assert_allclose(native[3], fallback[3], rtol=1e-12)
    assert not TN.have_native()
