"""The port's Stokes conversion against the JAX package on the CPU, in f64:
``weight_data`` with no Jones, diagonal Jones and full 2x2 Jones, over
both feed types, ncorr 1/2/4 and the products I/Q/U/V (1e-12 relative to
the largest value: the same least squares summed in another order), and
the host Jones/Mueller beam helpers (1e-14)."""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu.utils import stokes as J
from pfb_imaging_tpu_torch.utils import stokes as T

torch.set_num_threads(1)
NROW, NCHAN = 37, 5


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _cplx(rng, shape, scale=1.0, centre=0.0):
    return centre + scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def _inputs(ncorr, jones, seed=3):
    rng = np.random.default_rng(seed)
    vis = _cplx(rng, (ncorr, NROW, NCHAN))
    wgt = rng.random((ncorr, NROW, NCHAN))
    wgt[:, :3] = 0.0  # rows with no weight give zeros
    if jones == "diag":
        jp, jq = (_cplx(rng, (ncorr, NROW, NCHAN), 0.2, 1.0) for _ in range(2))
    elif jones == "full":
        eye = np.eye(2)[:, :, None, None]
        jp, jq = (eye + _cplx(rng, (2, 2, NROW, NCHAN), 0.1) for _ in range(2))
    else:
        jp = jq = None
    return vis, wgt, jp, jq


CASES = [(feed, ncorr, prod, jones) for feed in ("linear", "circular") for ncorr in (1, 2, 4)
         for prod in "IQUV" for jones in ("none", "diag", "full") if jones != "full" or ncorr == 4]


@pytest.mark.parametrize("feed, ncorr, product, jones", CASES)
def test_weight_data_matches_jax(feed, ncorr, product, jones):
    vis, wgt, jp, jq = _inputs(ncorr, jones)
    vj, wj = J.weight_data(vis, wgt, jones_p=jp, jones_q=jq, product=product, feed_type=feed)
    vt, wt = T.weight_data(vis, wgt, jones_p=jp, jones_q=jq, product=product, feed_type=feed, device="cpu")
    assert vt.dtype == torch.complex128 and wt.dtype == torch.float64 and tuple(vt.shape) == (NROW, NCHAN)
    assert _rel(wt, wj) < 1e-12
    if np.abs(np.asarray(wj)).max() > 0:
        assert _rel(vt, vj) < 1e-12
    else:  # the product is blind to these correlations (e.g. Q from RR/LL)
        assert not vt.abs().any()
    assert not vt[:3].abs().any() and not wt[:3].any()


def test_weight_data_identity_is_the_stokes_average():
    """No Jones, linear feeds, 2 correlations: I = (XX + YY) / 2 with
    weight w_XX + w_YY; a full Jones term on 2 correlations raises."""
    vis, wgt, _, _ = _inputs(2, "none")
    vt, wt = T.weight_data(vis, np.ones_like(wgt), device="cpu")
    np.testing.assert_allclose(vt.numpy(), (vis[0] + vis[1]) / 2, rtol=1e-15)
    assert (wt.numpy() == 2.0).all()
    jp = np.ones((2, 2, NROW, NCHAN), complex)
    with pytest.raises(ValueError, match="4-correlation"):
        T.weight_data(vis, wgt, jones_p=jp, jones_q=jp, device="cpu")


@pytest.mark.parametrize("feed", ["linear", "circular"])
def test_jones_helpers_match_jax(feed):
    rng = np.random.default_rng(11)
    jp, jq = (_cplx(rng, (2, 2, 6, 7)) for _ in range(2))
    m = T.jones_to_mueller(jp, jq)
    assert m.shape == (4, 4, 6, 7)
    assert _rel(m, J.jones_to_mueller(jp, jq)) < 1e-14
    assert _rel(T.mueller_to_stokes_diag(m, feed), J.mueller_to_stokes_diag(m, feed)) < 1e-14
    for product in ("I", "IQUV", "QV"):
        s = T.jones_beam_to_stokes(jp, product, feed)
        assert s.shape == (len(product), 6, 7)
        assert _rel(s, J.jones_beam_to_stokes(jp, product, feed)) < 1e-14
