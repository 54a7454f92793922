"""The port's ``simulate_vis_store`` and ``init`` against the JAX package's
on the CPU, and ``reduce_counts``.

The simulator draws its array, gains and noise from the same numpy seeds in
the same order, so every array of every group must match: integer, flag,
time and UVW arrays exactly, VIS (the f64 DFT over the nonzero pixels,
the same sums in another order) and the Jones terms within 1e-10 relative
to the largest value; root and group attributes equal. ``init`` runs both
packages on one JAX store: its VIS and WEIGHT (the f64 least squares) to
1e-12, the rest exactly, the output dtypes equal."""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu.core.init import init as jax_init
from pfb_imaging_tpu.core.simulate import simulate_vis_store as jax_simulate
from pfb_imaging_tpu.ops.weighting import reduce_counts as jax_reduce_counts
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch.core.init import init
from pfb_imaging_tpu_torch.core.simulate import simulate_vis_store
from pfb_imaging_tpu_torch.ops.weighting import reduce_counts

torch.set_num_threads(1)
SMALL = dict(nant=5, ntime=4, nchan=3, nx=16)
EXACT = ("ANTENNA1", "ANTENNA2", "FLAG", "TIME", "UVW", "MASK", "FREQ", "BEAM_L", "BEAM_M", "BEAM_SMALL",
         "GAIN_TIME", "GAIN_FREQ")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _same_store(pt, pj, tol):
    """Every group and array of two stores: names, dtypes, shapes,
    attributes; EXACT arrays bit for bit, the others within ``tol``."""
    st, sj = TreeStore(pt), TreeStore(pj)
    assert st.attrs == sj.attrs
    assert st.groups() == sj.groups() and st.arrays() == sj.arrays()
    for g in [st, *(st.group(k) for k in st.groups())]:
        h = sj.group(g.path.name) if g is not st else sj
        assert g.attrs == h.attrs and g.arrays() == h.arrays()
        for name in g.arrays():
            a, b = g.read(name), h.read(name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if name in EXACT:
                assert np.array_equal(a, b), name
            else:
                assert _rel(a, b) < tol, name


SIM_CASES = {
    "default": dict(),
    "noise": dict(noise=0.3),
    "gain_table_out": dict(noise=0.1),
    "corrupt_gains": dict(corrupt_gains=True, ncorr=4),
    "pol_fractions": dict(pol_fractions=(0.1, -0.2, 0.05), ncorr=4, feed_type="circular"),
    "beam_diameter": dict(beam_diameter=13.5, noise=0.1),
    "times_per_scan": dict(times_per_scan=2, noise=0.1, ntime=5),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulate_matches_jax(case, tmp_path):
    kw = {**SMALL, **SIM_CASES[case]}
    if case == "gain_table_out":
        _, tt = simulate_vis_store(str(tmp_path / "t.ms"), gain_table_out=str(tmp_path / "tg"), device="cpu", **kw)
        _, tj = jax_simulate(str(tmp_path / "j.ms"), gain_table_out=str(tmp_path / "jg"), **kw)
        _same_store(tmp_path / "tg", tmp_path / "jg", 1e-10)
    else:
        _, tt = simulate_vis_store(str(tmp_path / "t.ms"), device="cpu", **kw)
        _, tj = jax_simulate(str(tmp_path / "j.ms"), **kw)
    _same_store(tmp_path / "t.ms", tmp_path / "j.ms", 1e-10)
    assert tt["cell_rad"] == tj["cell_rad"] and tt["nx"] == tj["nx"]
    assert np.array_equal(tt["model"], tj["model"]) and np.array_equal(tt["freqs"], tj["freqs"])


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """One JAX store with per-row Jones terms, a beam, several partitions,
    and its gain table."""
    d = tmp_path_factory.mktemp("init")
    jax_simulate(str(d / "sim.ms"), nant=6, ntime=4, nchan=4, nx=16, noise=0.1, ncorr=4, times_per_scan=2,
                 beam_diameter=13.5, pol_fractions=(0.2, 0.1, 0.0), gain_table_out=str(d / "gains"))
    return d


INIT_CASES = {
    "I": dict(),
    "Q": dict(product="Q"),
    "chan_average": dict(chan_average=2),
    "bda": dict(bda_decorrelation=0.98),
    "gain_table": dict(gain_table="gains"),
    "beam_gauss": dict(beam_model="gauss"),
    "beam_kbl": dict(beam_model="kbl", apply_jones=False),
}


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_init_matches_jax(case, raw, tmp_path):
    kw = dict(INIT_CASES[case])
    if "gain_table" in kw:
        kw["gain_table"] = str(raw / kw["gain_table"])
    init(str(raw / "sim.ms"), str(tmp_path / "t.xds"), device="cpu", **kw)
    jax_init(str(raw / "sim.ms"), str(tmp_path / "j.xds"), **kw)
    _same_store(tmp_path / "t.xds", tmp_path / "j.xds", 1e-12)
    g = TreeStore(str(tmp_path / "t.xds")).group("scan0000")
    assert g.read("VIS").dtype == np.complex128 and g.read("WEIGHT").dtype == np.float64


def test_init_reads_the_ports_own_store(tmp_path):
    """The port's simulate -> init chain: Stokes I of two linear
    correlations is (XX + YY) / 2, with weight 2 / noise^2."""
    ms, xds = str(tmp_path / "sim.ms"), str(tmp_path / "sim.xds")
    simulate_vis_store(ms, noise=0.5, device="cpu", **SMALL)
    init(ms, xds, device="cpu")
    for key in TreeStore(ms).groups():
        vis = TreeStore(ms).group(key).read("VIS")
        g = TreeStore(xds).group(key)
        np.testing.assert_allclose(g.read("VIS"), (vis[0] + vis[1]) / 2, rtol=1e-14)
        np.testing.assert_allclose(g.read("WEIGHT"), 2.0 / 0.5**2, rtol=1e-15)
        assert (g.read("MASK") == 1).all()


@pytest.mark.parametrize("grouping", ["per-band-time", "mfs", "per-time", "per-band"])
def test_reduce_counts_matches_jax(grouping):
    rng = np.random.default_rng(2)
    counts = {(b, t): rng.random((1, 8, 6)) for b in range(3) for t in range(2)}
    out, ref = reduce_counts(counts, grouping), jax_reduce_counts(counts, grouping)
    assert out.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(out[k], ref[k]), k
    with pytest.raises(ValueError, match="grouping"):
        reduce_counts(counts, "per-baseline")
