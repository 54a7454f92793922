"""Snapshot imaging in the port against the JAX package, in f64 on the CPU:
``transient_spectrum`` for every kind (1e-15 relative), and ``hci`` on one
port-made store of two scans, IDG at epsilon 1e-7 and the classic stack
gridder at 1e-9, with two frequency chunks, an injected transient, RMS
flags and per-scan products: CUBE, WSUMS, TIMES, FLAGS and the scan
products to 1e-9. Then a step transient's frames at its pixel, as the JAX
tests check them."""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu.models.transients import transient_spectrum as jspectrum
from pfb_imaging_tpu_torch.core import hci as TH
from pfb_imaging_tpu_torch.models.transients import transient_spectrum
from pfb_imaging_tpu_torch.utils.store import TreeStore

torch.set_num_threads(1)
NX = 64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("kw", [
    dict(kind="gaussian"),
    dict(kind="gaussian", t0=3.0, width=2.0, amplitude=2.5, spectral_index=-0.7, ref_freq=1.2e9),
    dict(kind="exponential", t0=4.0, width=3.0),
    dict(kind="step", t0=5.5),
    dict(kind="periodic", width=1.5),
    dict(kind="periodic", t0=1.0, width=1.5, period=7.0),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_transient_spectrum_matches_jax(kw):
    times, freqs = np.linspace(0.0, 12.0, 13), np.linspace(0.9e9, 1.7e9, 5)
    out, ref = transient_spectrum(times, freqs, **kw), jspectrum(times, freqs, **kw)
    assert out.shape == (13, 5) and _rel(out, ref) <= 1e-15


def test_transient_spectrum_unknown_kind():
    with pytest.raises(ValueError, match="Unknown transient kind"):
        transient_spectrum([0.0, 1.0], [1e9], kind="burst")


@pytest.fixture(scope="module")
def xds(tmp_path_factory):
    """Two scans (12 antennas, 4 channels) from the port's own simulate ->
    init on the CPU, in the JAX schema."""
    from pfb_imaging_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("hci")
    ms, out = str(d / "s.ms"), str(d / "s.xds")
    main(["simulate", ms, "--nant", "12", "--ntime", "2", "--nchan", "4", "--nx", "64", "--noise", "0.1",
          "--device", "cpu"])
    main(["init", ms, out, "--device", "cpu"])
    return out


@pytest.mark.parametrize("epsilon, route", [(1e-7, "idg"), (1e-9, "stack")])
def test_hci_matches_jax(xds, tmp_path, epsilon, route):
    from pfb_imaging_tpu.core.hci import hci as jhci

    kw = dict(nx=NX, freq_chunks=2, epsilon=epsilon, rms_flag_level=1.0, per_scan_products=True,
              inject_transient=dict(kind="gaussian", amplitude=3.0, xfrac=0.3, yfrac=0.6))
    oj = jhci(xds, str(tmp_path / "j.cube"), **kw)
    ot = TH.hci(xds, str(tmp_path / "t.cube"), device="cpu", **kw)
    assert TH.HCI_STATS["route"] == route and TH.HCI_STATS["tasks"] == 4
    cube = np.asarray(ot.read("CUBE"))
    assert cube.shape == (2, 2, NX, NX) and np.isfinite(cube).all()
    for name in ("CUBE", "WSUMS", "TIMES", "FREQS"):
        assert _rel(ot.read(name), oj.read(name)) <= 1e-9, name
    flags = np.asarray(ot.read("FLAGS"))
    assert np.array_equal(flags, np.asarray(oj.read("FLAGS"))) and 0 < flags.sum() < flags.size
    for t in range(2):
        st, sj = ot.group(f"scan{t:04d}"), oj.group(f"scan{t:04d}")
        for name in ("DIRTY", "WSUM"):
            assert _rel(st.read(name), sj.read(name)) <= 1e-9, (t, name)
        assert st.attrs["time"] == sj.attrs["time"]
    assert ot.attrs["nfreq_chunks"] == 2 and ot.attrs["cell_rad"] == oj.attrs["cell_rad"]


def test_hci_step_transient_frames(xds, tmp_path):
    """A step that turns on between the two scans: the first frame at its
    pixel holds little, the second about its amplitude (as the JAX tests)."""
    times = np.array([float(TreeStore(xds).group(k).attrs["time"]) for k in TreeStore(xds).groups()])
    out = TH.hci(xds, str(tmp_path / "s.cube"), nx=NX, epsilon=1e-7, device="cpu",
                 inject_transient=dict(kind="step", t0=times.mean(), amplitude=5.0, xfrac=0.25, yfrac=0.25))
    cube = np.asarray(out.read("CUBE"))
    assert abs(cube[0, 0, 16, 16]) < 0.5
    assert cube[1, 0, 16, 16] == pytest.approx(5.0, rel=0.15)
