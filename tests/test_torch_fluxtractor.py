"""The flux mop in the port against the JAX package, in f64 on the CPU: the
Hessian approximations ``hessian_vis`` (classic ES gridder round trip, with
weights, mask, beam, eta and wsum), ``hessian_psf`` and ``hess_direct``
(both modes) on the same seeded inputs, to 1e-10 relative; and
``fluxtractor`` with a mask on copies of one port-made tree: its returns
and MODEL_MOPPED, RESIDUAL_MOPPED and UPDATE in the tree to 1e-8."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_imaging_tpu.ops import gridder as JG
from pfb_imaging_tpu.ops import hessian as JH
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch.ops import gridder as TG
from pfb_imaging_tpu_torch.ops import hessian as TH

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX, NXP, CELL, NROW = 48, 96, 3e-4, 300
FREQ = np.array([1.0e9, 1.1e9])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _data():
    rng = np.random.default_rng(17)
    uvw = rng.uniform(-400, 400, (NROW, 3))
    uvw[:, 2] *= 5.0
    wgt = rng.random((NROW, FREQ.size))
    mask = (rng.random((NROW, FREQ.size)) > 0.1).astype(np.uint8)
    x = rng.standard_normal((NX, NX))
    beam = np.exp(-((np.arange(NX) - NX / 2) ** 2)[:, None] / 800.0 - ((np.arange(NX) - NX / 2) ** 2)[None] / 900.0)
    return uvw, wgt, mask, x, beam


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "beam_eta_wsum"])
def test_hessian_vis_matches_jax(extras):
    uvw, wgt, mask, x, beam = _data()
    kw = dict(nx=NX, ny=NX, cellx=CELL, celly=CELL, epsilon=1e-7, divide_by_n=False)
    pj = JG.plan_wgridder(uvw, FREQ, dtype=np.float64, **kw)
    pt = TG.plan_wgridder(uvw, FREQ, dtype=torch.float64, device=CPU, **kw)
    more = dict(beam=beam, eta=1e-2, wsum=37.5) if extras else {}
    ref = np.asarray(JH.hessian_vis(pj, jnp.asarray(x), wgt=jnp.asarray(wgt), mask=jnp.asarray(mask),
                                    **{k: jnp.asarray(v) if k == "beam" else v for k, v in more.items()}))
    out = TH.hessian_vis(pt, _t(x), wgt=_t(wgt), mask=_t(mask),
                         **{k: _t(v) if k == "beam" else v for k, v in more.items()})
    assert out.shape == (NX, NX) and _rel(out.numpy(), ref) <= 1e-10


def _psf_inputs():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, NX, NX))
    absphat = np.abs(np.fft.rfft2(rng.standard_normal((2, NXP, NXP)), axes=(1, 2)))
    c = 1.0 - ((np.arange(NX) - NX / 2) / NX) ** 2
    return x, absphat, np.outer(c, c)


def test_hessian_psf_matches_jax():
    x, absphat, beam = _psf_inputs()
    for kw in (dict(), dict(beam=beam, eta=0.3)):
        ref = np.asarray(JH.hessian_psf(jnp.asarray(x), jnp.asarray(absphat), NXP, NXP,
                                        **{k: jnp.asarray(v) if k == "beam" else v for k, v in kw.items()}))
        out = TH.hessian_psf(_t(x), _t(absphat), NXP, NXP, **{k: _t(v) if k == "beam" else v for k, v in kw.items()})
        assert _rel(out.numpy(), ref) <= 1e-10


@pytest.mark.parametrize("mode", ["forward", "backward"])
def test_hess_direct_matches_jax(mode):
    x, absphat, taper = _psf_inputs()
    ref = np.asarray(JH.hess_direct(jnp.asarray(x), jnp.asarray(absphat), jnp.asarray(taper), NXP, NXP, eta=0.5,
                                    mode=mode))
    out = TH.hess_direct(_t(x), _t(absphat), _t(taper), NXP, NXP, eta=0.5, mode=mode)
    assert out.shape == x.shape and _rel(out.numpy(), ref) <= 1e-10


def _port_tree(d):
    """A small 2-band tree from the port's own simulate -> init -> imager
    on the CPU (f64, the JAX schema) at epsilon 1e-7."""
    from pfb_imaging_tpu_torch.cli import main

    ms, xds, dt = str(d / "s.ms"), str(d / "s.xds"), str(d / "s.dt")
    for argv in (["simulate", ms, "--nant", "12", "--ntime", "2", "--nchan", "4", "--nx", "64", "--noise", "0.1"],
                 ["init", ms, xds], ["imager", xds, dt, "--nband", "2", "--nx", "64", "--epsilon", "1e-7"]):
        main(argv + ["--device", "cpu"])
    return dt


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _port_tree(tmp_path_factory.mktemp("mop"))


def test_fluxtractor_matches_jax(tree, tmp_path):
    """A 17x17 mask round the simulator's central source, 5 CG iterations
    per band (classic gridder, epsilon 1e-7), the closing residual by IDG."""
    from pfb_imaging_tpu.core.fluxtractor import fluxtractor as jflux

    from pfb_imaging_tpu_torch.core.fluxtractor import fluxtractor

    pj, pt = tmp_path / "j.dt", tmp_path / "t.dt"
    shutil.copytree(tree, pj)
    shutil.copytree(tree, pt)
    mask = np.zeros((64, 64))
    mask[24:41, 24:41] = 1.0
    kw = dict(mask=mask, eta=1e-3, cg_maxit=5, epsilon=1e-7)
    mj, rj = jflux(str(pj), **kw)
    mt, rt = fluxtractor(str(pt), device="cpu", **kw)
    assert not mt[:, mask == 0].any() and np.abs(mt).max() > 0
    assert _rel(mt, mj) <= 1e-8 and _rel(rt, rj) <= 1e-8
    tj, tt = TreeStore(str(pj)), TreeStore(str(pt))
    for key in tj.groups():
        for name in ("MODEL_MOPPED", "RESIDUAL_MOPPED", "UPDATE"):
            assert _rel(tt.group(key).read(name), tj.group(key).read(name)) <= 1e-8, (key, name)
    wsum = sum(float(np.asarray(tt.group(k).read("WSUM"))[0]) for k in tt.groups())
    r0 = sum(np.asarray(tt.group(k).read("DIRTY")) for k in tt.groups()) / wsum
    assert np.abs(rt.sum(0) / wsum * mask).max() < np.abs(r0 * mask).max()
