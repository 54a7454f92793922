"""The port's ``restore`` against the JAX package's on one .dt tree (the JAX
imager's products plus a MODEL and a RESIDUAL per band), on the CPU in f64:
the six FITS products, data within 1e-10 relative to the largest value
(the same clean-beam fit, FFT convolutions by torch instead of numpy) and
headers equal (beam parameters within 1e-10), and the Gaussian kernel and
the Gaussian-ratio convolution on their own."""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu import geometry as JG
from pfb_imaging_tpu.core.imager import imager as jax_imager
from pfb_imaging_tpu.core.init import init as jax_init
from pfb_imaging_tpu.core.restore import restore as jax_restore
from pfb_imaging_tpu.core.simulate import simulate_vis_store as jax_simulate
from pfb_imaging_tpu.utils import restoration as JR
from pfb_imaging_tpu.utils.fits import load_fits
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch import geometry as TG
from pfb_imaging_tpu_torch.core.restore import restore
from pfb_imaging_tpu_torch.utils import restoration as TR

torch.set_num_threads(1)
PRODUCTS = ("model", "model_mfs", "residual", "residual_mfs", "image", "image_mfs")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("restore")
    ms, xds, dt = str(d / "sim.ms"), str(d / "sim.xds"), str(d / "sim.dt")
    jax_simulate(ms, nant=7, ntime=3, nchan=4, nx=32, noise=0.05)
    jax_init(ms, xds)
    jax_imager(xds, dt, nband=2, nx=32, ny=32, psf_oversize=1.5, gridder="stack", fits_out=False)
    rng = np.random.default_rng(4)
    st = TreeStore(dt)
    for key in st.groups():
        node = st.group(key)
        model = np.zeros((32, 32))
        model[rng.integers(8, 24, 4), rng.integers(8, 24, 4)] = rng.uniform(0.1, 1.0, 4)
        node.write("MODEL", model)
        node.write("RESIDUAL", np.asarray(node.read("DIRTY")) * 0.3)
    return d


def test_restore_matches_jax(tree):
    dt = str(tree / "sim.dt")
    written_t = restore(dt, fits_base=str(tree / "t"), device="cpu")
    written_j = jax_restore(dt, fits_base=str(tree / "j"))
    assert [p.replace(str(tree / "t"), "") for p in written_t] == [p.replace(str(tree / "j"), "") for p in written_j]
    assert len(written_t) == 6
    for prod in PRODUCTS:
        at, ht = load_fits(str(tree / f"t_{prod}.fits"), dtype=np.float64)
        aj, hj = load_fits(str(tree / f"j_{prod}.fits"), dtype=np.float64)
        assert at.shape == aj.shape and np.isfinite(at).all(), prod
        assert _rel(at, aj) < 1e-10, prod
        assert ht.keys() == hj.keys(), prod
        for k in hj:
            if isinstance(hj[k], float):
                assert ht[k] == pytest.approx(hj[k], rel=1e-10, abs=1e-300), (prod, k)
            else:
                assert ht[k] == hj[k], (prod, k)


def test_restore_outputs_select_products(tree):
    written = restore(str(tree / "sim.dt"), outputs="MI", fits_base=str(tree / "s"), device="cpu")
    assert written == [str(tree / "s_model_mfs.fits"), str(tree / "s_image_mfs.fits")]


@pytest.mark.parametrize("par", [(3.0, 2.0, 0.3), (5.5, 5.5, 0.0), (4.0, 1.5, 2.8)])
def test_gaussian_kernel_and_convolution_match_jax(par):
    x = np.arange(-12, 13)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    for norm in (True, False):
        assert _rel(TG.gaussian_kernel(xx, yy, par, norm), JG.gaussian_kernel(xx, yy, par, norm)) < 1e-15
    rng = np.random.default_rng(8)
    img = rng.standard_normal((2, 30, 26))
    intrinsic = [(2.0, 1.5, 0.1), (2.5, 1.0, 1.0)]
    assert _rel(TR.convolve2gaussres(img, par, device="cpu"), JR.convolve2gaussres(img, par)) < 1e-10
    assert _rel(TR.convolve2gaussres(img, par, intrinsic, device="cpu"),
                JR.convolve2gaussres(img, par, intrinsic)) < 1e-10
