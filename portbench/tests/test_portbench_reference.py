"""The plain reference's parts against their definitions: the non-uniform
FFT and its adjoint against the direct sums, the Daubechies filters
against their defining properties and the program's filter bank, the
dictionary's synthesis as the exact adjoint of its analysis, and the
control's precision switch."""

import numpy as np
import pytest
import torch

from portbench import data
from portbench import reference as ref


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("cell", [4e-6, 2e-5])
def test_nufft_matches_the_direct_sum(cell):
    uvw = torch.as_tensor(data.synth_array(12, 20, 42, 1.0))
    freq = data.channels(4, 856e6, 1712e6)
    rng = np.random.default_rng(0)
    img = np.zeros((128, 128))
    on = rng.random(img.shape) < 0.05
    img[on] = rng.random(on.sum())
    want = ref.vis_of_image(uvw, freq, torch.as_tensor(img), 128, cell)
    got = ref.vis_nufft(uvw, freq, torch.as_tensor(img), 128, cell)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-9


def test_the_adjoint_nufft_matches_the_direct_sum_at_every_pixel():
    uvw = torch.as_tensor(data.synth_array(10, 16, 42, 1.0, 4000.0))
    freq = data.channels(3, 856e6, 1712e6)
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.standard_normal((uvw.shape[0], 3)) + 1j * rng.standard_normal((uvw.shape[0], 3)))
    nx, cell = 48, 2e-5
    pix = np.stack(np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij"), -1).reshape(-1, 2)
    want = ref.image_at(uvw, freq, v, pix, nx, cell).reshape(nx, nx)
    got = ref.image_nufft(uvw, freq, v, nx, cell)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-9


@pytest.mark.parametrize("n", range(1, 9))
def test_daubechies_filters_are_orthonormal_and_the_programs(n):
    from pfb_imaging_tpu_torch.ops import wavelets

    h = np.asarray(ref.daubechies(n))
    assert len(h) == 2 * n and abs(h.sum() - np.sqrt(2.0)) < 1e-12
    for shift in range(n):  # orthonormal to its even shifts
        dot = float(h[2 * shift :] @ h[: len(h) - 2 * shift])
        assert abs(dot - (shift == 0)) < 1e-12
    assert np.allclose(h, np.asarray(wavelets.daubechies(n), dtype=float).ravel(), atol=1e-12, rtol=0)


def test_dictionary_synthesis_is_the_adjoint():
    psi = ref.Dictionary(("self",) + tuple(f"db{n}" for n in range(1, 9)), 2, torch.float64, "cpu")
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((2, 40, 36)))
    a = [torch.as_tensor(rng.standard_normal(tuple(c.shape))) for c in psi.dot(x)]
    lhs = sum(float((c * d).sum()) for c, d in zip(psi.dot(x), a))
    rhs = float((x * psi.hdot(a, x)).sum())
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


def test_image_at_is_the_adjoint_of_vis_of_image():
    uvw = torch.as_tensor(data.synth_array(8, 10, 3, 1.0))
    freq = data.channels(2, 856e6, 1712e6)
    rng = np.random.default_rng(2)
    pix = np.stack([rng.integers(0, 32, 5), rng.integers(0, 32, 5)], 1)
    img = np.zeros((32, 32))
    img[pix[:, 0], pix[:, 1]] = rng.random(5)
    v = torch.as_tensor(rng.standard_normal((uvw.shape[0], 2)) + 1j * rng.standard_normal((uvw.shape[0], 2)))
    # <I, R^H v> = Re <R I, v>
    lhs = float((torch.as_tensor(img[pix[:, 0], pix[:, 1]]) * ref.image_at(uvw, freq, v, pix, 32, 1e-4)).sum())
    rhs = float((ref.vis_of_image(uvw, freq, torch.as_tensor(img), 32, 1e-4).conj() * v).real.sum())
    assert abs(lhs - rhs) < 1e-9 * abs(rhs)


def test_precision_switch_restores_the_defaults():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with ref.precision("tf32") as dt:
        assert dt == torch.float32 and torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
