"""The port's row-sharded FFT (``parallel/fft.py``) and the row-sharded
``HessianCube`` on spawned gloo ranks, against the JAX package on its 8
virtual CPU devices and against the unsharded operators.

Four ranks (``tests/torch_ranks.py``) compute, from seeded numpy inputs, the
sharded PSF convolution and PSF Hessian at row sizes 2 and 4 (an even and an
odd half-spectrum: ny_psf 128 gives 65 columns, 96 gives 49, padded to a
multiple of the row size) and the cube Hessian on a 2 x 2 band x row mesh.
Every rank of a row group must return the whole result; all comparisons are
f64 at 1e-10 relative.
"""

import numpy as np
import pytest
import torch

from torch_ranks import load, run_ranks, save

torch.set_num_threads(1)
GEOMS = ((64, 128), (48, 96))  # (nx, nx_psf): half-spectra of 65 and 49 columns
ROWS = (2, 4)
NBAND, NPART, NX_CUBE = 2, 2, 32
WSUMS = np.asarray([1.0, 2.0])


def _image_inputs(nx, nxp):
    rng = np.random.default_rng(nx)
    psf = rng.standard_normal((nxp, nxp))
    ph = np.abs(np.fft.rfft2(np.fft.ifftshift(psf)))
    return rng.standard_normal((nx, nx)), ph, rng.uniform(0.5, 1.0, (nx, nx))


def _cube_inputs():
    rng = np.random.default_rng(3)
    nxp = 2 * NX_CUBE
    ph = np.abs(rng.standard_normal((NBAND, NPART, nxp, nxp // 2 + 1))) + 0.1
    return ph, rng.standard_normal((NBAND, NX_CUBE, NX_CUBE))


def _ranks(rank, world, outdir):
    from pfb_imaging_tpu_torch.ops.hessian import HessianCube
    from pfb_imaging_tpu_torch.parallel.fft import hessian_psf_sharded, psf_convolve_sharded, psfhat_transposed
    from pfb_imaging_tpu_torch.parallel.mesh import make_mesh

    for d in ROWS:
        mesh = make_mesh(band=1, row=d)
        for nx, nxp in GEOMS:
            x, ph, beam = (torch.as_tensor(a) for a in _image_inputs(nx, nxp))
            ph_t = psfhat_transposed(ph.numpy(), d)
            save(outdir, f"conv_{d}_{nx}", psf_convolve_sharded(mesh, x, ph_t, nx, nx, nxp, nxp), rank)
            save(outdir, f"hess_{d}_{nx}", hessian_psf_sharded(mesh, x, ph_t, nxp, nxp, beam=beam, eta=1e-3), rank)
    mesh = make_mesh(band=2, row=2)
    ph, x = _cube_inputs()
    cube = HessianCube.build(ph[mesh.band_slice(NBAND)], WSUMS, 1e-3, 2 * NX_CUBE, 2 * NX_CUBE, mesh=mesh,
                             device="cpu")
    assert cube.mesh is mesh and cube.abspsfhat.shape[0] == 1
    save(outdir, "cube", cube.dot(torch.as_tensor(x[mesh.band_slice(NBAND)])), rank)
    save(outdir, "cube_band", [mesh.band_index, mesh.row_index], rank)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_ranks, 4, tmp_path_factory.mktemp("fft"))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("d", ROWS)
@pytest.mark.parametrize("nx, nxp", GEOMS)
def test_psf_convolve_sharded_matches_jax(ranks, d, nx, nxp):
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops.psf import psf_convolve
    from pfb_imaging_tpu.parallel.fft import psf_convolve_sharded, psfhat_transposed
    from pfb_imaging_tpu.parallel.mesh import make_mesh

    x, ph, _ = _image_inputs(nx, nxp)
    ref = np.asarray(psf_convolve(jnp.asarray(x), jnp.asarray(ph), nxp, nxp))
    jmesh = make_mesh(band=1, row=d)
    jout = np.asarray(psf_convolve_sharded(jmesh, jnp.asarray(x), jnp.asarray(psfhat_transposed(ph, d)), nx, nx,
                                           nxp, nxp))
    for r in range(4):
        out = load(ranks, f"conv_{d}_{nx}", r)
        assert out.shape == (nx, nx)
        assert _rel(out, jout) < 1e-10, r
        assert _rel(out, ref) < 1e-10, r


@pytest.mark.parametrize("d", ROWS)
@pytest.mark.parametrize("nx, nxp", GEOMS)
def test_hessian_psf_sharded_matches_jax(ranks, d, nx, nxp):
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops.hessian import hessian_psf
    from pfb_imaging_tpu.parallel.fft import hessian_psf_sharded, psfhat_transposed
    from pfb_imaging_tpu.parallel.mesh import make_mesh

    x, ph, beam = _image_inputs(nx, nxp)
    ref = np.asarray(hessian_psf(jnp.asarray(x), jnp.asarray(ph), nxp, nxp, beam=jnp.asarray(beam), eta=1e-3))
    jout = np.asarray(hessian_psf_sharded(make_mesh(band=1, row=d), jnp.asarray(x),
                                          jnp.asarray(psfhat_transposed(ph, d)), nxp, nxp, beam=jnp.asarray(beam),
                                          eta=1e-3))
    for r in range(4):
        out = load(ranks, f"hess_{d}_{nx}", r)
        assert _rel(out, jout) < 1e-10, r
        assert _rel(out, ref) < 1e-10, r


def test_hessian_cube_rowsharded_matches_jax(ranks):
    """Each rank of the 2 x 2 mesh holds one band; both row ranks of a band
    return it whole; the cube equals JAX's ``_hess_cube_dot_rowsharded``
    (a 2 x 4 mesh there), the port's unsharded cube and JAX's."""
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops.hessian import HessianCube as JH, hess_cube_dot
    from pfb_imaging_tpu.parallel.mesh import make_mesh
    from pfb_imaging_tpu_torch.ops.hessian import HessianCube

    ph, x = _cube_inputs()
    nxp = 2 * NX_CUBE
    jrow = np.asarray(hess_cube_dot(JH.build(ph, WSUMS, 1e-3, nxp, nxp, mesh=make_mesh(band=2, row=4)),
                                    jnp.asarray(x)))
    jref = np.asarray(hess_cube_dot(JH.build(ph, WSUMS, 1e-3, nxp, nxp), jnp.asarray(x)))
    tref = HessianCube.build(ph, WSUMS, 1e-3, nxp, nxp, device="cpu").dot(torch.as_tensor(x)).numpy()
    seen = set()
    for r in range(4):
        b, row = (int(v) for v in load(ranks, "cube_band", r))
        seen.add((b, row))
        out = load(ranks, "cube", r)[0]
        for ref in (jrow[b], jref[b], tref[b]):
            assert _rel(out, ref) < 1e-10, (r, b)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("axes", [dict(row_axis="x"), dict(band_axis="freq")])
def test_hessian_cube_refuses_other_axis_names(axes):
    """The port's mesh has fixed axis names: the JAX signature's
    ``row_axis``/``band_axis`` take only "row" and "band"."""
    from pfb_imaging_tpu_torch.ops.hessian import HessianCube

    ph, _ = _cube_inputs()
    with pytest.raises(ValueError, match="axes are 'row' and 'band'"):
        HessianCube.build(ph, WSUMS, 1e-3, 2 * NX_CUBE, 2 * NX_CUBE, device="cpu", **axes)
