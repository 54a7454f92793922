"""The port's ``pfb-torch`` command line against the JAX package's ``pfb``,
on the CPU (``--device cpu``).

Parsing: ``--help`` of every command, the JAX parser's commands and flags,
and the ``NotImplementedError`` of each command or option the port lacks.
The slice: simulate -> init -> imager -> sara --niter 1 -> restore through
both CLIs at ``recipes/sara.yml``'s size. The stores agree as
tests/test_torch_simulate_init.py requires; DIRTY/PSF to 1e-9 relative
(the stack route in f64); MODEL/RESIDUAL after the cycle to 1e-8 (f64
rounding through CG and primal-dual, as tests/test_torch_deconv.py); the
FITS images to 1e-6 (stored as f32). Both deconvolutions take the JAX
run's spectral norm from the tree's ``hess_norm`` attribute (the packages
start their power methods from different random vectors). Last, the port
runs ``recipes/sara.yml`` through its own ``run_recipe``.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from pfb_imaging_tpu import cli as jax_cli
from pfb_imaging_tpu.utils.fits import load_fits
from pfb_imaging_tpu.utils.store import TreeStore
from pfb_imaging_tpu_torch import cli
from pfb_imaging_tpu_torch.recipes import run_recipe

torch.set_num_threads(1)
COMMANDS = ("simulate", "init", "imager", "grid", "deconv", "sara", "kclean", "restore", "degrid", "fluxtractor",
            "model2comps", "hci")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _flags(parser):
    """{command: sorted option strings} of a parser."""
    sub = next(a for a in parser._actions if a.dest == "command")
    return {name: sorted(s for a in p._actions for s in a.option_strings) for name, p in sub.choices.items()}


@pytest.mark.parametrize("cmd", COMMANDS)
def test_help_parses_for_every_command(cmd):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0 and "--device" in out.getvalue()


def test_parser_has_the_jax_commands_and_flags():
    """Command for command and flag for flag, plus ``--device`` on every
    command."""
    port, ref = _flags(cli.make_parser()), _flags(jax_cli.make_parser())
    assert port.keys() == ref.keys() == set(COMMANDS)
    for name in ref:
        assert port[name] == sorted(ref[name] + ["--device"]), name


@pytest.mark.parametrize("argv, item", [
    (["kclean", "x.dt"], "remaining commands"),
    (["fluxtractor", "x.dt"], "remaining commands"),
    (["hci", "x.xds", "out"], "remaining commands"),
    (["deconv", "x.dt", "--preset", "ista"], "remaining commands"),
    (["deconv", "x.dt", "--use-mesh"], "parallel/"),
    (["sara", "x.dt", "--use-mesh"], "parallel/"),
])
def test_unported_commands_raise(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, queue A: {item}"):
        cli.main(argv + ["--device", "cpu"])


SIM = ["--nant", "12", "--ntime", "2", "--nchan", "4", "--nx", "64", "--noise", "0.1"]
IMAGE = ["--nband", "2", "--nx", "64", "--epsilon", "1e-9"]
SARA = ["--niter", "1", "--epsilon", "1e-9", "--pd-maxit", "100", "--cg-maxit", "30"]


def _slice(main, d, tag, extra=(), hess_norm=None):
    ms, xds, dt = str(d / f"{tag}.ms"), str(d / f"{tag}.xds"), str(d / f"{tag}.dt")
    main(["simulate", ms, *SIM, *extra])
    main(["init", ms, xds, *extra])
    main(["imager", xds, dt, *IMAGE, *extra])
    if hess_norm is not None:
        TreeStore(dt, mode="w").set_attrs(hess_norm=hess_norm)
    main(["sara", dt, *SARA, *extra])
    main(["restore", dt, *extra])
    return TreeStore(dt)


@pytest.fixture(scope="module")
def jax_slice(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return d, _slice(jax_cli.main, d, "j")


def test_slice_matches_jax_cli(jax_slice):
    d, sj = jax_slice
    st = _slice(cli.main, d, "t", extra=["--device", "cpu"], hess_norm=sj.attrs["hess_norm"])
    for a, b in (("t.ms", "j.ms"), ("t.xds", "j.xds")):
        ta, tb = TreeStore(str(d / a)), TreeStore(str(d / b))
        assert ta.groups() == tb.groups()
        for k in ta.groups():
            assert _rel(ta.group(k).read("VIS"), tb.group(k).read("VIS")) < 1e-10
    assert st.groups() == sj.groups()
    for key in sj.groups():
        nt, nj = st.group(key), sj.group(key)
        assert nt.attrs["niters"] == nj.attrs["niters"] == 1
        for name, tol in (("DIRTY", 1e-9), ("PSF", 1e-9), ("MODEL", 1e-8), ("RESIDUAL", 1e-8)):
            assert _rel(nt.read(name), nj.read(name)) < tol, (key, name)
        assert np.abs(nt.read("MODEL")).max() > 0
    for prod in ("model", "model_mfs", "residual", "residual_mfs", "image", "image_mfs"):
        at, _ = load_fits(str(d / f"t_{prod}.fits"), dtype=np.float64)
        aj, _ = load_fits(str(d / f"j_{prod}.fits"), dtype=np.float64)
        assert at.shape == aj.shape and np.isfinite(at).all(), prod
        assert _rel(at, aj) < 1e-6, prod


def test_port_runs_the_sara_recipe(tmp_path):
    run_recipe("recipes/sara.yml", {"out": str(tmp_path)}, device="cpu")
    node = TreeStore(str(tmp_path / "sim_I.dt")).group("band0000_time0000")
    assert node.attrs["niters"] == 2
    for prod in ("model_mfs", "image_mfs"):
        img, _ = load_fits(str(tmp_path / f"sim_I_{prod}.fits"))
        assert img.shape[-2:] == (64, 64) and np.isfinite(img).all() and np.abs(img).max() > 0
    assert not (tmp_path / "sim_I_residual.fits").exists()  # the recipe asks for "MI" only
