"""The port's ``pfb-torch`` command line against the JAX package's ``pfb``,
on the CPU (``--device cpu``).

Parsing: ``--help`` of every command, the JAX parser's commands and flags;
``--use-mesh`` on one process equals the run without it.
The slice: simulate -> init -> imager -> sara --niter 1 -> restore through
both CLIs at ``recipes/sara.yml``'s size. The stores agree as
tests/test_torch_simulate_init.py requires; DIRTY/PSF to 1e-9 relative
(the stack route in f64); MODEL/RESIDUAL after the cycle to 1e-8 (f64
rounding through CG and primal-dual, as tests/test_torch_deconv.py); the
FITS images to 1e-6 (stored as f32). Both deconvolutions take the JAX
run's spectral norm from the tree's ``hess_norm`` attribute (the packages
start their power methods from different random vectors). The port runs
``recipes/sara.yml`` through its own ``run_recipe``. Last, ``kclean``
(Clark and Hogbom), ``fluxtractor``, ``hci`` and ``deconv --preset ista``
run through both CLIs on copies of one port-made store or tree: their
products to 1e-8 (1e-9 for hci's cube).
"""

import contextlib
import io
import shutil

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
    (["deconv", "x.dt", "--use-mesh"], "parallel/"),
    (["sara", "x.dt", "--use-mesh"], "parallel/"),
])
def test_unported_commands_raise(argv, item, port_store, tmp_path):
    """``--use-mesh`` (the port's ``item``) runs: on one process its mesh is
    one band slice and every collective the identity, so the tree equals a
    run without the flag bit for bit."""
    trees = []
    for tag, flag in (("mesh", ["--use-mesh"]), ("plain", [])):
        dt = tmp_path / tag
        shutil.copytree(port_store[1], dt)
        cli.main([argv[0], str(dt), "--niter", "1", "--cg-maxit", "10", "--pd-maxit", "30", *flag, "--device", "cpu"])
        trees.append(TreeStore(str(dt)))
    assert trees[0].attrs["hess_norm"] == trees[1].attrs["hess_norm"]
    for key in trees[1].groups():
        assert trees[0].group(key).attrs["niters"] == 1
        for name in ("MODEL", "RESIDUAL", "UPDATE", "DUAL"):
            np.testing.assert_array_equal(trees[0].group(key).read(name), trees[1].group(key).read(name))


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


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    """simulate -> init -> imager through the port's CLI (epsilon 1e-7: IDG)."""
    d = tmp_path_factory.mktemp("cmds")
    ms, xds, dt = str(d / "p.ms"), str(d / "p.xds"), str(d / "p.dt")
    for argv in (["simulate", ms, *SIM], ["init", ms, xds], ["imager", xds, dt, "--nband", "2", "--nx", "64"]):
        cli.main(argv + ["--device", "cpu"])
    return xds, dt


def _both(src, tmp_path, argv, copy_attrs=()):
    """Run ``argv`` (with the store or tree as its first argument) through
    the JAX CLI on one copy, then through the port's on another; ``copy_attrs``
    are root attributes the JAX run wrote that the port's run takes over."""
    pj, pt = tmp_path / "j", tmp_path / "t"
    shutil.copytree(src, pj)
    shutil.copytree(src, pt)
    jax_cli.main([argv[0], str(pj), *argv[1:]])
    if copy_attrs:
        TreeStore(str(pt), mode="w").set_attrs(**{k: TreeStore(str(pj)).attrs[k] for k in copy_attrs})
    cli.main([argv[0], str(pt), *argv[1:], "--device", "cpu"])
    return TreeStore(str(pj)), TreeStore(str(pt))


@pytest.mark.parametrize("minor", ["clark", "hogbom"])
def test_kclean_cli_matches_jax(port_store, tmp_path, minor):
    tj, tt = _both(port_store[1], tmp_path, ["kclean", "--niter", "2", "--minor", minor])
    for key in tj.groups():
        nj, nt = tj.group(key), tt.group(key)
        assert nt.attrs["niters"] == nj.attrs["niters"] >= 1
        assert np.abs(nt.read("MODEL")).max() > 0
        for name in ("MODEL", "RESIDUAL"):
            assert _rel(nt.read(name), nj.read(name)) < 1e-8, (key, name)


def test_fluxtractor_cli_matches_jax(port_store, tmp_path):
    tj, tt = _both(port_store[1], tmp_path, ["fluxtractor", "--cg-maxit", "5"])
    for key in tj.groups():
        nj, nt = tj.group(key), tt.group(key)
        for name in ("MODEL_MOPPED", "RESIDUAL_MOPPED", "UPDATE"):
            assert np.isfinite(nt.read(name)).all()
            assert _rel(nt.read(name), nj.read(name)) < 1e-8, (key, name)


def test_hci_cli_matches_jax(port_store, tmp_path):
    xds = port_store[0]
    oj, ot = str(tmp_path / "j.cube"), str(tmp_path / "t.cube")
    jax_cli.main(["hci", xds, oj, "--nx", "64", "--freq-chunks", "2"])
    cli.main(["hci", xds, ot, "--nx", "64", "--freq-chunks", "2", "--device", "cpu"])
    cube = np.asarray(TreeStore(ot).read("CUBE"))
    assert cube.shape == (2, 2, 64, 64) and np.isfinite(cube).all() and np.abs(cube).max() > 0
    for name in ("CUBE", "WSUMS", "TIMES"):
        assert _rel(TreeStore(ot).read(name), TreeStore(oj).read(name)) < 1e-9, name


def test_deconv_ista_cli_matches_jax(port_store, tmp_path):
    tj, tt = _both(port_store[1], tmp_path, ["deconv", "--preset", "ista", "--niter", "1", "--cg-maxit", "20"],
                   copy_attrs=("hess_norm",))
    for key in tj.groups():
        nj, nt = tj.group(key), tt.group(key)
        assert nt.attrs["niters"] == nj.attrs["niters"] == 1 and not nt.has("DUAL")
        assert np.abs(nt.read("MODEL")).max() > 0
        for name in ("MODEL", "RESIDUAL", "UPDATE"):
            assert _rel(nt.read(name), nj.read(name)) < 1e-8, (key, name)
