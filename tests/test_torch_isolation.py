"""The port stands alone: no module of ``pfb_imaging_tpu_torch`` and nothing
in ``chip_smoke.py`` imports ``jax`` or the JAX package, and the entry
points run on the card unless the caller asks for the CPU."""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pfb_imaging_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "pfb_imaging_tpu"


def test_sources_import_nothing_of_jax():
    """Every import statement, at module level or inside a function."""
    bad = []
    for path in [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter: import every module of the port and
    ``chip_smoke``, then look at ``sys.modules``."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import pfb_imaging_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert "pfb_imaging_tpu_torch.parallel.sharded" in names
for m in ("cli", "recipes", "core.simulate", "core.init", "core.restore", "ops.dft", "core.kclean",
          "core.fluxtractor", "core.hci", "deconv.clark", "deconv.hogbom", "opt.forward_backward",
          "models.transients", "ops.precond", "ops.gauss", "ops.mask", "opt.fista", "deconv.nnls", "models.spi",
          "utils.astrometry", "utils.naming", "utils.profiling", "utils.debug", "parallel.mesh", "parallel.fft",
          "parallel.multihost", "ops", "opt", "deconv", "utils.beam", "native"):
    assert "pfb_imaging_tpu_torch." + m in names, m
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pfb_imaging_tpu"))
print(len(names), bad)
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.split()[0]) >= 30


def _entry_points():
    from pfb_imaging_tpu_torch.core.deconv import deconv
    from pfb_imaging_tpu_torch.core.degrid import degrid
    from pfb_imaging_tpu_torch.core.fluxtractor import fluxtractor
    from pfb_imaging_tpu_torch.core.hci import hci
    from pfb_imaging_tpu_torch.core.imager import imager, residual_from_parts, residual_from_parts_multiband
    from pfb_imaging_tpu_torch.core.init import init
    from pfb_imaging_tpu_torch.core.kclean import kclean
    from pfb_imaging_tpu_torch.core.model2comps import model2comps
    from pfb_imaging_tpu_torch.core.restore import restore
    from pfb_imaging_tpu_torch.core.simulate import simulate_vis_store
    from pfb_imaging_tpu_torch.deconv.nnls import nnls
    from pfb_imaging_tpu_torch.deconv.presets import make_ista, make_sara
    from pfb_imaging_tpu_torch.ops.gauss import Gauss
    from pfb_imaging_tpu_torch.ops.mask import Mask
    from pfb_imaging_tpu_torch.ops.precond import HessPSF
    from pfb_imaging_tpu_torch.ops.dft import dirty2vis_dft, vis2dirty_dft
    from pfb_imaging_tpu_torch.ops.gridder import plan_wgridder, wgridder_plan_from_jax
    from pfb_imaging_tpu_torch.ops.gridder_idg import plan_from_jax, plan_idg
    from pfb_imaging_tpu_torch.ops.hessian import HessianCube
    from pfb_imaging_tpu_torch.parallel.mesh import shard_cube, stream_band_stack
    from pfb_imaging_tpu_torch.parallel.multihost import init_distributed
    from pfb_imaging_tpu_torch.parallel.sharded import (plan_idg_multiband_freqs, plan_idg_sharded,
                                                        plan_wgridder_sharded, row_sharded_vis2dirty)
    from pfb_imaging_tpu_torch.recipes import run_recipe
    from pfb_imaging_tpu_torch.utils.restoration import convolve2gaussres, restore_image
    from pfb_imaging_tpu_torch.utils.stokes import weight_data

    return [deconv, imager, residual_from_parts, make_sara, plan_wgridder, wgridder_plan_from_jax, plan_idg,
            plan_from_jax, HessianCube.build, degrid, model2comps, residual_from_parts_multiband,
            plan_idg_multiband_freqs, simulate_vis_store, init, restore, run_recipe, weight_data, dirty2vis_dft,
            vis2dirty_dft, convolve2gaussres, restore_image, kclean, fluxtractor, hci, make_ista, HessPSF, Gauss, Mask,
            nnls, init_distributed, plan_idg_sharded, plan_wgridder_sharded, row_sharded_vis2dirty, shard_cube,
            stream_band_stack]


@pytest.mark.parametrize("fn", _entry_points(), ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_defaults_to_cuda():
    """``cli.main`` takes its device from ``--device``, whose default is the
    card on every command."""
    from pfb_imaging_tpu_torch.cli import make_parser

    parser = make_parser()
    sub = next(a for a in parser._actions if a.dest == "command")
    for name, p in sub.choices.items():
        assert p.get_default("device") == "cuda", name


def test_no_silent_cpu_fallback(tmp_path):
    """Without a card, the default device raises instead of running on the
    CPU; with one, ``resolve_device`` hands the card back."""
    from pfb_imaging_tpu_torch import resolve_device
    from pfb_imaging_tpu_torch.core.degrid import degrid
    from pfb_imaging_tpu_torch.core.fluxtractor import fluxtractor
    from pfb_imaging_tpu_torch.core.hci import hci
    from pfb_imaging_tpu_torch.core.imager import imager
    from pfb_imaging_tpu_torch.cli import main as cli_main
    from pfb_imaging_tpu_torch.core.kclean import kclean
    from pfb_imaging_tpu_torch.core.init import init
    from pfb_imaging_tpu_torch.core.model2comps import model2comps
    from pfb_imaging_tpu_torch.core.restore import restore
    from pfb_imaging_tpu_torch.core.simulate import simulate_vis_store

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imager(str(tmp_path / "missing.xds"), str(tmp_path / "out.dt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        degrid(str(tmp_path / "missing.mds"), str(tmp_path / "missing.ms"), 1e-5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model2comps(str(tmp_path / "missing.dt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_vis_store(str(tmp_path / "x.ms"), nant=3, ntime=1, nchan=1, nx=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init(str(tmp_path / "missing.ms"), str(tmp_path / "x.xds"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore(str(tmp_path / "missing.dt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["restore", str(tmp_path / "missing.dt")])
    for cmd in (kclean, fluxtractor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cmd(str(tmp_path / "missing.dt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hci(str(tmp_path / "missing.xds"), str(tmp_path / "out.cube"))


def test_module_tree_matches_the_jax_package():
    """File for file, apart from the port's kernel build (``kernels/``)."""
    ref = {p.relative_to(ROOT / "pfb_imaging_tpu") for p in (ROOT / "pfb_imaging_tpu").rglob("*.py")}
    port = {p.relative_to(PKG) for p in PKG.rglob("*.py") if p.relative_to(PKG).parts[0] != "kernels"}
    assert port == ref, sorted(map(str, port ^ ref))


def test_init_distributed_never_changes_backend_or_device(tmp_path, monkeypatch):
    """The card by default (raising without one), gloo only on the CPU or
    when asked for, and a backend that cannot start raises."""
    import torch.distributed as dist

    from pfb_imaging_tpu_torch.parallel.multihost import init_distributed

    for var in ("PFB_COORDINATOR", "PFB_NUM_PROCESSES", "PFB_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
                "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    url = f"file://{tmp_path / 'rdv'}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_distributed(url, 1, 0)
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(device="cpu")
    with pytest.raises((RuntimeError, ValueError, AssertionError)):  # torch asserts on an unknown backend
        init_distributed(url, 1, 0, backend="no-such-backend", device="cpu")
    assert not dist.is_initialized()
    init_distributed(url, 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
