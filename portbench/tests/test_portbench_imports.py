"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level names, and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

HERE = Path(harness.__file__).resolve().parent


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_compared_whole():
    assert harness.forbidden_loaded(["pfb_imaging_tpu_torch", "pfb_imaging_tpu_torch.ops.gridder_idg"]) == []
    assert harness.forbidden_loaded(["jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_loaded(["pfb_imaging_tpu.ops", "jaxlib.xla_client", "jax", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "pfb_imaging_tpu"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "data.py", "roofline.py"):
        assert "pfb_imaging_tpu_torch" not in _imports(HERE / name), name


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); from portbench.tests.tiny import tiny_run; "
            "from portbench.harness import forbidden_loaded; import torch; torch.set_num_threads(1); "
            "rc, res = tiny_run('meerkat_l_2k.residual'); assert rc == 0 and res['correct'], res; "
            "print('LOADED', forbidden_loaded())") % str(HERE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
