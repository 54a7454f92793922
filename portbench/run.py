#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload meerkat_l_2k.sara --seed 7 --seconds 30 --trace 0

It makes the cell's inputs from ``--seed``, sets up and warms the program
(``setup_s``), measures whole steps until ``--seconds`` have passed, checks
what the steps produced against the plain reference, and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from a
traced window), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines on
standard error). It exits non-zero and prints no result without a CUDA
device, or when JAX or the JAX package is loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a cell's first run there builds."""
    build = root / "build"
    os.environ["PFB_TORCH_BUILD_DIR"] = str(build / "torch_kernels")
    os.environ["PFB_TORCH_FIT_CACHE"] = str(build / "taper_fits.pkl")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import run_cell

    code, result = run_cell(args, T_START)
    if result is None:
        return code or 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
