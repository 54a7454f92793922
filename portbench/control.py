#!/usr/bin/env python3
"""The control of a cell's check: one run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the program's readings), then the plain
reference computed in the next lower precision in the program's place and
judged by the same numbers, and each fault's answers (``cells.FAULTS``) at
the cell's size. Prints the result line with ``control`` and ``faults``
added.

    python3 portbench/control.py --workload meerkat_l_2k.residual --seed 11 --seconds 5

The limits under ``limits/`` are set between the program's readings and the
control's over three seeds or more (PERF.md).
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.run import ROOT, cache_dirs  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    args.trace = 0
    cache_dirs(ROOT)
    from portbench.harness import run_cell

    code, result = run_cell(args, T_START, with_control=True)
    if result is None:
        return code or 1
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
