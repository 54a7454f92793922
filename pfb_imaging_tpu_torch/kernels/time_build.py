"""Time the kernel build two ways on one machine: ``build.build()`` (one
nvcc per ``csrc/*.cu`` source, all started together, then a link) against
one ``nvcc -shared`` call over every source, in the order parallel, single,
single, parallel, each into an empty directory. Prints one JSON line.

    python -m pfb_imaging_tpu_torch.kernels.time_build
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from pathlib import Path

from . import build


def _parallel(out_dir: str) -> None:
    os.environ["PFB_TORCH_BUILD_DIR"] = out_dir
    build.build()


def _single(out_dir: str) -> None:
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(Path(out_dir) / "lib.so")]
    subprocess.run([*cmd, *map(str, build._sources())], check=True)


def main() -> None:
    seconds = {"parallel": [], "single": []}
    for kind in ("parallel", "single", "single", "parallel"):
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            (_parallel if kind == "parallel" else _single)(out_dir)
            seconds[kind].append(time.perf_counter() - t0)
    print(json.dumps({"build_seconds": seconds, "sources": [s.name for s in build._sources()]}), flush=True)


if __name__ == "__main__":
    main()
