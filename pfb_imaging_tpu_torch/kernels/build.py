"""Build and load the hand-written CUDA kernels of ``csrc/``.

At first use, one ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17
-O3 -Xcompiler -fPIC -c`` per ``csrc/*.cu`` source, all started together,
compiles the objects, and one ``nvcc -shared`` links them into a library
with a plain C interface, which is loaded with ``ctypes`` (pointers and the
stream pass as ``c_void_p``). The library's name carries a hash of the
sources, so an edited kernel is rebuilt. Output goes to
``build/torch_kernels/`` at the repository root (``PFB_TORCH_BUILD_DIR``
overrides it). A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("PFB_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "torch_kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libpfb_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, sources = nvcc_path(), _sources()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all started together
            list(pool.map(lambda src, obj: subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                                          check=True), sources, objs))
        lib = Path(tmp) / out.name
        subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)], check=True)
        os.replace(lib, out)
    return out


def load():
    """The loaded kernel library (built at first call), with its C signatures."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _load()
    return _LIB


def _load():
    lib = ctypes.CDLL(str(build()))
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.pfb_patches_from_vals.argtypes = [vp, vp, vp, vp, vp, ll, i, vp]
    lib.pfb_patches_from_vals.restype = i
    lib.pfb_vals_from_patches.argtypes = [vp, vp, vp, vp, vp, ll, i, vp]
    lib.pfb_vals_from_patches.restype = i
    # act, nact, blk_start, blk_count, ch_qa, ch_nq, ch_off, nq_max, cmp_ptr,
    # cmp_blk, cmp_oxy, per-vis lu, lv, du, dv, wrel, vre, vim, scratch, out;
    # W, beta, nbig_x, nbig_y, ntx, nty, w_support, do_w, p0, nw, stream
    lib.pfb_scatter_grid_wstack.argtypes = [vp, i] + [vp] * 5 + [i] + [vp] * 12 + [i, f, i, i, i, i, i, i, i, i, vp]
    lib.pfb_scatter_grid_wstack.restype = i
    # act, nact, blk_tile, blk_start, blk_count, ch_qa, ch_nq, nq_max, per-vis
    # lu, lv, du, dv, wrel, grids, acc; nvis, W, beta, nbig_x, nbig_y, nty,
    # w_support, do_w, p0, stream
    lib.pfb_gather_grid_wstack.argtypes = [vp, i, vp, vp, vp, vp, vp, i] + [vp] * 7 + [ll, i, f, i, i, i, i, i, i, vp]
    lib.pfb_gather_grid_wstack.restype = i
    # patches, cstride, order (or NULL), chunks, nchunk, partials, pstride, S, stream
    lib.pfb_idg_chunk_sums.argtypes = [vp, ll, vp, vp, i, vp, ll, i, vp]
    lib.pfb_idg_chunk_sums.restype = i
    # patches, cstride, order (or NULL), starts, first (or NULL), partials (or
    # NULL), pstride, pstarts (or NULL), c0, grid; nbig_x, nbig_y, S, half,
    # k0_off, nbu, nbv, stream
    lib.pfb_idg_assemble.argtypes = [vp, ll, vp, vp, vp, vp, ll, vp, i, vp] + [i] * 7 + [vp]
    lib.pfb_idg_assemble.restype = i
    # grid, bid, patches, cstride, gc; S, half, k0_off, nbv, nbig_x, nbig_y, stream
    lib.pfb_idg_extract.argtypes = [vp, vp, vp, ll, ll] + [i] * 6 + [vp]
    lib.pfb_idg_extract.restype = i
    lib.pfb_error_string.argtypes = [i]
    lib.pfb_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError()."""
    if code != 0:
        msg = "unsupported arguments" if code == -1 else load().pfb_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (code {code})")
