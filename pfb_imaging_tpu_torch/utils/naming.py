"""Output naming conventions and the options cache (a copy of
pfb_imaging_tpu/utils/naming.py).

Products: ``{output_filename}_{product}[_{suffix}].{ext}`` with extensions
``.xds`` (Stokes vis pieces), ``.dt`` (image tree), ``.mds`` (component
model), all TreeStore directories, and ``.fits``.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path


def output_name(output_filename: str, product: str, suffix: str = "", ext: str = "dt") -> str:
    base = f"{output_filename}_{product.upper()}"
    if suffix:
        base = f"{base}_{suffix}"
    return f"{base}.{ext}"


def cache_opts(opts: dict, url: str) -> None:
    """Pickle a command's options next to the product for cache validation
    (reference naming.py:151-178 / core/grid.py:197-227)."""
    path = Path(url) / "opts.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(opts, f)


def get_opts(url: str) -> dict | None:
    path = Path(url) / "opts.pkl"
    if not path.exists():
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def opts_match(opts: dict, url: str, ignore=("nworkers", "nthreads", "verbosity")) -> bool:
    """True when a cached product was produced with compatible options."""
    cached = get_opts(url)
    if cached is None:
        return False
    a = {k: v for k, v in opts.items() if k not in ignore}
    b = {k: v for k, v in cached.items() if k not in ignore}
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)
