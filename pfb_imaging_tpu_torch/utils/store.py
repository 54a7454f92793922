"""On-disk data-product tree — the framework's IR between pipeline stages.

The reference moves all bulk data between processes through zarr stores
(``.xds``/``.dds``/``.dt`` products, SURVEY.md §2.7) with concurrent
writers touching distinct group paths. This image carries no zarr, so the
same design is expressed as a directory tree:

    store/
      .attrs.json
      band0000_time0000/
        .attrs.json
        DIRTY.npy  PSF.npy  WSUM.npy ...
        part0000/
          .attrs.json
          VIS.npy  WEIGHT.npy  UVW.npy ...

Concurrent-writer safety is the reference's by-construction rule
(imager-pipeline.md:131-134): writers own disjoint subtrees; parents are
created up front by the caller. Arrays are .npy (memory-mappable for the
selective per-band loads the band workers do, band_worker.py:61-106).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


class TreeStore:
    """A node in the product tree."""

    def __init__(self, path: str | Path, mode: str = "r"):
        self.path = Path(path)
        self.mode = mode
        if mode == "w":
            self.path.mkdir(parents=True, exist_ok=True)
        elif not self.path.is_dir():
            raise FileNotFoundError(f"No store at {self.path}")

    # ── attrs ────────────────────────────────────────────────────────

    @property
    def attrs(self) -> dict:
        f = self.path / ".attrs.json"
        if f.exists():
            return json.loads(f.read_text())
        return {}

    def set_attrs(self, **kw) -> None:
        attrs = self.attrs
        attrs.update({k: self._jsonable(v) for k, v in kw.items()})
        # atomic replace: a concurrent reader (multi-host peers share the
        # store) must never observe a torn half-written JSON
        tmp = self.path / f".attrs.json.tmp.{os.getpid()}"
        tmp.write_text(json.dumps(attrs, indent=1))
        os.replace(tmp, self.path / ".attrs.json")

    @staticmethod
    def _jsonable(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        return v

    # ── arrays ───────────────────────────────────────────────────────

    def write(self, name: str, array) -> None:
        np.save(self.path / f"{name}.npy", np.asarray(array))

    def read(self, name: str, mmap: bool = False):
        cdir = self.path / f"{name}.chunks"
        if not (self.path / f"{name}.npy").exists() and cdir.is_dir():
            return self._read_chunked(cdir)
        return np.load(self.path / f"{name}.npy", mmap_mode="r" if mmap else None)

    def has(self, name: str) -> bool:
        return (self.path / f"{name}.npy").exists() or (self.path / f"{name}.chunks").is_dir()

    def mtime(self, name: str) -> tuple:
        """(mtime_ns, size) content stamp of an array — cache-key material
        for plan caches keyed on partition content, not just path."""
        st = (self.path / f"{name}.npy").stat()
        return (st.st_mtime_ns, st.st_size)

    def arrays(self) -> list[str]:
        plain = [p.stem for p in self.path.glob("*.npy")]
        chunked = [p.name[: -len(".chunks")] for p in self.path.glob("*.chunks") if p.is_dir()]
        return sorted(set(plain) | set(chunked))

    # ── chunked arrays (incremental/resumable slab writers) ──────────
    # The hci stacked cube analogue of the reference's pre-scaffolded
    # zarr dataset (core/hci.py:741 make_dummy_dataset): the array is
    # declared once, then each (time, chunk) slab is its own .npy chunk
    # file — concurrent writers own disjoint chunks (the store's
    # by-construction rule), a killed run resumes by rewriting missing
    # chunks, and the on-disk format stays TreeStore-consistent
    # (round-3 VERDICT #9: the bare CUBE.npy memmap broke the format).

    def create_chunked(self, name: str, shape: tuple, dtype, chunks: tuple) -> None:
        if len(chunks) != len(shape) or any(s % c for s, c in zip(shape, chunks)):
            raise ValueError(f"chunks {chunks} must tile shape {shape} exactly")
        cdir = self.path / f"{name}.chunks"
        cdir.mkdir(parents=True, exist_ok=True)
        meta = dict(shape=list(shape), dtype=np.dtype(dtype).str, chunks=list(chunks))
        (cdir / ".meta.json").write_text(json.dumps(meta))

    def write_chunk(self, name: str, index: tuple, block) -> None:
        """Write the chunk at grid position ``index`` (one file per chunk)."""
        cdir = self.path / f"{name}.chunks"
        meta = json.loads((cdir / ".meta.json").read_text())
        block = np.asarray(block, dtype=meta["dtype"]).reshape(meta["chunks"])
        np.save(cdir / ("chunk_" + ".".join(str(int(i)) for i in index) + ".npy"), block)

    def _read_chunked(self, cdir) -> np.ndarray:
        meta = json.loads((cdir / ".meta.json").read_text())
        shape, chunks = meta["shape"], meta["chunks"]
        out = np.zeros(shape, dtype=meta["dtype"])  # missing chunks read as 0
        for f in cdir.glob("chunk_*.npy"):
            idx = tuple(int(i) for i in f.stem[len("chunk_"):].split("."))
            sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
            out[sl] = np.load(f)
        return out

    # ── groups ───────────────────────────────────────────────────────

    def group(self, name: str) -> "TreeStore":
        mode = self.mode if (self.path / name).is_dir() or self.mode == "w" else "r"
        return TreeStore(self.path / name, mode="w" if self.mode == "w" else mode)

    def groups(self) -> list[str]:
        return sorted(p.name for p in self.path.iterdir() if p.is_dir())

    def __repr__(self):
        return f"TreeStore({self.path}, groups={self.groups()}, arrays={self.arrays()})"


def band_key(band: int, time: int = 0) -> str:
    """Node naming convention (reference ``band####_time####``)."""
    return f"band{band:04d}_time{time:04d}"


def part_key(part: int) -> str:
    return f"part{part:04d}"


def open_store(path, mode="r") -> TreeStore:
    return TreeStore(path, mode=mode)


def require_complete(store: TreeStore, producer: str = "imager") -> None:
    """Fail fast on trees whose producing run never finished.

    Writers stamp ``complete=True`` as their LAST root-attr write; a killed
    run leaves a structurally-valid tree (band nodes may exist and even be
    empty) that downstream stages would otherwise fail on obscurely.
    """
    if not store.attrs.get("complete", False):
        raise RuntimeError(
            f"{store.path} is missing the completion stamp — the producing "
            f"`{producer}` run did not finish (or predates the stamp); re-run it"
        )
