"""Self-contained zarr v2 store access, numpy only (a copy of
pfb_imaging_tpu/utils/zarrio.py, so the port imports nothing of the JAX
package).

It implements the zarr v2 on-disk format directly, without the zarr or
numcodecs packages: enough to read (and, for tests, write) the stores the
MSv4 tooling produces:

  * consolidated (``.zmetadata``) and per-array (``.zarray``/``.zattrs``)
    metadata, group trees (``.zgroup``);
  * C/F chunk order, ``.`` and ``/`` dimension separators, edge-chunk
    trimming, ``fill_value`` for missing chunks;
  * codecs: ``null``, ``zlib``, ``gzip``, ``zstd`` (when the zstandard
    package is installed) and ``blosc`` with byte-shuffle and zstd/zlib
    inner codecs (the c-blosc1 frame: 16-byte header, per-block offsets,
    per-split 4-byte lengths). LZ4-compressed blosc raises a clear error.

Writing (``write_array``) covers the same layout with zstd/zlib/null
codecs; ``degrid`` writes MODEL_DATA into MSv4 targets through it.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover - without zstandard, zstd chunks raise and writes use zlib
    _zstd = None

__all__ = ["ZArray", "ZGroup", "open_zarr", "write_array", "write_group"]


# ── codecs ───────────────────────────────────────────────────────────


def _zstd_decompress(buf, nbytes_hint=None):
    if _zstd is None:
        raise RuntimeError("zstandard not available")
    d = _zstd.ZstdDecompressor()
    try:
        return d.decompress(buf)
    except _zstd.ZstdError:
        # frames without content size in the header need max_output_size
        return d.decompress(buf, max_output_size=int(nbytes_hint or (len(buf) * 64 + 1 << 20)))


def _unshuffle(buf: bytes, typesize: int) -> bytes:
    """Undo blosc byte-shuffle: buf holds all byte-0s, then byte-1s, ..."""
    n = len(buf) // typesize
    arr = np.frombuffer(buf[: n * typesize], np.uint8).reshape(typesize, n)
    out = np.empty((n, typesize), np.uint8)
    out[:] = arr.T
    tail = buf[n * typesize :]
    return out.tobytes() + tail


def _shuffle(buf: bytes, typesize: int) -> bytes:
    n = len(buf) // typesize
    arr = np.frombuffer(buf[: n * typesize], np.uint8).reshape(n, typesize)
    return np.ascontiguousarray(arr.T).tobytes() + buf[n * typesize :]


_BLOSC_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}


def _blosc_decompress(frame: bytes) -> bytes:
    """Decode a c-blosc1 frame (header + bstarts + per-split streams)."""
    if len(frame) < 16:
        raise ValueError("short blosc frame")
    version, _vlz, flags, typesize = frame[0], frame[1], frame[2], frame[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", frame, 4)
    if nbytes == 0:
        return b""
    memcpyed = bool(flags & 0x4)
    if memcpyed:
        return frame[16 : 16 + nbytes]
    codec = _BLOSC_CODECS.get(flags >> 5, "?")
    if codec in ("lz4", "snappy", "blosclz"):
        raise ValueError(
            f"blosc inner codec {codec!r} is not available in this environment "
            "(re-write the store with zstd/zlib/no compression)"
        )
    shuffled = bool(flags & 0x1)
    bitshuf = bool(flags & 0x2)
    if bitshuf:
        raise ValueError("blosc bit-shuffle not supported")
    nblocks = -(-nbytes // blocksize)
    bstarts = struct.unpack_from(f"<{nblocks}I", frame, 16)
    # blosc splits a shuffled block into `typesize` streams when the
    # blocksize is divisible; each stream: 4-byte cbytes + codec data
    out = bytearray()
    for i in range(nblocks):
        bsize = min(blocksize, nbytes - i * blocksize)
        nsplits = typesize if (shuffled and typesize > 1 and bsize % typesize == 0) else 1
        ssize = bsize // nsplits
        pos = bstarts[i]
        block = bytearray()
        for _ in range(nsplits):
            (csize,) = struct.unpack_from("<I", frame, pos)
            pos += 4
            raw = bytes(frame[pos : pos + csize])
            pos += csize
            if csize == ssize:  # stored uncompressed
                part = raw
            elif codec == "zstd":
                part = _zstd_decompress(raw, ssize)
            else:
                part = zlib.decompress(raw)
            block += part
        if shuffled and typesize > 1:
            block = _unshuffle(bytes(block), typesize)
        out += block
    return bytes(out[:nbytes])


def _decompress(buf: bytes, comp: dict | None, nbytes: int) -> bytes:
    if comp is None:
        return buf
    cid = comp.get("id")
    if cid in (None, "null"):
        return buf
    if cid == "zlib":
        return zlib.decompress(buf)
    if cid == "gzip":
        return zlib.decompress(buf, 16 + zlib.MAX_WBITS)
    if cid == "zstd":
        return _zstd_decompress(buf, nbytes)
    if cid == "blosc":
        return _blosc_decompress(buf)
    raise ValueError(f"unsupported zarr compressor {cid!r}")


def _compress(buf: bytes, comp: dict | None) -> bytes:
    if comp is None or comp.get("id") in (None, "null"):
        return buf
    cid = comp["id"]
    if cid == "zlib":
        return zlib.compress(buf, comp.get("level", 5))
    if cid == "zstd":
        return _zstd.ZstdCompressor(level=comp.get("level", 3)).compress(buf)
    raise ValueError(f"write: unsupported compressor {cid!r}")


# ── store model ──────────────────────────────────────────────────────


class ZArray:
    """Lazy zarr v2 array: meta now, chunks on ``[...]`` / ``read()``."""

    def __init__(self, root: str, path: str, meta: dict, attrs: dict):
        self._root = root
        self._path = path
        self.meta = meta
        self.attrs = attrs
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.order = meta.get("order", "C")
        self.fill_value = meta.get("fill_value", 0)
        if meta.get("filters"):
            raise ValueError(f"zarr filters not supported ({self._path})")

    def __getitem__(self, idx):
        return self.read()[idx]

    def read(self) -> np.ndarray:
        sep = self.meta.get("dimension_separator", ".")
        fill = self.fill_value
        if fill is None:
            fill = 0
        if fill == "NaN":
            fill = np.nan
        out = np.full(self.shape, fill, self.dtype)
        if out.size == 0:
            return out
        ndim = max(1, len(self.shape))
        grid = [max(1, -(-s // c)) for s, c in zip(self.shape, self.chunks)] or [1]
        cshape = self.chunks or (1,)
        for ci in np.ndindex(*grid):
            name = sep.join(str(i) for i in (ci if self.shape else (0,)))
            fp = os.path.join(self._root, self._path, name)
            if not os.path.exists(fp):
                continue
            with open(fp, "rb") as f:
                buf = f.read()
            nbytes = int(np.prod(cshape)) * self.dtype.itemsize
            raw = _decompress(buf, self.meta.get("compressor"), nbytes)
            chunk = np.frombuffer(raw, self.dtype, count=int(np.prod(cshape)))
            chunk = chunk.reshape(cshape, order=self.order)
            sl = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(ci, self.chunks, self.shape)
            )
            trim = tuple(slice(0, s.stop - s.start) for s in sl)
            out[sl] = chunk[trim]
        return out


class ZGroup:
    """A zarr v2 group: child groups + arrays, attrs."""

    def __init__(self, root: str, path: str = "", meta: dict | None = None):
        self._root = root
        self._path = path
        self._meta = meta if meta is not None else _load_meta(root)
        key = f"{path}/.zattrs" if path else ".zattrs"
        self.attrs = self._meta.get(key, {})

    def _child_names(self):
        prefix = f"{self._path}/" if self._path else ""
        kids = set()
        for key in self._meta:
            if key.startswith(prefix):
                rest = key[len(prefix):]
                if "/" in rest:
                    kids.add(rest.split("/", 1)[0])
        return sorted(kids)

    def groups(self):
        out = []
        for name in self._child_names():
            p = f"{self._path}/{name}" if self._path else name
            if f"{p}/.zgroup" in self._meta:
                out.append(name)
        return out

    def arrays(self):
        out = []
        for name in self._child_names():
            p = f"{self._path}/{name}" if self._path else name
            if f"{p}/.zarray" in self._meta:
                out.append(name)
        return out

    def group(self, name: str) -> "ZGroup":
        p = f"{self._path}/{name}" if self._path else name
        if f"{p}/.zgroup" not in self._meta:
            raise KeyError(f"no zarr group {p!r}")
        return ZGroup(self._root, p, self._meta)

    def array(self, name: str) -> ZArray:
        p = f"{self._path}/{name}" if self._path else name
        meta = self._meta.get(f"{p}/.zarray")
        if meta is None:
            raise KeyError(f"no zarr array {p!r}")
        return ZArray(self._root, p, meta, self._meta.get(f"{p}/.zattrs", {}))

    def __contains__(self, name: str) -> bool:
        p = f"{self._path}/{name}" if self._path else name
        return f"{p}/.zarray" in self._meta or f"{p}/.zgroup" in self._meta


def _load_meta(root: str) -> dict:
    """Consolidated metadata if present, else walk the directory tree."""
    zm = os.path.join(root, ".zmetadata")
    if os.path.exists(zm):
        with open(zm) as f:
            return json.load(f)["metadata"]
    meta = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        rel = "" if rel == "." else rel.replace(os.sep, "/")
        for fn in filenames:
            if fn in (".zgroup", ".zarray", ".zattrs"):
                key = f"{rel}/{fn}" if rel else fn
                with open(os.path.join(dirpath, fn)) as f:
                    meta[key] = json.load(f)
    if not meta:
        raise ValueError(f"{root!r} is not a zarr v2 store")
    return meta


def open_zarr(path: str) -> ZGroup:
    """Open a zarr v2 store (directory) as a group tree."""
    if os.path.exists(os.path.join(path, "zarr.json")):
        raise ValueError(
            f"{path!r} is a zarr v3 store; only the v2 layout the MSv4 "
            "tooling writes is supported"
        )
    return ZGroup(path)


def is_zarr_store(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f))
        for f in (".zmetadata", ".zgroup", "zarr.json")
    )


# ── minimal writer (tests + exports) ─────────────────────────────────


def write_group(root: str, path: str = "", attrs: dict | None = None):
    d = os.path.join(root, path) if path else root
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    if attrs:
        with open(os.path.join(d, ".zattrs"), "w") as f:
            json.dump(attrs, f)


def write_array(root: str, path: str, data: np.ndarray, chunks=None,
                compressor: dict | None = {"id": "zstd", "level": 3},
                attrs: dict | None = None):
    """Write one zarr v2 array (C order, '.' separator)."""
    data = np.asarray(data)
    if chunks is None:
        chunks = data.shape or (1,)
    chunks = tuple(int(min(c, s)) for c, s in zip(chunks, data.shape)) or (1,)
    if _zstd is None and compressor and compressor.get("id") == "zstd":
        compressor = {"id": "zlib", "level": 5}
    d = os.path.join(root, path)
    os.makedirs(d, exist_ok=True)
    meta = {
        "zarr_format": 2,
        "shape": list(data.shape),
        "chunks": list(chunks),
        "dtype": data.dtype.str,
        "order": "C",
        "fill_value": None,
        "filters": None,
        "compressor": compressor,
        "dimension_separator": ".",
    }
    with open(os.path.join(d, ".zarray"), "w") as f:
        json.dump(meta, f)
    if attrs:
        with open(os.path.join(d, ".zattrs"), "w") as f:
            json.dump(attrs, f)
    grid = [max(1, -(-s // c)) for s, c in zip(data.shape, chunks)] or [1]
    for ci in np.ndindex(*grid):
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(ci, chunks, data.shape))
        block = data[sl]
        if block.shape != tuple(chunks):  # pad edge chunks to full size
            full = np.zeros(chunks, data.dtype)
            full[tuple(slice(0, e) for e in block.shape)] = block
            block = full
        buf = _compress(np.ascontiguousarray(block).tobytes(), compressor)
        name = ".".join(str(i) for i in (ci if data.shape else (0,)))
        with open(os.path.join(d, name), "wb") as f:
            f.write(buf)


def consolidate(root: str):
    """Write .zmetadata from the on-disk tree (xarray-compatible)."""
    meta = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        rel = "" if rel == "." else rel.replace(os.sep, "/")
        for fn in filenames:
            if fn in (".zgroup", ".zarray", ".zattrs"):
                key = f"{rel}/{fn}" if rel else fn
                with open(os.path.join(dirpath, fn)) as f:
                    meta[key] = json.load(f)
    with open(os.path.join(root, ".zmetadata"), "w") as f:
        json.dump({"metadata": meta, "zarr_consolidated_format": 1}, f)
