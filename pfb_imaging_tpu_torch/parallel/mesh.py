"""A ('band', 'row') mesh of ranks and band-sharded cubes (port of
pfb_imaging_tpu/parallel/mesh.py).

A :class:`Mesh` is a small object, not a JAX mesh: its band and row sizes,
this rank's coordinates, the band and row process groups, and the
collectives the solvers call (:meth:`Mesh.band_all_gather`,
:meth:`Mesh.row_all_to_all`, :meth:`Mesh.row_all_gather`,
:meth:`Mesh.all_reduce`). A rank holds the band slice :meth:`Mesh.band_slice`
of every (nband, ...) cube, and the ranks of one row group hold the same
slice. With band and row size 1 every collective is the identity and no
group is made.

The layout: row groups are blocks of consecutive local ranks inside a node
(when the row size divides the ranks per node), and the band axis takes one
block of every node before it takes a second block of any, so it spans the
nodes. As many copies of the band x row grid as the world holds are laid
out one after the other; each copy runs the same program on its own groups,
and a rank beyond the last whole copy is outside the mesh (``in_mesh``
False). gloo takes CUDA tensors for every collective here (``all_reduce``,
``all_gather``, ``all_to_all_single``: the smoke's parallel phase records
it), so no collective stages its tensors through the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import real_dtype, resolve_device, to_device
from ..utils.profiling import count
from . import multihost

__all__ = ["Mesh", "make_mesh", "band_sharding", "band_sum", "shard_cube", "stream_band_stack"]


def _default_order(block: int) -> list:
    """Ranks in blocks of ``block`` consecutive local ranks, the blocks
    taken node-minor (block j of every node before block j + 1 of any).
    Without whole blocks inside a node: the ranks in their order."""
    world, lws = multihost.world_size(), multihost.local_world_size()
    if lws % block:
        return list(range(world))
    nodes = multihost.process_count()
    return [node * lws + j * block + i for j in range(lws // block) for node in range(nodes) for i in range(block)]


class Mesh:
    """This rank's place in a band x row grid of ranks, with its groups."""

    def __init__(self, band: int, row: int, grids: list):
        self.band_size, self.row_size = int(band), int(row)
        self.grids = grids  # one (band, row) array of ranks per copy
        me = multihost.rank()
        self.in_mesh = False
        self.copy_index = self.band_index = self.row_index = 0
        self.band_group = self.row_group = self.group = None
        self._band_order = [0]  # the all_gather slot of each band of this rank's band group
        distributed = multihost.is_distributed()
        # every rank makes every group, in one order (torch.distributed's rule)
        for c, grid in enumerate(grids):
            where = np.argwhere(grid == me)
            mine = where.size > 0
            if mine:
                self.in_mesh, self.copy_index = True, c
                self.band_index, self.row_index = (int(v) for v in where[0])
                # a group's ranks are ordered by rank, not by band
                members = [int(r) for r in grid[:, self.row_index]]
                self._band_order = [sorted(members).index(r) for r in members]
            if not distributed:
                continue
            for j in range(self.row_size):
                g = self._new_group(grid[:, j])
                if mine and j == self.row_index:
                    self.band_group = g
            for i in range(self.band_size):
                g = self._new_group(grid[i, :])
                if mine and i == self.band_index:
                    self.row_group = g
            g = self._new_group(grid.ravel())
            if mine:
                self.group = g
        self.backend = dist.get_backend() if distributed else None

    @staticmethod
    def _new_group(ranks):
        return dist.new_group([int(r) for r in ranks]) if len(ranks) > 1 else None

    @property
    def shape(self) -> dict:
        return {"band": self.band_size, "row": self.row_size}

    @property
    def writes(self) -> bool:
        """Whether this rank's band slice is the one that counts: the first
        row rank of the first copy (every other rank of the slice holds the
        same values), which writes it and contributes it to gathers."""
        return self.in_mesh and self.copy_index == 0 and self.row_index == 0

    def size(self, axes=("band", "row")) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes=("band", "row")) -> int:
        """This rank's shard index along the flattened ``axes`` (band-major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes == ("band", "row"):
            return self.band_index * self.row_size + self.row_index
        return self.band_index if axes == ("band",) else self.row_index

    def _group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes == ("band", "row"):
            return self.group
        return self.band_group if axes == ("band",) else self.row_group

    def band_slice(self, nband: int) -> slice:
        """The bands this rank holds of an ``nband`` cube."""
        if nband % self.band_size:
            raise ValueError(f"{nband} bands do not split over a {self.band_size}-way band axis")
        nb = nband // self.band_size
        return slice(self.band_index * nb, (self.band_index + 1) * nb)

    # ── collectives ──────────────────────────────────────────────────

    def all_reduce(self, t: torch.Tensor, axes=("band", "row")) -> torch.Tensor:
        """Sum ``t`` over ``axes`` (in place when it is contiguous); returns
        the sum."""
        if self.size(axes) == 1:
            return t
        t = multihost.counted("all_reduce", t.contiguous())
        dist.all_reduce(t, group=self._group(axes))
        return t

    def band_all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(nb, ...) -> (nband, ...): every band slice of the band group,
        in band order."""
        if self.band_size == 1:
            return t
        t = multihost.counted("all_gather", t.contiguous())
        parts = [torch.empty_like(t) for _ in range(self.band_size)]
        dist.all_gather(parts, t, group=self.band_group)
        return torch.cat([parts[k] for k in self._band_order])

    def row_all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """(d, ...) -> (d, ...) over the row group: chunk i goes to row
        rank i, and chunk i of the result came from row rank i."""
        if self.row_size == 1:
            return t
        t = multihost.counted("all_to_all", t.contiguous())
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.row_group)
        return out

    def row_all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(...) -> (d, ...): every row rank's ``t``, in row order."""
        if self.row_size == 1:
            return t[None]
        t = multihost.counted("all_gather", t.contiguous())
        parts = [torch.empty_like(t) for _ in range(self.row_size)]
        dist.all_gather(parts, t, group=self.row_group)
        return torch.stack(parts)


def make_mesh(band: int | None = None, row: int = 1, ranks=None) -> Mesh:
    """A ('band', 'row') mesh.

    Args:
        band: size of the band axis (defaults to the ranks / row).
        row: size of the row axis.
        ranks: the ranks of one copy, band-major (defaults to the layout in
            the module docstring, as many copies as the world holds).
    """
    pool = list(ranks) if ranks is not None else _default_order(row)
    if band is None:
        band = len(pool) // row
    n = band * row
    if n > len(pool) or n < 1:
        raise ValueError(f"mesh {band}x{row} needs {n} ranks, have {len(pool)}")
    ncopy = 1 if ranks is not None else len(pool) // n
    grids = [np.asarray(pool[c * n:(c + 1) * n]).reshape(band, row) for c in range(ncopy)]
    return Mesh(band, row, grids)


def band_sharding(mesh: Mesh | None, nband: int) -> slice:
    """This rank's slice of an (nband, ...) cube."""
    return slice(0, nband) if mesh is None else mesh.band_slice(nband)


def band_sum(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum over axis 0 of the band-sharded cube whose slice (nb, ...) is
    ``t``: every band gathered, then added one at a time in band order. A
    sum over ranks would add the bands in another order for every band
    split, and the solvers turn such last-bit differences into visible
    ones; this way every rank and every split, one rank included, gets the
    same bits. Counts the bands it adds up as ``band.sum``."""
    if mesh is not None and mesh.band_size > 1:
        t = mesh.band_all_gather(t)
    count("band.sum", t.shape[0])
    out = t[0]
    for i in range(1, t.shape[0]):
        out = out + t[i]
    return out


def shard_cube(mesh: Mesh | None, cube, *, device="cuda", dtype=None) -> torch.Tensor:
    """This rank's band slice of a full (nband, ...) cube, on ``device``."""
    dev = resolve_device(device)
    cube = cube[band_sharding(mesh, cube.shape[0])]
    if torch.is_tensor(cube):
        return cube.to(device=dev, dtype=dtype or cube.dtype)
    return to_device(cube, dev, dtype or real_dtype(dev))


def stream_band_stack(mesh: Mesh | None, loaders, *, device="cuda", dtype=None, row_axis: int | None = None):
    """This rank's band slice of a band-sharded cube without the full host
    stack: only this rank's loaders run, each band goes to the device and
    its host copy is dropped before the next load. With ``row_axis``, each
    band is cut to this rank's 1/row share of that axis (the row-sharded
    |PSFHAT|).

    Args:
        loaders: zero-argument callables, one per band, each returning a
            numpy array of the per-band shape.
    """
    dev = resolve_device(device)
    dtype = dtype or real_dtype(dev)
    nband = len(loaders)
    out = None
    for i, b in enumerate(range(nband)[band_sharding(mesh, nband)]):
        arr = np.asarray(loaders[b]())
        if row_axis is not None and mesh is not None and mesh.row_size > 1:
            ax = row_axis % arr.ndim
            n = arr.shape[ax] // mesh.row_size
            arr = np.take(arr, np.arange(mesh.row_index * n, (mesh.row_index + 1) * n), axis=ax)
        t = to_device(arr, dev, dtype)
        if out is None:
            nb = band_sharding(mesh, nband)
            out = torch.empty((nb.stop - nb.start,) + tuple(t.shape), dtype=dtype, device=dev)
        out[i] = t
        del arr, t
    return out
