"""Multi-process runs over ``torch.distributed`` (port of
pfb_imaging_tpu/parallel/multihost.py).

JAX has two levels, processes (hosts) and the devices inside one program;
PyTorch runs one process per GPU. The port maps them so:

* a JAX **process** is a torch **node**: the ranks that share a host, from
  torchrun's ``LOCAL_WORLD_SIZE`` (1 per rank when it is unset), so
  :func:`process_index` / :func:`process_count` are the node index and the
  node count, and bands owned "by process" are owned by node;
* a JAX **device** is a torch **rank**: a mesh (``parallel/mesh.py``) lays
  its row groups inside a node and its band axis across nodes.

Every helper is the identity when no process group is initialised or the
world has one rank, so a single-process run takes the code path it takes
without this module. Collectives on host data (``allsum``,
``host_gather``) run on the CPU under gloo and on the card under NCCL.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils.profiling import count

__all__ = [
    "init_distributed",
    "is_distributed",
    "is_multihost",
    "world_size",
    "rank",
    "local_rank",
    "local_world_size",
    "process_index",
    "process_count",
    "owned_items",
    "rank_items",
    "owned_band_slices",
    "barrier",
    "host_gather",
    "allsum",
    "spanning_devices",
]

# the process group's timeout when the caller gives none (seconds)
DEFAULT_TIMEOUT_S = 600.0
# ranks per node, read from LOCAL_WORLD_SIZE by ``init_distributed``
_LOCAL = {"size": 1, "rank": 0}


def _env_int(*names):
    for n in names:
        if os.environ.get(n) not in (None, ""):
            return int(os.environ[n])
    return None


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str | None = None, device="cuda",
                     timeout: float | None = None) -> None:
    """Join this process into a ``torch.distributed`` world.

    The arguments default to ``PFB_COORDINATOR`` / ``PFB_NUM_PROCESSES`` /
    ``PFB_PROCESS_ID`` (as in the JAX package), then to torchrun's
    ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.
    ``num_processes`` is the world size and ``process_id`` this rank. The
    coordinator is ``host:port`` (a TCP rendezvous), or a ``tcp://`` or
    ``file://`` URL. ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` give the node
    layout (one rank per node when unset).

    ``backend`` defaults to "nccl" on the card and "gloo" on the CPU; a
    caller that puts several ranks on one card passes "gloo" and a device
    with its index (e.g. "cuda:0"). On the card this calls
    ``torch.cuda.set_device``: the device's index, else ``LOCAL_RANK``. A
    backend that fails to start raises; there is no fallback to another.
    ``timeout`` (seconds) bounds every collective."""
    ca = coordinator_address or os.environ.get("PFB_COORDINATOR")
    nproc = num_processes if num_processes is not None else _env_int("PFB_NUM_PROCESSES", "WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int("PFB_PROCESS_ID", "RANK")
    if ca is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        ca = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if ca is None or nproc is None or pid is None:
        raise ValueError("init_distributed needs a coordinator, the world size and this rank (arguments, "
                         "PFB_* or torchrun's variables)")
    init_method = ca if "://" in ca else f"tcp://{ca}"
    dev = resolve_device(device)
    lrank = _env_int("LOCAL_RANK")
    lsize = _env_int("LOCAL_WORLD_SIZE")
    _LOCAL["size"] = lsize if lsize is not None else 1
    _LOCAL["rank"] = lrank if lrank is not None else (int(pid) % _LOCAL["size"])
    if int(nproc) % _LOCAL["size"]:
        raise ValueError(f"world size {nproc} is not a whole number of nodes of {_LOCAL['size']} ranks")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else _LOCAL["rank"]
        torch.cuda.set_device(index)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend, init_method=init_method, world_size=int(nproc), rank=int(pid),
                            timeout=datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_S), **kw)


def is_distributed() -> bool:
    """A process group with more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_world_size() -> int:
    """Ranks per node (``LOCAL_WORLD_SIZE`` at ``init_distributed``; 1 without a group)."""
    return _LOCAL["size"] if world_size() > 1 else 1


def local_rank() -> int:
    return rank() % local_world_size()


def process_index() -> int:
    """This rank's node (JAX's process index)."""
    return rank() // local_world_size()


def process_count() -> int:
    """The number of nodes (JAX's process count)."""
    return world_size() // local_world_size()


def is_multihost() -> bool:
    """More than one node, as JAX's ``process_count() > 1``."""
    return process_count() > 1


def owned_items(items, pid: int | None = None, nproc: int | None = None) -> list:
    """Round-robin assignment of work items (bands, partitions) to this
    node: deterministic and disjoint-covering across nodes."""
    pid = process_index() if pid is None else pid
    nproc = process_count() if nproc is None else nproc
    return [it for i, it in enumerate(items) if i % nproc == pid]


def rank_items(items) -> list:
    """This rank's share of :func:`owned_items`: the node's items split
    round-robin over its local ranks."""
    return owned_items(owned_items(items), local_rank(), local_world_size())


def owned_band_slices(local, mesh) -> list[tuple[int, np.ndarray]]:
    """(band_index, host value) pairs of this rank's band slice ``local``
    (nb, ...) of a band-sharded cube over ``mesh``: the write-back path.
    Ranks of one band slice hold the same values, so only the first row
    rank of the first copy returns them (one writer per band)."""
    if mesh is not None and not mesh.writes:
        return []
    b0 = 0 if mesh is None else mesh.band_index * local.shape[0]
    arr = local.cpu().numpy() if torch.is_tensor(local) else np.asarray(local)
    return [(b0 + i, arr[i]) for i in range(arr.shape[0])]


def barrier(name: str = "pfb") -> None:
    """Sync point of every rank (before completion stamps and shared
    writes); ``name`` labels it in logs."""
    if is_distributed():
        dist.barrier()


def _comm_device() -> torch.device:
    """Where world collectives on host data run: the card under NCCL, the
    CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def counted(kind: str, t: torch.Tensor) -> torch.Tensor:
    """``t``, the operand of a collective of ``kind``, counted by the
    recorder as ``collective.<kind>`` and its bytes as
    ``collective.<kind>.bytes``."""
    count("collective." + kind)
    count("collective." + kind + ".bytes", t.numel() * t.element_size())
    return t


def allsum(x) -> np.ndarray:
    """Sum a host numpy array over every rank (disjoint per-rank band
    contributions -> the full cube on every rank). The identity on one
    rank."""
    x = np.asarray(x)
    if not is_distributed():
        return x
    t = counted("all_reduce", torch.from_numpy(np.ascontiguousarray(x)).to(_comm_device()))
    dist.all_reduce(t)
    return t.cpu().numpy()


def host_gather(local, mesh, shape) -> np.ndarray:
    """The full cube of ``shape`` (nband, ...) on every rank, from each
    rank's band slice ``local`` of ``mesh`` (None on a rank outside the
    mesh): a sum over the world to which the first row rank of the first
    copy of each band slice contributes it and every other rank zeros, so
    every rank gets the same bits. Without a mesh or on one rank: ``local``
    as numpy."""
    if not is_distributed() or mesh is None:
        return local.cpu().numpy() if torch.is_tensor(local) else np.asarray(local)
    full = np.zeros(shape)
    if mesh.writes:
        full[mesh.band_slice(shape[0])] = local.cpu().numpy()
    return allsum(full)


def spanning_devices(n: int) -> list:
    """``n`` ranks ordered node-minor: the first local rank of every node,
    then the second of every node, and so on. A small band axis built from
    this order touches every node whenever n >= process_count (the JAX
    package's device order, whose prefix lands on process 0 only)."""
    lws, nodes = local_world_size(), process_count()
    order = [node * lws + i for i in range(lws) for node in range(nodes)]
    if n > len(order):
        raise ValueError(f"need {n} ranks, have {len(order)}")
    return order[:n]
