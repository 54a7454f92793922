"""Spawned gloo ranks for the port's parallel tests (tests/test_torch_parallel*.py).

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes (the
"spawn" start method, so no JAX state is inherited), each of which sets
``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK``, one torch thread, joins a gloo world
through a ``file://`` rendezvous under ``tmp_path`` (no ports, so pytest
workers never collide) with a 60 s collective timeout, and calls
``fn(rank, world, outdir, *args)``. ``fn`` must be a module-level function
of a module the child can import. The ranks save their outputs with
``np.save`` under ``outdir``; the parent reads them back. Every child is
killed after ``timeout`` seconds, so a hang fails one test instead of the
suite.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback
from pathlib import Path

import numpy as np

COLLECTIVE_TIMEOUT_S = 60.0


def _child(fn, rank: int, world: int, local_world: int, init_file: str, outdir: str, args):
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    os.environ["LOCAL_RANK"] = str(rank % local_world)
    try:
        import torch

        torch.set_num_threads(1)
        from pfb_imaging_tpu_torch.parallel.multihost import init_distributed

        init_distributed(f"file://{init_file}", world, rank, backend="gloo", device="cpu",
                         timeout=COLLECTIVE_TIMEOUT_S)
        fn(rank, world, outdir, *args)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        Path(outdir, f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp_path, *args, local_world: int | None = None, timeout: float = 240.0) -> Path:
    """Run ``fn`` on ``world`` gloo ranks; returns the output directory.
    ``local_world`` ranks share a node (default: all of them)."""
    outdir = Path(tmp_path) / f"ranks_{fn.__name__}"
    outdir.mkdir(parents=True, exist_ok=True)
    init_file = outdir / "rendezvous"
    if init_file.exists():
        init_file.unlink()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, local_world or world, str(init_file), str(outdir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (outdir / f"error_{r}.txt").read_text() for r in range(world) if (outdir / f"error_{r}.txt").exists()}
    assert not hung, f"ranks {hung} still running after {timeout} s; errors: {errors}"
    codes = [p.exitcode for p in procs]
    assert all(c == 0 for c in codes), f"exit codes {codes}; errors: {errors}"
    return outdir


def load(outdir: Path, name: str, rank: int | None = None) -> np.ndarray:
    return np.load(Path(outdir) / (f"{name}_{rank}.npy" if rank is not None else f"{name}.npy"))


def save(outdir, name: str, arr, rank: int | None = None) -> None:
    np.save(Path(outdir) / (f"{name}_{rank}.npy" if rank is not None else f"{name}.npy"), np.asarray(arr))
