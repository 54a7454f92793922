"""The exact once-per-major-cycle residual (port of the IDG branch of
``residual_from_parts`` in pfb_imaging_tpu/core/imager.py).

Per partition of a band node: an IDG plan (cached, keyed on the partition
path, its content stamp and the geometry, as the JAX cache is), the masked
weights in group layout, and the gather-free ``hessian_vis_idg`` round trip.
A partition the IDG planner refuses raises — the classic w-stacking
gridder is not ported yet.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from pfb_imaging_tpu.utils.store import TreeStore

from .. import real_dtype, to_device
from ..ops.gridder_idg import hessian_vis_idg, plan_idg, to_group_layout

# the JAX router's slot-padding bound for IDG (core/imager.py)
IDG_MAX_SLOT_FACTOR = 8.0

_PLAN_CACHE: OrderedDict = OrderedDict()
_PLAN_CACHE_CAP = 256
# byte-bounded LRU: a plan for ~4M visibilities holds ~0.3 GB of device tensors
_PLAN_CACHE_BYTES_CAP = 32 << 30
_PLAN_CACHE_BYTES = 0
# planning telemetry (read by chip_smoke.py): plans built and their seconds
PLAN_STATS = {"plans": 0, "seconds": 0.0}


def _cached_nbytes(cached) -> int:
    plan, wgt_g, beam = cached
    return plan.nbytes + sum(t.numel() * t.element_size() for t in (wgt_g, beam) if t is not None)


def _plan_cache_put(key, cached):
    global _PLAN_CACHE_BYTES
    nb = _cached_nbytes(cached)
    while _PLAN_CACHE and (len(_PLAN_CACHE) >= _PLAN_CACHE_CAP or _PLAN_CACHE_BYTES + nb > _PLAN_CACHE_BYTES_CAP):
        _, old = _PLAN_CACHE.popitem(last=False)
        _PLAN_CACHE_BYTES -= _cached_nbytes(old)
    _PLAN_CACHE[key] = cached
    _PLAN_CACHE_BYTES += nb


def _part_stamp(pg: TreeStore) -> tuple:
    """Modification stamps of the arrays a cached plan depends on."""
    stamps = []
    for name in ("UVW", "FREQ", "WEIGHT", "MASK"):
        try:
            stamps.append(pg.mtime(name))
        except (AttributeError, KeyError, OSError):
            stamps.append(None)
    return tuple(stamps)


def _cell_from_root(band_node: TreeStore) -> float:
    return float(TreeStore(band_node.path.parent).attrs["cell_rad"])


def residual_from_parts(band_node: TreeStore, model_b, epsilon: float = 1e-7, do_wgridding: bool = True, *,
                        device):
    """DIRTY - sum_p R_p^H W_p R_p (B_p model) for one band, un-normalised,
    computed on ``device`` and returned as an f64 numpy array."""
    dev = torch.device(device)
    rdt = real_dtype(dev)
    dirty = np.asarray(band_node.read("DIRTY"))
    nx, ny = dirty.shape
    model_t = to_device(model_b, dev, rdt)
    resid = to_device(dirty, dev, rdt)
    for pk in band_node.groups():
        pg = band_node.group(pk)
        key = (str(pg.path), _part_stamp(pg), nx, ny, epsilon, do_wgridding, str(dev))
        cached = _PLAN_CACHE.get(key)
        if cached is None:
            t0 = time.perf_counter()
            cell = band_node.attrs.get("cell_rad", 0.0) or _cell_from_root(band_node)
            plan = plan_idg(
                np.asarray(pg.read("UVW")), np.asarray(pg.read("FREQ")), nx=nx, ny=ny, cellx=cell, celly=cell,
                l0=pg.attrs.get("l0", 0.0), m0=pg.attrs.get("m0", 0.0), epsilon=epsilon,
                do_wgridding=do_wgridding, max_slot_factor=IDG_MAX_SLOT_FACTOR, device=dev,
            )
            wm = np.asarray(pg.read("WEIGHT"), np.float64) * np.asarray(pg.read("MASK"), np.float64)
            wgt_g = to_group_layout(plan, to_device(wm, dev, rdt))
            beam = to_device(pg.read("BEAM"), dev, rdt) if pg.has("BEAM") else None
            cached = (plan, wgt_g, beam)
            _plan_cache_put(key, cached)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            PLAN_STATS["plans"] += 1
            PLAN_STATS["seconds"] += time.perf_counter() - t0
        else:
            _PLAN_CACHE.move_to_end(key)
        plan, wgt_g, beam = cached
        xin = model_t if beam is None else model_t * beam
        resid = resid - hessian_vis_idg(plan, xin, wgt_g=wgt_g)
    return resid.cpu().numpy().astype(np.float64)
