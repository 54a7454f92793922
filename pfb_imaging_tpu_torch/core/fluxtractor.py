"""``fluxtractor``: the flux mop, a per-band CG against the exact vis-space
Hessian inside a mask (port of pfb_imaging_tpu/core/fluxtractor.py).

Solves ``(mask R^H W R mask / wsum + eta) x = mask * residual / wsum`` per
band, with ``R`` the classic ES w-stacking gridder of every partition
(``ops/gridder.py``, plain torch, as the JAX package computes this path
outside any Pallas kernel), and writes UPDATE, MODEL_MOPPED and, from the
exact residual of the mopped model (``residual_from_parts``: IDG where its
envelope covers ``epsilon``), RESIDUAL_MOPPED into the tree.

Departure from the JAX function: it takes ``device`` and no
``double_precision``; plans and the CG run in the device's type (f64 on the
CPU, f32 on the card).
"""

from __future__ import annotations

import numpy as np

from .. import checked_real_dtype, resolve_device, to_device, to_host
from ..ops.gridder import plan_wgridder
from ..ops.hessian import hessian_vis
from ..opt.pcg import pcg
from ..utils.logging import get_logger
from ..utils.store import TreeStore, require_complete
from .imager import residual_from_parts

log = get_logger("FLUXTRACTOR")


def fluxtractor(dt_path, mask=None, eta: float = 1e-3, cg_tol: float = 1e-4, cg_maxit: int = 50,
                epsilon: float = 1e-7, do_wgridding: bool = True, double_precision: bool | None = None, *,
                device="cuda"):
    """Returns (model_mopped, residual_mopped) as f64 numpy arrays.
    ``double_precision`` may only name the device's type (f64 on the CPU,
    f32 on the card): None takes it."""
    rdt = checked_real_dtype(device, double_precision)
    dev = resolve_device(device)
    dt = TreeStore(dt_path, mode="w")
    require_complete(dt)
    attrs = dt.attrs
    nx, ny = attrs["nx"], attrs["ny"]
    band_nodes = [k for k in dt.groups() if k.startswith("band")]
    nband = len(band_nodes)
    cell = attrs["cell_rad"]

    wsums = np.array([float(np.asarray(dt.group(k).read("WSUM"))[0]) for k in band_nodes])
    wsum = wsums.sum()
    mask = np.ones((nx, ny)) if mask is None else np.asarray(mask, dtype=float)
    mask_t = to_device(mask, dev, rdt)

    model = np.zeros((nband, nx, ny))
    residual = np.zeros((nband, nx, ny))
    for b, key in enumerate(band_nodes):
        node = dt.group(key)
        resid_b = np.asarray(node.read("RESIDUAL" if node.has("RESIDUAL") else "DIRTY")) / wsum
        model_b = np.asarray(node.read("MODEL")) if node.has("MODEL") else np.zeros((nx, ny))
        parts = []
        for pk in node.groups():
            pg = node.group(pk)
            plan = plan_wgridder(np.asarray(pg.read("UVW")), np.asarray(pg.read("FREQ")), nx=nx, ny=ny, cellx=cell,
                                 celly=cell, l0=pg.attrs.get("l0", 0.0), m0=pg.attrs.get("m0", 0.0), epsilon=epsilon,
                                 do_wgridding=do_wgridding, divide_by_n=False, dtype=rdt, device=dev)
            parts.append((plan, to_device(pg.read("WEIGHT"), dev, rdt), to_device(pg.read("MASK"), dev, rdt)))

        def hess(x, parts=parts):
            out = eta * x
            xm = x * mask_t
            for plan, w, m in parts:
                out = out + mask_t * hessian_vis(plan, xm, wgt=w, mask=m) / wsum
            return out

        x = pcg(hess, to_device(resid_b * mask, dev, rdt), tol=cg_tol, maxit=cg_maxit, minit=1)
        del parts
        x_h = to_host(x).astype(np.float64)
        model[b] = model_b + x_h * mask
        node.write("UPDATE", x_h)
        node.write("MODEL_MOPPED", model[b])
        log.info("band %d mopped, |x|max=%.3e", b, float(np.abs(x_h).max()))

    queued = [residual_from_parts(dt.group(key), model[b], epsilon=epsilon, do_wgridding=do_wgridding,
                                  as_device=True, device=dev) for b, key in enumerate(band_nodes)]
    for b, (key, r) in enumerate(zip(band_nodes, queued)):
        residual[b] = to_host(r)
        dt.group(key).write("RESIDUAL_MOPPED", residual[b])
    return model, residual
