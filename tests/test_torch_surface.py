"""Surface parity of the port: every public function and class defined in a
module of the JAX package has a counterpart of the same name in the same
module of ``pfb_imaging_tpu_torch``, and a JAX-style positional call of it
either binds the same parameter names in the port or fails to bind (so a
script written against JAX never runs with an argument in the wrong
place). One case per JAX module. The JAX signatures are read with
``inspect`` here; the port imports nothing of JAX."""

import importlib
import inspect
import pkgutil

import pytest
import torch

import pfb_imaging_tpu

torch.set_num_threads(1)

# the JAX surface that exists only for the TPU runtime, with the reason
STAYS_OUT = {
    "ops.gridder.vis2dirty_hostloop": "TPU per-plane host loop for runtimes without a fused stack; the port's "
                                      "stack gridder and B3 serve it",
    "ops.gridder.dirty2vis_hostloop": "TPU per-plane host loop; the port's stack degrid and B4 serve it",
    "ops.gridder_idg.idg_fused_BG": "Pallas grid-block size in groups; the CUDA kernels take any group count",
    "ops.gridder_pallas.plan_tiles": "Mosaic tile buckets; plan_pallas builds the CUDA kernels' tile plan",
    "ops.gridder_pallas.vis2dirty_pallas": "Pallas scatter entry point; vis2dirty_pallas_wstack runs B3 at nw = 1",
    "ops.gridder_pallas.vis2dirty_pallas_grouped": "grouped Pallas scatter (VMEM flush flags); B3 at nw = 1",
    "ops.gridder_pallas.add_group_flags": "VMEM flush flags of the grouped Pallas scatter",
    "ops.gridder_pallas.dirty2vis_pallas": "Pallas gather entry point; dirty2vis_pallas_wstack runs B4",
    "ops.idg_fused.block_groups": "Pallas grid-block padding of the groups",
    "ops.idg_fused.fused_supported": "TPU kernel coverage; plan_idg raises ValueError outside S in {16, 24, 32}",
    "ops.idg_fused.wc_perm_kron": "the packed kron constant of the TPU matmuls; wc_from_perm_kron reads it back",
    "opt.primal_dual.dev_scalar": "JAX device-scalar helper for TPU runtimes without 0-d transfers",
    "parallel.multihost.global_band_array": "global JAX arrays; a torch rank holds its band slice "
                                            "(stream_band_stack)",
    "parallel.multihost.fetch_band_slices": "alias over global JAX arrays; owned_band_slices takes a rank's slice",
}

# shared names whose positional parameters differ on purpose: the call then
# means the port's argument (recorded departures, not misbindings)
DEPARTS = {
    "ops.gridder.WGridderPlan": "the TPU layout fields of the plan",
    "parallel.fft.rfft2_t_local": "a mesh where JAX takes an axis name",
    "parallel.fft.irfft2_t_local": "a mesh where JAX takes an axis name",
    "parallel.fft.psf_convolve_local": "a mesh where JAX takes an axis name",
    "parallel.mesh.make_mesh": "ranks where JAX takes devices",
    "parallel.multihost.owned_band_slices": "a rank's local slice where JAX takes a global array",
    "parallel.multihost.host_gather": "a rank's local slice where JAX takes a global array",
    "parallel.sharded.sharded_vis2dirty": "a rank's plan where JAX takes the stacked plans",
    "parallel.sharded.sharded_dirty2vis_idg": "a rank's plan where JAX takes the stacked plans",
    "parallel.sharded.sharded_vis2dirty_idg": "a rank's plan where JAX takes the stacked plans",
}

MODULES = [pfb_imaging_tpu.__name__] + [m.name for m in pkgutil.walk_packages(pfb_imaging_tpu.__path__,
                                                                              pfb_imaging_tpu.__name__ + ".")]


def _short(module: str, name: str) -> str:
    return ".".join((module.split(".", 1)[1:] or []) + [name])


def _public(mod):
    """(name, object) of each public function and class defined in ``mod``."""
    return [(k, v) for k, v in vars(mod).items() if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == mod.__name__]


def _misbinding(jax_fn, port_fn):
    """The first JAX-style positional call (from JAX's required count up to
    all its positional parameters) that the port binds to other names, as
    (JAX names, port names), or None."""
    try:
        js, ps = inspect.signature(jax_fn), inspect.signature(port_fn)
    except (TypeError, ValueError):
        return None
    pos = [p for p in js.parameters.values() if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    names = [p.name for p in pos]
    required = sum(p.default is p.empty for p in pos)
    for n in range(required, len(names) + 1):
        try:
            bound = ps.bind_partial(*range(n))
        except TypeError:
            continue
        got = list(bound.arguments)[:n]
        if got != names[:n]:
            return names[:n], got
    return None


@pytest.mark.parametrize("module", MODULES)
def test_module_surface_and_positional_binding(module):
    jm = importlib.import_module(module)
    pm = importlib.import_module(module.replace("pfb_imaging_tpu", "pfb_imaging_tpu_torch", 1))
    missing, misbound = [], []
    for name, obj in _public(jm):
        key = _short(module, name)
        port = getattr(pm, name, None)
        if port is None:
            if key not in STAYS_OUT:
                missing.append(key)
            continue
        assert key not in STAYS_OUT, f"{key} is ported: take it off STAYS_OUT"
        bad = _misbinding(obj, port)
        if bad is not None and key not in DEPARTS:
            misbound.append((key, bad))
    assert not missing, missing
    assert not misbound, misbound


def test_exclusions_name_real_jax_names():
    """Every listed exclusion names a public JAX function or class, so the
    lists cannot keep a name the JAX package no longer has."""
    for key in (*STAYS_OUT, *DEPARTS):
        mod, name = key.rsplit(".", 1)
        obj = getattr(importlib.import_module("pfb_imaging_tpu." + mod), name)
        assert inspect.isfunction(obj) or inspect.isclass(obj), key
    for key in DEPARTS:
        mod, name = key.rsplit(".", 1)
        assert _misbinding(getattr(importlib.import_module("pfb_imaging_tpu." + mod), name),
                           getattr(importlib.import_module("pfb_imaging_tpu_torch." + mod), name)), key
