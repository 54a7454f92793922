"""``pfb-torch`` command line (port of pfb_imaging_tpu/cli.py): the JAX
package's parser, command for command and flag for flag, dispatching to the
port's ``simulate``, ``init``, ``imager``/``grid``, ``deconv``/``sara``
(presets sara and ista), ``kclean``, ``restore``, ``degrid``,
``fluxtractor``, ``model2comps`` and ``hci``. One option is added to every
command: ``--device`` (default ``cuda``), where the command runs; the CPU
only when asked for.

    python -m pfb_imaging_tpu_torch.cli imager sim.xds out.dt --nband 4
    pfb-torch restore out.dt --device cpu

The imager's ``double_precision`` is False under ``--single-precision`` and
otherwise None, the device's working type (f64 on the CPU, f32 on the card,
whose IDG kernels are f32-only); ``kclean`` and ``fluxtractor`` likewise
run in the device's type. ``deconv``/``sara --use-mesh`` shard the solver
over the band mesh (``parallel/``).

Started by torchrun (``WORLD_SIZE`` above 1, or the ``PFB_*`` variables of
``parallel.multihost.init_distributed``), a command first joins the world,
on NCCL for the card and gloo for the CPU:

    torchrun --standalone --nproc-per-node 2 -m pfb_imaging_tpu_torch.cli sara out.dt --use-mesh --device cpu

Science modules are imported when a command runs, so ``--help`` needs none.
"""

from __future__ import annotations

import argparse
import sys


def _join_world(device) -> None:
    """Join the process group a launcher describes (torchrun's WORLD_SIZE or
    PFB_NUM_PROCESSES above 1) unless the caller has already."""
    import os

    n = os.environ.get("PFB_NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
    if not n or int(n) < 2:
        return
    import torch.distributed as dist

    if not dist.is_initialized():
        from .parallel.multihost import init_distributed

        init_distributed(device=device)


def _add_common(p):
    p.add_argument("--log-directory", default=None)
    p.add_argument("--verbosity", type=int, default=1)
    p.add_argument("--device", default="cuda", help="where the command runs: cuda (default) or cpu")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pfb-torch", description="Radio interferometric imaging on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("simulate", help="simulate a raw measurement container")
    p.add_argument("output")
    p.add_argument("--nant", type=int, default=16)
    p.add_argument("--ntime", type=int, default=3)
    p.add_argument("--nchan", type=int, default=8)
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--corrupt-gains", action="store_true")
    _add_common(p)

    p = sub.add_parser("init", help="raw container -> Stokes vis product")
    p.add_argument("ms")
    p.add_argument("output")
    p.add_argument("--product", default="I")
    p.add_argument("--chan-average", type=int, default=1)
    p.add_argument(
        "--beam-model", default="auto",
        help="primary beam at ingest: auto|none|gauss|kbl|kbuhf|<holography>.npz",
    )
    p.add_argument("--bda-decorrelation", type=float, default=None)
    p.add_argument(
        "--data-column", default=None,
        help="MSv4 ingest: visibility column (default VISIBILITY/CORRECTED_DATA/DATA)",
    )
    p.add_argument(
        "--gain-table", default=None,
        help="externally-solved gain table (TreeStore or .npz; utils/gains.py schema) "
        "interpolated onto the stream at ingest",
    )
    _add_common(p)

    for name in ("imager", "grid"):
        p = sub.add_parser(name, help="Stokes vis -> image DataTree (.dt)")
        p.add_argument("xds")
        p.add_argument("output")
        p.add_argument("--nband", type=int, default=1)
        p.add_argument("--field-of-view", type=float, default=None)
        p.add_argument("--super-resolution-factor", type=float, default=2.0)
        p.add_argument("--nx", type=int, default=None)
        p.add_argument("--cell-size", type=float, default=None, help="arcsec")
        p.add_argument("--robustness", type=float, default=None)
        p.add_argument("--super-uniform-pix", type=int, default=0)
        p.add_argument("--epsilon", type=float, default=1e-7)
        p.add_argument("--no-wgridding", action="store_true")
        p.add_argument("--psf-oversize", type=float, default=2.0)
        p.add_argument("--single-precision", action="store_true")
        p.add_argument(
            "--gridder", choices=("auto", "idg", "stack", "pallas"), default="auto",
            help="measurement operator backend (auto: idg down to epsilon 1e-8 when the occupancy budget allows)",
        )
        _add_common(p)

    for name, preset in (("deconv", None), ("sara", "sara")):
        p = sub.add_parser(name, help="PFB major cycle deconvolution")
        p.add_argument("dt")
        if preset is None:
            p.add_argument("--preset", default="sara", choices=["sara", "ista"])
        p.add_argument("--niter", type=int, default=5)
        p.add_argument("--rmsfactor", type=float, default=1.0)
        p.add_argument("--init-factor", type=float, default=1.0)
        p.add_argument("--gamma", type=float, default=1.0)
        p.add_argument("--eta", type=float, default=1e-5)
        p.add_argument("--bases", default="self,db1,db2")
        p.add_argument("--nlevels", type=int, default=2)
        p.add_argument("--positivity", type=int, default=1)
        p.add_argument("--cg-maxit", type=int, default=100)
        p.add_argument("--pd-maxit", type=int, default=500)
        p.add_argument("--l1-reweight-from", type=int, default=5)
        p.add_argument("--epsilon", type=float, default=1e-7)
        p.add_argument("--no-wgridding", action="store_true")
        p.add_argument("--use-mesh", action="store_true", help="shard cubes over the band mesh axis")
        _add_common(p)

    p = sub.add_parser("kclean", help="CLEAN deconvolution")
    p.add_argument("dt")
    p.add_argument("--niter", type=int, default=5)
    p.add_argument("--minor", default="clark", choices=["clark", "hogbom"])
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--peak-factor", type=float, default=0.15)
    p.add_argument("--epsilon", type=float, default=1e-7)
    p.add_argument("--no-wgridding", action="store_true")
    _add_common(p)

    p = sub.add_parser("restore", help="write restored FITS products")
    p.add_argument("dt")
    p.add_argument("--outputs", default="mMrRiI")
    _add_common(p)

    p = sub.add_parser("degrid", help="predict .mds model into MODEL_DATA")
    p.add_argument("mds")
    p.add_argument("ms")
    p.add_argument("--cell-rad", type=float, required=True)
    p.add_argument("--column", default="MODEL_DATA")
    p.add_argument("--to-corr", action="store_true")
    p.add_argument(
        "--region-file", default=None,
        help="split the prediction by regions (circle/box text spec or .npy "
        "mask stack); remainder -> --column, region i -> --column{i}",
    )
    p.add_argument("--gridder", default="auto", choices=("auto", "idg", "stack", "pallas"))
    _add_common(p)

    p = sub.add_parser("fluxtractor", help="vis-space CG flux mop")
    p.add_argument("dt")
    p.add_argument("--eta", type=float, default=1e-3)
    p.add_argument("--cg-maxit", type=int, default=50)
    _add_common(p)

    p = sub.add_parser("model2comps", help="fit model cube to components")
    p.add_argument("dt")
    p.add_argument("--mds", default=None)
    p.add_argument("--nbasisf", type=int, default=None)
    _add_common(p)

    p = sub.add_parser("hci", help="high-cadence snapshot imaging")
    p.add_argument("xds")
    p.add_argument("output")
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--freq-chunks", type=int, default=1)
    p.add_argument("--epsilon", type=float, default=1e-7)
    p.add_argument(
        "--gridder", choices=("auto", "idg", "stack", "pallas"), default="auto",
        help="measurement operator backend (auto: idg down to epsilon 1e-8 when the occupancy budget allows)",
    )
    _add_common(p)

    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    from .utils.logging import add_file_handler, get_logger, log_options_dict

    log = get_logger("CLI")
    add_file_handler(args.command, args.log_directory)
    log_options_dict(log, vars(args))

    cmd, dev = args.command, args.device
    _join_world(dev)
    if cmd == "simulate":
        from .core.simulate import simulate_vis_store

        simulate_vis_store(args.output, nant=args.nant, ntime=args.ntime, nchan=args.nchan, nx=args.nx,
                           noise=args.noise, corrupt_gains=args.corrupt_gains, device=dev)
    elif cmd == "init":
        from .core.init import init

        init(args.ms, args.output, product=args.product, chan_average=args.chan_average, beam_model=args.beam_model,
             bda_decorrelation=args.bda_decorrelation, data_column=args.data_column, gain_table=args.gain_table,
             device=dev)
    elif cmd in ("imager", "grid"):
        from .core.imager import imager

        imager(args.xds, args.output, nband=args.nband, field_of_view=args.field_of_view,
               super_resolution_factor=args.super_resolution_factor, nx=args.nx, cell_size=args.cell_size,
               robustness=args.robustness, super_uniform_pix=args.super_uniform_pix, epsilon=args.epsilon,
               do_wgridding=not args.no_wgridding, psf_oversize=args.psf_oversize,
               double_precision=False if args.single_precision else None, gridder=args.gridder, device=dev)
    elif cmd in ("deconv", "sara"):
        preset = getattr(args, "preset", "sara")
        from .core.deconv import deconv

        deconv(args.dt, preset=preset, niter=args.niter, rmsfactor=args.rmsfactor, init_factor=args.init_factor,
               gamma=args.gamma, eta=args.eta, bases=args.bases, nlevels=args.nlevels, positivity=args.positivity,
               cg_maxit=args.cg_maxit, pd_maxit=args.pd_maxit, l1_reweight_from=args.l1_reweight_from,
               epsilon=args.epsilon, do_wgridding=not args.no_wgridding, use_mesh=args.use_mesh, device=dev)
    elif cmd == "kclean":
        from .core.kclean import kclean

        kclean(args.dt, niter=args.niter, minor=args.minor, gamma=args.gamma, peak_factor=args.peak_factor,
               epsilon=args.epsilon, do_wgridding=not args.no_wgridding, device=dev)
    elif cmd == "restore":
        from .core.restore import restore

        restore(args.dt, outputs=args.outputs, device=dev)
    elif cmd == "degrid":
        from .core.degrid import degrid

        degrid(args.mds, args.ms, cell_rad=args.cell_rad, column=args.column, to_corr=args.to_corr,
               region_file=args.region_file, gridder=args.gridder, device=dev)
    elif cmd == "fluxtractor":
        from .core.fluxtractor import fluxtractor

        fluxtractor(args.dt, eta=args.eta, cg_maxit=args.cg_maxit, device=dev)
    elif cmd == "model2comps":
        from .core.model2comps import model2comps

        model2comps(args.dt, mds_path=args.mds, nbasisf=args.nbasisf, device=dev)
    elif cmd == "hci":
        from .core.hci import hci

        hci(args.xds, args.output, nx=args.nx, freq_chunks=args.freq_chunks, epsilon=args.epsilon,
            gridder=args.gridder, device=dev)
    else:  # pragma: no cover
        raise SystemExit(f"unknown command {cmd}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
