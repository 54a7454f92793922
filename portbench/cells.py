"""The generator: one step kind for each ``step`` a traffic mix may name.

Each kind makes its inputs from the configuration and the seed, sets the
program up and warms every shape its steps use (``setup``), runs one step
(``step``), and afterwards hands what the steps produced to the plain
reference (``check``). ``control`` judges the reference itself computed in
the next lower precision in the program's place, with the same numbers.

- ``major_cycle``: the first major cycle of ``core/deconv.deconv``'s loop
  body on the imaged tree: ``first`` -> ``forward`` (PCG on the PSF
  Hessian) -> ``backward`` (primal-dual with Psi) -> ``last``, then the
  exact residual of the model by ``residual_from_parts_multiband`` and its
  fetch. Each step starts from the same state (a solver built again with
  the cached ``hess_norm``), so each does the same work. The checkpoint
  writes and the ``.mds`` fit stay outside.
- ``residual``: ``residual_from_parts_multiband`` and its fetch, cycling
  through sparse model cubes made in set-up.

``faulted`` hands back a step kind's answers as a fault of its timed path
would have made them (its state unchanged, half the bands left out with
the mean of the rest in their place, the answer altered where it is made),
so that the check's readings of each fault can be taken at the cell's size.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import data
from . import reference as ref
from .roofline import add_counts, plan_counts


# the faults of a timed path that ``faulted`` makes
FAULTS = ("unchanged", "half", "altered")
# most nonzero model pixels whose visibilities the reference sums directly
DIRECT_PIXELS = 4096


def _tmpdir() -> Path:
    return Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))


class Kind:
    """What every step kind has: its configuration, mix, seed, device, the
    timer of its spans, and the counters its steps keep."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, dev, timer):
        self.cfg, self.traffic, self.seed, self.dev, self.timer = cfg, traffic, int(seed), dev, timer
        self.counters: dict = {}
        self.tmp: Path | None = None

    def work_counts(self, steps: int) -> dict:
        return {}

    def diagnostics(self) -> dict:
        return dict(self.counters)

    def free_program(self) -> None:
        """Drop the program's state (plans, solver, caches) before the
        reference runs."""
        from pfb_imaging_tpu_torch.core import imager as TI

        TI._PLAN_CACHE.clear()
        TI._PLAN_CACHE_BYTES = 0
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def cleanup(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None


class Observation:
    """The configuration's observation on the device: uvw of the fixed
    array, each band's channels, the seeded sky and noise (f32 values, as
    the program is given them), natural weights, and the sampled pixels."""

    def __init__(self, cfg: dict, seed: int, dev, nrandom: int):
        self.cfg, self.dev = cfg, dev
        self.nx, self.cell = cfg["nx"], cfg["cell_rad"]
        self.uvw = data.synth_array(cfg["nant"], cfg["ntime"], cfg["array_seed"], cfg["wscale"], cfg["radius_m"])
        self.bands = data.band_freqs(cfg)
        self.srcs = data.point_sources(self.nx, cfg["nsrc"], seed)
        self.pix = data.sample_pixels(self.nx, self.srcs, nrandom, seed)
        self.uvw_d = torch.as_tensor(self.uvw, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.nrow = self.uvw.shape[0]
        self.nvis = self.nrow * cfg["nchan"]

    def band_vis(self, b: int):
        """Band ``b``'s sky plus noise (re, im), f32 (nrow, nchan_b); drawn
        in band order from the seed's generator."""
        return data.sky_vis(self.uvw_d, self.bands[b], self.srcs, self.cell, self.nx, self.cfg["noise"], self.gen)


def write_tree(obs: Observation, path: Path, dirty: list, wsums: list):
    """The .dt tree the residual reads: per band DIRTY and one partition
    with UVW, FREQ, WEIGHT, MASK (the bands' identical arrays linked, not
    written again)."""
    from pfb_imaging_tpu_torch.utils.store import TreeStore

    root = TreeStore(path, mode="w")
    first = None
    for b, freq in enumerate(obs.bands):
        node = root.group(f"band{b:04d}_time0000")
        node.write("DIRTY", dirty[b])
        node.write("WSUM", np.asarray([wsums[b]]))
        node.set_attrs(freq_out=float(freq.mean()), wsum=wsums[b], niters=0, time_out=0.0)
        pg = node.group("part0000")
        pg.set_attrs(l0=0.0, m0=0.0, wsum=wsums[b])
        pg.write("FREQ", freq)
        if first is None:
            pg.write("UVW", obs.uvw)
            pg.write("WEIGHT", np.ones((obs.nrow, freq.size)))
            pg.write("MASK", np.ones((obs.nrow, freq.size), np.uint8))
            first = pg
        else:
            for name in ("UVW", "WEIGHT", "MASK"):
                os.link(first.path / f"{name}.npy", pg.path / f"{name}.npy")
    cfg = obs.cfg
    root.set_attrs(nx=obs.nx, ny=obs.nx, nx_psf=cfg["nx_psf"], ny_psf=cfg["nx_psf"], nband=cfg["nband"], ntime=1,
                   freq_out=[float(f.mean()) for f in obs.bands], cell_rad=obs.cell, wsum=float(sum(wsums)),
                   complete=True)
    return root


class Imaged(Kind):
    """A kind whose set-up images the observation as ``chip_smoke.build_tree``
    does: per band the port's IDG plan (``w_mode="auto"``), DIRTY and the
    PSF by ``vis2dirty_idg`` on the device, and the tree the residual reads."""

    def image(self, psf: bool) -> None:
        from pfb_imaging_tpu_torch.core.imager import IDG_MAX_SLOT_FACTOR
        from pfb_imaging_tpu_torch.ops.gridder_idg import plan_idg, vis2dirty_idg

        cfg, dev = self.cfg, self.dev
        self.obs = obs = Observation(cfg, self.seed, dev, self.traffic["sample_pixels"])
        self.tmp = _tmpdir()
        self.vis, dirty, self.psf, self.wsums = [], [], [], []
        for b, freq in enumerate(obs.bands):
            plan = plan_idg(obs.uvw, freq, nx=obs.nx, ny=obs.nx, cellx=obs.cell, celly=obs.cell,
                            epsilon=cfg["epsilon"], max_slot_factor=IDG_MAX_SLOT_FACTOR, divide_by_n=False,
                            device=dev)
            vr, vi = obs.band_vis(b)
            wgt = torch.ones_like(vr)
            dirty.append(vis2dirty_idg(plan, vr, wgt=wgt, vis_im=vi).double().cpu().numpy())
            if psf:
                self.psf.append(vis2dirty_idg(plan, torch.ones_like(vr), wgt=wgt, vis_im=torch.zeros_like(vr)))
            self.vis.append(torch.complex(vr.double(), vi.double()))
            self.wsums.append(float(vr.numel()))
            del plan
        self.dirty = np.stack(dirty)
        self.keys = [f"band{b:04d}_time0000" for b in range(cfg["nband"])]
        self.dt = write_tree(obs, self.tmp / "cell.dt", dirty, self.wsums)

    def residual_call(self, model):
        from pfb_imaging_tpu_torch.core.imager import residual_from_parts_multiband

        out = residual_from_parts_multiband(self.dt, self.keys, model, epsilon=self.cfg["epsilon"],
                                            do_wgridding=True, as_device=True, device=self.dev)
        if out is None:
            raise RuntimeError("the multiband residual declined this observation; the cell measures that route")
        return out

    def dirty_at(self, prec: str) -> np.ndarray:
        """(nband, K) reference DIRTY at the sampled pixels."""
        o = self.obs
        return np.stack([ref.image_at(o.uvw_d, o.bands[b], self.vis[b], o.pix, o.nx, o.cell, prec).cpu().numpy()
                         for b in range(len(o.bands))])

    def residual_at(self, model: np.ndarray, prec: str) -> np.ndarray:
        """(nband, K) reference residual DIRTY - R^H W R model at the
        sampled pixels (natural weights)."""
        o = self.obs
        out = []
        for b, freq in enumerate(o.bands):
            img = torch.as_tensor(model[b], device=self.dev)
            # a direct sum over a sparse model's pixels; a dense one (a
            # deconvolution's) through the reference's non-uniform FFT
            vis = ref.vis_of_image if int(torch.count_nonzero(img)) <= DIRECT_PIXELS else ref.vis_nufft
            mv = vis(o.uvw_d, freq, img, o.nx, o.cell, prec)
            out.append(ref.image_at(o.uvw_d, freq, self.vis[b] - mv, o.pix, o.nx, o.cell, prec).cpu().numpy())
        return np.stack(out)

    def multiband_counts(self) -> dict:
        """Work of one residual: each band's plan in the program's cached
        multiband plan, weighed by this cell's own (natural) weights."""
        from pfb_imaging_tpu_torch.core import imager as TI

        total: dict = {}
        for key, entry in TI._PLAN_CACHE.items():
            if isinstance(key, tuple) and key[0] == "multiband" and entry is not None:
                mplan = entry[0]
                for p in mplan.plans:
                    total = add_counts(total, plan_counts(p, torch.ones(p.nrow * p.nchan, device=p.cg_idx.device)))
        return total


class MajorCycle(Imaged):
    def setup(self) -> None:
        from pfb_imaging_tpu_torch.deconv.presets import make_sara
        from pfb_imaging_tpu_torch.parallel.mesh import make_mesh

        cfg, dev, s = self.cfg, self.dev, self.cfg["solver"]
        self.image(psf=True)
        nx, nxp = cfg["nx"], cfg["nx_psf"]
        o = (nxp - nx) // 2
        ph = []
        for p in self.psf:
            pad = torch.zeros((nxp, nxp), dtype=torch.float64, device=dev)
            pad[o : o + nx, o : o + nx] = p.double()
            ph.append(torch.fft.rfft2(torch.fft.ifftshift(pad)).abs().float())
        self.abspsfhat = torch.stack(ph)[:, None]
        self.wsum = float(sum(self.wsums))
        self.rin = self.dirty / self.wsum
        mfs = self.dirty.sum(axis=0) / self.wsum
        self.lam = s["rmsfactor"] * float(np.std(mfs))
        self.geometry = dict(nx=nx, ny=nx, nx_psf=nxp, ny_psf=nxp)
        self.opts = dict(bases=s["bases"], nlevels=s["nlevels"], eta=s["eta"], gamma=s["gamma"],
                         positivity=s["positivity"], cg_tol=s["cg_tol"], cg_maxit=s["cg_maxit"], pd_tol=s["pd_tol"],
                         pd_maxit=s["pd_maxit"], rmsfactor=s["rmsfactor"], l1_reweight_from=s["l1_reweight_from"],
                         hess_norm=None, verbosity=1)
        self.zeros = np.zeros((cfg["nband"], nx, nx))
        self.mesh = make_mesh(band=1, row=1)  # deconv's default mesh on one rank
        self.make_sara = make_sara
        first = make_sara(self.abspsfhat, self.wsums, self.geometry, self.zeros, self.zeros, self.opts, mesh=self.mesh,
                          device=dev)  # the power method
        self.opts["hess_norm"] = first.hess_norm
        del first
        # warm every shape: a short cycle, then the residual (the multiband plan)
        warm = dict(self.traffic["warm_maxit"])
        self._cycle(dict(self.opts, **warm), keep=False)
        self.outputs = []
        self.counters = dict(cg_iters=0, pd_iters=0)

    def _cycle(self, opts: dict, keep: bool) -> None:
        from pfb_imaging_tpu_torch import to_host
        from pfb_imaging_tpu_torch.parallel.mesh import shard_cube

        span = self.timer.span
        solver = self.make_sara(self.abspsfhat, self.wsums, self.geometry, self.zeros, self.zeros, opts,
                                mesh=self.mesh, device=self.dev)
        with span("forward"):
            solver.first(shard_cube(self.mesh, self.rin, device=self.dev, dtype=torch.float32 if
                                    self.dev.type == "cuda" else torch.float64))
            upd_t = solver.forward(None)
        update = to_host(upd_t).astype(np.float64)
        with span("backward"):
            mdl_t = solver.backward(self.lam)
            solver.last()
        model = to_host(mdl_t).astype(np.float64)
        with span("residual"):
            residual = to_host(self.residual_call(model)).astype(np.float64)
        mfs = residual.sum(axis=0) / self.wsum
        self.rms = (float(np.std(mfs)), float(np.abs(mfs).max()))
        if keep:
            self.counters["cg_iters"] += int(solver.forward_alg.niter_last)
            self.counters["pd_iters"] += int(solver.backward_alg.niter_last)
            self.outputs.append((update, model, residual))

    def step(self, i: int) -> None:
        self._cycle(self.opts, keep=True)

    def diagnostics(self) -> dict:
        x = self.outputs[-1][1] if self.outputs else np.zeros(1)
        return dict(self.counters, hess_norm=self.opts["hess_norm"], lam=self.lam, rms_rmax=self.rms,
                    model_nonzero=int(np.count_nonzero(x)), **getattr(self, "diag", {}))

    def answers(self) -> dict:
        psf = np.stack([p.double().cpu().numpy() for p in self.psf])
        return dict(dirty=self.dirty, psf=psf, steps=self.outputs)

    def faulted(self, answers: dict, fault: str) -> dict:
        steps = []
        for u, x, r in answers["steps"]:
            if fault == "unchanged":  # the model handed back as it came in: zero, its residual DIRTY
                x, r = np.zeros_like(x), answers["dirty"].copy()
            elif fault == "half":
                x, r = _half(x), _half(r)
            else:
                r = r * (1.0 + 1e-3)
            steps.append((u, x, r))
        return dict(answers, steps=steps)

    def _chain(self, prec: str, update_in, dirty, psf):
        """The reference's minor cycle in ``prec`` from its own DIRTY and PSF
        (nband, nx, nx): PCG, the power method from the program's documented
        start vector, primal-dual from ``update_in`` (the program's update,
        checked on its own) or, where that is None, from its own."""
        s, dev = self.cfg["solver"], self.dev
        with ref.precision(prec) as dt:
            hess = ref.PsfHessian(torch.as_tensor(psf, device=dev).to(dt), self.wsums, s["eta"], self.cfg["nx_psf"],
                                  dt, lowp=prec != "f64")
            rin = torch.as_tensor(dirty / self.wsum, device=dev).to(dt)
            u, _ = ref.cg(hess, rin, s["cg_tol"], s["cg_minit"], s["cg_maxit"])
            gen = torch.Generator(device=dev).manual_seed(s["pm_seed"])
            b0 = torch.randn(rin.shape, generator=gen, device=dev,
                             dtype=torch.float32 if dev.type == "cuda" else torch.float64).to(dt)
            hn = ref.power_norm(hess, b0, s["pm_tol"], s["pm_maxit"]) * 1.05
            psi = ref.Dictionary(s["bases"].split(","), s["nlevels"], dt, dev)
            lam = s["rmsfactor"] * float(np.std(dirty.sum(axis=0) / self.wsum))
            xt = s["gamma"] * torch.as_tensor(update_in if update_in is not None else u, device=dev).to(dt)
            x, k = ref.primal_dual(hess, psi, xt, lam, hn, s["gamma"], s["pd_tol"], s["pd_maxit"])
            self.diag[f"reference_{prec}"] = dict(hess_norm=hn, pd_iters=k)
            return u.double().cpu().numpy(), x.double().cpu().numpy()

    def _judge(self, dirty, psf, steps, want) -> tuple:
        """Readings of answers against the reference's ``want``: DIRTY and
        the PSF as given (the whole images, or the control's at the sampled
        pixels); ``steps`` holds (update, model, residual at the sampled
        pixels, the reference's residual there) per step."""
        scale = np.abs(want["dirty"].reshape(len(self.wsums), -1)).max(axis=1)
        wd, wp = want["dirty"], want["psf"]
        if dirty.shape != wd.shape:  # the control's, at the sampled pixels
            pix = self.obs.pix
            wd, wp = wd[:, pix[:, 0], pix[:, 1]], wp[:, pix[:, 0], pix[:, 1]]
        read = dict(dirty_rel=float(max(np.abs(dirty[b] - wd[b]).max() / scale[b] for b in range(len(scale)))),
                    psf_rel=float(max(np.abs(psf[b] - wp[b]).max() / self.wsums[b] for b in range(len(scale)))))
        per = []
        for u, x, r_at, r_want in steps:
            per.append(dict(update_rel=float(np.linalg.norm(u - want["u"]) / np.linalg.norm(want["u"])),
                            model_rel=float(np.linalg.norm(x - want["x"]) / np.linalg.norm(want["x"])),
                            resid_rel=float(max(np.abs(r_at[b] - r_want[b]).max() / scale[b]
                                                for b in range(len(scale))))))
        for k in per[0]:
            read[k] = max(p[k] for p in per)
        return read, per

    def _images(self, prec: str) -> tuple:
        """The reference's DIRTY and PSF (nband, nx, nx) by its adjoint NUFFT."""
        o = self.obs
        dirty = np.stack([ref.image_nufft(o.uvw_d, o.bands[b], self.vis[b], o.nx, o.cell, prec).cpu().numpy()
                          for b in range(len(o.bands))])
        psf = np.stack([ref.image_nufft(o.uvw_d, o.bands[b], torch.ones_like(self.vis[b]), o.nx, o.cell,
                                        prec).cpu().numpy() for b in range(len(o.bands))])
        return dirty, psf

    def _want(self, update_in) -> dict:
        """The float64 reference's answers, its PD from ``update_in``; kept,
        so that a fault's answers are judged against the same."""
        self.diag = getattr(self, "diag", {})
        self._wants = getattr(self, "_wants", {})
        key = update_in.tobytes()
        if key not in self._wants:
            if not hasattr(self, "_ref_images"):
                self._ref_images = self._images("f64")
            dirty, psf = self._ref_images
            u, x = self._chain("f64", update_in, dirty, psf)
            self._wants[key] = dict(dirty=dirty, psf=psf, u=u, x=x)
        return self._wants[key]

    def _residual_ref(self, x):
        """The reference's residual of model ``x`` at the sampled pixels, kept by model."""
        self._resid = getattr(self, "_resid", [])
        hit = next((rw for xm, rw in self._resid if np.array_equal(xm, x)), None)
        if hit is None:
            hit = self.residual_at(x, "f64")
            self._resid.append((x, hit))
        return hit

    def check(self, answers: dict) -> tuple:
        steps = answers["steps"]
        want = self._want(steps[-1][0])
        pix = self.obs.pix
        rows = [(u, x, r[:, pix[:, 0], pix[:, 1]], self._residual_ref(x)) for u, x, r in steps]
        read, per = self._judge(answers["dirty"], answers["psf"], rows, want)
        x0 = steps[0][1]
        self.diag["steps_spread"] = max(float(np.linalg.norm(x - x0)) for _, x, _ in steps) / max(
            float(np.linalg.norm(x0)), 1e-300)
        self.diag["per_step"] = per[:4]
        return read, per

    def control(self) -> dict:
        """Readings of the reference computed in the lower precision in the
        program's place, judged as the program's answers are (DIRTY and the
        PSF at the sampled pixels)."""
        o = self.obs
        dirty = self.dirty_at("tf32")
        psf = np.stack([ref.image_at(o.uvw_d, o.bands[b], torch.ones_like(self.vis[b]), o.pix, o.nx, o.cell,
                                     "tf32").cpu().numpy() for b in range(len(o.bands))])
        full_dirty, full_psf = self._images("tf32")
        u, x = self._chain("tf32", None, full_dirty, full_psf)
        want = self._want(u)
        r_at = self.residual_at(x, "tf32")
        read, _ = self._judge(dirty, psf, [(u, x, r_at, self._residual_ref(x))], want)
        return read


def _half(a: np.ndarray) -> np.ndarray:
    """Half the bands left out, the mean of the rest in their place."""
    a = a.copy()
    h = a.shape[0] // 2
    a[h:] = a[:h].mean(0, keepdims=True)
    return a


class Residual(Imaged):
    def setup(self) -> None:
        cfg = self.cfg
        self.image(psf=False)
        t = self.traffic
        self.models = data.sparse_model_cubes(t["models"], cfg["nband"], cfg["nx"], self.obs.srcs,
                                              t["model_extra_pixels"], self.seed)
        to_host_fetch(self.residual_call(self.models[0]))  # warm: the multiband plan, kernels
        self.outputs = []
        self.counters = dict(nvis=self.obs.nvis)

    def step(self, i: int) -> None:
        k = i % len(self.models)
        with self.timer.span("residual"):
            r = to_host_fetch(self.residual_call(self.models[k]))
        pix = self.obs.pix
        self.outputs.append((k, np.asarray(r[:, pix[:, 0], pix[:, 1]], dtype=np.float64)))

    def work_counts(self, steps: int) -> dict:
        return {k: (ops * steps, nb * steps) for k, (ops, nb) in self.multiband_counts().items()}

    def answers(self) -> dict:
        return dict(steps=self.outputs)

    def faulted(self, answers: dict, fault: str) -> dict:
        pix = self.obs.pix
        state = self.dirty[:, pix[:, 0], pix[:, 1]]  # DIRTY, as the residual's input holds it
        change = dict(unchanged=lambda r: state.copy(), half=_half, altered=lambda r: r * (1.0 + 1e-3))[fault]
        return dict(steps=[(k, change(r)) for k, r in answers["steps"]])

    def _judge(self, steps, want, scale) -> tuple:
        per = [dict(resid_rel=float(max(np.abs(r[b] - want[k][b]).max() / scale[b] for b in range(len(scale)))))
               for k, r in steps]
        return dict(resid_rel=max(p["resid_rel"] for p in per)), per

    def _want(self, ks) -> tuple:
        """The float64 reference's DIRTY peaks and residuals of models ``ks``, kept."""
        if not hasattr(self, "_scale"):
            self._scale, self._resid = np.abs(self.dirty_at("f64")).max(axis=1), {}
        for k in ks:
            if k not in self._resid:
                self._resid[k] = self.residual_at(self.models[k], "f64")
        return self._resid, self._scale

    def check(self, answers: dict) -> tuple:
        steps = answers["steps"]
        want, scale = self._want(sorted({k for k, _ in steps}))
        return self._judge(steps, want, scale)

    def control(self) -> dict:
        ks = range(min(len(self.models), len(self.outputs) or 1))
        want, scale = self._want(ks)
        got = [(k, self.residual_at(self.models[k], "tf32")) for k in ks]
        return self._judge(got, want, scale)[0]


def to_host_fetch(t) -> np.ndarray:
    from pfb_imaging_tpu_torch import to_host

    return to_host(t)


STEP_KINDS = {"major_cycle": MajorCycle, "residual": Residual}
