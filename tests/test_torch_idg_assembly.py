"""The IDG patch assembly and its transpose (ops/gridder_idg.py,
csrc/idg_assemble.cu), and the classic gridder's scatter on the card.

On the CPU: the plain versions in the kernels' closed form
(``assemble_bin_gather_ref``/``extract_bin_gather_ref``) against the plain
versions in the JAX formula (``_assemble_bin``/``_extract_bin``, with
``index_add_``) and against JAX's own ``_assemble_bin``/``_extract_bin``, on
the same numpy-seeded patches and grids in f64, at small plans built by the
port's planner and converted from JAX plans by ``plan_from_jax``: chirp and
wplanes, S = 16, 24 (half 12 and 8) and 32, padded groups (``bin_gcap``),
an empty bin, and padded plans whose bucket 0 is long (summed in chunks:
1100 groups a bin, and 97, one past a chunk boundary), with random values
in the padding. Tolerance 1e-12 relative L-inf (f64 sums in another order);
the adjoint identity <assemble(P), G> = <P, extract(G)> to 1e-12; the per-bin
CSR visits every group once; the chunk table covers every group of each
long bucket once, in CSR order, and is a function of the bucket counts. On
a CUDA card only (``gpu``): K1/K2 against their plain versions (1e-6
relative, f32), K1 and its chunk sums the gather form's bits, two launches
the same bits, the chunk table built on the card equal to the CPU's; the
classic ``vis2dirty`` through B3, the same bits twice.

JAX is imported inside the tests that compare with it, so the ``gpu``
tests also run where only PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_idg_assembly.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_recorder import launches, recording

from pfb_imaging_tpu_torch.ops import gridder as TG
from pfb_imaging_tpu_torch.ops import gridder_idg as T

torch.set_num_threads(1)
CPU = torch.device("cpu")
NX, CELL, NROW = 64, 1e-4, 300
FREQ = np.array([1.0e9, 1.1e9])
TOL = 1e-12

# name -> (plan_idg arguments, w layout): "wide" |w| < 1500, "split" two w
# clusters with nothing between them (so the middle chirp bins are empty)
CASES = {
    "chirp_s16": (dict(epsilon=1e-5), "wide"),
    "chirp_s24": (dict(epsilon=1e-5, subgrid=24), "wide"),
    "chirp_s24_half8": (dict(epsilon=1e-5, subgrid=24, half=8), "wide"),
    "chirp_s32": (dict(epsilon=1e-7), "wide"),
    "wplanes_s32": (dict(epsilon=1e-5, w_mode="wplanes"), "wide"),
    "wplanes_s16": (dict(epsilon=1e-5, w_mode="wplanes", subgrid=16), "wide"),
    "padded_chirp": (dict(epsilon=1e-5, pad=3), "wide"),
    "padded_wplanes": (dict(epsilon=1e-5, w_mode="wplanes", pad=2), "wide"),
    "empty_bin": (dict(epsilon=1e-5, nbins=6), "split"),
    # bucket 0 of every bin past LONG_BUCKET: 1100-1101 groups, chunks of 64
    # (the last shorter), and 97 groups (one of them the plan's own), one
    # past a chunk boundary
    "padded_long_bucket0": (dict(epsilon=1e-5, pad=1100), "wide"),
    "padded_one_past_chunk": (dict(epsilon=1e-5, w_mode="wplanes", pad=96), "wide"),
}
_PLANS: dict = {}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _uvw(layout):
    rng = np.random.default_rng(31)
    uvw = rng.uniform(-1500, 1500, (NROW, 3))
    if layout == "split":
        uvw[:, 2] = np.sign(uvw[:, 2]) * rng.uniform(1000, 1500, NROW)
    return uvw


def _plan_kw(case):
    kw, layout = CASES[case]
    kw = dict(kw)
    pad, nbins = kw.pop("pad", 0), kw.pop("nbins", None)
    kw.update(nx=NX, ny=NX, cellx=CELL, celly=CELL, do_wgridding=True, divide_by_n=False)
    if nbins is not None:
        wmax = float(np.abs(_uvw(layout)[:, 2]).max() * FREQ.max() / 299792458.0)  # |w| survives the v fold
        kw.update(force_w_range=(-wmax, wmax, nbins), w_mode="chirp")
    return kw, pad


def _plans(case):
    """(JAX plan, the port's own plan, the port's plan converted from JAX)."""
    if case not in _PLANS:
        from pfb_imaging_tpu.ops import gridder_idg as J

        kw, pad = _plan_kw(case)
        uvw = _uvw(CASES[case][1])
        if pad:
            counts = T.plan_idg(uvw, FREQ, count_only=True, device=CPU, **kw)[1]
            kw["bin_gcap"] = tuple(int(c) + pad for c in counts)
        pj = J.plan_idg(uvw, FREQ, eval_backend="einsum", dtype=np.float64, **kw)
        pt = T.plan_idg(uvw, FREQ, device=CPU, **kw)
        _PLANS[case] = (pj, pt, T.plan_from_jax(*_jax_leaves(pj), device=CPU))
    return _PLANS[case]


def _jax_leaves(pj):
    """The numpy leaves and static fields of a JAX einsum plan, chirp or
    windowed, as ``plan_from_jax`` takes them."""
    names = ["au_re", "au_im", "av_re", "av_im", "scal", "wcu8", "wcv8", "sg", "bid", "phase_re", "phase_im",
             "corr_re", "corr_im", "nm1", "nm1_lo"]
    names += ["rep_idx", "win_start", "win_off", "win_len", "sort_idx"] if pj.w_support > 1 else ["cg_idx"]
    leaves = {k: np.asarray(getattr(pj, k)) for k in names}
    skip = set(names) | {"cg_idx", "inv_orig", "rep_idx", "win_start", "win_off", "win_len", "sort_idx",
                         "unsort_idx", "scr_re", "scr_im"}
    return leaves, {f.name: getattr(pj, f.name) for f in dataclasses.fields(pj) if f.name not in skip}


def _seeded(plan, seed):
    rng = np.random.default_rng(seed)
    P = torch.as_tensor(rng.standard_normal((2, plan.ngroups, plan.S, plan.S)))
    G = torch.as_tensor(rng.standard_normal((plan.nbig_x, plan.nbig_y))
                        + 1j * rng.standard_normal((plan.nbig_x, plan.nbig_y)))
    return P, G


def test_cases_cover_the_layouts():
    """The cases hold what they are named for: both w modes, every S, a
    wrapping extended plane, padded groups out of bucket order, an empty
    bin."""
    seen = dict(S=set(), ws=set())
    for case in CASES:
        pj, pt, _ = _plans(case)
        ext_u, ext_v = T._ext_dims(pt)
        assert ext_u > pt.nbig_x + pt.k0_off and ext_v > pt.nbig_y + pt.k0_off, case
        seen["S"].add((pt.S, pt.half))
        seen["ws"].add(pt.w_support > 1)
        assert (T.bucket_csr(pt).order is not None) == case.startswith("padded"), case
    assert seen["S"] >= {(16, 8), (24, 12), (24, 8), (32, 16)} and seen["ws"] == {False, True}
    assert 0 in _plans("empty_bin")[1].bin_gcount
    for case in CASES:
        pt = _plans(case)[1]
        csr, nb = T.bucket_csr(pt), pt.nbu * pt.nbv
        counts = np.diff(csr.starts.numpy().astype(np.int64))
        bucket0 = counts[: pt.nbins * nb : nb]
        assert (csr.chunks is not None) == ("long" in case or "chunk" in case), case
        if "long" in case:  # several chunks of 64 in every non-empty bin
            assert np.all(bucket0[bucket0 > 0] >= 1100) and np.all(np.diff(csr.bin_chunk0) >= 17), case
        if "chunk" in case:  # a long bucket one past a chunk boundary
            long = counts[counts > T.LONG_BUCKET]
            assert np.any(long % T.chunk_length(long) == 1), case


@pytest.mark.parametrize("built", ["port", "from_jax"])
@pytest.mark.parametrize("case", list(CASES))
def test_assembly_matches_jax(case, built):
    """Every bin: the gather-form plain version and the JAX-formula plain
    version of the assembly and of its transpose against JAX's
    ``_assemble_bin``/``_extract_bin`` (f64, 1e-12)."""
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops import gridder_idg as J

    pj, pt, pc = _plans(case)
    plan = pt if built == "port" else pc
    for f in ("S", "half", "k0_off", "nbu", "nbv", "nbig_x", "nbig_y", "ngroups", "bin_gstart", "bin_gcount"):
        assert getattr(plan, f) == getattr(pj, f), f
    np.testing.assert_array_equal(plan.bid.numpy(), np.asarray(pj.bid))
    P, G = _seeded(plan, 5)
    for b in range(plan.nbins):
        gs, gc = plan.bin_gstart[b], plan.bin_gcount[b]
        bid_b = plan.bid[gs : gs + gc]
        ref = np.asarray(J._assemble_bin(pj, jnp.asarray(P[:, gs : gs + gc].numpy()), jnp.asarray(bid_b.numpy())))
        gather = T.assemble_bin_gather_ref(plan, P, b).numpy()
        plain = T._assemble_bin(plan, P[:, gs : gs + gc], bid_b).numpy()
        eref = np.asarray(J._extract_bin(pj, jnp.asarray(G.numpy()), jnp.asarray(bid_b.numpy())))
        egather = T.extract_bin_gather_ref(plan, G, b).numpy()
        eplain = T._extract_bin(plan, G, bid_b).numpy()
        if gc == 0:
            assert not gather.any() and not plain.any() and egather.shape == eplain.shape == (2, 0, pt.S, pt.S)
            continue
        assert _rel(gather, ref) < TOL and _rel(plain, ref) < TOL, (case, b)
        assert _rel(egather, eref) < TOL and _rel(eplain, eref) < TOL, (case, b)


@pytest.mark.parametrize("case", list(CASES))
def test_gather_forms_are_adjoint(case):
    """<assemble(P), G> = <P, extract(G)> per bin, gather forms (1e-12)."""
    _, pt, _ = _plans(case)
    P, G = _seeded(pt, 9)
    for b in range(pt.nbins):
        gs, gc = pt.bin_gstart[b], pt.bin_gcount[b]
        if gc == 0:
            continue
        g = T.assemble_bin_gather_ref(pt, P, b)
        lhs = float((g.real * G.real + g.imag * G.imag).sum())
        rhs = float((P[:, gs : gs + gc] * T.extract_bin_gather_ref(pt, G, b)).sum())
        assert abs(lhs - rhs) <= TOL * abs(lhs), (case, b)


@pytest.mark.parametrize("case", list(CASES))
def test_csr_visits_each_group_once(case):
    """Each bin's CSR lists every group of the bin exactly once, under its
    own bucket, ascending within the bucket."""
    _, pt, pc = _plans(case)
    for plan in (pt, pc):
        csr = T.bucket_csr(plan)
        assert T.bucket_csr(plan) is csr  # cached
        nb = plan.nbu * plan.nbv
        starts = csr.starts.numpy().astype(np.int64)
        order = np.arange(plan.ngroups) if csr.order is None else csr.order.numpy()
        bid = plan.bid.numpy()
        for b in range(plan.nbins):
            gs, gc = plan.bin_gstart[b], plan.bin_gcount[b]
            row = starts[b * nb : (b + 1) * nb + 1]
            assert row[0] == gs and row[-1] == gs + gc and np.all(np.diff(row) >= 0)
            seen = []
            for k in np.flatnonzero(np.diff(row)):
                groups = order[row[k] : row[k + 1]]
                assert np.all(bid[groups] == k) and np.all(np.diff(groups) > 0)
                seen.extend(groups)
            assert sorted(seen) == list(range(gs, gs + gc))


@pytest.mark.parametrize("n,length", [(65, 32), (97, 32), (1024, 32), (1025, 64), (6053, 96), (8217, 96),
                                      (100_000, 320)])
def test_chunk_length(n, length):
    """ceil(sqrt(n)) rounded up to a warp multiple, exact in integers."""
    assert int(T.chunk_length(n)) == length
    assert T.chunk_length(np.array([n]))[0] == length


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_table_covers_long_buckets(case):
    """Every bucket with more than LONG_BUCKET groups is cut into chunks of
    ``chunk_length(n)`` consecutive CSR entries (the last takes the rest),
    which cover its range exactly once in CSR order; no short bucket has a
    chunk; each bin's chunks are its own. The table depends on the bucket
    counts alone: a CSR rebuilt from a copy of the same ``bid`` gives the
    same table, and so does the table of the counts alone."""
    _, pt, pc = _plans(case)
    for plan in (pt, pc):
        csr, nb = T.bucket_csr(plan), plan.nbu * plan.nbv
        starts = csr.starts.numpy().astype(np.int64)
        pstarts = np.zeros_like(starts) if csr.pstarts is None else csr.pstarts.numpy().astype(np.int64)
        chunks = np.zeros((0, 2), np.int64) if csr.chunks is None else csr.chunks.numpy().astype(np.int64)
        assert csr.bin_chunk0 == tuple(int(c) for c in pstarts[::nb]) and pstarts[-1] == len(chunks)
        for k, n in enumerate(np.diff(starts)):
            mine = chunks[pstarts[k] : pstarts[k + 1]]
            if n <= T.LONG_BUCKET:
                assert len(mine) == 0, (case, k)
                continue
            length = int(T.chunk_length(n))
            assert len(mine) == -(-n // length), (case, k)
            assert mine[0, 0] == starts[k] and mine[-1, 1] == starts[k + 1] and np.all(mine[1:, 0] == mine[:-1, 1])
            assert np.all(mine[:-1, 1] - mine[:-1, 0] == length) and 0 < mine[-1, 1] - mine[-1, 0] <= length
        again = T._build_csr(dataclasses.replace(plan, bid=plan.bid.clone()), (plan.bin_gstart, plan.bin_gcount))
        for f in ("starts", "pstarts", "chunks", "order", "first"):
            a, b = getattr(csr, f), getattr(again, f)
            assert (a is None and b is None) or torch.equal(a, b), (case, f)
        assert again.bin_chunk0 == csr.bin_chunk0
        table = T._chunk_table(np.concatenate([[0], np.cumsum(np.diff(starts))]) + starts[0])
        np.testing.assert_array_equal(table[0], pstarts if len(chunks) else np.zeros_like(starts))
        np.testing.assert_array_equal(table[1], chunks)


@pytest.mark.parametrize("case", list(CASES))
def test_first_marks_consecutive_buckets(case):
    """Where the CSR has an ``order``, ``first[k]`` is bucket k's first
    group exactly where its groups are consecutive (K1 then reads no order
    entry for it), else -1; without one every bucket is consecutive."""
    _, pt, _ = _plans(case)
    csr = T.bucket_csr(pt)
    if csr.order is None:
        assert csr.first is None
        return
    starts, order, first = csr.starts.numpy(), csr.order.numpy(), csr.first.numpy()
    for k in range(len(starts) - 1):
        groups = order[starts[k] : starts[k + 1]]
        run = len(groups) > 0 and np.array_equal(groups, groups[0] + np.arange(len(groups)))
        assert first[k] == (groups[0] if run else -1), (case, k)
    assert (first < 0).sum() >= 1  # a padded bucket 0 has its plan's own groups, then the padding


def test_k1_layout_check():
    """K1 takes every case's layout (half 8, 12, 16) and refuses, before
    any launch, a half it has no blocks for."""
    for case in CASES:
        T._check_k1_layout(_plans(case)[1])
    pt = _plans("chirp_s16")[1]
    for half in (4, 2):
        with pytest.raises(ValueError, match="half"):
            T._check_k1_layout(dataclasses.replace(pt, half=half))


def test_csr_follows_a_plan_padded_in_place():
    """The multiband planner pads a plan in place (new ``bid``, new bins):
    the cached CSR is rebuilt, with the padded groups ordered into bucket 0."""
    from pfb_imaging_tpu_torch.parallel.sharded import _pad_to_caps

    kw, _ = _plan_kw("chirp_s16")
    p = T.plan_idg(_uvw("wide"), FREQ, device=CPU, **kw)
    before = T.bucket_csr(p)
    assert before.order is None
    gcap = tuple(c + 2 for c in p.bin_gcount)
    _pad_to_caps(p, gcap, p.scal.new_zeros((4, sum(gcap), p.G)))
    after = T.bucket_csr(p)
    assert after is not before and after.order is not None
    P, _ = _seeded(p, 3)
    for b in range(p.nbins):
        gs, gc = p.bin_gstart[b], p.bin_gcount[b]
        ref = T._assemble_bin(p, P[:, gs : gs + gc], p.bid[gs : gs + gc])
        assert _rel(T.assemble_bin_gather_ref(p, P, b), ref) < TOL


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers run the JAX-formula plain versions (the
    same bits) and launch nothing; the forward writes every group."""
    _, pt, _ = _plans("padded_wplanes")
    P, G = _seeded(pt, 11)
    out = torch.full_like(P, float("nan"))
    with recording() as got:
        for b in range(pt.nbins):
            gs, gc = pt.bin_gstart[b], pt.bin_gcount[b]
            assert torch.equal(T.assemble_bin(pt, P, b),
                               T._assemble_bin(pt, P[:, gs : gs + gc], pt.bid[gs : gs + gc]))
            T.extract_bin(pt, G, b, out)
            assert torch.equal(out[:, gs : gs + gc], T._extract_bin(pt, G, pt.bid[gs : gs + gc]))
    assert not out.isnan().any()
    assert launches(got["counters"]) == {}


def test_idg_round_trip_unchanged_on_the_cpu():
    """The whole adjoint and forward on a padded wplanes plan: the runtime
    through the wrappers equals its composition of the plain versions."""
    _, pt, _ = _plans("padded_wplanes")
    rng = np.random.default_rng(13)
    vis = torch.as_tensor(rng.standard_normal((NROW, 2)) + 1j * rng.standard_normal((NROW, 2)))
    img = torch.as_tensor(rng.standard_normal((NX, NX)))
    vals = T._idg_prepare(pt, vis.real, vis.imag)
    patches = T.idg_fused.patches_from_vals(pt.scal, vals, pt.wcu, pt.wcv, pt.S)
    acc = torch.zeros((NX, NX), dtype=torch.complex128)
    for b in range(pt.nbins):
        gs, gc = pt.bin_gstart[b], pt.bin_gcount[b]
        grid = T._assemble_bin(pt, patches[:, gs : gs + gc], pt.bid[gs : gs + gc])
        big = torch.fft.ifft2(grid) * (pt.nbig_x * pt.nbig_y)
        acc += T._crop(pt, torch.fft.fftshift(big)) * T._screen(pt, b, -1.0)
    assert torch.equal(T.vis2dirty_idg(pt, vis), T._idg_finish(pt, acc))
    fwd = T._idg_bins_to_grid_patches(pt, img)
    assert not fwd.isnan().any()
    lhs = float((T.vis2dirty_idg(pt, vis) * img).sum())
    v = T.dirty2vis_idg(pt, img)
    rhs = float((vis.real * v.real + vis.imag * v.imag).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_classic_vis2dirty_is_plain_on_the_cpu():
    """The classic adjoint on a CPU plan is its plain version (the same
    bits), launching no B3."""
    rng = np.random.default_rng(3)
    uvw = _uvw("wide")
    plan = TG.plan_wgridder(uvw, FREQ, nx=NX, ny=NX, cellx=CELL, celly=CELL, epsilon=1e-5, device=CPU)
    vis = torch.as_tensor(rng.standard_normal((NROW, 2)) + 1j * rng.standard_normal((NROW, 2)))
    wgt = torch.as_tensor(rng.random((NROW, 2)))
    with recording() as got:
        assert torch.equal(TG.vis2dirty(plan, vis, wgt=wgt), TG.vis2dirty_plain(plan, vis, wgt))
    assert got["counters"].get("launch.scatter_grid_wstack", 0) == 0


# ── on a CUDA card only ───────────────────────────────────────────────


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _f32_plan(case, dev):
    kw, pad = _plan_kw(case)
    uvw = _uvw(CASES[case][1])
    if pad:
        counts = T.plan_idg(uvw, FREQ, count_only=True, device=dev, **kw)[1]
        kw["bin_gcap"] = tuple(int(c) + pad for c in counts)
    return T.plan_idg(uvw, FREQ, device=dev, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_on_cuda(case):
    """K1 and K2 against their plain versions in f32 and f64 (1e-6
    relative; where the f32 plain version's own sums of a long bucket leave
    it more than 1e-6 from f64, K1 nearer to f64 than it), K1 and its chunk
    sums the gather form's bits (it adds in K1's order), one launch count
    per call, and two launches the same bits."""
    dev = _cuda()
    plan = _f32_plan(case, dev)
    P, G = (t.to(dev) for t in _seeded(plan, 21))
    P, G = P.float(), G.to(torch.complex64)
    out1 = torch.full_like(P, float("nan"))
    out2 = torch.full_like(P, float("nan"))
    for b in range(plan.nbins):
        gs, gc = plan.bin_gstart[b], plan.bin_gcount[b]
        with recording() as got:
            g1, g2 = T.assemble_bin(plan, P, b), T.assemble_bin(plan, P, b)
            T.extract_bin(plan, G, b, out1)
            T.extract_bin(plan, G, b, out2)
        torch.cuda.synchronize()
        chunked = T.bucket_csr(plan).bin_chunk0[b + 1] > T.bucket_csr(plan).bin_chunk0[b]
        c = got["counters"]
        assert c.get("launch.idg_assemble", 0) == 2
        assert c.get("launch.idg_chunk_sums", 0) == (2 if chunked else 0)
        assert c.get("launch.idg_extract", 0) == (2 if gc else 0)
        assert torch.equal(g1, g2) and torch.equal(out1[:, gs : gs + gc], out2[:, gs : gs + gc])
        if gc == 0:
            assert not g1.any()
            continue
        ref = T._assemble_bin(plan, P[:, gs : gs + gc], plan.bid[gs : gs + gc])
        ref64 = T._assemble_bin(plan, P[:, gs : gs + gc].double(), plan.bid[gs : gs + gc]).cpu()
        rel, rel64, plain64 = _rel(g1.cpu(), ref.cpu()), _rel(g1.cpu(), ref64), _rel(ref.cpu(), ref64)
        # the f32 plain version adds a long bucket's groups one by one: where
        # that leaves it more than 1e-6 from f64, K1 must be the nearer to f64
        assert rel64 < 1e-6 and (rel < 1e-6 or (plain64 > 1e-6 and rel64 < plain64)), (rel, rel64, plain64)
        assert torch.equal(g1, T.assemble_bin_gather_ref(plan, P, b))
        if chunked:
            assert torch.equal(T.chunk_sums(plan, P, b), T.chunk_sums_ref(plan, P, b))
        assert torch.equal(out1[:, gs : gs + gc], T._extract_bin(plan, G, plan.bid[gs : gs + gc]))
    assert not out1.isnan().any()
    with pytest.raises(TypeError, match="float32"):
        T.assemble_bin(plan, P.double(), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["padded_long_bucket0", "padded_one_past_chunk"])
def test_chunk_table_same_on_the_card(case):
    """The CSR and chunk table of a plan on the card equal those built on
    the CPU from the same ``bid``: the chunks depend on the plan alone."""
    dev = _cuda()
    plan = _f32_plan(case, dev)
    bins = (plan.bin_gstart, plan.bin_gcount)
    on_card = T.bucket_csr(plan)
    on_cpu = T._build_csr(dataclasses.replace(plan, bid=plan.bid.cpu()), bins)
    assert on_card.chunks is not None and on_card.bin_chunk0 == on_cpu.bin_chunk0
    for f in ("starts", "pstarts", "chunks", "order", "first"):
        assert torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)), f


@pytest.mark.gpu
def test_classic_vis2dirty_runs_b3_on_cuda():
    """On the card the classic adjoint launches B3, gives the same bits
    twice, stays within 1e-5 of its f64 plain version, and refuses an f64
    plan."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    uvw = _uvw("wide")
    kw = dict(nx=NX, ny=NX, cellx=CELL, celly=CELL, epsilon=1e-5, device=dev)
    plan = TG.plan_wgridder(uvw, FREQ, dtype=np.float32, **kw)
    plan64 = TG.plan_wgridder(uvw, FREQ, dtype=np.float64, **kw)
    vis = torch.as_tensor(rng.standard_normal((NROW, 2)) + 1j * rng.standard_normal((NROW, 2)), device=dev)
    wgt = torch.as_tensor(rng.random((NROW, 2)), device=dev)
    with recording() as got:
        d1, d2 = TG.vis2dirty(plan, vis, wgt=wgt), TG.vis2dirty(plan, vis, wgt=wgt)
    torch.cuda.synchronize()
    assert got["counters"]["launch.scatter_grid_wstack"] > 0
    assert torch.equal(d1, d2)
    assert _rel(d1.cpu(), TG.vis2dirty_plain(plan64, vis, wgt).cpu()) < 1e-5
    with pytest.raises(ValueError, match="f32"):
        TG.vis2dirty(plan64, vis, wgt=wgt)
