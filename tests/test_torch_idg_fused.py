"""The fused IDG patch kernels of the port (ops/idg_fused.py,
csrc/idg_fused.cu): plain versions against the JAX Pallas kernels run in
interpret mode and against a dense f64 oracle, the adjoint identity, the
constant layout, and — on a CUDA card only — each kernel against its
plain version.

JAX is imported inside the tests that compare with it, so the ``gpu``
tests also run where only PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_idg_fused.py``.
"""

import numpy as np
import pytest
import torch

from pfb_imaging_tpu_torch.ops import idg_fused as F

torch.set_num_threads(1)
G = F.G


def _inputs(S, ng, seed=7):
    """Angles, values and taper-DFT constants as the JAX kernel tests make them."""
    rng = np.random.default_rng(seed)
    tfac = 2 * np.pi / S
    half = S // 2
    k0 = (S - half) // 2
    scal = np.stack([
        tfac * (k0 + half * rng.random((ng, G))), 0.005 * rng.standard_normal((ng, G)),
        tfac * (k0 + half * rng.random((ng, G))), 0.005 * rng.standard_normal((ng, G)),
    ]).astype(np.float32)
    vals = rng.standard_normal((2, ng, G)).astype(np.float32)
    W = np.exp(-2j * np.pi * np.outer(np.arange(S), np.arange(S)) / S)
    wcu = W * (rng.standard_normal(S) + 1j * rng.standard_normal(S))[None, :]
    wcv = W * (rng.standard_normal(S) + 1j * rng.standard_normal(S))[None, :]
    return scal, vals, wcu, wcv


def _ri(w):
    return np.stack([w.real, w.imag])


def _fitted_wc(S):
    """A production taper-DFT factor W diag(c): the 64^2 chirp-plan fit at
    the tier's epsilon (S=16: 1e-5, else 1e-7)."""
    from pfb_imaging_tpu_torch.ops.gridder_idg import fit_taper

    nbig = 120 if S == 16 else 128
    c, _, _ = fit_taper(S, S // 2, 64 / (2.0 * nbig) + 0.01, 0.1, tol=0.25 * (1e-5 if S == 16 else 1e-7))
    return np.exp(-2j * np.pi * np.outer(np.arange(S), np.arange(S)) / S) * c[None, :]


def _t(a, dtype=torch.float64, device="cpu"):
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)


def _oracle(S, scal, vals, wcu, wcv):
    xc = np.fft.fftfreq(S) * S
    s = np.asarray(scal, np.float64)
    Zu = np.exp(1j * (s[0][:, None, :] * xc[None, :, None] + s[1][:, None, :] * (xc**2)[None, :, None]))
    Zv = np.exp(1j * (s[2][:, None, :] * xc[None, :, None] + s[3][:, None, :] * (xc**2)[None, :, None]))
    Au = np.einsum("kx,gxv->gkv", wcu, Zu)
    Av = np.einsum("kx,gxv->gkv", wcv, Zv)
    V = vals[0].astype(np.float64) + 1j * vals[1]
    return Au, Av, np.einsum("gkv,gv,glv->gkl", Au, V, Av)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("S,zpasses", [(16, 3), (32, 6)])
def test_plain_versions_match_jax_interpret(S, zpasses):
    """f64 plain versions against the f32 Pallas kernels on a production
    taper: the JAX kernel's own error is what the tolerance bounds."""
    import jax.numpy as jnp

    from pfb_imaging_tpu.ops import idg_fused as J

    ng = J.block_groups(S)
    scal, vals, _, _ = _inputs(S, ng)
    wcu = wcv = _fitted_wc(S)
    exp = 2 if zpasses <= 3 else 3
    kw = dict(S=S, zpasses=zpasses, expasses=exp, interpret=True)
    wu8, wv8 = jnp.asarray(J.wc_perm_kron(wcu)), jnp.asarray(J.wc_perm_kron(wcv))
    pj = np.asarray(J.patches_from_vals(jnp.asarray(scal), jnp.asarray(vals), wu8, wv8, **kw))
    wu, wv = _t(_ri(wcu).astype(np.float32)), _t(_ri(wcv).astype(np.float32))
    pt = F.patches_from_vals_ref(_t(scal), _t(vals), wu, wv, S).numpy()
    tol = 2e-5 if zpasses == 3 else 2e-6
    assert _rel(pj, pt) < tol
    y = np.random.default_rng(1).standard_normal((2, ng, S, S)).astype(np.float32)
    yt = jnp.transpose(jnp.asarray(y), (0, 2, 1, 3)).reshape(2, S, ng * S)
    vj = np.asarray(J.vals_from_patches(yt, jnp.asarray(scal), wu8, wv8, **kw))
    vt = F.vals_from_patches_ref(_t(y), _t(scal), wu, wv, S).numpy()
    assert _rel(vj, vt) < tol


@pytest.mark.parametrize("S", [16, 24, 32])
def test_plain_versions_match_dense_oracle(S):
    scal, vals, wcu, wcv = _inputs(S, 6, seed=S)
    Au, Av, P = _oracle(S, scal, vals, wcu, wcv)
    got = F.patches_from_vals_ref(_t(scal), _t(vals), _t(_ri(wcu)), _t(_ri(wcv)), S).numpy()
    assert _rel(got[0] + 1j * got[1], P) < 1e-12
    y = np.random.default_rng(S).standard_normal((2, 6, S, S))
    Y = y[0] + 1j * y[1]
    ref = np.einsum("gkv,gkl,glv->gv", Au.conj(), Y, Av.conj())
    got = F.vals_from_patches_ref(_t(y), _t(scal), _t(_ri(wcu)), _t(_ri(wcv)), S).numpy()
    assert _rel(got[0] + 1j * got[1], ref) < 1e-12


@pytest.mark.parametrize("S", [16, 24, 32])
def test_plain_forward_is_exact_transpose(S):
    """<patches(v), y> == <v, vals(y)> over the real inner product."""
    scal, vals, wcu, wcv = _inputs(S, 5, seed=3)
    wu, wv = _t(_ri(wcu)), _t(_ri(wcv))
    p = F.patches_from_vals_ref(_t(scal), _t(vals), wu, wv, S)
    y = _t(np.random.default_rng(4).standard_normal(tuple(p.shape)))
    back = F.vals_from_patches_ref(y, _t(scal), wu, wv, S)
    lhs, rhs = float((p * y).sum()), float((_t(vals) * back).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


@pytest.mark.parametrize("S", [16, 32])
def test_plain_f32_close_to_f64(S):
    scal, vals, wcu, wcv = _inputs(S, 8, seed=5)
    p64 = F.patches_from_vals_ref(_t(scal), _t(vals), _t(_ri(wcu)), _t(_ri(wcv)), S)
    p32 = F.patches_from_vals_ref(*(_t(a, torch.float32) for a in (scal, vals, _ri(wcu), _ri(wcv))), S)
    assert _rel(p32.double(), p64) < 1e-5


@pytest.mark.parametrize("S", [16, 24, 32])
def test_wc_from_perm_kron_round_trip(S):
    from pfb_imaging_tpu.ops import idg_fused as J

    wc = _inputs(S, 1)[2]
    back = F.wc_from_perm_kron(J.wc_perm_kron(wc), S)
    np.testing.assert_allclose(back[0] + 1j * back[1], wc.astype(np.complex64), rtol=0, atol=1e-6)


def test_cpu_wrappers_take_the_plain_version_without_launching():
    S = 16
    scal, vals, wcu, wcv = _inputs(S, 3)
    before = dict(F.LAUNCHES)
    args = (_t(scal), _t(vals), _t(_ri(wcu)), _t(_ri(wcv)))
    p = F.patches_from_vals(*args, S)
    assert torch.equal(p, F.patches_from_vals_ref(*args, S))
    v = F.vals_from_patches(p, args[0], args[2], args[3], S)
    assert torch.equal(v, F.vals_from_patches_ref(p, args[0], args[2], args[3], S))
    assert F.LAUNCHES == before


def test_launch_checks_refuse_bad_inputs():
    S, ng = 16, 2
    ok = dict(scal=torch.zeros(4, ng, G), vals=torch.zeros(2, ng, G), wcu=torch.zeros(2, S, S),
              wcv=torch.zeros(2, S, S))
    F._check_cuda(S, ng, **ok)
    with pytest.raises(TypeError):
        F._check_cuda(S, ng, **dict(ok, vals=torch.zeros(2, ng, G, dtype=torch.float64)))
    with pytest.raises(ValueError):
        F._check_cuda(S, ng, **dict(ok, vals=torch.zeros(2, ng + 1, G)))
    with pytest.raises(ValueError):
        F._check_cuda(S, ng, **dict(ok, wcu=torch.zeros(2, S, 2 * S)[:, :, ::2]))
    with pytest.raises(ValueError):
        F._check_cuda(20, ng, **ok)


def _tf32(x):
    """f32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: to 10 mantissa bits,
    nearest, ties away from zero (the 13 low bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """f32 a @ b from TF32 parts with f32 sums: big*big alone (one pass), or
    small*big + big*small + big*big (3xTF32), big = tf32(x), small =
    tf32(x - big), as the CUDA kernels split each operand."""
    ab, bb = _tf32(a), _tf32(b)
    out = ab @ bb
    if passes == 3:
        out = (_tf32(a - ab) @ bb + ab @ _tf32(b - bb)) + out
    return out


def _cmm_tf32(a, b, passes):
    """Complex a @ b as the kernels take it: one real product of stacked
    operands, [Or; Oi] = [[Ar, -Ai], [Ai, Ar]] [Br; Bi], in TF32 passes."""
    a = a.to(torch.complex64)
    b = b.to(torch.complex64)
    A = torch.cat([torch.cat([a.real, -a.imag], -1), torch.cat([a.imag, a.real], -1)], -2)
    B = torch.cat([b.real, b.imag], -2)
    O = _mm_tf32(A, B, passes)
    R = a.shape[-2]
    return torch.complex(O[..., :R, :], O[..., R:, :])


def _b1_tf32(scal, vals, Wu, Wv, S, passes):
    """B1's products in TF32 passes: M^T = Bv Zu^T over the slots, Q = Wv M^T,
    P = Wu Q^T; Z rows from the f64 recurrence rounded once to f32."""
    Zu = F._rot_rows(scal[0], scal[1], S, False).permute(1, 0, 2)
    Bv = (F._rot_rows(scal[2], scal[3], S, False) * torch.complex(vals[0], vals[1])).permute(1, 0, 2)
    Mt = _cmm_tf32(Bv, Zu.transpose(1, 2), passes)
    Q = _cmm_tf32(Wv, Mt, passes)
    return _cmm_tf32(Wu, Q.transpose(1, 2), passes)


def _b2_tf32(P, scal, Wu, Wv, S, passes):
    """B2's products in TF32 passes: T1 = P conj(Wv), R = conj(Wu)^T T1,
    T = R conj(Zv) over the slots; then V = sum_x conj(Zu) T in f32."""
    cZu = F._rot_rows(scal[0], scal[1], S, True).permute(1, 0, 2).to(torch.complex64)
    cZv = F._rot_rows(scal[2], scal[3], S, True).permute(1, 0, 2)
    T1 = _cmm_tf32(P, Wv.conj(), passes)
    R = _cmm_tf32(Wu.conj().transpose(0, 1), T1, passes)
    return (cZu * _cmm_tf32(R, cZv, passes)).sum(1)


@pytest.mark.parametrize("kernel", ["b1", "b2"])
@pytest.mark.parametrize("S", [16, 24, 32])
def test_split_tf32_products_reach_f32_accuracy(S, kernel):
    """The kernels' 3xTF32 split, emulated in torch on a production taper:
    within 5e-7 of the f64 plain version, where one TF32 pass is not
    within 1e-5 (so the split is what buys the f32 contract of 2e-6)."""
    ng = 6
    scal, vals, _, _ = _inputs(S, ng, seed=S + 1)
    wc = _ri(_fitted_wc(S)).astype(np.float32)
    wu64 = wv64 = _t(wc)
    Wu = Wv = torch.complex(wu64[0], wu64[1])
    s64 = _t(scal)
    if kernel == "b1":
        ref = F.patches_from_vals_ref(s64, _t(vals), wu64, wv64, S)
        ref = torch.complex(ref[0], ref[1])
        got = {n: _b1_tf32(s64, _t(vals), Wu, Wv, S, n) for n in (1, 3)}
    else:
        y = np.random.default_rng(S).standard_normal((2, ng, S, S)).astype(np.float32)
        ref = F.vals_from_patches_ref(_t(y), s64, wu64, wv64, S)
        ref = torch.complex(ref[0], ref[1])
        got = {n: _b2_tf32(torch.complex(_t(y[0]), _t(y[1])), s64, Wu, Wv, S, n) for n in (1, 3)}
    assert _rel(got[3].to(torch.complex128), ref) <= 5e-7
    assert _rel(got[1].to(torch.complex128), ref) > 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("ng", [1024, 1021, 1, 0])
@pytest.mark.parametrize("S", [16, 24, 32])
def test_cuda_kernels_match_plain_versions(S, ng):
    """Each kernel against its plain version, also at a ragged ng (not a
    multiple of the blocks the card holds), one group and none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    scal, vals, _, _ = _inputs(S, ng, seed=11)
    wcu = wcv = _ri(_fitted_wc(S))
    f32 = [_t(a, torch.float32, dev) for a in (scal, vals, wcu, wcv)]
    f64 = [a.double() for a in f32]
    n0 = dict(F.LAUNCHES)
    p = F.patches_from_vals(*f32, S)
    y = torch.randn((2, ng, S, S), generator=torch.Generator(dev).manual_seed(3), device=dev)
    v = F.vals_from_patches(y, f32[0], f32[2], f32[3], S)
    torch.cuda.synchronize()
    assert p.shape == (2, ng, S, S) and v.shape == (2, ng, G)
    if ng:
        assert _rel(p.double().cpu(), F.patches_from_vals_ref(*f64, S).cpu()) < 2e-6
        assert _rel(v.double().cpu(), F.vals_from_patches_ref(y.double(), f64[0], f64[2], f64[3], S).cpu()) < 2e-6
    assert F.LAUNCHES["patches_from_vals"] == n0["patches_from_vals"] + (ng > 0)
    assert F.LAUNCHES["vals_from_patches"] == n0["vals_from_patches"] + (ng > 0)
    with pytest.raises(TypeError):
        F.patches_from_vals(*f64, S)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_at_a_wplanes_plan():
    """B1/B2 on the input a wplanes plan gives them: S = 32, the chirp rows
    of ``scal`` zero, group values carrying ES-weighted slot phases; each
    against its f64 plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from pfb_imaging_tpu_torch.ops.gridder_idg import _idg_prepare, plan_idg

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    uvw = rng.uniform(-800, 800, (4000, 3))
    uvw[:, 2] = rng.uniform(-2200, 2200, 4000)
    freq = np.linspace(1e9, 1.1e9, 2)
    plan = plan_idg(uvw, freq, nx=128, ny=128, cellx=1e-4, celly=1e-4, epsilon=1e-7, w_mode="wplanes", device=dev)
    assert plan.S == 32 and plan.w_support > 1 and not plan.scal[1].any() and not plan.scal[3].any()
    vis = torch.as_tensor(rng.standard_normal((2, 4000, 2)), device=dev).float()
    vals = _idg_prepare(plan, vis[0], vis[1])
    p = F.patches_from_vals(plan.scal, vals, plan.wcu, plan.wcv, plan.S)
    v = F.vals_from_patches(p, plan.scal, plan.wcu, plan.wcv, plan.S)
    f64 = [t.double() for t in (plan.scal, vals, plan.wcu, plan.wcv, p)]
    assert _rel(p.double().cpu(), F.patches_from_vals_ref(*f64[:4], plan.S).cpu()) < 2e-6
    assert _rel(v.double().cpu(), F.vals_from_patches_ref(f64[4], f64[0], f64[2], f64[3], plan.S).cpu()) < 2e-6
