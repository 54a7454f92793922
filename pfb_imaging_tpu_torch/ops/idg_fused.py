"""Fused IDG patch evaluation: the two CUDA kernels of the grid/degrid round
trip, their plain PyTorch versions, and the wrappers that pick between
them (port of pfb_imaging_tpu/ops/idg_fused.py).

* ``patches_from_vals`` (adjoint) replaces the Pallas kernel
  ``idg_fused.patches_from_vals`` (pfb_imaging_tpu/ops/idg_fused.py:253,
  body ``_adj_kernel_body`` :228):
  P_g = Wu (Zu diag(V_g) Zv^T) Wv^T, (2, ng, G) values -> (2, ng, S, S).
* ``vals_from_patches`` (forward, its exact transpose) replaces
  ``idg_fused.vals_from_patches`` (:329, body ``_fwd_kernel_body`` :287):
  V_g[v] = sum_{k,l} conj(Au)[k,v] P[k,l] conj(Av)[l,v]. It takes patches
  as (2, ng, S, S): the x-major transpose the TPU kernel wanted was a lane
  layout need.

Z[x, v] = exp(i (du_v xc[x] + phi_v xc[x]^2)), xc = fftfreq(S)*S, is
rebuilt from the plan's per-slot angles ``scal`` (4, ng, G) by the
rotation-power recurrence of the TPU kernel (angles < 2 pi, so no large
phase is ever reduced; the kernels run it in f64); Au = Wu Zu with the
taper-DFT constant ``wcu`` (2, S, S) = [re, im] of W diag(c).

The kernels are bound by operations (S^2 G complex MACs per group for the
slot contraction, 2 S^3 for the taper-DFT products). Every complex product
runs on the tensor cores as one real product of stacked operands, in three
TF32 passes (3xTF32: each operand split into a TF32 big part and a TF32
small part, small*big + big*small + big*big with f32 sums), which is as
accurate as plain f32 here; one TF32 pass would miss the 2e-6 contract
~150x. Persistent blocks walk the groups one at a time, so any ng >= 0 is
taken as it is. The header of ``csrc/idg_fused.cu`` gives the design.

The wrappers run the plain version only for tensors on the CPU. For CUDA
tensors they launch the kernel (f32 only) or raise.
"""

from __future__ import annotations

import numpy as np
import torch

G = 128
SUPPORTED_S = (16, 24, 32)

# groups per chunk of the plain versions (bounds their (S, chunk, G)
# complex temporaries to ~0.1-0.3 GB)
_REF_CHUNK = 8192


def pack_count(S: int) -> int:
    """Groups per 128-row pack of the TPU kernel's permuted-kron constant."""
    return 128 // S


def wc_from_perm_kron(w8, S: int) -> np.ndarray:
    """Permuted-kron TPU constant (2, PK*S, PK*S) -> taper-DFT factor (2, S, S).

    Inverse of the JAX ``wc_perm_kron``: W8[g*S + k, x*PK + g] = wc[k, x],
    so group 0's rows, every PK-th column, are wc itself."""
    w8 = np.asarray(w8)
    pk = pack_count(S)
    if w8.shape[-2:] != (pk * S, pk * S):
        raise ValueError(f"not a permuted-kron constant for S={S}: shape {w8.shape}")
    return np.ascontiguousarray(w8[:, :S, ::pk])


def _rot_rows(du, phi, S: int, conj: bool):
    """(...) angles -> complex (S, ...) rows Z[x] (conj(Z) when ``conj``),
    by the same rotation-power recurrence as the kernel."""
    sgn = -1.0 if conj else 1.0
    zr, zi = torch.cos(du), sgn * torch.sin(du)
    qr, qi = torch.cos(phi), sgn * torch.sin(phi)
    rows_r = [None] * S
    rows_i = [None] * S
    rows_r[0], rows_i[0] = torch.ones_like(du), torch.zeros_like(du)
    pr, pi = rows_r[0], rows_i[0]
    mr, mi = pr, pi
    cr, ci = qr, qi
    q2r, q2i = qr * qr - qi * qi, 2.0 * qr * qi
    nh = S // 2
    for k in range(1, nh + 1):
        fr, fi = zr * cr - zi * ci, zr * ci + zi * cr
        br, bi = zr * cr + zi * ci, zr * ci - zi * cr
        pr, pi = pr * fr - pi * fi, pr * fi + pi * fr
        mr, mi = mr * br - mi * bi, mr * bi + mi * br
        if k <= nh - 1:
            rows_r[k], rows_i[k] = pr, pi
        rows_r[S - k], rows_i[S - k] = mr, mi
        cr, ci = cr * q2r - ci * q2i, cr * q2i + ci * q2r
    return torch.complex(torch.stack(rows_r), torch.stack(rows_i))


def _cw(w):
    return torch.complex(w[0], w[1])


def patches_from_vals_ref(scal, vals, wcu, wcv, S: int):
    """Plain version of the adjoint kernel, in the input's dtype."""
    Wu, Wv = _cw(wcu), _cw(wcv)
    ng = scal.shape[1]
    out = scal.new_empty((2, ng, S, S))
    for s in range(0, ng, _REF_CHUNK):
        e = min(ng, s + _REF_CHUNK)
        Zu = _rot_rows(scal[0, s:e], scal[1, s:e], S, False)  # (S, n, G)
        Bv = _rot_rows(scal[2, s:e], scal[3, s:e], S, False) * torch.complex(vals[0, s:e], vals[1, s:e])
        M = torch.einsum("xgv,ygv->gxy", Zu, Bv)
        P = Wu @ M @ Wv.transpose(0, 1)
        out[0, s:e], out[1, s:e] = P.real, P.imag
    return out


def vals_from_patches_ref(patches, scal, wcu, wcv, S: int):
    """Plain version of the forward kernel, in the input's dtype."""
    Wu, Wv = _cw(wcu), _cw(wcv)
    ng = scal.shape[1]
    out = scal.new_empty((2, ng, G))
    for s in range(0, ng, _REF_CHUNK):
        e = min(ng, s + _REF_CHUNK)
        R = Wu.conj().transpose(0, 1) @ torch.complex(patches[0, s:e], patches[1, s:e]) @ Wv.conj()
        cZu = _rot_rows(scal[0, s:e], scal[1, s:e], S, True)
        cZv = _rot_rows(scal[2, s:e], scal[3, s:e], S, True)
        T = torch.einsum("gxy,ygv->xgv", R, cZv)
        V = (cZu * T).sum(0)
        out[0, s:e], out[1, s:e] = V.real, V.imag
    return out


def _check_cuda(S: int, ng: int, **tensors):
    """Device, dtype, shape and contiguity checks before a launch."""
    if S not in SUPPORTED_S:
        raise ValueError(f"subgrid S={S} not in {SUPPORTED_S}")
    shapes = dict(scal=(4, ng, G), vals=(2, ng, G), patches=(2, ng, S, S), wcu=(2, S, S), wcv=(2, S, S))
    dev = tensors["scal"].device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, scal on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def patches_from_vals(scal, vals, wcu, wcv, S: int):
    """Adjoint patch evaluation: (2, ng, G) values -> (2, ng, S, S) patches."""
    if scal.device.type == "cpu":
        return patches_from_vals_ref(scal, vals, wcu, wcv, S)
    ng = scal.shape[1]
    _check_cuda(S, ng, scal=scal, vals=vals, wcu=wcu, wcv=wcv)
    out = torch.empty((2, ng, S, S), dtype=torch.float32, device=scal.device)
    if ng:
        from ..kernels.build import check, load, stream

        code = load().pfb_patches_from_vals(
            scal.data_ptr(), vals.data_ptr(), wcu.data_ptr(), wcv.data_ptr(), out.data_ptr(), ng, S,
            stream(scal.device),
        )
        check(code, "patches_from_vals")
    return out


def vals_from_patches(patches, scal, wcu, wcv, S: int):
    """Forward evaluation: (2, ng, S, S) patches -> (2, ng, G) values."""
    if scal.device.type == "cpu":
        return vals_from_patches_ref(patches, scal, wcu, wcv, S)
    ng = scal.shape[1]
    _check_cuda(S, ng, patches=patches, scal=scal, wcu=wcu, wcv=wcv)
    out = torch.empty((2, ng, G), dtype=torch.float32, device=scal.device)
    if ng:
        from ..kernels.build import check, load, stream

        code = load().pfb_vals_from_patches(
            patches.data_ptr(), scal.data_ptr(), wcu.data_ptr(), wcv.data_ptr(), out.data_ptr(), ng, S,
            stream(scal.device),
        )
        check(code, "vals_from_patches")
    return out
