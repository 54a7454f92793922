// Fused IDG patch evaluation for Hopper (sm_90a): the two kernels of the
// image-domain-gridding round trip, with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of pfb_imaging_tpu/ops/idg_fused.py:
//   * pfb_patches_from_vals  <- idg_fused.patches_from_vals (_adj_kernel_body)
//       P_g = Wu (Zu diag(V_g) Zv^T) Wv^T                 (adjoint / grid)
//   * pfb_vals_from_patches  <- idg_fused.vals_from_patches (_fwd_kernel_body)
//       V_g[v] = sum_{x,y} conj(Zu[x,v]) R[x,y] conj(Zv[y,v]),
//       R = conj(Wu)^T P_g conj(Wv)                       (forward / degrid)
// Z[x, v] = exp(i (du_v xc[x] + phi_v xc[x]^2)), xc = fftfreq(S) * S, is
// rebuilt per slot by the rotation-power recurrence of _rot_block: two
// sincos per (slot, axis) and S complex multiplies. The recurrence is an
// accuracy device, not a TPU one — the angles stay below 2 pi, so no
// large phase is ever reduced.
//
// What bounds it on the card: FMA issue. A group costs ~S^2 * G complex
// MACs (4 f32 FMAs each) for the slot contraction plus 2 S^3 for the two
// taper-DFT products, against 24 bytes per slot in and 8 S^2 bytes per
// patch out — 30 (S = 16) to 70 (S = 32) FMAs per byte, above the H100's
// ridge of ~10 f32 FMAs per byte (33.5 T FMA/s over 3.35 TB/s).
// Design: one block per group, one thread per slot (G = 128 threads).
// Everything a group touches lives in shared memory (B1 needs ~101 KB at
// S = 32 and takes the dynamic-shared-memory opt-in); the slot columns are
// stored with a padded row stride (S + 1) so neither the per-slot writes
// nor the contraction reads serialise on one bank; each thread owns one
// output column and NR rows, so the slot-column value it loads is reused
// NR times from registers. Plain f32 FMAs replace the TPU's bf16 split
// matmuls and 0/1 packing matmuls, which were MXU devices. No tensor
// cores: the f32 accuracy contract (rel 2e-6) rules out TF32.
//
// Layouts (all f32, C-contiguous): scal (4, ng, G) [du_u, phi_u, du_v,
// phi_v]; vals (2, ng, G) [re, im]; wcu, wcv (2, S, S) [re, im] with
// W[k, x] = exp(-2 pi i k x / S) c[x]; patches (2, ng, S, S).
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int G = 128;

// acc += a * b, and acc += conj(a) * b
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}
__device__ __forceinline__ void cmac_conj_a(float2& acc, float2 a, float2 b) {
  acc.x += a.x * b.x + a.y * b.y;
  acc.y += a.x * b.y - a.y * b.x;
}

// col[x * stride] = Z[x] * V for x in [0, S): Z[x] = z^xc q^(xc^2) with
// z = e^{i du}, q = e^{i phi} (conjugated when CONJ). Row k <- z^k q^(k^2),
// row S-k <- conj(z)^k q^(k^2); both advance by a running q^(2k-1) factor.
// The recurrence runs in f64 and each entry is rounded once to f32: in
// f32 its S/2 chained products drift ~1e-6 in phase, which alone would
// spend the 2e-6 accuracy contract. It costs ~S f64 complex products per
// slot and axis against ~4 S^2 f32 FMAs of the contraction.
template <int S, bool CONJ>
__device__ __forceinline__ void rot_column(float du, float phi, float vr, float vi, float2* col, int stride) {
  constexpr int NH = S / 2;
  double sz, cz, sq, cq;
  sincos((double)du, &sz, &cz);
  sincos((double)phi, &sq, &cq);
  const double zr = cz, zi = CONJ ? -sz : sz;
  const double qr = cq, qi = CONJ ? -sq : sq;
  col[0] = make_float2(vr, vi);
  double pr = 1.0, pi = 0.0, mr = 1.0, mi = 0.0, cr = qr, ci = qi;
  const double q2r = qr * qr - qi * qi, q2i = 2.0 * qr * qi;
#pragma unroll
  for (int k = 1; k <= NH; ++k) {
    const double fr = zr * cr - zi * ci, fi = zr * ci + zi * cr;  // z * c
    const double br = zr * cr + zi * ci, bi = zr * ci - zi * cr;  // conj(z) * c
    double t = pr * fr - pi * fi;
    pi = pr * fi + pi * fr;
    pr = t;
    t = mr * br - mi * bi;
    mi = mr * bi + mi * br;
    mr = t;
    if (k <= NH - 1) col[k * stride] = make_float2((float)(pr * vr - pi * vi), (float)(pr * vi + pi * vr));
    col[(S - k) * stride] = make_float2((float)(mr * vr - mi * vi), (float)(mr * vi + mi * vr));
    t = cr * q2r - ci * q2i;
    ci = cr * q2i + ci * q2r;
    cr = t;
  }
}

// Shared-memory layout (float2 units) and output-ownership of the kernels:
// thread t < R*S owns column t % S and rows t / S + R*j, j < NR.
template <int S>
struct Tile {
  static constexpr int SP = S + 1;            // padded row stride
  static constexpr int R = G / S;             // threads per column
  static constexpr int NR = (S + R - 1) / R;  // rows per thread
  static constexpr int MAT = S * SP;          // one S x S matrix
};

template <int S>
__device__ __forceinline__ void load_w(const float* __restrict__ w, float2* ws, int t) {
  constexpr int SP = Tile<S>::SP;
  for (int i = t; i < S * S; i += G) ws[(i / S) * SP + i % S] = make_float2(w[i], w[S * S + i]);
}

template <int S>
__global__ void __launch_bounds__(G) patches_from_vals_kernel(
    const float* __restrict__ scal, const float* __restrict__ vals, const float* __restrict__ wcu,
    const float* __restrict__ wcv, float* __restrict__ out, long long ng) {
  using T = Tile<S>;
  constexpr int SP = T::SP, R = T::R, NR = T::NR;
  extern __shared__ float2 smem[];
  float2* zu = smem;             // (G, SP): zu[v*SP + x] = Zu[x, v]
  float2* bv = zu + G * SP;      // (G, SP): Zv[y, v] * V[v]
  float2* wu = bv + G * SP;      // (S, SP): Wu[k, x]
  float2* wv = wu + T::MAT;      // (S, SP): Wv[l, y]
  float2* mm = wv + T::MAT;      // (S, SP): M[x, y] = sum_v Zu[x,v] Bv[y,v]
  float2* tt = mm + T::MAT;      // (S, SP): Tm[x, l] = sum_y M[x,y] Wv[l,y]
  const int t = threadIdx.x;
  const long long g = blockIdx.x;
  const long long ngG = ng * G;
  const long long o = g * G + t;

  load_w<S>(wcu, wu, t);
  load_w<S>(wcv, wv, t);
  rot_column<S, false>(scal[o], scal[ngG + o], 1.f, 0.f, zu + t * SP, 1);
  rot_column<S, false>(scal[2 * ngG + o], scal[3 * ngG + o], vals[o], vals[ngG + o], bv + t * SP, 1);
  __syncthreads();

  const int col = t % S, row0 = t / S;
  const bool active = t < R * S;
  float2 acc[NR];

  // M = Zu diag(V) Zv^T: contract the G slots
  if (active) {
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int v = 0; v < G; ++v) {
      const float2 b = bv[v * SP + col];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int x = row0 + R * j;
        if (x < S) cmac(acc[j], zu[v * SP + x], b);
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int x = row0 + R * j;
      if (x < S) mm[x * SP + col] = acc[j];
    }
  }
  __syncthreads();

  // Tm = M Wv^T
  if (active) {
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int y = 0; y < S; ++y) {
      const float2 w = wv[col * SP + y];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int x = row0 + R * j;
        if (x < S) cmac(acc[j], mm[x * SP + y], w);
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int x = row0 + R * j;
      if (x < S) tt[x * SP + col] = acc[j];
    }
  }
  __syncthreads();

  // P = Wu Tm, straight to the (2, ng, S, S) output
  if (active) {
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int x = 0; x < S; ++x) {
      const float2 tv = tt[x * SP + col];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int k = row0 + R * j;
        if (k < S) cmac(acc[j], wu[k * SP + x], tv);
      }
    }
    const long long plane = ng * S * S;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int k = row0 + R * j;
      if (k < S) {
        const long long idx = (g * S + k) * S + col;
        out[idx] = acc[j].x;
        out[plane + idx] = acc[j].y;
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(G) vals_from_patches_kernel(
    const float* __restrict__ patches, const float* __restrict__ scal, const float* __restrict__ wcu,
    const float* __restrict__ wcv, float* __restrict__ out, long long ng) {
  using T = Tile<S>;
  constexpr int SP = T::SP, R = T::R, NR = T::NR;
  extern __shared__ float2 smem[];
  float2* wu = smem;             // (S, SP): Wu[k, x]
  float2* wv = wu + T::MAT;      // (S, SP): Wv[l, y]
  float2* pp = wv + T::MAT;      // (S, SP): P[k, l]
  float2* tt = pp + T::MAT;      // (S, SP): Tm[k, y] = sum_l P[k,l] conj(Wv[l,y])
  float2* rr = tt + T::MAT;      // (S, SP): R[x, y] = sum_k conj(Wu[k,x]) Tm[k,y]
  const int t = threadIdx.x;
  const long long g = blockIdx.x;
  const long long plane = ng * S * S;

  load_w<S>(wcu, wu, t);
  load_w<S>(wcv, wv, t);
  for (int i = t; i < S * S; i += G) {
    const long long idx = g * S * S + i;
    pp[(i / S) * SP + i % S] = make_float2(patches[idx], patches[plane + idx]);
  }
  __syncthreads();

  const int col = t % S, row0 = t / S;
  const bool active = t < R * S;
  float2 acc[NR];

  // Tm = P conj(Wv)
  if (active) {
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int l = 0; l < S; ++l) {
      const float2 w = wv[l * SP + col];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int k = row0 + R * j;
        if (k < S) cmac_conj_a(acc[j], w, pp[k * SP + l]);
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int k = row0 + R * j;
      if (k < S) tt[k * SP + col] = acc[j];
    }
  }
  __syncthreads();

  // R = conj(Wu)^T Tm
  if (active) {
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int k = 0; k < S; ++k) {
      const float2 tv = tt[k * SP + col];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int x = row0 + R * j;
        if (x < S) cmac_conj_a(acc[j], wu[k * SP + x], tv);
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int x = row0 + R * j;
      if (x < S) rr[x * SP + col] = acc[j];
    }
  }
  __syncthreads();

  // per slot: V = sum_x conj(Zu[x]) sum_y R[x,y] conj(Zv[y]); the conj
  // columns live in registers (fully unrolled), R is a warp broadcast
  const long long ngG = ng * G;
  const long long o = g * G + t;
  float2 czu[S], czv[S];
  rot_column<S, true>(scal[o], scal[ngG + o], 1.f, 0.f, czu, 1);
  rot_column<S, true>(scal[2 * ngG + o], scal[3 * ngG + o], 1.f, 0.f, czv, 1);
  float2 val = make_float2(0.f, 0.f);
#pragma unroll
  for (int x = 0; x < S; ++x) {
    float2 inner = make_float2(0.f, 0.f);
#pragma unroll
    for (int y = 0; y < S; ++y) cmac(inner, rr[x * SP + y], czv[y]);
    cmac(val, czu[x], inner);
  }
  out[o] = val.x;
  out[ngG + o] = val.y;
}

template <int S>
int launch_patches_from_vals(const float* scal, const float* vals, const float* wcu, const float* wcv, float* out,
                             long long ng, cudaStream_t stream) {
  const size_t smem = (2 * G * Tile<S>::SP + 4 * Tile<S>::MAT) * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(patches_from_vals_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  patches_from_vals_kernel<S><<<(unsigned)ng, G, smem, stream>>>(scal, vals, wcu, wcv, out, ng);
  return (int)cudaGetLastError();
}

template <int S>
int launch_vals_from_patches(const float* patches, const float* scal, const float* wcu, const float* wcv, float* out,
                             long long ng, cudaStream_t stream) {
  const size_t smem = 5 * Tile<S>::MAT * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(vals_from_patches_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  vals_from_patches_kernel<S><<<(unsigned)ng, G, smem, stream>>>(patches, scal, wcu, wcv, out, ng);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t otherwise, -1 for an unsupported S.
int pfb_patches_from_vals(const float* scal, const float* vals, const float* wcu, const float* wcv, float* out,
                          long long ng, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 16: return launch_patches_from_vals<16>(scal, vals, wcu, wcv, out, ng, st);
    case 24: return launch_patches_from_vals<24>(scal, vals, wcu, wcv, out, ng, st);
    case 32: return launch_patches_from_vals<32>(scal, vals, wcu, wcv, out, ng, st);
    default: return -1;
  }
}

int pfb_vals_from_patches(const float* patches, const float* scal, const float* wcu, const float* wcv, float* out,
                          long long ng, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 16: return launch_vals_from_patches<16>(patches, scal, wcu, wcv, out, ng, st);
    case 24: return launch_vals_from_patches<24>(patches, scal, wcu, wcv, out, ng, st);
    case 32: return launch_vals_from_patches<32>(patches, scal, wcu, wcv, out, ng, st);
    default: return -1;
  }
}

const char* pfb_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
