// The primal-dual dual update of SARA's signed-sum l2,1 prior for Hopper
// (sm_90a), one pass over the coefficient cube, with a plain C interface for
// ctypes.
//
// It replaces no Pallas kernel: on the TPU the update is XLA element-wise
// ops (pfb_imaging_tpu/prox/prox_21m.py:33, dual_update), and the port's
// plain version (prox/prox_21m.py, dual_update_plain, which CPU tensors
// take) is a chain of torch ops, each a pass over the
// (nband, nbasis, nymax, nxmax) cube or one of its band planes.
//
// What it computes, for every plane position i (basis, row, column) of the
// cube's P = nbasis * nymax * nxmax, over its nband bands:
//   vt[b]  = vp[b] + sigma * v[b]           (v: this iteration's analysis)
//   s      = ((vt[0] + vt[1]) + vt[2]) + ...  (band order, as band_sum adds)
//   thr    = lam * weight[i]                 (lam where there is no weight)
//   scale  = |s| > thr ? thr / (|s| > 0 ? |s| : 1) : 1
//   vn[b]  = vt[b] * scale
// with each operation rounded as torch rounds it as its own kernel
// (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc would otherwise contract
// vp + sigma * v into one fma), sigma and lam rounded to float32 as torch
// rounds a Python scalar. So the kernel gives the composition's bits.
//
// Under a band split a rank holds nb of the nband bands, and the sum needs
// them all: the caller gathers vt over the band group and adds it in band
// order (parallel/mesh.band_sum), and passes that plane as `sum`; the kernel
// then takes s from it and does the rest over this rank's bands, the same
// bits on every split.
//
// What bounds it: bytes. It reads vp and v once and the weight plane once
// (and the sum plane, if given), and writes vn once: 3C + p, C the cube and
// p one band's plane. At the sara
// cells, 4 x 9 x 2077^2 and 16 x 9 x 1053^2, that is 2.02 GB and 1.96 GB,
// >= 0.60 / 0.58 ms at 3.35 TB/s; the composition moves ~9.2 / ~7.1 GB.
// The arithmetic is a few operations a byte read, far below the card's rate.
//
// The design:
//   * a thread owns E plane positions THREADS apart, so each warp load is
//     32 neighbouring floats (128 bytes) of one band; it issues the loads
//     of vp[b] and v[b] for all its positions and all bands before the sum,
//     2 * E * nband of them (32 where nband divides 16), holds vt in
//     registers and writes vn once, so enough bytes are in flight per SM to
//     cover the memory's latency without staging through shared memory;
//   * the plane is odd at SARA's shapes (P % 4 == 1), so a band's start is
//     not 16-byte aligned: the loads are 4-byte, neighbouring threads on
//     neighbouring addresses, and need no alignment at all;
//   * the band count is a template parameter up to 16, the
//     positions a thread E = 16 / nband rounded down to a power of two; the
//     last block's threads past the plane load a clamped position and store
//     nothing, so every load is unconditional;
//   * past 16 bands a thread reads vp and v twice, a sum pass and a
//     scale pass that recomputes vt: the same bits, chosen by the shape.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__host__ __device__ constexpr int positions(int nb) { return nb > 8 ? 1 : nb > 4 ? 2 : nb > 2 ? 4 : nb > 1 ? 8 : 16; }

__device__ __forceinline__ float scale_of(float s, float thr) {
  const float a = fabsf(s);
  return a > thr ? __fdiv_rn(thr, a > 0.f ? a : 1.f) : 1.f;
}

// sum: the band sum plane of a band split, or null to sum the NB bands here.
template <int NB>
__global__ void __launch_bounds__(THREADS) dual_update_kernel(const float* __restrict__ vp,
                                                              const float* __restrict__ v,
                                                              const float* __restrict__ w,
                                                              const float* __restrict__ sum, float* __restrict__ out,
                                                              long long plane, float sigma, float lam) {
  constexpr int E = positions(NB);
  const long long first = (long long)blockIdx.x * (THREADS * E) + threadIdx.x;
  float a[E][NB], c[E][NB], thr[E], s[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = min(first + e * THREADS, plane - 1);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      a[e][b] = vp[b * plane + i];
      c[e][b] = v[b * plane + i];
    }
    thr[e] = w ? __fmul_rn(lam, w[i]) : lam;
    if (sum) s[e] = sum[i];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
#pragma unroll
    for (int b = 0; b < NB; ++b) a[e][b] = __fadd_rn(a[e][b], __fmul_rn(sigma, c[e][b]));
    if (!sum) {
      s[e] = a[e][0];
#pragma unroll
      for (int b = 1; b < NB; ++b) s[e] = __fadd_rn(s[e], a[e][b]);
    }
    const float k = scale_of(s[e], thr[e]);
    const long long i = first + e * THREADS;
    if (i < plane) {
#pragma unroll
      for (int b = 0; b < NB; ++b) out[b * plane + i] = __fmul_rn(a[e][b], k);
    }
  }
}

// Past 16 bands: one position a thread, vp and v read twice (once where
// the sum is given).
__global__ void __launch_bounds__(THREADS) dual_update_two_pass_kernel(const float* __restrict__ vp,
                                                                       const float* __restrict__ v,
                                                                       const float* __restrict__ w,
                                                                       const float* __restrict__ sum,
                                                                       float* __restrict__ out, int nband,
                                                                       long long plane, float sigma, float lam) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= plane) return;
  float s;
  if (sum) {
    s = sum[i];
  } else {
    s = __fadd_rn(vp[i], __fmul_rn(sigma, v[i]));
#pragma unroll 4
    for (int b = 1; b < nband; ++b)
      s = __fadd_rn(s, __fadd_rn(vp[b * plane + i], __fmul_rn(sigma, v[b * plane + i])));
  }
  const float k = scale_of(s, w ? __fmul_rn(lam, w[i]) : lam);
#pragma unroll 4
  for (int b = 0; b < nband; ++b)
    out[b * plane + i] = __fmul_rn(__fadd_rn(vp[b * plane + i], __fmul_rn(sigma, v[b * plane + i])), k);
}

template <int NB>
int launch(const float* vp, const float* v, const float* w, const float* sum, float* out, long long plane,
           float sigma, float lam, cudaStream_t st) {
  const long long per = (long long)THREADS * positions(NB);
  const long long blocks = (plane + per - 1) / per;
  if (blocks > 0x7fffffffLL) return -1;
  dual_update_kernel<NB><<<(unsigned)blocks, THREADS, 0, st>>>(vp, v, w, sum, out, plane, sigma, lam);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vn = the dual update of the cubes vp and v (nband, plane), float32,
// contiguous, into out (the same shape; none of them overlapping); weight
// (plane) or null for a weight of ones; sum (plane), the band sum of vt over
// every band of a band split, or null to sum these nband bands. Returns 0 on
// success, a cudaError_t otherwise, -1 for unsupported sizes.
int pfb_dual_update_21m(const float* vp, const float* v, const float* weight, const float* sum, float* out,
                        int nband, long long plane, float sigma, float lam, void* stream) {
  if (nband < 1 || plane < 0) return -1;
  if (plane == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nband) {
#define PFB_DUAL_CASE(NB) \
  case NB:                \
    return launch<NB>(vp, v, weight, sum, out, plane, sigma, lam, st);
    PFB_DUAL_CASE(1) PFB_DUAL_CASE(2) PFB_DUAL_CASE(3) PFB_DUAL_CASE(4) PFB_DUAL_CASE(5) PFB_DUAL_CASE(6)
    PFB_DUAL_CASE(7) PFB_DUAL_CASE(8) PFB_DUAL_CASE(9) PFB_DUAL_CASE(10) PFB_DUAL_CASE(11) PFB_DUAL_CASE(12)
    PFB_DUAL_CASE(13) PFB_DUAL_CASE(14) PFB_DUAL_CASE(15) PFB_DUAL_CASE(16)
#undef PFB_DUAL_CASE
    default:
      break;
  }
  const long long blocks = (plane + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  dual_update_two_pass_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(vp, v, weight, sum, out, nband, plane, sigma,
                                                                     lam);
  return (int)cudaGetLastError();
}

}  // extern "C"
