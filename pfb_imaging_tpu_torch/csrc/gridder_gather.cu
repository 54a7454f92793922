// W-stacked ES-kernel gather (degrid) for Hopper (sm_90a), with a plain C
// interface for ctypes: the degridding core of the classic w-stacking
// gridder, and the exact transpose of gridder_scatter.cu.
//
// Replaces the Pallas TPU kernel of pfb_imaging_tpu/ops/gridder_pallas.py:
//   * pallas_gather_grid (_gather_kernel, :672, call :731)  B4
// The Pallas kernel gathers one plane per call and leaves the w-weight and
// the sum over planes to XLA (_accumulate, :781-789); this kernel takes a
// chunk of planes and applies both itself.
//
// What it computes: for each visibility k of the tile plan (tile order),
//   acc[k] += sum_{q < nw} ww_q sum_{a, b < W} es(2 (du - a) / W)
//             es(2 (dv - b) / W) grid_q[iu0 + a, iv0 + b],
// real and imaginary parts apart, cells taken mod nbig, with
// ww_q = es(2 (w_rel - p0 - q) / w_support) when do_w, else 1 (the plan's
// _w_weight rule), es(x) = exp(beta (sqrt(1 - x^2) - 1)) on |x| < 1.
//
// What bounds it on the card: bytes. A pass reads nw * 2 * nbig^2 f32 grid
// cells (1.07 GB for 8 planes of a 4096^2 grid) against ~36 bytes and
// ~W^2 (1 + 4 n_planes) flops per visibility. The TPU kernel DMA'd one
// plane's 272 x 256 tile into VMEM; a block here has at most 227 KB of
// shared memory, so:
//   * a block takes one block of the scatter's tile plan (a TILE x TILE uv
//     tile, at most BLOCK_VIS of its visibilities) and stages the tile plus
//     its (W - 1)-cell apron of every plane of the chunk, nw * 2 *
//     (TILE + W - 1)^2 f32 (~97 KB at W = 8, ~141 KB at W = 16), into
//     shared memory, wrapping cell indices mod nbig;
//   * one warp takes one visibility: lanes 0..W-1 evaluate the u stencil,
//     lanes 16..16+W-1 the v stencil, lanes 0..n-1 the w-weights of the n
//     candidate planes (the visibility's w_support planes and one more on
//     each side, as the scatter), each once; each lane keeps its cells'
//     stencil products in registers, sums its cells of every plane whose
//     weight is not zero, and a warp reduction gives the visibility's value;
//   * lane 0 adds it into the accumulator: each visibility belongs to one
//     block, so no atomics are needed and the result is deterministic;
//   * coordinates come window-relative, computed in f64 on the host, as in
//     the scatter. Arithmetic is f32.
// Making it faster (staging only the planes a block touches, a persistent
// schedule, fewer apron re-reads) is later work.
//
// Layouts (C-contiguous): per-block blk_tile (int32, tx * nty + ty),
// blk_start (int64), blk_count (int32); per visibility, in tile order, lu,
// lv (int32, window start in the tile, [0, TILE)), du, dv, w_rel (f32);
// grids (nw, 2, nbig_x, nbig_y) f32; acc (2, nvis) f32, added into.
// The entry point returns cudaGetLastError() after its launch, -1 for
// arguments it does not take.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int MAX_NW = 8;
constexpr int MAX_W = 16;
constexpr int MAX_ROUNDS = (MAX_W * MAX_W + 31) / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float es(float x, float beta) {
  const float x2 = x * x;
  return x2 < 1.f ? expf(beta * (sqrtf(1.f - x2) - 1.f)) : 0.f;
}

__global__ void __launch_bounds__(THREADS) gather_wstack_kernel(
    const int* __restrict__ blk_tile, const long long* __restrict__ blk_start, const int* __restrict__ blk_count,
    const int* __restrict__ lu, const int* __restrict__ lv, const float* __restrict__ du,
    const float* __restrict__ dv, const float* __restrict__ wrel, const float* __restrict__ grids,
    float* __restrict__ acc, long long nvis, int W, float beta, int nbx, int nby, int nty, int ws, int do_w, int p0,
    int nw) {
  extern __shared__ float tile[];  // (nw, 2, A, A), A = TILE + W - 1
  const int A = TILE + W - 1;
  const int AA = A * A;
  const int t = blk_tile[blockIdx.x];
  const int gx0 = (t / nty) * TILE, gy0 = (t % nty) * TILE;
  const long long plane = (long long)nbx * nby;
  for (int i = threadIdx.x; i < nw * 2 * AA; i += THREADS) {
    const int qc = i / AA;  // 2 q + (0 re | 1 im)
    const int cell = i - qc * AA;
    const int gx = (gx0 + cell / A) % nbx;
    const int gy = (gy0 + cell % A) % nby;
    tile[i] = grids[qc * plane + (long long)gx * nby + gy];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long start = blk_start[blockIdx.x];
  const int count = blk_count[blockIdx.x];
  const float inv = 2.f / (float)W;
  const float winv = 2.f / (float)ws;
  const int rounds = (W * W + 31) / 32;

  for (int i = warp; i < count; i += THREADS / 32) {
    const long long k = start + i;
    // the planes [qa, qb) of the chunk (relative to p0) that may hold this
    // visibility, as in the scatter kernel
    int qa = 0, qb = 1;
    float wr = 0.f;
    if (do_w) {
      wr = wrel[k];
      const int pa = (int)floorf(wr - 0.5f * (float)ws);
      qa = max(pa - p0, 0);
      qb = min(pa + ws + 2 - p0, nw);
    }
    if (qa >= qb) continue;  // uniform across the warp
    const float fu = du[k], fv = dv[k];
    const int u0 = lu[k], v0 = lv[k];
    float kval = 0.f;
    if (lane < W) {
      kval = es((fu - (float)lane) * inv, beta);
    } else if (lane >= 16 && lane - 16 < W) {
      kval = es((fv - (float)(lane - 16)) * inv, beta);
    }
    float wval = 1.f;
    if (do_w && lane < qb - qa) wval = es((wr - (float)(p0 + qa + lane)) * winv, beta);
    // this lane's stencil cells c = 32 r + lane, a = c / W, b = c % W
    float sten[MAX_ROUNDS];
    int cell[MAX_ROUNDS];
#pragma unroll
    for (int r = 0; r < MAX_ROUNDS; ++r) {
      sten[r] = 0.f;
      cell[r] = 0;
      if (r < rounds) {  // uniform across the warp
        const int c = r * 32 + lane;
        const bool on = c < W * W;
        const int a = on ? c / W : 0;
        const int b = on ? c - a * W : 0;
        const float ku = __shfl_sync(FULL, kval, a);
        const float kv = __shfl_sync(FULL, kval, 16 + b);
        sten[r] = on ? ku * kv : 0.f;
        cell[r] = (u0 + a) * A + (v0 + b);
      }
    }
    float sre = 0.f, sim = 0.f;
    for (int q = qa; q < qb; ++q) {
      const float ww = __shfl_sync(FULL, wval, q - qa);
      if (ww == 0.f) continue;  // uniform across the warp
      const float* gre = tile + (2 * q) * AA;
      const float* gim = gre + AA;
      float pre = 0.f, pim = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_ROUNDS; ++r) {
        if (r < rounds) {
          pre += sten[r] * gre[cell[r]];
          pim += sten[r] * gim[cell[r]];
        }
      }
      sre += ww * pre;
      sim += ww * pim;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sre += __shfl_xor_sync(FULL, sre, off);
      sim += __shfl_xor_sync(FULL, sim, off);
    }
    if (lane == 0) {
      acc[k] += sre;
      acc[nvis + k] += sim;
    }
  }
}

}  // namespace

extern "C" {

int pfb_gather_grid_wstack(const int* blk_tile, const long long* blk_start, const int* blk_count, const int* lu,
                           const int* lv, const float* du, const float* dv, const float* wrel, const float* grids,
                           float* acc, long long nvis, int nblocks, int W, float beta, int nbx, int nby, int nty,
                           int ws, int do_w, int p0, int nw, void* stream) {
  if (W < 1 || W > MAX_W || nw < 1 || nw > MAX_NW || (do_w && (ws < 1 || ws > 30)) || nbx < W || nby < W) return -1;
  if (nblocks <= 0) return 0;
  const int A = TILE + W - 1;
  const size_t smem = (size_t)nw * 2 * A * A * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gather_wstack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gather_wstack_kernel<<<(unsigned)nblocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      blk_tile, blk_start, blk_count, lu, lv, du, dv, wrel, grids, acc, nvis, W, beta, nbx, nby, nty, ws, do_w, p0,
      nw);
  return (int)cudaGetLastError();
}

}  // extern "C"
