// W-stacked ES-kernel scatter for Hopper (sm_90a), with a plain C interface
// for ctypes: the gridding core of the classic w-stacking gridder.
//
// Replaces the Pallas TPU kernels of pfb_imaging_tpu/ops/gridder_pallas.py:
//   * pallas_scatter_grid_wstack (_scatter_kernel_wstack, :308, call :366)  B3
//   * pallas_scatter_grid (_scatter_kernel, :119, call :168)                 B5
//   * pallas_scatter_grid_grouped (_scatter_kernel_grouped, :527, call :571) B6
// B5 and B6 compute the one-plane grid, which is this kernel at nw = 1 (a
// plan without w-gridding, or a one-plane chunk); B6 differed from B5 only
// in its VMEM schedule, which is not carried over.
//
// What it computes: planes p0 .. p0+nw-1 of
//   grid_p[iu, iv] += es(2 (du - a) / W) es(2 (dv - b) / W) ww_p value,
// for each visibility with window start (iu0, iv0), cells iu0+a, iv0+b
// (a, b < W, taken mod nbig), du = u - iu0, dv = v - iv0, and
// ww_p = es(2 (w_rel - p) / w_support) when do_w, else 1 (the plan's
// _w_weight rule; the Pallas B3 kernel applied the w-weight even without
// w-gridding). es(x) = exp(beta (sqrt(1 - x^2) - 1)) on |x| < 1.
//
// What bounds it on the card: bytes. A pass writes nw * 2 * nbig^2 f32 grid
// cells (4.3 GB for 8 planes of an 8192^2 grid) against ~28 bytes and
// ~W^2 (1 + 4 n_planes) flops read and done per visibility, so the grid
// traffic, and the global atomics that put a block's tile into it, set the
// time. The TPU kernel kept a 272 x 256 tile of up to 8 planes (4.5 MB) in
// VMEM; a block here has at most 227 KB of shared memory, so:
//   * a block owns a TILE x TILE uv tile plus a (W - 1)-cell apron for at
//     most nw <= 8 planes, and at most BLOCK_VIS of the tile's
//     visibilities (the host cuts busy tiles into several blocks); its
//     accumulators, nw * 2 * (TILE + W - 1)^2 f32, live in shared memory;
//   * one warp takes one visibility: lanes 0..W-1 evaluate the u stencil,
//     lanes 16..16+W-1 the v stencil, lanes 0..n-1 the w-weights of the n
//     candidate planes of the chunk (its w_support planes and one more on
//     each side, at most w_support + 2), each once; every lane then adds
//     its stencil cells for the planes whose weight is not zero with
//     shared-memory atomics (no two lanes of a warp hit one address); a
//     visibility that touches no plane of the chunk is skipped;
//   * the block flushes the planes it touched with global atomicAdd, and
//     only the cells that are not zero, so overlapping aprons and the
//     blocks of one tile sum without a second pass; windows that wrap the
//     grid edge land mod nbig;
//   * coordinates come window-relative, computed in f64 on the host: an
//     absolute f32 coordinate on an 8192 grid keeps ~5e-4 cell, a
//     window-relative one ~1e-7. Arithmetic is f32, as on the TPU.
// Making it faster (sorting a tile's visibilities by w, fewer global
// atomics, a persistent schedule) is later work.
//
// Layouts (C-contiguous): per-block blk_tile (int32, tx * nty + ty),
// blk_start (int64), blk_count (int32); per visibility, in tile order, lu,
// lv (int32, window start in the tile, [0, TILE)), du, dv, w_rel, vre, vim
// (f32); out (nw, 2, nbig_x, nbig_y) f32, zeroed by the caller.
// The entry point returns cudaGetLastError() after its launch, -1 for
// arguments it does not take.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int MAX_NW = 8;
constexpr int MAX_W = 16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float es(float x, float beta) {
  const float x2 = x * x;
  return x2 < 1.f ? expf(beta * (sqrtf(1.f - x2) - 1.f)) : 0.f;
}

__global__ void __launch_bounds__(THREADS) scatter_wstack_kernel(
    const int* __restrict__ blk_tile, const long long* __restrict__ blk_start, const int* __restrict__ blk_count,
    const int* __restrict__ lu, const int* __restrict__ lv, const float* __restrict__ du,
    const float* __restrict__ dv, const float* __restrict__ wrel, const float* __restrict__ vre,
    const float* __restrict__ vim, float* __restrict__ out, int W, float beta, int nbx, int nby, int nty, int ws,
    int do_w, int p0, int nw) {
  extern __shared__ float acc[];  // (nw, 2, A, A), A = TILE + W - 1
  __shared__ int touched[MAX_NW];
  const int A = TILE + W - 1;
  const int AA = A * A;
  for (int i = threadIdx.x; i < nw * 2 * AA; i += THREADS) acc[i] = 0.f;
  if (threadIdx.x < MAX_NW) touched[threadIdx.x] = 0;
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
    // visibility: its ws support planes and one more on each side, since
    // the base plane is rounded here in f32; a plane whose weight comes
    // out exactly zero is skipped below
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
    const float re = vre[k], im = vim[k];
    float kval = 0.f;
    if (lane < W) {
      kval = es((fu - (float)lane) * inv, beta);
    } else if (lane >= 16 && lane - 16 < W) {
      kval = es((fv - (float)(lane - 16)) * inv, beta);
    }
    float wval = 1.f;
    if (do_w && lane < qb - qa) wval = es((wr - (float)(p0 + qa + lane)) * winv, beta);
    for (int r = 0; r < rounds; ++r) {
      const int c = r * 32 + lane;
      const bool on = c < W * W;
      const int a = on ? c / W : 0;
      const int b = on ? c - a * W : 0;
      const float ku = __shfl_sync(FULL, kval, a);
      const float kv = __shfl_sync(FULL, kval, 16 + b);
      const float sten = ku * kv;
      const int cell = (u0 + a) * A + (v0 + b);
      for (int q = qa; q < qb; ++q) {
        const float ww = __shfl_sync(FULL, wval, q - qa);
        if (ww == 0.f) continue;  // uniform across the warp
        if (on) {
          const float s = sten * ww;
          atomicAdd(acc + (2 * q) * AA + cell, re * s);
          atomicAdd(acc + (2 * q + 1) * AA + cell, im * s);
        }
        if (r == 0 && lane == 0) touched[q] = 1;
      }
    }
  }
  __syncthreads();

  // flush: overlap-add of the tile and its apron onto the global planes
  const int tile = blk_tile[blockIdx.x];
  const int gx0 = (tile / nty) * TILE, gy0 = (tile % nty) * TILE;
  const long long plane = (long long)nbx * nby;
  for (int q = 0; q < nw; ++q) {
    if (!touched[q]) continue;
    const float* are = acc + (2 * q) * AA;
    const float* aim = are + AA;
    for (int i = threadIdx.x; i < AA; i += THREADS) {
      const float r = are[i], m = aim[i];
      if (r == 0.f && m == 0.f) continue;
      int gx = gx0 + i / A;
      int gy = gy0 + i % A;
      if (gx >= nbx) gx -= nbx;
      if (gy >= nby) gy -= nby;
      float* o = out + (2LL * q) * plane + (long long)gx * nby + gy;
      atomicAdd(o, r);
      atomicAdd(o + plane, m);
    }
  }
}

}  // namespace

extern "C" {

int pfb_scatter_grid_wstack(const int* blk_tile, const long long* blk_start, const int* blk_count, const int* lu,
                            const int* lv, const float* du, const float* dv, const float* wrel, const float* vre,
                            const float* vim, float* out, int nblocks, int W, float beta, int nbx, int nby, int nty,
                            int ws, int do_w, int p0, int nw, void* stream) {
  if (W < 1 || W > MAX_W || nw < 1 || nw > MAX_NW || (do_w && (ws < 1 || ws > 30)) || nbx < W || nby < W) return -1;
  if (nblocks <= 0) return 0;
  const int A = TILE + W - 1;
  const size_t smem = (size_t)nw * 2 * A * A * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(scatter_wstack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  scatter_wstack_kernel<<<(unsigned)nblocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      blk_tile, blk_start, blk_count, lu, lv, du, dv, wrel, vre, vim, out, W, beta, nbx, nby, nty, ws, do_w, p0, nw);
  return (int)cudaGetLastError();
}

}  // extern "C"
