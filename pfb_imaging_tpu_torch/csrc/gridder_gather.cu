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
// What bounds it on the card: bytes, in principle. It must read the grid
// cells some window touches (49 MB of 8 planes of a 4096^2 grid at the
// degrid bin of record) and ~36 bytes per visibility, 0.06 ms at the HBM
// rate; the flops (4 W^2 per visibility and plane) take less. What held
// the first version back was latency: one warp per visibility, seven
// dependent broadcast loads, a shuffle reduction and a read-modify-write
// by one lane, in series (7.8 ms at that bin; staging all planes alone
// took 0.16 ms of it). So:
//   * a block takes one block of the scatter's tile plan (a TILE x TILE uv
//     tile and at most BLOCK_VIS of its visibilities) and stages only the
//     planes [qa, qa + nq) of the chunk that its visibilities can touch
//     (the host plan gives them), the tile plus its (W - 1)-cell apron of
//     each, re and im interleaved (float2), with cp.async: one commit
//     group per plane, so the first visibilities start on plane qa while
//     the later planes are still in flight; rows and columns wrap mod nbig
//     only where the apron crosses the grid edge. On an H100 80GB HBM3 at
//     700 W, at that bin, this took 0.79 ms, against 1.53 ms reading the
//     window cells straight from global memory and L2 with no staging,
//     and 0.94 ms staging with plain loads and one barrier;
//   * one thread takes one visibility: its inputs are read coalesced, its
//     W + W stencil values stay in registers (W is a template parameter, so
//     the window loops unroll), and it sums its window of every plane
//     whose w-weight is not zero from shared memory; no reduction across
//     lanes, and the results of a warp go out as one coalesced
//     read-modify-write of acc;
//   * each visibility belongs to one block, so there are no atomics and
//     the result is deterministic;
//   * coordinates come window-relative, computed in f64 on the host, as in
//     the scatter. Arithmetic is f32.
//
// Layouts (C-contiguous): per block of the tile plan blk_tile (int32,
// tx * nty + ty), blk_start (int64), blk_count (int32); for this chunk,
// per block, ch_qa and ch_nq (int32, its planes [qa, qa + nq) of the
// chunk), and the list act (int32) of the blocks with nq > 0, which are
// launched; per visibility, in tile order, lu, lv (int32, window start in
// the tile, [0, TILE)), du, dv, w_rel (f32); grids (nw, 2, nbig_x,
// nbig_y) f32; acc (2, nvis) f32, added into. nq_max is the largest nq.
// The entry point returns cudaGetLastError() after its launch, -1 for
// arguments it does not take.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_NW = 8;

__device__ __forceinline__ float es(float x, float beta) {
  const float x2 = x * x;
  return x2 < 1.f ? expf(beta * (sqrtf(1.f - x2) - 1.f)) : 0.f;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (0 <= n < MAX_NW) commit groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS) gather_wstack_kernel(
    const int* __restrict__ act, const int* __restrict__ blk_tile, const long long* __restrict__ blk_start,
    const int* __restrict__ blk_count, const int* __restrict__ ch_qa, const int* __restrict__ ch_nq,
    const int* __restrict__ lu, const int* __restrict__ lv, const float* __restrict__ du,
    const float* __restrict__ dv, const float* __restrict__ wrel, const float* __restrict__ grids,
    float* __restrict__ acc, long long nvis, float beta, int nbx, int nby, int nty, int ws, int do_w, int p0) {
  constexpr int A = TILE + W - 1;
  extern __shared__ float2 st[];  // (nq, A, A): re, im
  const int blk = act[blockIdx.x];
  const int qa = ch_qa[blk], nq = ch_nq[blk];
  const int t = blk_tile[blk];
  const int gx0 = (t / nty) * TILE, gy0 = (t % nty) * TILE;
  const long long plane = (long long)nbx * nby;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // stage the planes qa .. qa+nq-1 of the chunk, one commit group each
  for (int q = 0; q < nq; ++q) {
    const float* gre = grids + (2LL * (qa + q)) * plane;
    for (int i = warp; i < A; i += NWARPS) {
      int gx = gx0 + i;
      if (gx >= nbx) gx %= nbx;
      const float* rre = gre + (long long)gx * nby;
      float2* row = st + (q * A + i) * A;
      for (int j = lane; j < A; j += 32) {
        int gy = gy0 + j;
        if (gy >= nby) gy %= nby;
        cp_async4(&row[j].x, rre + gy);
        cp_async4(&row[j].y, rre + plane + gy);
      }
    }
    cp_async_commit();
  }

  const long long start = blk_start[blk];
  const int count = blk_count[blk];
  constexpr float inv = 2.f / (float)W;
  const float winv = 2.f / (float)ws;
  for (int base = 0; base < count; base += THREADS) {
    const int i = base + threadIdx.x;
    const bool valid = i < count;
    const long long k = start + i;
    // the planes [lo, hi) of the staged span that may hold this
    // visibility: its ws support planes and one more on each side, since
    // the base plane is rounded here in f32 (the rule the host plan used
    // for the span); a plane whose weight comes out zero is skipped
    int lo = 0, hi = 0;
    float wr = 0.f, fu = 0.f, fv = 0.f;
    int u0 = 0, v0 = 0;
    if (valid) {
      hi = 1;
      if (do_w) {
        wr = wrel[k];
        const int pa = (int)floorf(wr - 0.5f * (float)ws) - p0 - qa;
        lo = max(pa, 0);
        hi = min(pa + ws + 2, nq);
      }
      fu = du[k];
      fv = dv[k];
      u0 = lu[k];
      v0 = lv[k];
    }
    float ku[W], kv[W];
#pragma unroll
    for (int a = 0; a < W; ++a) {
      ku[a] = es((fu - (float)a) * inv, beta);
      kv[a] = es((fv - (float)a) * inv, beta);
    }
    float sre = 0.f, sim = 0.f;
    for (int q = 0; q < nq; ++q) {
      if (base == 0) {  // uniform across the block: wait for plane q
        cp_async_wait_pending(nq - 1 - q);
        __syncthreads();
      }
      if (q < lo || q >= hi) continue;
      const float ww = do_w ? es((wr - (float)(p0 + qa + q)) * winv, beta) : 1.f;
      if (ww == 0.f) continue;
      const float2* g = st + (q * A + u0) * A + v0;
      float pre = 0.f, pim = 0.f;
#pragma unroll
      for (int a = 0; a < W; ++a) {
        float rr = 0.f, ri = 0.f;
#pragma unroll
        for (int b = 0; b < W; ++b) {
          const float2 c = g[a * A + b];
          rr = fmaf(kv[b], c.x, rr);
          ri = fmaf(kv[b], c.y, ri);
        }
        pre = fmaf(ku[a], rr, pre);
        pim = fmaf(ku[a], ri, pim);
      }
      sre = fmaf(ww, pre, sre);
      sim = fmaf(ww, pim, sim);
    }
    if (valid && lo < hi) {
      acc[k] += sre;
      acc[nvis + k] += sim;
    }
  }
}

template <int W>
int launch(const int* act, int nact, const int* blk_tile, const long long* blk_start, const int* blk_count,
           const int* ch_qa, const int* ch_nq, int nq_max, const int* lu, const int* lv, const float* du,
           const float* dv, const float* wrel, const float* grids, float* acc, long long nvis, float beta, int nbx,
           int nby, int nty, int ws, int do_w, int p0, cudaStream_t stream) {
  constexpr int A = TILE + W - 1;
  const size_t smem = (size_t)nq_max * A * A * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(gather_wstack_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gather_wstack_kernel<W><<<(unsigned)nact, THREADS, smem, stream>>>(act, blk_tile, blk_start, blk_count, ch_qa, ch_nq,
                                                                     lu, lv, du, dv, wrel, grids, acc, nvis, beta, nbx,
                                                                     nby, nty, ws, do_w, p0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pfb_gather_grid_wstack(const int* act, int nact, const int* blk_tile, const long long* blk_start,
                           const int* blk_count, const int* ch_qa, const int* ch_nq, int nq_max, const int* lu,
                           const int* lv, const float* du, const float* dv, const float* wrel, const float* grids,
                           float* acc, long long nvis, int W, float beta, int nbx, int nby, int nty, int ws, int do_w,
                           int p0, void* stream) {
  if (nq_max < 1 || nq_max > MAX_NW || (do_w && (ws < 1 || ws > 30)) || nbx < W || nby < W) return -1;
  if (nact <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PFB_GATHER(WW)                                                                                         \
  case WW:                                                                                                     \
    return launch<WW>(act, nact, blk_tile, blk_start, blk_count, ch_qa, ch_nq, nq_max, lu, lv, du, dv, wrel, \
                      grids, acc, nvis, beta, nbx, nby, nty, ws, do_w, p0, s);
  switch (W) {
    PFB_GATHER(4)
    PFB_GATHER(5)
    PFB_GATHER(6)
    PFB_GATHER(7)
    PFB_GATHER(8)
    PFB_GATHER(9)
    PFB_GATHER(10)
    PFB_GATHER(11)
    PFB_GATHER(12)
    PFB_GATHER(13)
    PFB_GATHER(14)
    PFB_GATHER(15)
    PFB_GATHER(16)
    default: return -1;
  }
#undef PFB_GATHER
}

}  // extern "C"
