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
//   grid_p[iu, iv] = sum_vis es(2 (du - a) / W) es(2 (dv - b) / W) ww_p value,
// for each visibility with window start (iu0, iv0), cells iu0+a, iv0+b
// (a, b < W, taken mod nbig), du = u - iu0, dv = v - iv0, and
// ww_p = es(2 (w_rel - p) / w_support) when do_w, else 1 (the plan's
// _w_weight rule; the Pallas B3 kernel applied the w-weight even without
// w-gridding). es(x) = exp(beta (sqrt(1 - x^2) - 1)) on |x| < 1.
//
// What bounds it on the card: bytes. A call writes nw * 2 * nbig^2 f32
// cells (4.3 GB for 8 planes of an 8192^2 grid, 1.3 ms at the HBM rate),
// mostly zeros, against ~28 bytes and ~5 W^2 flops per visibility and
// plane. The first version spent 1.3 ms zero-filling the grid before it
// and ~6.3 ms in a loop of one warp per visibility (seven dependent
// broadcast loads, then shared-memory atomics), measured at the imager's
// PSF chunk; its global-atomic flush cost 0.07 ms. So two kernels:
//   * accumulate: one block per entry of the tile plan that touches the
//     chunk (a TILE x TILE uv tile plus a (W - 1)-cell apron, at most
//     BLOCK_VIS of the tile's visibilities, the planes [qa, qa + nq) of the
//     chunk that they can touch, from the host plan), with an accumulator
//     of each of those planes in shared memory (re and im interleaved),
//     sized by the largest span. Warp w owns plane w mod nq, or, where a
//     plane has several warps, a band of its rows, so every add is a plain
//     read-modify-write by the one lane that owns the cell at that step:
//     no atomics, and a fixed order. The block walks its visibilities in
//     batches of NB: all threads read a batch coalesced (prefetched during
//     the batch before) and evaluate each visibility's u and v stencils and
//     its w-weight on each plane once, into a shared batch buffer (two,
//     alternating, so one barrier a batch suffices); then each warp walks
//     the visibilities whose weight on its plane is not zero and whose
//     window meets its rows, taking their records and stencils from the
//     buffer with broadcast loads, and every lane adds its cells (one
//     64-bit load and store each). The accumulators go with plain stores
//     to the block's slot of a compact scratch buffer (offsets from the
//     host plan);
//   * compose: one block per output tile writes its TILE x TILE core of
//     every plane of the chunk once, with float4 stores where the row
//     length allows, zeros included: the sum, in the host plan's fixed
//     order, of the partials of the blocks whose tile plus apron covers it
//     (its own tile's and those of the tiles before it in u and v, wrapped
//     mod nbig), so no cell is a global read-modify-write and the caller
//     need not zero the grid. The scratch is at most nq (TILE + W - 1)
//     (TILE + W) 2 floats per launched block (ChunkPlan in
//     ops/gridder_pallas.py bounds it); the design without it, one block
//     per (tile, plane) that reads every visibility whose window reaches
//     its core, was 1.6 to 5 times slower on an H100 80GB HBM3 at 700 W,
//     since a busy tile's plane is then one block;
//   * accumulators have a row stride of TILE + W, so the W cells of one
//     window row and the next row start in distinct banks;
//   * coordinates come window-relative, computed in f64 on the host: an
//     absolute f32 coordinate on an 8192 grid keeps ~5e-4 cell, a
//     window-relative one ~1e-7. Arithmetic is f32, as on the TPU.
//
// Layouts (C-contiguous): per block of the tile plan blk_tile (int32,
// tx * nty + ty), blk_start (int64), blk_count (int32); for this chunk,
// per block, ch_qa, ch_nq (int32, its planes [qa, qa + nq) of the chunk)
// and ch_off (int64, the float offset of its partial (nq, 2, A, TILE + W)
// in scratch, A = TILE + W - 1), and the list act (int32) of the blocks
// with nq > 0; per output tile t, the compose list cmp_blk[cmp_ptr[t] ..
// cmp_ptr[t+1]] (int32 block ids) with cmp_oxy (int32, 65536 ox + oy: the
// tile's core starts at row ox, column oy of that block's partial); per
// visibility, in tile order, lu, lv (int32, window start in the tile,
// [0, TILE)), du, dv, w_rel, vre, vim (f32); out (nw, 2, nbig_x, nbig_y)
// f32, written whole. nq_max is the largest nq.
// The entry point returns cudaGetLastError() after its launches, -1 for
// arguments it does not take.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_NW = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NB = 64;  // visibilities per batch of the accumulate pass
// floats of one batch buffer: per visibility (re, im, window base, -) and
// its stencils (2 W: ku then kv), and the w-weights (MAX_NW, NB)
__host__ __device__ constexpr int batch_floats(int W) { return NB * (4 + 2 * W + MAX_NW); }

__device__ __forceinline__ float es(float x, float beta) {
  const float x2 = x * x;
  return x2 < 1.f ? expf(beta * (sqrtf(1.f - x2) - 1.f)) : 0.f;
}

// One warp adds a batch's visibilities into its accumulator acc (re, im
// interleaved): those whose w-weight on its plane (sww) is not zero and,
// when BANDED, whose window meets its rows [r0, r1), only those rows. A
// visibility's record (re, im, window base) and stencils come from the
// batch buffer, its weight by shuffle; lane c adds cell (c / W, c % W) of
// each round.
template <int W, bool BANDED>
__device__ __forceinline__ void add_batch(const float4* svis, const float* sk, const float* sww, float2* acc, int r0,
                                          int r1) {
  constexpr int S = TILE + W;
  constexpr int ROUNDS = (W * W + 31) / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int sb = 0; sb < NB / 32; ++sb) {
    const int v = sb * 32 + lane;
    const float ww = sww[v];
    bool mine = ww != 0.f;
    if (BANDED) {  // the window's rows u0 .. u0 + W - 1 meet the band
      const int u0 = __float_as_int(svis[v].z) / S;
      mine = mine && u0 + W > r0 && u0 < r1;
    }
    for (unsigned m = __ballot_sync(FULL, mine); m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const float jw = __shfl_sync(FULL, ww, j);
      const float4 rec = svis[sb * 32 + j];
      int jb = __float_as_int(rec.z);
      int a0 = 0, ncell = W * W;
      if (BANDED) {  // the window's rows [a0, a1) in the band
        a0 = max(r0 - jb / S, 0);
        ncell = (min(r1 - jb / S, W) - a0) * W;
        jb += a0 * S;
      }
      const float jre = jw * rec.x, jim = jw * rec.y;
      const float* kj = sk + (sb * 32 + j) * 2 * W;
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int c = r * 32 + lane;
        if (c < ncell) {
          const float st = kj[a0 + c / W] * kj[W + c % W];
          float2* cell = acc + jb + (c / W) * S + c % W;
          float2 g = *cell;
          g.x = fmaf(jre, st, g.x);
          g.y = fmaf(jim, st, g.y);
          *cell = g;
        }
      }
      __syncwarp();  // the next visibility's cells may be another lane's
    }
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS) accumulate_kernel(
    const int* __restrict__ act, const long long* __restrict__ blk_start, const int* __restrict__ blk_count,
    const int* __restrict__ ch_qa, const int* __restrict__ ch_nq, const long long* __restrict__ ch_off,
    const int* __restrict__ lu, const int* __restrict__ lv, const float* __restrict__ du,
    const float* __restrict__ dv, const float* __restrict__ wrel, const float* __restrict__ vre,
    const float* __restrict__ vim, float* __restrict__ scratch, float beta, int ws, int do_w, int p0) {
  constexpr int A = TILE + W - 1;
  constexpr int S = TILE + W;  // row stride
  constexpr int PLANE = 2 * A * S;  // one plane's accumulator: re, im
  extern __shared__ float4 smem4[];
  float* batches = reinterpret_cast<float*>(smem4);  // two batch buffers
  float2* acc = reinterpret_cast<float2*>(batches + 2 * batch_floats(W));  // (nq, A, S), re and im interleaved
  const int blk = act[blockIdx.x];
  const int nq = ch_nq[blk];
  for (int i = threadIdx.x; i < nq * PLANE / 4; i += THREADS)
    smem4[2 * batch_floats(W) / 4 + i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int warp = threadIdx.x >> 5;
  // this warp's plane q and its band of accumulator rows [r0, r1): the
  // nband warps w = q (mod nq) split the rows of plane q between them
  const int q = warp % nq;
  const int nband = (NWARPS - 1 - q) / nq + 1;
  const int r0 = (warp / nq) * A / nband, r1 = (warp / nq + 1) * A / nband;
  float2* accq = acc + q * A * S;
  const long long start = blk_start[blk];
  const int count = blk_count[blk];
  constexpr float inv = 2.f / (float)W;
  const float winv = 2.f / (float)ws;
  const float pq0 = (float)(p0 + ch_qa[blk]);

  // batch phase: thread (part, t) reads visibility t of the next batch:
  // part 0 its u stencil, 1 its v stencil, 2 its record and its w-weights
  // on planes 0..3, 3 its w-weights on planes 4..7
  const int part = threadIdx.x / NB, t = threadIdx.x % NB;
  float x = 0.f, wr = 0.f, vr = 0.f, vi = 0.f;
  int base = 0;
  bool on = false;
  auto fetch = [&](int i) {
    on = i < count;
    if (!on) return;
    const long long k = start + i;
    if (part < 2) {
      x = part == 0 ? du[k] : dv[k];
    } else {
      wr = do_w ? wrel[k] : 0.f;
      if (part == 2) {
        vr = vre[k];
        vi = vim[k];
        base = lu[k] * S + lv[k];
      }
    }
  };
  fetch(t);

  for (int b0 = 0, n = 0; b0 < count; b0 += NB, ++n) {
    float4* svis = reinterpret_cast<float4*>(batches + (n & 1) * batch_floats(W));
    float* sk = reinterpret_cast<float*>(svis + NB);
    float* sww = sk + NB * 2 * W;
    if (part < 2) {
#pragma unroll
      for (int a = 0; a < W; ++a) sk[t * 2 * W + part * W + a] = es((x - (float)a) * inv, beta);
    } else {
      if (part == 2) svis[t] = make_float4(vr, vi, __int_as_float(base), 0.f);
      for (int qq = 4 * (part - 2); qq < min(nq, 4 * (part - 1)); ++qq)
        sww[qq * NB + t] = !on ? 0.f : do_w ? es((wr - (pq0 + qq)) * winv, beta) : 1.f;
    }
    fetch(b0 + NB + t);
    __syncthreads();  // the batch is in; the buffer before it is free (two buffers)
    if (nband == 1) {
      add_batch<W, false>(svis, sk, sww + q * NB, accq, 0, A);
    } else {
      add_batch<W, true>(svis, sk, sww + q * NB, accq, r0, r1);
    }
  }
  __syncthreads();

  // the partials of the block's planes (nq, 2, A, S), with plain stores
  float* dst = scratch + ch_off[blk];
  for (int i = threadIdx.x; i < nq * A * S; i += THREADS) {
    const int qq = i / (A * S), c = i - qq * (A * S);
    dst[qq * PLANE + c] = acc[i].x;
    dst[qq * PLANE + A * S + c] = acc[i].y;
  }
}

__global__ void __launch_bounds__(THREADS) compose_kernel(
    const int* __restrict__ cmp_ptr, const int* __restrict__ cmp_blk, const int* __restrict__ cmp_oxy,
    const int* __restrict__ ch_qa, const int* __restrict__ ch_nq, const long long* __restrict__ ch_off,
    const float* __restrict__ scratch, float* __restrict__ out, int W, int nbx, int nby, int nty, int nw) {
  const int A = TILE + W - 1, S = TILE + W;
  const int t = blockIdx.x;
  const int gx0 = (t / nty) * TILE, gy0 = (t % nty) * TILE;
  const int x = threadIdx.x >> 3, y0 = (threadIdx.x & 7) * 4;  // row x, cells y0 .. y0+3 of the core
  const int gx = gx0 + x;
  const int e0 = cmp_ptr[t], e1 = cmp_ptr[t + 1];
  const long long plane = (long long)nbx * nby;
  for (int q = 0; q < nw; ++q) {
    float re[4] = {0.f, 0.f, 0.f, 0.f}, im[4] = {0.f, 0.f, 0.f, 0.f};
    for (int e = e0; e < e1; ++e) {
      const int b = cmp_blk[e];
      const int qq = q - ch_qa[b];
      if (qq < 0 || qq >= ch_nq[b]) continue;
      const int oxy = cmp_oxy[e];
      const int px = x + (oxy >> 16);
      if (px >= A) continue;
      const int py = y0 + (oxy & 0xffff);
      const float* src = scratch + ch_off[b] + (long long)qq * 2 * A * S + px * S + py;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (py + c < A) {
          re[c] += src[c];
          im[c] += src[A * S + c];
        }
      }
    }
    if (gx >= nbx) continue;
    float* ore = out + (2LL * q) * plane + (long long)gx * nby + gy0 + y0;
    float* oim = ore + plane;
    if ((nby & 3) == 0 && gy0 + y0 + 4 <= nby) {
      *reinterpret_cast<float4*>(ore) = make_float4(re[0], re[1], re[2], re[3]);
      *reinterpret_cast<float4*>(oim) = make_float4(im[0], im[1], im[2], im[3]);
    } else {
      for (int c = 0; c < 4 && gy0 + y0 + c < nby; ++c) {
        ore[c] = re[c];
        oim[c] = im[c];
      }
    }
  }
}

template <int W>
int accumulate(const int* act, int nact, const long long* blk_start, const int* blk_count, const int* ch_qa,
               const int* ch_nq, const long long* ch_off, int nq_max, const int* lu, const int* lv, const float* du,
               const float* dv, const float* wrel, const float* vre, const float* vim, float* scratch, float beta,
               int ws, int do_w, int p0, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)batch_floats(W) + (size_t)nq_max * 2 * (TILE + W - 1) * (TILE + W)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(accumulate_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  accumulate_kernel<W><<<(unsigned)nact, THREADS, smem, stream>>>(act, blk_start, blk_count, ch_qa, ch_nq, ch_off, lu,
                                                                  lv, du, dv, wrel, vre, vim, scratch, beta, ws, do_w,
                                                                  p0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pfb_scatter_grid_wstack(const int* act, int nact, const long long* blk_start, const int* blk_count,
                            const int* ch_qa, const int* ch_nq, const long long* ch_off, int nq_max,
                            const int* cmp_ptr, const int* cmp_blk, const int* cmp_oxy, const int* lu, const int* lv,
                            const float* du, const float* dv, const float* wrel, const float* vre, const float* vim,
                            float* scratch, float* out, int W, float beta, int nbx, int nby, int ntx, int nty, int ws,
                            int do_w, int p0, int nw, void* stream) {
  if (nw < 1 || nw > MAX_NW || nq_max > nw || (do_w && (ws < 1 || ws > 30)) || nbx < W || nby < W) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nact > 0) {
    int code = -1;
#define PFB_ACCUMULATE(WW)                                                                                    \
  case WW:                                                                                                    \
    code = accumulate<WW>(act, nact, blk_start, blk_count, ch_qa, ch_nq, ch_off, nq_max, lu, lv, du, dv, wrel, \
                          vre, vim, scratch, beta, ws, do_w, p0, s);                                          \
    break;
    switch (W) {
      PFB_ACCUMULATE(4)
      PFB_ACCUMULATE(5)
      PFB_ACCUMULATE(6)
      PFB_ACCUMULATE(7)
      PFB_ACCUMULATE(8)
      PFB_ACCUMULATE(9)
      PFB_ACCUMULATE(10)
      PFB_ACCUMULATE(11)
      PFB_ACCUMULATE(12)
      PFB_ACCUMULATE(13)
      PFB_ACCUMULATE(14)
      PFB_ACCUMULATE(15)
      PFB_ACCUMULATE(16)
      default: return -1;
    }
#undef PFB_ACCUMULATE
    if (code != 0) return code;
  }
  compose_kernel<<<(unsigned)(ntx * nty), THREADS, 0, s>>>(cmp_ptr, cmp_blk, cmp_oxy, ch_qa, ch_nq, ch_off, scratch,
                                                           out, W, nbx, nby, nty, nw);
  return (int)cudaGetLastError();
}

}  // extern "C"
