// IDG patch assembly (K1) and its transpose (K2) for Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Neither replaces a Pallas kernel: on the TPU both steps were XLA ops of
// pfb_imaging_tpu/ops/gridder_idg.py,
//   * _assemble_bin (:2026): a scatter .at[bid].add of each group's patch
//     onto its bucket's lattice cell, the r x r quarters of every cell
//     (r = S / half) shift-added into the extended plane, and a periodic
//     fold of that plane onto the grid;                                   K1
//   * _extract_bin (:2482): its transpose, the grid read periodically and
//     each group's S x S window gathered;                                 K2
// and the port's first version ran them as torch ops, the scatter through
// index_add_, whose atomic float adds sum in another order each run.
//
// What they compute. Group g of a bin has bucket (bu, bv) = divmod(bid[g],
// nbv) and an S x S patch (re and im planes cstride floats apart); its
// element (su, sv) lands on the grid cell
//   ((bu half + su - k0_off) mod nbig_x, (bv half + sv - k0_off) mod nbig_y),
// the closed form of the scatter, the shift-adds and the fold. K1 writes
// every cell of the bin's complex (nbig_x, nbig_y) grid as the sum of the
// patch elements landing on it; K2 sets every patch element to its cell.
//
// What bounds K1: bytes (each patch element read once, 8 S^2 bytes a group;
// each grid cell written once, 8 bytes), if the work is spread over the
// card. It is not spread by itself: a cell sums every group of the r^2
// buckets it lies under, and bucket sizes are skewed. The padded layouts
// (bin_gcap, the multiband plans) end each bin with empty groups, all in
// bucket 0, thousands of them, so one chain of thousands of dependent adds
// (each an order[] load, then a patch load) would set the whole launch's
// time while the rest of the card idles. K1 is therefore two kernels:
//
//   * idg_chunk_sums: every bucket with more than LONG_BUCKET groups was
//     cut at plan time into chunks of consecutive CSR entries (a function
//     of its count alone, ops/gridder_idg.py: chunk_length). One block a
//     chunk sums the chunk's patches element by element, in CSR order, from
//     0 into a scratch partial patch: neighbouring threads on neighbouring
//     elements, 16-byte loads, group indices read ahead. A bucket of 6,000
//     groups becomes ~64 chains of ~96 that run side by side.
//   * idg_assemble: one thread a grid cell of each of two neighbouring
//     lattice cells of the extended plane's first wrap (the grid's sides
//     are multiples of half), one block of half x half threads the pair. All
//     threads of a cell lie under the same r^2 buckets: counts, loop trips
//     and CSR loads are the block's, no warp straddles two buckets, and
//     consecutive threads read consecutive patch elements and write
//     consecutive cells. For each wrap, one warp loads the 2 r^2 buckets'
//     ranges at once and scans their counts; the block lists the wrap's
//     terms in shared memory (a group's or a partial's offset; a bucket's
//     groups are consecutive, save a padded bucket 0, so no order[] entry is
//     read for them), and each thread adds its element of every term, 8
//     loads in flight: a cell waits on ~2 round trips to memory, not on two
//     for each group, and the pair shares them and reads both halves of its
//     shared bucket's patch rows. Each cell is written once, by its owner,
//     with a plain store and is never read: no zeroing pass, no atomic.
//
// The order of sums, fixed by the plan: a cell starts from 0 and adds, by
// wrap of the extended plane (u, then v), then quarter (a, then b), then
// within the quarter's bucket either its groups in CSR order (a short
// bucket) or its chunk partials in chunk order (a long bucket), each
// partial being the sum from 0 of its chunk's groups in CSR order. So two
// runs give the same bits, on any card: the chunks depend on the plan only.
//
// K2 runs one thread per patch element, a pure gather by the same formula;
// it is bound by the same bytes and reads its grid cells coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// Patch loads a thread keeps in flight: the chunk sums' float4 loads, the
// assembly's term loads (each a re and an im float).
constexpr int CHUNK_BATCH = 16;
constexpr int TERM_BATCH = 8;
// terms of a block staged in shared memory at once; lattice cells a block
constexpr int TERMS = 512;
constexpr int CELLS = 2;

// One block a (chunk, tile of the 2 S^2 / 4 float4s of a patch): thread t
// of tile y sums the 4 consecutive elements of float4 f = y blockDim + t of
// the two planes over the chunk's groups, in CSR order, into the chunk's
// partial patch (2, nchunk, S, S), planes pstride floats apart. Tiles spread
// a bucket's chunks over every SM. The chunk's group indices are staged in
// shared memory first, so a thread's loads do not wait on them one by one.
__global__ void idg_chunk_sums_kernel(const float* __restrict__ patches, long long cstride,
                                      const int* __restrict__ order, const int2* __restrict__ chunks,
                                      float* __restrict__ partials, long long pstride, int S) {
  extern __shared__ int s_group[];  // blockDim.x entries
  const int c = blockIdx.x;
  const int2 range = chunks[c];
  const long long ss = (long long)S * S;
  const int quads = (int)(ss / 4);
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const int plane = f >= quads;
  const int e = (f - plane * quads) * 4;
  const float* src = patches + plane * cstride + e;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = range.x; base < range.y; base += blockDim.x) {
    const int n = min((int)blockDim.x, range.y - base);
    if ((int)threadIdx.x < n) s_group[threadIdx.x] = order ? order[base + threadIdx.x] : base + threadIdx.x;
    __syncthreads();
    int j = 0;
    for (; j + CHUNK_BATCH <= n; j += CHUNK_BATCH) {
      float4 v[CHUNK_BATCH];
#pragma unroll
      for (int u = 0; u < CHUNK_BATCH; ++u) v[u] = __ldg(reinterpret_cast<const float4*>(src + s_group[j + u] * ss));
#pragma unroll
      for (int u = 0; u < CHUNK_BATCH; ++u) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
    }
    for (; j < n; ++j) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + s_group[j] * ss));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    __syncthreads();
  }
  *reinterpret_cast<float4*>(partials + plane * pstride + c * ss + e) = acc;
}

// One thread a cell of each of CELLS lattice cells, one block of (half,
// half) threads the CELLS cell blocks (BU, BV .. BV + CELLS - 1) of the
// extended plane's first wrap. nbig_x and nbig_y are multiples of half, so
// every wrap of a cell block is a whole lattice cell and all its threads lie
// under the same R^2 buckets (R = S / half). Bucket k's groups are
// order[starts[k] .. starts[k + 1]), which are first[k] + 0, 1, ... where
// first[k] >= 0 (first is null where order is); where pstarts is given and
// pstarts[k] < pstarts[k + 1], the bucket is long and its partials are
// pstarts[k] - c0 .. pstarts[k + 1] - c0 of ``partials``. For each wrap (u,
// then v) the block lists its terms in shared memory, cell by cell in the
// order of sums (quarter (a, b), then the bucket's groups or partials),
// each as the element offset of its quarter's corner with the low bit
// marking a partial (offsets are even: S and half are), then every thread
// adds its element of each term to its cell's sums, TERM_BATCH loads in
// flight.
template <int R>
__global__ void idg_assemble_kernel(const float* __restrict__ patches, long long cstride,
                                    const int* __restrict__ order, const int* __restrict__ starts,
                                    const int* __restrict__ first, const float* __restrict__ partials,
                                    long long pstride, const int* __restrict__ pstarts, int c0,
                                    float2* __restrict__ grid, int nbx, int nby, int S, int half, int ko, int nbu,
                                    int nbv) {
  constexpr int NSEG = CELLS * R * R;  // one lane of warp 0 a segment
  static_assert(NSEG <= 32, "a warp sets up the segments");
  __shared__ long long s_term[TERMS];
  __shared__ int s_lo[NSEG], s_start[NSEG + 1], s_kind[NSEG];
  const int tid = threadIdx.y * half + threadIdx.x, nthreads = half * half;
  const int tu0 = blockIdx.y * half, tv0 = blockIdx.x * CELLS * half;  // the first cell block's corner
  const int ext_u = (nbu + R - 1) * half, ext_v = (nbv + R - 1) * half;
  const long long ss = (long long)S * S;
  const long long mine = (long long)threadIdx.y * S + threadIdx.x;  // this thread's element in a quarter
  float re[CELLS], im[CELLS];
#pragma unroll
  for (int c = 0; c < CELLS; ++c) re[c] = im[c] = 0.0f;
  for (int tu = tu0; tu < ext_u; tu += nbx) {
    for (int tv = tv0; tv < ext_v; tv += nby) {  // cell c's wrap is at tv + c half, if below ext_v
      if (tid < 32) {  // lane l: cell l / R^2, quarter l % R^2: its range in one round trip, then a prefix sum
        int lo = 0, n = 0, kind = 0;  // kind 0: groups lo + j, 1: partials lo + j, 2: groups order[lo + j]
        const int c = tid / (R * R), q = tid % (R * R);
        const int tvc = tv + c * half;
        const int bu = tu / half - q / R, bv = tvc / half - q % R;
        if (tid < NSEG && tvc < ext_v && tv0 + c * half < nby && bu >= 0 && bu < nbu && bv >= 0 && bv < nbv) {
          const int k = bu * nbv + bv;
          const int g0 = starts[k], g1 = starts[k + 1];
          const int f = first ? first[k] : -1;
          const int p0 = pstarts ? pstarts[k] : 0, p1 = pstarts ? pstarts[k + 1] : 0;
          kind = p0 < p1 ? 1 : (order && f < 0 ? 2 : 0);
          lo = kind == 1 ? p0 - c0 : (order && f >= 0 ? f : g0);
          n = kind == 1 ? p1 - p0 : g1 - g0;
        }
        int incl = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, d);
          incl += tid >= d ? v : 0;
        }
        if (tid < NSEG) {
          s_lo[tid] = lo;
          s_kind[tid] = kind;
          s_start[tid] = incl - n;
        }
        if (tid == NSEG - 1) s_start[NSEG] = incl;
      }
      __syncthreads();
      const int total = s_start[NSEG];
      for (int base = 0; base < total; base += TERMS) {
        const int n = min(TERMS, total - base);
        for (int t = tid; t < n; t += nthreads) {
          int l = 0;
          while (base + t >= s_start[l + 1]) ++l;
          const int j = base + t - s_start[l], q = l % (R * R);
          const long long corner = (long long)(q / R) * half * S + (q % R) * half;
          const int kind = s_kind[l];
          const long long g = kind == 2 ? order[s_lo[l] + j] : s_lo[l] + j;
          s_term[t] = g * ss + corner + (kind == 1);
        }
        __syncthreads();
        int t = 0;
        for (; t + TERM_BATCH <= n; t += TERM_BATCH) {
          float vr[TERM_BATCH], vi[TERM_BATCH];
#pragma unroll
          for (int u = 0; u < TERM_BATCH; ++u) {
            const long long w = s_term[t + u];
            const float* p = ((w & 1) ? partials : patches) + (w & ~1LL) + mine;
            vr[u] = p[0];
            vi[u] = p[(w & 1) ? pstride : cstride];
          }
#pragma unroll
          for (int u = 0; u < TERM_BATCH; ++u) {
            int c = 0;
#pragma unroll
            for (int cc = 1; cc < CELLS; ++cc) c += base + t + u >= s_start[cc * R * R];
#pragma unroll
            for (int cc = 0; cc < CELLS; ++cc) {
              if (cc == c) {
                re[cc] += vr[u];
                im[cc] += vi[u];
              }
            }
          }
        }
        for (; t < n; ++t) {
          const long long w = s_term[t];
          const float* p = ((w & 1) ? partials : patches) + (w & ~1LL) + mine;
          const float vr = p[0], vi = p[(w & 1) ? pstride : cstride];
          int c = 0;
#pragma unroll
          for (int cc = 1; cc < CELLS; ++cc) c += base + t >= s_start[cc * R * R];
#pragma unroll
          for (int cc = 0; cc < CELLS; ++cc) {
            if (cc == c) {
              re[cc] += vr;
              im[cc] += vi;
            }
          }
        }
        __syncthreads();
      }
      __syncthreads();  // every thread has read this wrap's segments before the next are written
    }
  }
  int x = (tu0 + (int)threadIdx.y - ko) % nbx;
  x += x < 0 ? nbx : 0;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    if (tv0 + c * half >= nby) break;
    int y = (tv0 + c * half + (int)threadIdx.x - ko) % nby;
    y += y < 0 ? nby : 0;
    grid[(long long)x * nby + y] = make_float2(re[c], im[c]);
  }
}

__global__ void idg_extract_kernel(const float2* __restrict__ grid, const long long* __restrict__ bid,
                                   float* __restrict__ patches, long long cstride, long long gc, int S, int half,
                                   int ko, int nbv, int nbx, int nby) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ss = (long long)S * S;
  if (e >= gc * ss) return;
  const long long g = e / ss;
  const int s = (int)(e - g * ss);
  const int su = s / S, sv = s - su * S;
  const long long k = bid[g];
  const int bu = (int)(k / nbv), bv = (int)(k - (long long)bu * nbv);
  int x = (bu * half + su - ko) % nbx;
  int y = (bv * half + sv - ko) % nby;
  x += x < 0 ? nbx : 0;
  y += y < 0 ? nby : 0;
  const float2 v = grid[(long long)x * nby + y];
  float* p = patches + g * ss + s;
  p[0] = v.x;
  p[cstride] = v.y;
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

template <int R>
void launch_assemble(dim3 blocks, dim3 threads, cudaStream_t stream, const float* patches, long long cstride,
                     const int* order, const int* starts, const int* first, const float* partials,
                     long long pstride, const int* pstarts, int c0, float* grid, int nbx, int nby, int S, int half,
                     int ko, int nbu, int nbv) {
  idg_assemble_kernel<R><<<blocks, threads, 0, stream>>>(patches, cstride, order, starts, first, partials, pstride,
                                                          pstarts, c0, reinterpret_cast<float2*>(grid), nbx, nby, S,
                                                          half, ko, nbu, nbv);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t otherwise, -1 for unsupported sizes.
// ``chunks`` holds nchunk (lo, hi) int32 pairs; ``patches`` and ``cstride``
// must allow 16-byte loads (the wrapper checks).
int pfb_idg_chunk_sums(const float* patches, long long cstride, const int* order, const int* chunks, int nchunk,
                       float* partials, long long pstride, int S, void* stream) {
  if (S < 2 || S % 2 || S * S / 2 > 1024 || nchunk < 0) return -1;
  if (nchunk == 0) return 0;
  // tiles of at most 128 threads, whole warps, where S allows (S = 16, 24, 32: 1, 3, 4 tiles)
  const int quads2 = S * S / 2;
  int tiles = (quads2 + 127) / 128;
  if (quads2 % tiles || (quads2 / tiles) % 32) tiles = 1;
  const int threads = quads2 / tiles;
  idg_chunk_sums_kernel<<<dim3(nchunk, tiles), threads, threads * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      patches, cstride, order, reinterpret_cast<const int2*>(chunks), partials, pstride, S);
  return (int)cudaGetLastError();
}

int pfb_idg_assemble(const float* patches, long long cstride, const int* order, const int* starts, const int* first,
                     const float* partials, long long pstride, const int* pstarts, int c0, float* grid, int nbx,
                     int nby, int S, int half, int ko, int nbu, int nbv, void* stream) {
  if (half < 6 || half > 32 || half % 2 || S % half || nbu < 1 || nbv < 1 || nbx % half || nby % half) return -1;
  const dim3 blocks((nby / half + CELLS - 1) / CELLS, nbx / half), threads(half, half);
  if (blocks.y > 65535) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S / half) {
    case 1:
      launch_assemble<1>(blocks, threads, st, patches, cstride, order, starts, first, partials, pstride, pstarts, c0,
                         grid, nbx, nby, S, half, ko, nbu, nbv);
      break;
    case 2:
      launch_assemble<2>(blocks, threads, st, patches, cstride, order, starts, first, partials, pstride, pstarts, c0,
                         grid, nbx, nby, S, half, ko, nbu, nbv);
      break;
    case 3:
      launch_assemble<3>(blocks, threads, st, patches, cstride, order, starts, first, partials, pstride, pstarts, c0,
                         grid, nbx, nby, S, half, ko, nbu, nbv);
      break;
    case 4:
      launch_assemble<4>(blocks, threads, st, patches, cstride, order, starts, first, partials, pstride, pstarts, c0,
                         grid, nbx, nby, S, half, ko, nbu, nbv);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

int pfb_idg_extract(const float* grid, const long long* bid, float* patches, long long cstride, long long gc, int S,
                    int half, int ko, int nbv, int nbx, int nby, void* stream) {
  if (half < 1 || S % half || nbv < 1 || nbx < 1 || nby < 1) return -1;
  const long long n = gc * S * S;
  if (n <= 0) return 0;
  idg_extract_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(grid), bid, patches, cstride, gc, S, half, ko, nbv, nbx, nby);
  return (int)cudaGetLastError();
}

}  // extern "C"
