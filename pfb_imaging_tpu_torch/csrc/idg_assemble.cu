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
// K1 runs one thread per cell: the thread owns its cell, writes it once
// with a plain store and never reads it, so the grid is neither zeroed nor
// updated in place, and there are no atomics. It finds the contributors by
// inverting the closed form: the extended-plane rows tu = x + k0_off (mod
// nbig_x) in [0, (nbu + r - 1) half) (the wraps, ascending), for each the
// quarter a in [0, r) giving bucket row bu = tu / half - a in [0, nbu) and
// patch row su = tu - bu half, and the same along v; bucket (bu, bv)'s
// groups come from the plan's per-bin CSR (bucket -> a range of ``order``,
// groups ascending; ``order`` null where the groups already lie in bucket
// order). The sum runs in one order fixed at plan time: by wrap (u, then
// v), then quarter (a, b), then group. So two runs give the same bits.
//
// K2 runs one thread per patch element, a pure gather by the same formula.
//
// What bounds them on the card: bytes. K1 reads each patch element once
// (8 S^2 bytes a group) and writes each grid cell once (8 bytes); K2 the
// reverse; the CSR adds 4 (nbu nbv + 1) bytes a bin and 4 a group. A
// thread's patch reads follow its neighbours' (consecutive cells along v
// read consecutive sv of one patch row), so loads coalesce. The work per
// cell follows the groups per bucket, so the cells under the fullest
// buckets set K1's time. This first version stages nothing in shared
// memory; making it fast is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void idg_assemble_kernel(const float* __restrict__ patches, long long cstride,
                                    const int* __restrict__ order, const int* __restrict__ starts,
                                    float2* __restrict__ grid, int nbx, int nby, int S, int half, int ko, int nbu,
                                    int nbv) {
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (long long)nbx * nby) return;
  const int x = (int)(cell / nby);
  const int y = (int)(cell - (long long)x * nby);
  const int r = S / half;
  const int ext_u = (nbu + r - 1) * half;
  const int ext_v = (nbv + r - 1) * half;
  const long long ss = (long long)S * S;
  float re = 0.0f, im = 0.0f;
  for (int tu = (x + ko) % nbx; tu < ext_u; tu += nbx) {
    for (int tv = (y + ko) % nby; tv < ext_v; tv += nby) {
      for (int a = 0; a < r; ++a) {
        const int bu = tu / half - a;
        if (bu < 0 || bu >= nbu) continue;
        const int su = tu - bu * half;
        for (int b = 0; b < r; ++b) {
          const int bv = tv / half - b;
          if (bv < 0 || bv >= nbv) continue;
          const int sv = tv - bv * half;
          const int k = bu * nbv + bv;
          const int hi = starts[k + 1];
          for (int i = starts[k]; i < hi; ++i) {
            const long long g = order ? order[i] : i;
            const float* p = patches + g * ss + su * S + sv;
            re += p[0];
            im += p[cstride];
          }
        }
      }
    }
  }
  grid[cell] = make_float2(re, im);
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

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t otherwise, -1 for unsupported sizes.
int pfb_idg_assemble(const float* patches, long long cstride, const int* order, const int* starts, float* grid,
                     int nbx, int nby, int S, int half, int ko, int nbu, int nbv, void* stream) {
  if (half < 1 || S % half || nbu < 1 || nbv < 1 || nbx < 1 || nby < 1) return -1;
  idg_assemble_kernel<<<blocks_for((long long)nbx * nby), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      patches, cstride, order, starts, reinterpret_cast<float2*>(grid), nbx, nby, S, half, ko, nbu, nbv);
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
