// Psi, SARA's wavelet dictionary, for Hopper (sm_90a): the analysis P1
// (psi_analysis) and its adjoint, the synthesis P2 (psi_synthesis), over the
// packed (nband, nbasis, nymax, nxmax) layout of ops/psi.py, with a plain C
// interface for ctypes.
//
// Neither replaces a Pallas kernel: on the TPU Psi is XLA's
// conv_general_dilated (pfb_imaging_tpu/ops/wavelets.py:114 and :139), and
// the port's plain version (ops/psi.py, ops/wavelets.py, which CPU tensors
// take) runs every basis and level as its own chain of torch ops (pad,
// conv1d, cat, transposes, strided slot writes), ~290 launches a PD
// iteration on cuDNN's grouped direct kernels.
//
// What they compute. Basis k-tap filters f (dec_lo) and g (dec_hi, the
// quadrature mirror g[n] = (-1)^(n+1) f[k-1-n]); one level maps an image
// (n1, n2), zero outside, to the block [[LL, LH], [HL, HH]] of 2c1 x 2c2
// coefficients, c = (n + k - 1) / 2, with
//   A_ab[i][j] = sum_{m,l} a[m] b[l] img[2i+1-m][2j+1-l],  a, b in {f, g}
// (a along the rows, the first axis; b along the columns). Level i + 1 takes
// level i's LL; each level's block goes to its basis's slot of the packed
// plane, a deeper level in place of the shallower LL, and every cell that
// no slot covers is zero. The synthesis is the exact transpose: every image
// pixel gathers the taps that reach it,
//   img[s][r] = sum_{i,j,a,b} A_ab[i][j] a[2i+1-s] b[2j+1-r],
// and the last level sums the bases (the "self" basis, a copy, in its place).
//
// What bounds them: bytes. At SARA's nine bases on 4 x 2048^2 an analysis
// reads x (67 MB) and writes the cube (621 MB, 610 MB of it coefficients);
// the synthesis reads the coefficients and writes x: 677 MB, >= 0.202 ms
// each at 3.35 TB/s. Besides, each level but the deepest passes its LL (analysis)
// or its image (synthesis) to the next through a scratch buffer the wrapper
// allocates (136 MB at that shape), since the deeper slot overwrites the LL
// in the cube. The arithmetic is ~2k multiply-adds a coefficient (36 at
// db8), far below the card's f32 rate if shared memory is read sparingly.
// In a primal-dual iteration the synthesis takes 2 vn - v of the two dual
// cubes: reading both and the scratch, 1.58 GB, >= 0.47 ms.
//
// The design:
//   * one launch a level for every basis and band; both separable passes
//     run in shared memory inside a block: the tile and the filter's halo are
//     loaded once (the analysis's 16-byte loads where the rows are aligned
//     to them, else 4-byte; the synthesis's below; neighbouring threads on
//     neighbouring addresses), the row pass writes a staging tile, the
//     column pass reads it, and each result is stored once, neighbouring
//     threads on neighbouring columns;
//   * analysis, level 0: a block is a (band, tile) and runs every basis on
//     its one x tile (loaded with the longest filter's halo; "self" copies
//     it), so x is read from memory once; deeper levels: a block a (band,
//     tile, basis), reading that basis's LL from scratch;
//   * extra blocks at the end of each analysis grid write the zeros: at
//     level 0 the plane outside a basis's slots (and "self" beyond (nx,
//     ny)), at every level the two strips beside its quadrants that no slot
//     covers; so the cube comes from torch.empty;
//   * synthesis, deepest level first: a block a (band, 64 x 64 image tile)
//     loops over the level's bases in their order; deeper levels write each
//     basis's image to scratch, level 0 adds each basis's contribution in
//     registers and writes x once: a gather, no atomic, f32 sums in a fixed
//     order, so two runs give the same bits. A basis's four quadrant windows
//     are copied with cp.async into a stage of a ring of RING, so the next
//     basis's copies are in flight while this one computes. The packed
//     cube's rows are nxmax floats, at SARA's shapes odd, so no row is
//     16-byte aligned: each window row is copied in 16-byte pieces from its
//     address rounded down to 16 bytes (zero-filled past the quadrant), and
//     the row pass reads it at its 0-3-float offset. (Chosen by timing in
//     turns on an H100: 32- and 48-row tiles, a block a basis at the deeper
//     levels and rings of 3 and 4 were slower, 96-row tiles slower on two
//     cubes.)
//   * the synthesis on two cubes (PD's vn and v; the same layout, at the
//     same address modulo 16 bytes) copies the same pieces of both, and each
//     thread turns the pieces it copied into 2 vn - v once they land (one
//     rounding, as torch's 2.0 * vn - v: 2 vn is exact), so every pixel's
//     sums are those of the one-cube synthesis on torch's extrapolation, bit
//     for bit; the row pass's staging tile is then the stage's v half;
//   * in the passes a thread makes two (analysis columns) or four
//     (synthesis) neighbouring outputs from one run of shared-memory reads;
//   * the filters and the slot and level sizes come by value
//     (__grid_constant__ PsiLevel); k is taken at run time, with unrolled
//     paths for k = 2..16 and a loop for k up to PSI_KMAX.

#include <cuda_runtime.h>
#include <stdint.h>

#define PSI_KMAX 32
#define PSI_MAXB 16

// One basis of a level (a "member" of its launch).
struct PsiMember {
  int k;               // filter length; 0 for the "self" basis
  int plane;           // its basis index in the packed cube
  int scr;             // its index in the scratch buffers (the wavelet bases in order)
  int nin_x, nin_y;    // the level's image: the analysis's input, the synthesis's output
  int cx, cy;          // coefficients a side at this level
  int s, t;            // first row and column of its slot (its LL quadrant) in the packed plane
  float lo[PSI_KMAX];  // dec_lo
};

struct PsiLevel {
  int nmem, nbasis, nx, ny, nymax, nxmax;
  int first, last;         // level 0; the deepest level
  int kmax;                // the longest filter of the members, at least 2 (level 0's halo)
  int img_x, img_y;        // scratch of the level's image (levels > 0): rows, row stride
  int ll_x, ll_y;          // scratch of the level's LL (all but the deepest): rows, row stride
  PsiMember m[PSI_MAXB];
};

namespace {

constexpr int THREADS = 256;
constexpr int TI = 16, TJ = 32;  // analysis: a block's coefficient tile (rows x columns)
constexpr int TS = 64, TR = 64;  // synthesis: a block's image tile
constexpr int SROWS = 4;  // synthesis: pixel rows an item
constexpr int SITEMS = TS / SROWS * TR / THREADS;  // synthesis: items a thread
constexpr int RING = 2;   // synthesis: stages of members' windows
constexpr int SBLOCKS = 2;  // synthesis: blocks an SM asked of the register allocator
constexpr int ZERO_BLOCKS = 2;   // analysis: blocks a (band, member) writing its zeros

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// shared memory, in floats, for the longest filter kmax of a launch
__host__ __device__ constexpr int a_rows(int kmax) { return 2 * TI + kmax - 2; }
__host__ __device__ constexpr int a_width(int kmax) { return round4(2 * TJ + kmax); }
__host__ __device__ constexpr int a_floats(int kmax) { return a_rows(kmax) * (a_width(kmax) + 2 * TJ); }
__host__ __device__ constexpr int s_rows(int kmax) { return TS / 2 + kmax / 2 - 1; }
__host__ __device__ constexpr int s_width(int kmax) { return round4(TR / 2 + kmax / 2 + 2); }

// Rows [r0, r0 + nr) and columns [c0, c0 + nc) (c0 a multiple of 4) of a
// row-major array with row stride ld into a shared tile of row stride w,
// zero outside rows [vr0, vr1) and columns [vc0, vc1); 16-byte loads where
// the rows are aligned to them, neighbouring threads on neighbouring columns.
__device__ __forceinline__ void load_tile(float* tile, int w, const float* __restrict__ src, long long ld, int r0,
                                          int nr, int c0, int nc, int vr0, int vr1, int vc0, int vc1) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (ld & 3) == 0) {  // 16-byte loads
    const int nv = (nc + 3) >> 2, dr = THREADS / nv, du = THREADS - dr * nv;
    for (int r = threadIdx.x / nv, u = threadIdx.x - (threadIdx.x / nv) * nv; r < nr;) {
      const int gr = r0 + r, gc = c0 + 4 * u;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr >= vr0 && gr < vr1) {
        const float* row = src + gr * ld;
        if (gc >= vc0 && gc + 4 <= vc1) {
          v = __ldg(reinterpret_cast<const float4*>(row + gc));
        } else {
          if (gc >= vc0 && gc < vc1) v.x = row[gc];
          if (gc + 1 >= vc0 && gc + 1 < vc1) v.y = row[gc + 1];
          if (gc + 2 >= vc0 && gc + 2 < vc1) v.z = row[gc + 2];
          if (gc + 3 >= vc0 && gc + 3 < vc1) v.w = row[gc + 3];
        }
      }
      *reinterpret_cast<float4*>(tile + r * w + 4 * u) = v;
      u += du;
      r += dr;
      if (u >= nv) {
        u -= nv;
        ++r;
      }
    }
  } else {
    const int dr = THREADS / nc, dc = THREADS - dr * nc;
    for (int r = threadIdx.x / nc, c = threadIdx.x - (threadIdx.x / nc) * nc; r < nr;) {
      const int gr = r0 + r, gc = c0 + c;
      tile[r * w + c] = (gr >= vr0 && gr < vr1 && gc >= vc0 && gc < vc1) ? __ldg(src + gr * ld + gc) : 0.f;
      c += dc;
      r += dr;
      if (c >= nc) {
        c -= nc;
        ++r;
      }
    }
  }
}

__device__ __forceinline__ float* plane_of(float* cube, const PsiLevel& P, int band, int plane) {
  return cube + ((long long)band * P.nbasis + plane) * P.nymax * P.nxmax;
}

// One member's analysis of coefficient tile (i0, j0) from a shared tile
// whose row dr and column cofs (even) hold the member's first input row
// 2 i0 + 2 - k and column 2 j0 + 2 - k. Ends with the staging tile free.
template <int K>
__device__ __forceinline__ void analysis_member(const PsiLevel& P, const PsiMember& M, int band, int nband, int i0,
                                                int j0, const float* tile, int w, int dr, int cofs, float* mid,
                                                float* __restrict__ cube, float* __restrict__ ll) {
  const int k = K ? K : M.k;
  const int rows = 2 * TI + k - 2;
  // row pass: lo and hi of column j (the lane) of every input row, a warp a row
  static_assert(TJ == 32, "a lane a column");
  const int jr = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += THREADS / 32) {
    const float* v = tile + (dr + r) * w + cofs + 2 * jr;
    float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int q = 0; q < k; q += 2) {
      const float2 a = *reinterpret_cast<const float2*>(v + q);
      lo = fmaf(M.lo[k - 1 - q], a.x, lo);
      hi = fmaf(M.lo[q], a.x, hi);
      lo = fmaf(M.lo[k - 2 - q], a.y, lo);
      hi = fmaf(-M.lo[q + 1], a.y, hi);
    }
    mid[r * 2 * TJ + jr] = lo;
    mid[r * 2 * TJ + TJ + jr] = hi;
  }
  __syncthreads();
  // column pass: rows 2i and 2i + 1 of column j of the lo (LL, HL) or hi (LH, HH) half
  float* plane = plane_of(cube, P, band, M.plane);
  for (int e = threadIdx.x; e < TI * TJ; e += THREADS) {
    const int j = e % TJ, yhi = (e / TJ) & 1, ip = e / (2 * TJ);
    const float* c = mid + 4 * ip * 2 * TJ + yhi * TJ + j;
    float l0 = 0.f, h0 = 0.f, l1 = 0.f, h1 = 0.f;
#pragma unroll
    for (int q = 0; q < k + 2; ++q) {
      const float v = c[q * 2 * TJ];
      if (q < k) {
        l0 = fmaf(M.lo[k - 1 - q], v, l0);
        h0 = fmaf((q & 1) ? -M.lo[q] : M.lo[q], v, h0);
      }
      if (q >= 2) {
        l1 = fmaf(M.lo[k + 1 - q], v, l1);
        h1 = fmaf((q & 1) ? -M.lo[q - 2] : M.lo[q - 2], v, h1);
      }
    }
    const int J = j0 + j;
    if (J >= M.cy) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int I = i0 + 2 * ip + h;
      if (I >= M.cx) break;
      const float l = h ? l1 : l0, g = h ? h1 : h0;
      if (yhi) {
        plane[(long long)(M.s + I) * P.nxmax + M.t + M.cy + J] = l;         // LH
        plane[(long long)(M.s + M.cx + I) * P.nxmax + M.t + M.cy + J] = g;  // HH
      } else {
        if (P.last) plane[(long long)(M.s + I) * P.nxmax + M.t + J] = l;   // LL
        else ll[(((long long)M.scr * nband + band) * P.ll_x + I) * P.ll_y + J] = l;
        plane[(long long)(M.s + M.cx + I) * P.nxmax + M.t + J] = g;         // HL
      }
    }
  }
  __syncthreads();
}

#define PSI_BY_K(CALL)        \
  switch (M.k) {              \
    case 2: CALL(2); break;   \
    case 4: CALL(4); break;   \
    case 6: CALL(6); break;   \
    case 8: CALL(8); break;   \
    case 10: CALL(10); break; \
    case 12: CALL(12); break; \
    case 14: CALL(14); break; \
    case 16: CALL(16); break; \
    default: CALL(0);         \
  }

// Zero the cells of member M's plane that this level owns and no quadrant
// covers: the strips above LH and left of HL; at level 0 also the plane
// beyond the slots ("self": beyond (nx, ny)).
__device__ void zero_margins(const PsiLevel& P, const PsiMember& M, float* plane, int zb) {
  int rect[4][4], n = 0;  // rows [a, b), columns [c, d)
  auto add = [&](int a, int b, int c, int d) {
    if (a < b && c < d) {
      rect[n][0] = a; rect[n][1] = b; rect[n][2] = c; rect[n][3] = d;
      ++n;
    }
  };
  if (M.k == 0) {
    add(P.nx, P.nymax, 0, P.nxmax);
    add(0, P.nx, P.ny, P.nxmax);
  } else {
    add(0, M.s, M.t + M.cy, M.t + 2 * M.cy);
    add(M.s + M.cx, M.s + 2 * M.cx, 0, M.t);
    if (P.first) {
      add(M.s + 2 * M.cx, P.nymax, 0, P.nxmax);
      add(0, M.s + 2 * M.cx, M.t + 2 * M.cy, P.nxmax);
    }
  }
  const int lane = threadIdx.x & 31, nwarp = ZERO_BLOCKS * THREADS / 32;
  const int wi = zb * (THREADS / 32) + threadIdx.x / 32;
  for (int q = 0; q < n; ++q)
    for (int p = rect[q][0] + wi; p < rect[q][1]; p += nwarp)
      for (int c = rect[q][2] + lane; c < rect[q][3]; c += 32) plane[(long long)p * P.nxmax + c] = 0.f;
}

__global__ void __launch_bounds__(THREADS) psi_analysis_kernel(const __grid_constant__ PsiLevel P, int nband,
                                                               const float* __restrict__ x, float* __restrict__ cube,
                                                               const float* __restrict__ img,
                                                               float* __restrict__ ll, int tiles_x, int tiles_y) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int w = a_width(P.kmax);
  float* mid = sh + a_rows(P.kmax) * w;
  const int per_band = tiles_x * tiles_y * (P.first ? 1 : P.nmem);
  long long b = blockIdx.x;
  if (b >= (long long)nband * per_band) {  // a zero block
    b -= (long long)nband * per_band;
    const int zb = b % ZERO_BLOCKS, mi = (b / ZERO_BLOCKS) % P.nmem, band = b / ZERO_BLOCKS / P.nmem;
    zero_margins(P, P.m[mi], plane_of(cube, P, band, P.m[mi].plane), zb);
    return;
  }
  const int band = b / per_band;
  int rest = b % per_band;
  const int mi = P.first ? 0 : rest % P.nmem;
  if (!P.first) rest /= P.nmem;
  const int i0 = (rest / tiles_y) * TI, j0 = (rest % tiles_y) * TJ;

  if (!P.first) {  // one member, its LL of the level above from scratch
    const PsiMember& M = P.m[mi];
    if (i0 >= M.cx || j0 >= M.cy) return;
    const int o = 2 * j0 + 2 - M.k, c0 = o & ~3;
    load_tile(sh, w, img + ((long long)M.scr * nband + band) * P.img_x * P.img_y, P.img_y, 2 * i0 + 2 - M.k,
              2 * TI + M.k - 2, c0, o - c0 + 2 * TJ + M.k - 2, 0, M.nin_x, 0, M.nin_y);
    __syncthreads();
#define PSI_ANALYSIS_ONE(KK) analysis_member<KK>(P, M, band, nband, i0, j0, sh, w, 0, o - c0, mid, cube, ll)
    PSI_BY_K(PSI_ANALYSIS_ONE)
    return;
  }
  // level 0: every member on one x tile, loaded with the longest filter's halo
  const int kh = P.kmax, r0 = 2 * i0 + 2 - kh, o = 2 * j0 + 2 - kh, c0 = o & ~3;
  load_tile(sh, w, x + (long long)band * P.nx * P.ny, P.ny, r0, 2 * TI + kh - 2, c0, o - c0 + 2 * TJ + kh - 2, 0,
            P.nx, 0, P.ny);
  __syncthreads();
  for (int m = 0; m < P.nmem; ++m) {
    const PsiMember& M = P.m[m];
    if (M.k == 0) {  // "self": the tile's own pixels
      float* plane = plane_of(cube, P, band, M.plane);
      for (int e = threadIdx.x; e < 4 * TI * TJ; e += THREADS) {
        const int r = e / (2 * TJ), c = e % (2 * TJ), p = 2 * i0 + r, q = 2 * j0 + c;
        if (p < P.nx && q < P.ny) plane[(long long)p * P.nxmax + q] = sh[(p - r0) * w + q - c0];
      }
      continue;
    }
    if (i0 >= M.cx || j0 >= M.cy) continue;
#define PSI_ANALYSIS_X(KK) \
  analysis_member<KK>(P, M, band, nband, i0, j0, sh, w, kh - M.k, o - c0 + kh - M.k, mid, cube, ll)
    PSI_BY_K(PSI_ANALYSIS_X)
  }
}

// 16-byte asynchronous copy to shared memory: the first `bytes` (0, 4, 8, 12
// or 16) of the 16 at src, the rest zero-filled; src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

// Quadrant q (rows a = q >> 1, columns b = q & 1) of member M as image tile
// (s0, r0) of its level reads it: p, the window's first coefficient (row
// s0 / 2, column r0 / 2 of the quadrant), the row stride ld, and the rows and
// columns from p to the quadrant's end (the window reads zeros past them).
// The LL comes from ll, the level below's output, unless the level is the
// deepest.
struct Quad {
  const float* p;
  int ld, rows, cols;
  bool from_ll;
};

__device__ __forceinline__ Quad quad_of(const PsiLevel& P, const PsiMember& M, int band, int nband, int s0, int r0,
                                        int q, const float* __restrict__ cube, const float* __restrict__ ll) {
  const int a = q >> 1, b = q & 1;
  Quad Q;
  Q.from_ll = q == 0 && !P.last;
  const int orr = Q.from_ll ? 0 : M.s + a * M.cx, orc = Q.from_ll ? 0 : M.t + b * M.cy;
  const float* src = Q.from_ll ? ll + ((long long)M.scr * nband + band) * P.ll_x * P.ll_y
                               : cube + ((long long)band * P.nbasis + M.plane) * P.nymax * P.nxmax;
  Q.ld = Q.from_ll ? P.ll_y : P.nxmax;
  Q.p = src + (long long)(orr + s0 / 2) * Q.ld + orc + r0 / 2;
  Q.rows = M.cx - s0 / 2;
  Q.cols = M.cy - r0 / 2;
  return Q;
}

// Where row i of a window starting at p lands in its shared tile: 0-3
// floats in, the row's address modulo 16 bytes.
__device__ __forceinline__ int row_offset(const float* p, int ld, int i) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) + (unsigned)(i * (ld & 3))) & 3;
}

// Member M's four quadrant windows for image tile (s0, r0) of its level into
// stage buf: quadrant q's row i in 16-byte pieces from its address rounded
// down to 16 bytes, at row i of tile q (row stride s_width), so the row's
// first coefficient sits row_offset(i) floats in; zero-filled past the
// quadrant. With a second cube (two), the same pieces of it to tiles 4-7
// (the LL from ll has one). One commit group.
template <bool TWO>
__device__ __forceinline__ void copy_quads(const PsiLevel& P, const PsiMember& M, int band, int nband, int s0,
                                            int r0, const float* __restrict__ cube, const float* __restrict__ two,
                                            const float* __restrict__ ll, float* buf) {
  const int ci = TS / 2 + M.k / 2 - 1, cj = TR / 2 + M.k / 2 - 1;
  const int w = s_width(P.kmax), nq = s_rows(P.kmax) * w, npc = (cj + 6) >> 2;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Quad Q = quad_of(P, M, band, nband, s0, r0, q, cube, ll);
    const int nr = min(Q.rows, ci), nc = min(Q.cols, cj);
    const float* safe = Q.p - row_offset(Q.p, Q.ld, 0);  // an aligned address for the pieces that read nothing
    float* tile = buf + q * nq;
    const int dr = THREADS / npc, du = THREADS - dr * npc;
    for (int r = threadIdx.x / npc, u = threadIdx.x - (threadIdx.x / npc) * npc; r < ci;) {
      const float* row = Q.p + (long long)r * Q.ld;
      const int o = row_offset(Q.p, Q.ld, r);
      const int n = r < nr ? min(max(o + nc - 4 * u, 0), 4) : 0;
      const float* piece = n ? row - o + 4 * u : safe;
      cp_async16(tile + r * w + 4 * u, piece, 4 * n);
      if (TWO && !Q.from_ll) cp_async16(tile + 4 * nq + r * w + 4 * u, piece + (two - cube), 4 * n);
      u += du;
      r += dr;
      if (u >= npc) {
        u -= npc;
        ++r;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// With two cubes (vn, v): each piece this thread copied of the cube's
// quadrants becomes 2 vn - v in place, one rounding as torch's 2.0 * vn - v
// (2 vn is exact). After this thread's copies have landed.
__device__ __forceinline__ void extrapolate_quads(const PsiLevel& P, const PsiMember& M, float* buf) {
  const int ci = TS / 2 + M.k / 2 - 1, cj = TR / 2 + M.k / 2 - 1;
  const int w = s_width(P.kmax), nq = s_rows(P.kmax) * w, npc = (cj + 6) >> 2;
  const int dr = THREADS / npc, du = THREADS - dr * npc;
  for (int q = P.last ? 0 : 1; q < 4; ++q) {
    float* tile = buf + q * nq;
    for (int r = threadIdx.x / npc, u = threadIdx.x - (threadIdx.x / npc) * npc; r < ci;) {
      float4* a = reinterpret_cast<float4*>(tile + r * w + 4 * u);
      const float4 b = *reinterpret_cast<const float4*>(tile + 4 * nq + r * w + 4 * u);
      float4 c = *a;
      c.x = fmaf(2.f, c.x, -b.x);
      c.y = fmaf(2.f, c.y, -b.y);
      c.z = fmaf(2.f, c.z, -b.z);
      c.w = fmaf(2.f, c.w, -b.w);
      *a = c;
      u += du;
      r += dr;
      if (u >= npc) {
        u -= npc;
        ++r;
      }
    }
  }
}

// One member's synthesis of image tile (s0, r0) of its level from its
// quadrant windows in buf, added to acc (pixel rows SROWS sp .. SROWS sp +
// SROWS - 1 of column R, sp and R from the thread and item). Starts with
// the staging tile free.
template <int K>
__device__ __forceinline__ void synthesis_member(const PsiLevel& P, const PsiMember& M, int band, int nband, int s0,
                                                 int r0, const float* __restrict__ cube, const float* __restrict__ ll,
                                                 const float* buf, float* mid, float (&acc)[SITEMS][SROWS]) {
  const int k = K ? K : M.k;
  const int ci = TS / 2 + k / 2 - 1;
  const int w = s_width(P.kmax), nrow = s_rows(P.kmax);
  // each quadrant's window: its first row's offset in the tile, and its row stride modulo 4
  int o0[4], ldm[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Quad Q = quad_of(P, M, band, nband, s0, r0, q, cube, ll);
    o0[q] = row_offset(Q.p, Q.ld, 0);
    ldm[q] = Q.ld & 3;
  }
  // row pass: columns 4 u2 .. 4 u2 + 3 of coefficient row i of the row filter a
  for (int e = threadIdx.x; e < 2 * ci * (TR / 4); e += THREADS) {
    const int u2 = e % (TR / 4), i = (e / (TR / 4)) % ci, a = e / (TR / 4 * ci);
    const int cl = (a ? o0[2] + i * ldm[2] : o0[0] + i * ldm[0]) & 3;
    const int ch = (a ? o0[3] + i * ldm[3] : o0[1] + i * ldm[1]) & 3;
    const float* ql = buf + (2 * a) * nrow * w + i * w + cl + 2 * u2;
    const float* qh = buf + (2 * a + 1) * nrow * w + i * w + ch + 2 * u2;
    float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
    for (int p = 0; p <= k / 2; ++p) {
      const float l = ql[p], h = qh[p];
      if (p < k / 2) {
        y0 = fmaf(M.lo[2 * p + 1], l, y0);
        y0 = fmaf(M.lo[k - 2 - 2 * p], h, y0);
        y1 = fmaf(M.lo[2 * p], l, y1);
        y1 = fmaf(-M.lo[k - 1 - 2 * p], h, y1);
      }
      if (p >= 1) {
        y2 = fmaf(M.lo[2 * p - 1], l, y2);
        y2 = fmaf(M.lo[k - 2 * p], h, y2);
        y3 = fmaf(M.lo[2 * p - 2], l, y3);
        y3 = fmaf(-M.lo[k + 1 - 2 * p], h, y3);
      }
    }
    *reinterpret_cast<float4*>(mid + (a * nrow + i) * TR + 4 * u2) = make_float4(y0, y1, y2, y3);
  }
  __syncthreads();
  // column pass: pixel rows 4 sp .. 4 sp + 3 of column R
#pragma unroll
  for (int it = 0; it < SITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS, R = e % TR, sp = e / TR;
    const float* ml = mid + 2 * sp * TR + R;
    const float* mh = mid + (nrow + 2 * sp) * TR + R;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
#pragma unroll
    for (int p = 0; p <= k / 2; ++p) {
      const float l = ml[p * TR], h = mh[p * TR];
      if (p < k / 2) {
        x0 = fmaf(M.lo[2 * p + 1], l, x0);
        x0 = fmaf(M.lo[k - 2 - 2 * p], h, x0);
        x1 = fmaf(M.lo[2 * p], l, x1);
        x1 = fmaf(-M.lo[k - 1 - 2 * p], h, x1);
      }
      if (p >= 1) {
        x2 = fmaf(M.lo[2 * p - 1], l, x2);
        x2 = fmaf(M.lo[k - 2 * p], h, x2);
        x3 = fmaf(M.lo[2 * p - 2], l, x3);
        x3 = fmaf(-M.lo[k + 1 - 2 * p], h, x3);
      }
    }
    acc[it][0] += x0;
    acc[it][1] += x1;
    acc[it][2] += x2;
    acc[it][3] += x3;
  }
}

// whether image tile (s0, r0) of its level has work for member m: a wavelet
// basis (k > 0) whose level image the tile meets
__device__ __forceinline__ bool tile_wavelet(const PsiLevel& P, int m, int s0, int r0) {
  return P.m[m].k > 0 && s0 < P.m[m].nin_x && r0 < P.m[m].nin_y;
}

// the next member from m on with work for tile (s0, r0), m1 if none
__device__ __forceinline__ int next_wavelet(const PsiLevel& P, int m, int m1, int s0, int r0) {
  while (m < m1 && !tile_wavelet(P, m, s0, r0)) ++m;
  return m;
}

// image tile (s0, r0) from acc into dst (row stride ld), inside (nout_x, nout_y)
__device__ __forceinline__ void store_tile(float* __restrict__ dst, int ld, int nout_x, int nout_y, int s0, int r0,
                                           const float (&acc)[SITEMS][SROWS]) {
#pragma unroll
  for (int it = 0; it < SITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS, R = r0 + e % TR, S = s0 + SROWS * (e / TR);
    if (R >= nout_y) continue;
#pragma unroll
    for (int h = 0; h < SROWS; ++h)
      if (S + h < nout_x) dst[(long long)(S + h) * ld + R] = acc[it][h];
  }
}

// P2 of one level from one cube, or (TWO) from 2 vn - v of two: a block a
// (band, tile) loops over the level's members in their order, at level 0
// summing them into x, deeper writing each basis's image to scratch. The
// wavelet members' windows stream through a ring of RING stages (the launch
// gives it `stages`, at most the block's wavelet members), RING - 1
// members' copies in flight while one computes. The row pass's staging tile
// (mid) is the current stage's second-cube half with two cubes, else past
// the ring.
template <bool TWO>
__global__ void __launch_bounds__(THREADS, SBLOCKS)
    psi_synthesis_kernel(const __grid_constant__ PsiLevel P, int nband, const float* __restrict__ cube,
                         const float* __restrict__ two, const float* __restrict__ ll, float* __restrict__ img,
                         float* __restrict__ x, int tiles_x, int tiles_y, int stages) {
  static_assert(RING >= 2, "a ring of at least two stages");
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int m1 = P.nmem;
  const int s0 = (blockIdx.x % (tiles_x * tiles_y)) / tiles_y * TS, r0 = (blockIdx.x % tiles_y) * TR;
  const int band = blockIdx.x / (tiles_x * tiles_y);
  if (P.first && (s0 >= P.nx || r0 >= P.ny)) return;
  const int nq = s_rows(P.kmax) * s_width(P.kmax), nstage = (TWO ? 8 : 4) * nq;
  float acc[SITEMS][SROWS];
#pragma unroll
  for (int it = 0; it < SITEMS; ++it)
#pragma unroll
    for (int h = 0; h < SROWS; ++h) acc[it][h] = 0.f;
  // RING - 1 wavelet members copied ahead; an empty group where none is left
  // keeps a member's copies RING - 2 groups behind the newest
  int nxt = next_wavelet(P, 0, m1, s0, r0), slot_in = 0, slot = 0;
  auto copy_next = [&]() {
    if (nxt < m1) {
      copy_quads<TWO>(P, P.m[nxt], band, nband, s0, r0, cube, two, ll, sh + slot_in * nstage);
      nxt = next_wavelet(P, nxt + 1, m1, s0, r0);
      slot_in = slot_in + 1 == RING ? 0 : slot_in + 1;
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  };
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) copy_next();
  for (int m = 0; m < m1; ++m) {
    const PsiMember& M = P.m[m];
    if (M.k == 0) {  // "self": its plane's own pixels
      const long long po = ((long long)band * P.nbasis + M.plane) * P.nymax * P.nxmax;
#pragma unroll
      for (int it = 0; it < SITEMS; ++it) {
        const int e = threadIdx.x + it * THREADS, R = r0 + e % TR, S = s0 + SROWS * (e / TR);
        if (R >= P.ny) continue;
#pragma unroll
        for (int h = 0; h < SROWS; ++h) {
          if (S + h >= P.nx) continue;
          const long long i = po + (long long)(S + h) * P.nxmax + R;
          acc[it][h] += TWO ? fmaf(2.f, cube[i], -two[i]) : cube[i];
        }
      }
      continue;
    }
    if (!tile_wavelet(P, m, s0, r0)) continue;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2));
    float* buf = sh + slot * nstage;
    if (TWO) extrapolate_quads(P, M, buf);
    __syncthreads();  // this member's windows are in; the last member is done with its stage and mid
    copy_next();     // into the last member's stage
    float* mid = TWO ? buf + 4 * nq : sh + stages * nstage;
#define PSI_SYNTHESIS(KK) synthesis_member<KK>(P, M, band, nband, s0, r0, cube, ll, buf, mid, acc)
    PSI_BY_K(PSI_SYNTHESIS)
    slot = slot + 1 == RING ? 0 : slot + 1;
    if (!P.first) {  // this basis's level image to scratch
      store_tile(img + ((long long)M.scr * nband + band) * P.img_x * P.img_y, P.img_y, M.nin_x, M.nin_y, s0, r0,
                 acc);
#pragma unroll
      for (int it = 0; it < SITEMS; ++it)
#pragma unroll
        for (int h = 0; h < SROWS; ++h) acc[it][h] = 0.f;
    }
  }
  if (P.first) store_tile(x + (long long)band * P.nx * P.ny, P.ny, P.nx, P.ny, s0, r0, acc);
}

bool level_ok(const PsiLevel& P, int nband) {
  if (nband < 1 || P.nmem < 1 || P.nmem > PSI_MAXB || P.kmax < 2 || P.kmax > PSI_KMAX || (P.kmax & 1)) return false;
  for (int m = 0; m < P.nmem; ++m) {
    const int k = P.m[m].k;
    if (k < 0 || k > P.kmax || (k & 1) || (k == 0 && !P.first)) return false;
  }
  return true;
}

// Tiles of a plane in each direction: enough for the largest member's
// coefficients (the analysis's TI x TJ tiles; "self" copies two image rows
// and columns a coefficient) or image (the synthesis's TS x TR tiles).
void plane_tiles(const PsiLevel& P, bool analysis, int& tiles_x, int& tiles_y) {
  int ex = 0, ey = 0;
  for (int m = 0; m < P.nmem; ++m) {
    const PsiMember& M = P.m[m];
    const int rows = analysis ? (M.k ? M.cx : (P.nx + 1) / 2) : M.nin_x;
    const int cols = analysis ? (M.k ? M.cy : (P.ny + 1) / 2) : M.nin_y;
    ex = rows > ex ? rows : ex;
    ey = cols > ey ? cols : ey;
  }
  const int tx = analysis ? TI : TS, ty = analysis ? TJ : TR;
  tiles_x = (ex + tx - 1) / tx;
  tiles_y = (ey + ty - 1) / ty;
}

// Shared memory of a synthesis launch: `stages` stages of one or two cubes'
// four quadrant tiles, and the row pass's staging tile past them (one cube;
// with two it is the current stage's second half).
int synthesis_smem(int kmax, bool two, int stages) {
  const int nq = s_rows(kmax) * s_width(kmax);
  return (int)sizeof(float) * (two ? stages * 8 * nq : stages * 4 * nq + 2 * s_rows(kmax) * TR);
}

template <bool TWO>
int launch_synthesis(const PsiLevel& P, int nband, const float* cube, const float* two, const float* ll, float* img,
                     float* x, int tx, int ty, int nwav, long long blocks, void* stream) {
  const int stages = nwav < RING ? (nwav > 0 ? nwav : 1) : RING;
  const int smem = synthesis_smem(P.kmax, TWO, stages);
  if (smem > 48 * 1024) {  // past the default: opt in
    const cudaError_t e =
        cudaFuncSetAttribute(psi_synthesis_kernel<TWO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  psi_synthesis_kernel<TWO><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      P, nband, cube, two, ll, img, x, tx, ty, stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One analysis level (the levels in order, 0 first): x (nband, nx, ny) at
// level 0, else img, the level above's LL scratch; the LL to ll (all but the
// deepest level); the coefficients and zeros into the cube.
int pfb_psi_analysis(const PsiLevel* lvl, int nband, const float* x, float* cube, const float* img, float* ll,
                     void* stream) {
  const PsiLevel& P = *lvl;
  if (!level_ok(P, nband)) return -1;
  int tx, ty;
  plane_tiles(P, true, tx, ty);
  if (tx < 1 || ty < 1) return -1;
  const long long blocks =
      (long long)nband * tx * ty * (P.first ? 1 : P.nmem) + (long long)nband * P.nmem * ZERO_BLOCKS;
  if (blocks > 0x7fffffffLL) return -1;
  psi_analysis_kernel<<<(unsigned)blocks, THREADS, a_floats(P.kmax) * sizeof(float), (cudaStream_t)stream>>>(
      P, nband, x, cube, img, ll, tx, ty);
  return (int)cudaGetLastError();
}

// One synthesis level (the deepest first): the cube's quadrants (the LL from
// ll, the level below's output, unless the level is the deepest) to img, the
// level above's scratch, or at level 0 the bases summed into x. With a second
// cube (two, not null: PD's v beside vn in cube), the quadrants of 2 cube -
// two; both cubes must lie at the same address modulo 16 bytes.
int pfb_psi_synthesis(const PsiLevel* lvl, int nband, const float* cube, const float* two, const float* ll,
                      float* img, float* x, void* stream) {
  const PsiLevel& P = *lvl;
  if (!level_ok(P, nband)) return -1;
  if (two && ((reinterpret_cast<uintptr_t>(cube) ^ reinterpret_cast<uintptr_t>(two)) & 15)) return -1;
  int tx, ty;
  plane_tiles(P, false, tx, ty);
  if (tx < 1 || ty < 1) return -1;
  const long long blocks = (long long)nband * tx * ty;
  if (blocks > 0x7fffffffLL) return -1;
  int nwav = 0;
  for (int m = 0; m < P.nmem; ++m) nwav += P.m[m].k > 0;
  return two ? launch_synthesis<true>(P, nband, cube, two, ll, img, x, tx, ty, nwav, blocks, stream)
             : launch_synthesis<false>(P, nband, cube, two, ll, img, x, tx, ty, nwav, blocks, stream);
}

}  // extern "C"
