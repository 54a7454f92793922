// Fused IDG patch evaluation for Hopper (sm_90a): the two kernels of the
// image-domain-gridding round trip, with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of pfb_imaging_tpu/ops/idg_fused.py:
//   * pfb_patches_from_vals  <- patches_from_vals (:253, body _adj_kernel_body :228)
//       P_g = Wu (Zu diag(V_g) Zv^T) Wv^T                 (adjoint / grid)
//   * pfb_vals_from_patches  <- vals_from_patches (:329, body _fwd_kernel_body :287)
//       V_g[v] = sum_{x,y} conj(Zu[x,v]) R[x,y] conj(Zv[y,v]),
//       R = conj(Wu)^T P_g conj(Wv)                       (forward / degrid)
// Z[x, v] = exp(i (du_v xc[x] + phi_v xc[x]^2)), xc = fftfreq(S) * S, is
// rebuilt per slot by the rotation-power recurrence of _rot_block: two
// sincos per (slot, axis) and S complex multiplies, in f64 (below).
//
// What bounds it on the card: operations. A group costs S^2 G complex MACs
// for the slot contraction plus 2 S^3 for the two taper-DFT products,
// against 24 bytes per slot in and 8 S^2 bytes per patch out: 30 (S = 16)
// to 70 (S = 32) complex-MAC flops per byte, far above the ridge. At the
// main plan (ng 32,194, S 32) three TF32 passes at the dense 495 TFLOP/s
// would take 0.31 ms; mma.sync runs at about half that rate (PERF.md §6),
// and the f64 recurrence, the fragment splits and the barriers add to it.
//
// Design: every complex product runs on the tensor cores (warp-level
// mma.sync m16n8k8 TF32, f32 accumulators). A complex product O = A B is
// one real product of stacked operands,
//     [Or; Oi] = [[Ar, -Ai], [Ai, Ar]] [Br; Bi],
// whose 2R output rows fill m16 tiles for every S in {16, 24, 32}. One
// TF32 pass keeps 11 significant bits and misses the f32 contract (rel
// 2e-6) by ~150x. So every operand is split, as it is loaded into a
// fragment, into big = rna_tf32(x) and small = rna_tf32(x - big), and each
// product takes three passes, small*big + big*small + big*big (3xTF32):
// the counterpart of the TPU kernel's bf16 split matmuls (zpasses). The
// tensor cores sum in truncating steps, so the passes do not share one
// accumulator (cgemm below): that keeps the kernels as accurate as plain
// f32 (~2.5e-7 against f64). No library GEMM is called; wgmma is not used
// (its 64-row tiles would need the split operands staged in shared memory).
//   B1: the block builds Zu and Bv = Zv diag(V) in shared memory (one
//   thread per slot and axis, rows x, slot index as K); the warps contract
//   M^T = Bv Zu^T (stacked 2S x S), each on a share of the rows and slots;
//   the partial sums are added once; then Q = Wv M^T and P = Wu Q^T, a
//   warp per column tile, P stored straight from the accumulators.
//   B2: T1 = P conj(Wv), R = conj(Wu)^T T1, then T = R conj(Zv) (S x G, the
//   S^2 G part), each warp on its own slots; V[v] = sum_x conj(Zu)[x,v]
//   T[x,v] is summed in the accumulator registers and across the eight
//   lanes of a column by shuffles.
// Blocks are persistent and walk the groups one at a time, so the taper
// factors are loaded once per block and a ragged ng needs no mask. The
// slots are taken in two halves (below), which lets three blocks share an
// SM at S = 32. Shared-memory pitches are chosen so that every fragment
// load and every per-slot store is free of bank conflicts: rows read as
// the A operand (row = lane / 4, column = lane % 4) have a pitch of 4 mod
// 8 floats, rows read as a row-major B operand one of 8 or 24 mod 32.
//
// Layouts (all f32, C-contiguous): scal (4, ng, G) [du_u, phi_u, du_v,
// phi_v]; vals (2, ng, G) [re, im]; wcu, wcv (2, S, S) [re, im] with
// W[k, x] = exp(-2 pi i k x / S) c[x]; patches (2, ng, S, S).
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int G = 128;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <int S>
struct Pitch {
  static constexpr int A = S + 4;                    // 4 mod 8
  static constexpr int B = S % 32 == 24 ? S : S + 8;  // 8 or 24 mod 32
};

// Re/im planes of col[x * stride] = Z[x] (* V when HAS_V) for x in [0, S): Z[x] =
// z^xc q^(xc^2) with z = e^{i du}, q = e^{i phi} (conjugated when CONJ).
// Row k <- z^k q^(k^2), row S-k <- conj(z)^k q^(k^2); both advance by a
// running q^(2k-1) factor. The recurrence runs in f64 and each entry is
// rounded once to f32: in f32 its S/2 chained products drift ~1e-6 in
// phase, which alone would spend the 2e-6 accuracy contract.
template <int S, bool CONJ, bool HAS_V>
__device__ __forceinline__ void rot_column(float du, float phi, float vr, float vi, float* re, float* im,
                                           int stride) {
  constexpr int NH = S / 2;
  double sz, cz, sq, cq;
  sincos((double)du, &sz, &cz);
  sincos((double)phi, &sq, &cq);
  const double zr = cz, zi = CONJ ? -sz : sz;
  const double qr = cq, qi = CONJ ? -sq : sq;
  re[0] = vr;
  im[0] = vi;
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
    if (k <= NH - 1) {
      re[k * stride] = (float)(HAS_V ? pr * vr - pi * vi : pr);
      im[k * stride] = (float)(HAS_V ? pr * vi + pi * vr : pi);
    }
    re[(S - k) * stride] = (float)(HAS_V ? mr * vr - mi * vi : mr);
    im[(S - k) * stride] = (float)(HAS_V ? mr * vi + mi * vr : mi);
    t = cr * q2r - ci * q2i;
    ci = cr * q2i + ci * q2r;
    cr = t;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to ~2^-22 of |x|, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += tile (MT0 + i, nt0 + j) of the stacked product
//   [Or; Oi] = [[Ar, -Ai], [Ai, Ar]] [Br; Bi]      (O = A B, A: R x K complex)
// over the complex K range [k0, k1), in steps of 8. a(r, k) gives (Ar, Ai)
// at r < R, b(k, n) gives (Br, Bi). Fragments (PTX m16n8k8 .tf32): A holds
// rows lane/4 (+8) and columns lane%4 (+4), B rows lane%4 (+4) and column
// lane/4; the accumulator rows lane/4 (+8) and columns 2 (lane%4) (+1).
// The tensor cores sum in truncating steps, so the three passes do not
// share one accumulator (that loses ~1.3e-6, rel, at S = 32): the small
// terms (small*big + big*small, ~2^-11 of the result) chain in their own,
// and each K step's big*big products go into a fresh one that is added
// to acc in f32.
template <int R, int MT0, int NM, int NN, class AF, class BF>
__device__ __forceinline__ void cgemm(float (&acc)[NM][NN][4], int nt0, int k0, int k1, AF a, BF b) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float sm[NM][NN][4] = {};
  for (int kc = k0; kc < k1; kc += 8) {
    uint32_t bb[NN][2][2], bs[NN][2][2];  // [n-tile][Br, Bi][register]
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const int n = (nt0 + j) * 8 + gid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = b(kc + tig + 4 * h, n);
        split(v.x, bb[j][0][h], bs[j][0][h]);
        split(v.y, bb[j][1][h], bs[j][1][h]);
      }
    }
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      uint32_t ab[2][4], as[2][4];  // [K half multiplying Br, Bi][register]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = (MT0 + i) * 16 + gid + 8 * (q & 1);
        const bool im = (MT0 + i) * 16 + 8 * (q & 1) >= R;  // R is a multiple of 8
        const float2 v = a(im ? r - R : r, kc + tig + 4 * (q >> 1));
        uint32_t rb, rs, ib, is;
        split(v.x, rb, rs);
        split(v.y, ib, is);
        ab[0][q] = im ? ib : rb;
        as[0][q] = im ? is : rs;
        ab[1][q] = im ? rb : ib ^ 0x80000000u;
        as[1][q] = im ? rs : is ^ 0x80000000u;
      }
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        float big[4] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(sm[i][j], as[h], bb[j][h]);
          mma(sm[i][j], ab[h], bs[j][h]);
          mma(big, ab[h], bb[j][h]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += big[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += sm[i][j][e];
}

// accumulator tiles (mt0 + i, nt0 + j) to shared rows of the given pitch
template <int NM, int NN>
__device__ __forceinline__ void store_tiles(const float (&c)[NM][NN][4], float* dst, int pitch, int mt0, int nt0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const int r = (mt0 + i) * 16 + (lane >> 2), col = (nt0 + j) * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst + r * pitch + col) = make_float2(c[i][j][0], c[i][j][1]);
      *reinterpret_cast<float2*>(dst + (r + 8) * pitch + col) = make_float2(c[i][j][2], c[i][j][3]);
    }
}

// row-major (rows, S) f32 plane -> shared rows of the given pitch
template <int S>
__device__ __forceinline__ void load_plane(const float* __restrict__ src, float* dst, int pitch, int rows) {
  for (int i = threadIdx.x; i < rows * S; i += THREADS) dst[(i / S) * pitch + i % S] = src[i];
}

// Each group's G slots are taken in two halves of GH: the block builds one
// half's Z rows (a thread per slot and axis), contracts them, then the
// next. Half the slot rows in shared memory is what lets three blocks
// share an SM at S = 32, so one block's f64 recurrence, loads and barriers
// overlap another's tensor-core work. Each thread loads the next group's
// inputs into registers while it works on this one.
constexpr int GH = G / 2;
constexpr int ZH = GH + 4;  // half-slot rows read as the A operand, or as B transposed
constexpr int ZT = GH + 8;  // half-slot rows read as a row-major B operand

// B1's slot contraction: at S = 32 the warps split the output rows in two
// and the slots in two (32 accumulators a lane each), else the slots in four
template <int S>
struct SlotSplit {
  static constexpr int M = S == 32 ? 2 : 1;
  static constexpr int K = WARPS / M;
};

template <int S>
constexpr int b1_smem_floats() {
  return 4 * S * ZH + 2 * S * Pitch<S>::B + 2 * S * Pitch<S>::A + 4 * S * Pitch<S>::A;
}

template <int S>
__global__ void __launch_bounds__(THREADS, 3) patches_from_vals_kernel(
    const float* __restrict__ scal, const float* __restrict__ vals, const float* __restrict__ wcu,
    const float* __restrict__ wcv, float* __restrict__ out, long long ng) {
  constexpr int PA = Pitch<S>::A, PB = Pitch<S>::B, NM = 2 * S / 16, NN = S / 8;
  constexpr int MS = SlotSplit<S>::M, KS = SlotSplit<S>::K, NMW = NM / MS, KW = GH / KS;
  extern __shared__ float smem[];
  float* zur = smem;             // (S, ZH): Zu[x][v], v in this half
  float* zui = zur + S * ZH;
  float* bvr = zui + S * ZH;     // (S, ZH): Zv[y][v] V[v]
  float* bvi = bvr + S * ZH;
  float* part = smem;            // (KS, 2S, PB): partial M^T, over the Z rows once they are read
  float* mt = bvi + S * ZH;      // (2S, PB): [Mr^T; Mi^T][y][x]
  float* q = mt + 2 * S * PB;    // (2S, PA): [Qr; Qi][l][x], Q = Wv M^T
  float* wvr = q + 2 * S * PA;   // (S, PA) each: Wv[l][y], Wu[k][x]
  float* wvi = wvr + S * PA;
  float* wur = wvi + S * PA;
  float* wui = wur + S * PA;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int wm = w % MS, wk = w / MS;
  const int slot = t % GH, axis = t / GH;  // axis 0: Zu, 1: Bv (two warps each)
  float* zre = axis ? bvr : zur;
  float* zim = axis ? bvi : zui;
  const long long ngG = ng * G, plane = ng * S * S;

  load_plane<S>(wcv, wvr, PA, S);
  load_plane<S>(wcv + S * S, wvi, PA, S);
  load_plane<S>(wcu, wur, PA, S);
  load_plane<S>(wcu + S * S, wui, PA, S);

  // this thread's angles (and values, for Bv) in each half
  float in[2][4] = {};
  const auto load_in = [&](long long g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long o = g * G + h * GH + slot;
      in[h][0] = scal[2 * axis * ngG + o];
      in[h][1] = scal[(2 * axis + 1) * ngG + o];
      if (axis) {
        in[h][2] = vals[o];
        in[h][3] = vals[ngG + o];
      }
    }
  };
  if (blockIdx.x < ng) load_in(blockIdx.x);

  for (long long g = blockIdx.x; g < ng; g += gridDim.x) {
    float cur[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[h][e] = in[h][e];
    if (g + gridDim.x < ng) load_in(g + gridDim.x);

    // M^T = Bv Zu^T (stacked 2S x S): this warp's rows and slots, by halves
    float acc[NMW][NN][4] = {};
    const auto bv = [&](int r, int k) { return make_float2(bvr[r * ZH + k], bvi[r * ZH + k]); };
    const auto zut = [&](int k, int n) { return make_float2(zur[n * ZH + k], zui[n * ZH + k]); };
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      if (axis) rot_column<S, false, true>(cur[h][0], cur[h][1], cur[h][2], cur[h][3], zre + slot, zim + slot, ZH);
      else rot_column<S, false, false>(cur[h][0], cur[h][1], 1.f, 0.f, zre + slot, zim + slot, ZH);
      __syncthreads();
      if constexpr (MS == 2) {
        if (wm) cgemm<S, NMW>(acc, 0, wk * KW, wk * KW + KW, bv, zut);
        else cgemm<S, 0>(acc, 0, wk * KW, wk * KW + KW, bv, zut);
      } else {
        cgemm<S, 0>(acc, 0, wk * KW, wk * KW + KW, bv, zut);
      }
      __syncthreads();
    }
    store_tiles(acc, part + wk * 2 * S * PB, PB, wm * NMW, 0);
    __syncthreads();
    for (int e = t; e < 2 * S * PB; e += THREADS) {
      float s = part[e];
#pragma unroll
      for (int u = 1; u < KS; ++u) s += part[u * 2 * S * PB + e];
      mt[e] = s;
    }
    __syncthreads();

    // Q = Wv M^T, a warp per column tile
    for (int ni = w; ni < NN; ni += WARPS) {
      float c[NM][1][4] = {};
      cgemm<S, 0>(c, ni, 0, S, [&](int r, int k) { return make_float2(wvr[r * PA + k], wvi[r * PA + k]); },
                  [&](int k, int n) { return make_float2(mt[k * PB + n], mt[(S + k) * PB + n]); });
      store_tiles(c, q, PA, 0, ni);
    }
    __syncthreads();

    // P = Wu Q^T, straight to the (2, ng, S, S) output
    for (int ni = w; ni < NN; ni += WARPS) {
      float c[NM][1][4] = {};
      cgemm<S, 0>(c, ni, 0, S, [&](int r, int k) { return make_float2(wur[r * PA + k], wui[r * PA + k]); },
                  [&](int k, int n) { return make_float2(q[n * PA + k], q[(S + n) * PA + k]); });
      const int col = ni * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < NM; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = i * 16 + gid + 8 * hh;
          const long long idx = (r >= S ? plane : 0) + (g * S + r % S) * S + col;
          *reinterpret_cast<float2*>(out + idx) = make_float2(c[i][0][2 * hh], c[i][0][2 * hh + 1]);
        }
    }
  }
}

template <int S>
constexpr int b2_smem_floats() {
  return 4 * S * ZT + 2 * S * Pitch<S>::A + 4 * S * Pitch<S>::B;
}

template <int S>
__global__ void __launch_bounds__(THREADS, 3) vals_from_patches_kernel(
    const float* __restrict__ patches, const float* __restrict__ scal, const float* __restrict__ wcu,
    const float* __restrict__ wcv, float* __restrict__ out, long long ng) {
  constexpr int PA = Pitch<S>::A, PB = Pitch<S>::B, NM = 2 * S / 16, NN = S / 8;
  constexpr int NC = GH / 8 / WARPS;   // a warp's column tiles (slots / 8) in each half
  constexpr int NP = 2 * S * S / THREADS;  // patch values a thread loads
  extern __shared__ float smem[];
  float* czur = smem;            // (S, ZT): conj(Zu)[x][v], v in this half
  float* czui = czur + S * ZT;
  float* czvr = czui + S * ZT;   // (S, ZT): conj(Zv)[y][v]
  float* czvi = czvr + S * ZT;
  float* t1 = smem;              // (2S, PB): [T1r; T1i][k][y], T1 = P conj(Wv), before the Z rows
  float* pp = czvi + S * ZT;     // (2S, PA): [Pr; Pi][k][l]
  float* rr = pp;                // (2S, PA): [Rr; Ri][x][y], over P once it is read
  float* wvr = pp + 2 * S * PA;  // (S, PB) each: Wv[l][y], Wu[k][x]
  float* wvi = wvr + S * PB;
  float* wur = wvi + S * PB;
  float* wui = wur + S * PB;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int slot = t % GH, axis = t / GH;  // axis 0: conj(Zu), 1: conj(Zv) (two warps each)
  float* zre = axis ? czvr : czur;
  float* zim = axis ? czvi : czui;
  const long long ngG = ng * G, plane = ng * S * S;

  load_plane<S>(wcv, wvr, PB, S);
  load_plane<S>(wcv + S * S, wvi, PB, S);
  load_plane<S>(wcu, wur, PB, S);
  load_plane<S>(wcu + S * S, wui, PB, S);

  // this thread's patch values (element t + THREADS j of [Pr; Pi]) and angles
  float in_p[NP], in_a[2][2];
  const auto load_in = [&](long long g) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int e = t + THREADS * j;
      in_p[j] = patches[(e >= S * S ? plane : 0) + g * S * S + e % (S * S)];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long o = g * G + h * GH + slot;
      in_a[h][0] = scal[2 * axis * ngG + o];
      in_a[h][1] = scal[(2 * axis + 1) * ngG + o];
    }
  };
  if (blockIdx.x < ng) load_in(blockIdx.x);

  for (long long g = blockIdx.x; g < ng; g += gridDim.x) {
    float cur[2][2];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int e = t + THREADS * j;
      pp[(e / S) * PA + e % S] = in_p[j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) cur[h][0] = in_a[h][0], cur[h][1] = in_a[h][1];
    if (g + gridDim.x < ng) load_in(g + gridDim.x);
    __syncthreads();

    // T1 = P conj(Wv), a warp per column tile
    for (int ni = w; ni < NN; ni += WARPS) {
      float c[NM][1][4] = {};
      cgemm<S, 0>(c, ni, 0, S, [&](int r, int k) { return make_float2(pp[r * PA + k], pp[(S + r) * PA + k]); },
                  [&](int k, int n) { return make_float2(wvr[k * PB + n], -wvi[k * PB + n]); });
      store_tiles(c, t1, PB, 0, ni);
    }
    __syncthreads();

    // R = conj(Wu)^T T1
    for (int ni = w; ni < NN; ni += WARPS) {
      float c[NM][1][4] = {};
      cgemm<S, 0>(c, ni, 0, S, [&](int r, int k) { return make_float2(wur[k * PB + r], -wui[k * PB + r]); },
                  [&](int k, int n) { return make_float2(t1[k * PB + n], t1[(S + k) * PB + n]); });
      store_tiles(c, rr, PA, 0, ni);
    }
    __syncthreads();

    // by halves: T = R conj(Zv) on this warp's NC column tiles; V[v] =
    // sum_x conj(Zu)[x][v] T[x][v]: this lane's rows x = gid + 8 m hold
    // Re T in stacked row x and Im T in row S + x; then the sum over the
    // eight lanes of a column
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      rot_column<S, true, false>(cur[h][0], cur[h][1], 1.f, 0.f, zre + slot, zim + slot, ZT);
      __syncthreads();
      const int nt0 = NC * w;
      float acc[NM][NC][4] = {};
      cgemm<S, 0>(acc, nt0, 0, S, [&](int r, int k) { return make_float2(rr[r * PA + k], rr[(S + r) * PA + k]); },
                  [&](int k, int n) { return make_float2(czvr[k * ZT + n], czvi[k * ZT + n]); });
      float vre[NC][2] = {}, vim[NC][2] = {};
#pragma unroll
      for (int m = 0; m < S / 8; ++m) {
        const int x = gid + 8 * m, ri = m / 2, rh = m % 2, ii = (S / 8 + m) / 2, ih = (S / 8 + m) % 2;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int v = (nt0 + j) * 8 + 2 * tig;
          const float2 zr = *reinterpret_cast<const float2*>(czur + x * ZT + v);
          const float2 zi = *reinterpret_cast<const float2*>(czui + x * ZT + v);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float tr = acc[ri][j][2 * rh + e], ti = acc[ii][j][2 * ih + e];
            const float ar = e ? zr.y : zr.x, ai = e ? zi.y : zi.x;
            vre[j][e] += ar * tr - ai * ti;
            vim[j][e] += ar * ti + ai * tr;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int d = 4; d < 32; d *= 2) {
            vre[j][e] += __shfl_xor_sync(0xffffffffu, vre[j][e], d);
            vim[j][e] += __shfl_xor_sync(0xffffffffu, vim[j][e], d);
          }
      if (gid == 0) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const long long idx = g * G + h * GH + (nt0 + j) * 8 + 2 * tig;
          *reinterpret_cast<float2*>(out + idx) = make_float2(vre[j][0], vre[j][1]);
          *reinterpret_cast<float2*>(out + ngG + idx) = make_float2(vim[j][0], vim[j][1]);
        }
      }
      __syncthreads();
    }
  }
}

// persistent launch: as many blocks as fit on the card, at most one a group
template <class Kernel, class... Args>
int launch(Kernel kernel, size_t smem, long long ng, cudaStream_t stream, Args... args) {
  if (ng <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<(unsigned)(ng < fit ? ng : fit), THREADS, smem, stream>>>(args..., ng);
  return (int)cudaGetLastError();
}

template <int S>
int launch_patches_from_vals(const float* scal, const float* vals, const float* wcu, const float* wcv, float* out,
                             long long ng, cudaStream_t stream) {
  return launch(patches_from_vals_kernel<S>, b1_smem_floats<S>() * sizeof(float), ng, stream, scal, vals, wcu, wcv,
                out);
}

template <int S>
int launch_vals_from_patches(const float* patches, const float* scal, const float* wcu, const float* wcv, float* out,
                             long long ng, cudaStream_t stream) {
  return launch(vals_from_patches_kernel<S>, b2_smem_floats<S>() * sizeof(float), ng, stream, patches, scal, wcu, wcv,
                out);
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
