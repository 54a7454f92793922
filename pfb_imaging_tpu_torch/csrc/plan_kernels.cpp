// Host-side visibility-stream planning kernels (C++/OpenMP).
//
// The reference's runtime substrate does this class of work in numba/C++
// (uv binning in utils/weighting.py, chunk mapping in utils/misc.py). Here
// the device compute path is XLA, and the native runtime owns the
// *planning* hot path: converting (uvw, freq) streams to oversampled grid
// coordinates and bucketing them by w-plane so the device program sees
// contiguous, statically sized slices (ops/gridder.py plan_wgridder).
//
// The bucketing is a stable counting sort over plane indices — O(n) vs the
// numpy argsort's O(n log n) — and the coordinate conversion is a fused,
// OpenMP-parallel pass instead of four numpy temporaries.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Fused uvw -> (u_pix, v_pix, w_lam) conversion.
//   u_pix = su * u * (freq/c) * cellx * nbig_x   (likewise v)
//   w_lam = sw * w * (freq/c)
// Layout: outputs are flattened (row, chan).
void uvw_to_pix(const double* uvw, const double* freq, int64_t nrow, int64_t nchan,
                double su, double sv, double sw,
                double scale_u, double scale_v, double inv_c,
                double l_shift, double m_shift,
                double* u_pix, double* v_pix, double* w_lam,
                double* shift_re, double* shift_im) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < nrow; ++r) {
    const double u = uvw[3 * r + 0];
    const double v = uvw[3 * r + 1];
    const double w = uvw[3 * r + 2];
    for (int64_t c = 0; c < nchan; ++c) {
      const double nf = freq[c] * inv_c;
      const int64_t k = r * nchan + c;
      const double ul = su * u * nf;
      const double vl = sv * v * nf;
      u_pix[k] = ul * scale_u;
      v_pix[k] = vl * scale_v;
      w_lam[k] = sw * w * nf;
      // phase-centre shift e^{-2 pi i (u' * lshift + v' * mshift)}
      const double ph = -2.0 * M_PI * (ul * l_shift + vl * m_shift);
      shift_re[k] = std::cos(ph);
      shift_im[k] = std::sin(ph);
    }
  }
}

// Stable counting sort of visibilities by base w-plane index i0 (values in
// [0, n_i0)), plus per-plane bucket ranges for kernel support w_supp:
// plane p covers sorted entries with i0 in [p - w_supp + 1, p].
// perm: output permutation (sorted order -> original index).
// starts/counts: (nw,) bucket ranges over the sorted stream.
void wplane_buckets(const int64_t* i0, int64_t n, int64_t n_i0, int64_t nw, int64_t w_supp,
                    int64_t* perm, int64_t* starts, int64_t* counts) {
  std::vector<int64_t> hist(n_i0 + 1, 0);
  for (int64_t i = 0; i < n; ++i) hist[i0[i] + 1]++;
  for (int64_t b = 0; b < n_i0; ++b) hist[b + 1] += hist[b];
  // hist[b] now = start offset of plane-b entries in sorted order
  std::vector<int64_t> cursor(hist.begin(), hist.end() - 1);
  for (int64_t i = 0; i < n; ++i) perm[cursor[i0[i]]++] = i;  // stable
  for (int64_t p = 0; p < nw; ++p) {
    const int64_t lo = p - w_supp + 1 < 0 ? 0 : p - w_supp + 1;
    const int64_t hi = p + 1 < n_i0 ? p + 1 : n_i0;
    const int64_t s = hist[lo];
    const int64_t e = hi <= lo ? s : hist[hi];
    starts[p] = s;
    counts[p] = e - s;
  }
}

// Apply a permutation out[i] = in[perm[i]] (gather), double payload.
void apply_perm(const double* in, const int64_t* perm, int64_t n, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = in[perm[i]];
}

// ── IDG plan core (ops/gridder_idg.py plan_idg hot path) ────────────

// Per-visibility pass, fused from the (row, chan) product (so no 8M-entry
// u_l/v_l/w_l outer products or complex shift exps ever materialise in
// numpy): coordinate scaling, w-bin assignment, Taylor-fold of the bin
// residual dw into effective coordinates / chirps / phase, uv bucket key.
//   u_l = su*uvw[i,0]*invlam[c] ; u_pix = u_l*cux  (likewise v, w)
//   u_eff = u_pix - dw*blsu ; um = mod(u_eff, nbig) ; bu = um/half
//   key = (bin*nbu + bu)*nbv + bv
//   du = um - (bu*half - k0_off)  (patch-local offset, likewise dv)
//   phase = e^{i 2 pi (dw alpha - u_l*(-l0) - v_l*m0)}  (ONE sincos)
void idg_coords(const double* uvw, const double* invlam, int64_t nrow, int64_t nchan,
                double su, double sv, double sw, double cux, double cvy,
                double l0, double m0,
                int64_t nbins, double wmin, double binw, double alpha,
                double blsu, double bmsv, double chiru, double chirv,
                int64_t nbig_x, int64_t nbig_y, int64_t half,
                int64_t nbu, int64_t nbv, int64_t k0_off,
                int64_t* key, double* du, double* dv, double* phiu, double* phiv,
                double* ph_re, double* ph_im) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < nrow; ++r) {
    const double u3 = su * uvw[r * 3], v3 = sv * uvw[r * 3 + 1], w3 = sw * uvw[r * 3 + 2];
    for (int64_t c = 0; c < nchan; ++c) {
      const int64_t i = r * nchan + c;
      const double il = invlam[c];
      const double u_l = u3 * il, v_l = v3 * il, w_lam = w3 * il;
      int64_t b = 0;
      double dw = 0.0;
      if (nbins > 1 || binw > 0.0) {
        b = binw > 0.0 ? (int64_t)std::floor((w_lam - wmin) / binw) : 0;
        if (b < 0) b = 0;
        if (b >= nbins) b = nbins - 1;
        dw = w_lam - (wmin + ((double)b + 0.5) * binw);
      }
      const double ue = u_l * cux - dw * blsu;
      const double ve = v_l * cvy - dw * bmsv;
      double um = std::fmod(ue, (double)nbig_x);
      if (um < 0) um += (double)nbig_x;
      double vm = std::fmod(ve, (double)nbig_y);
      if (vm < 0) vm += (double)nbig_y;
      int64_t bu = (int64_t)(um / (double)half);
      if (bu > nbu - 1) bu = nbu - 1;
      int64_t bv = (int64_t)(vm / (double)half);
      if (bv > nbv - 1) bv = nbv - 1;
      key[i] = (b * nbu + bu) * nbv + bv;
      du[i] = um - (double)(bu * half - k0_off);
      dv[i] = vm - (double)(bv * half - k0_off);
      phiu[i] = chiru * dw;
      phiv[i] = chirv * dw;
      // forward phase: shift term e^{-2 pi i (u_l*(-l0) + v_l*m0)} folded
      // with the bin-residual constant e^{+2 pi i dw alpha}
      const double ph = 2.0 * M_PI * (dw * alpha - (u_l * (-l0) + v_l * m0));
      if (ph != 0.0) {
        ph_re[i] = std::cos(ph);
        ph_im[i] = std::sin(ph);
      } else {
        ph_re[i] = 1.0;
        ph_im[i] = 0.0;
      }
    }
  }
}

// Counting sort by key (key in [0, nkeys)) + compacted occupied-bucket
// tables. Returns noccup via out param. uniq/starts/counts are
// caller-allocated with capacity n.
void key_sort_counts(const int64_t* key, int64_t n, int64_t nkeys,
                     int64_t* order, int64_t* uniq, int64_t* starts,
                     int64_t* counts, int64_t* noccup_out) {
  std::vector<int64_t> hist(nkeys + 1, 0);
  for (int64_t i = 0; i < n; ++i) hist[key[i] + 1]++;
  for (int64_t b = 0; b < nkeys; ++b) hist[b + 1] += hist[b];
  std::vector<int64_t> cursor(hist.begin(), hist.end() - 1);
  for (int64_t i = 0; i < n; ++i) order[cursor[key[i]]++] = i;  // stable
  int64_t m = 0;
  for (int64_t b = 0; b < nkeys; ++b) {
    const int64_t c = hist[b + 1] - hist[b];
    if (c > 0) {
      uniq[m] = b;
      starts[m] = hist[b];
      counts[m] = c;
      ++m;
    }
  }
  *noccup_out = m;
}

// Group-layout fill: for occupied bucket r (contiguous sorted range
// [starts[r], starts[r]+counts[r])), its visibilities land in groups
// gbase[r] + pos/G at slot pos%G. Fills the combined gather index and the
// per-slot payload arrays in one parallel pass.
void fill_groups(const int64_t* order, const int64_t* starts, const int64_t* counts,
                 const int64_t* gbase, int64_t noccup, int64_t G,
                 const double* du, const double* dv, const double* phiu, const double* phiv,
                 const double* ph_re, const double* ph_im,
                 int64_t* cg_idx, double* du_g, double* dv_g, double* phiu_g, double* phiv_g,
                 double* phre_g, double* phim_g, int64_t* inv_orig) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t r = 0; r < noccup; ++r) {
    const int64_t s = starts[r], c = counts[r], gb = gbase[r];
    for (int64_t t = 0; t < c; ++t) {
      const int64_t orig = order[s + t];
      const int64_t slot = (gb + t / G) * G + (t % G);
      cg_idx[slot] = orig;
      du_g[slot] = du[orig];
      dv_g[slot] = dv[orig];
      phiu_g[slot] = phiu[orig];
      phiv_g[slot] = phiv[orig];
      phre_g[slot] = ph_re[orig];
      phim_g[slot] = ph_im[orig];
      inv_orig[orig] = slot;
    }
  }
}

// ── uv-counts / Briggs weighting host kernels (ops/weighting.py) ────
//
// The XLA scatter-add form of compute_counts serialises on TPU (~us per
// scalar update — 92 s for a 4M-vis pass at 8192^2, BENCH_r03
// major8k16.briggs_sec); the host histogram is O(nvis) adds.

// NN-binned weight histogram with the Hermitian v<0 fold
// (reference utils/weighting.py:82-140). out: (ncorr, nx, ny), f64,
// caller-zeroed. mask: (nrow, nchan); wgt: (ncorr, nrow, nchan).
void counts_nn(const double* uvw, const double* freq, const double* mask,
               const double* wgt, int64_t ncorr, int64_t nrow, int64_t nchan,
               int64_t nx, int64_t ny, double cellx, double celly,
               double usign, double vsign, double inv_c, double* out) {
  const double u_cell = 1.0 / ((double)nx * cellx);
  const double umax = std::fabs(1.0 / cellx / 2.0);
  const double v_cell = 1.0 / ((double)ny * celly);
  const double vmax = std::fabs(1.0 / celly / 2.0);
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < nrow; ++r) {
    for (int64_t c = 0; c < nchan; ++c) {
      if (mask[r * nchan + c] == 0.0) continue;
      const double nf = freq[c] * inv_c;
      double ut = uvw[3 * r] * nf * usign;
      double vt = uvw[3 * r + 1] * nf * vsign;
      if (vt < 0) { ut = -ut; vt = -vt; }
      const int64_t iu = (int64_t)std::floor((ut + umax) / u_cell);
      const int64_t iv = (int64_t)std::floor((vt + vmax) / v_cell);
      if (iu < 0 || iu >= nx || iv < 0 || iv >= ny) continue;
      for (int64_t k = 0; k < ncorr; ++k) {
        double* p = out + (k * nx + iu) * ny + iv;
#pragma omp atomic
        *p += wgt[(k * nrow + r) * nchan + c];
      }
    }
  }
}

// Per-sample weight division by the (Briggs-adjusted) counts grid
// (reference counts_to_weights tail, weighting.py:184-208). counts is
// the ALREADY-adjusted grid (counts*ssq + 1 applied caller-side);
// wgt (ncorr, nrow, nchan) updated in place.
void weights_from_counts(const double* counts, const double* uvw, const double* freq,
                         const double* mask, int64_t ncorr, int64_t nrow, int64_t nchan,
                         int64_t nx, int64_t ny, double cellx, double celly,
                         double usign, double vsign, double inv_c, double* wgt) {
  const double u_cell = 1.0 / ((double)nx * cellx);
  const double umax = std::fabs(1.0 / cellx / 2.0);
  const double v_cell = 1.0 / ((double)ny * celly);
  const double vmax = std::fabs(1.0 / celly / 2.0);
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < nrow; ++r) {
    for (int64_t c = 0; c < nchan; ++c) {
      if (mask[r * nchan + c] == 0.0) continue;
      const double nf = freq[c] * inv_c;
      double ut = uvw[3 * r] * nf * usign;
      double vt = uvw[3 * r + 1] * nf * vsign;
      if (vt < 0) { ut = -ut; vt = -vt; }
      int64_t iu = (int64_t)std::floor((ut + umax) / u_cell);
      int64_t iv = (int64_t)std::floor((vt + vmax) / v_cell);
      if (iu < 0 || iu >= nx || iv < 0 || iv >= ny) continue;
      for (int64_t k = 0; k < ncorr; ++k) {
        const double cval = counts[(k * nx + iu) * ny + iv];
        if (cval > 0) wgt[(k * nrow + r) * nchan + c] /= cval;
      }
    }
  }
}

}  // extern "C"
