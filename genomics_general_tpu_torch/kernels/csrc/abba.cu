// ABBA-BABA / f4-family site terms and window sums for Hopper (sm_90a): the
// device half of ABBABABAwindows and fourPopWindows.
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/abba.py).  Each launch goes on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
//
// Exactness: this file is built with --fmad=false (kernels/_build.py), so no
// a*b+c is contracted into one fused multiply-add.  Every product, sum,
// difference and quotient below is then one IEEE double operation rounded to
// nearest, evaluated in the expression order of the JAX/numpy formulas
// (genomics_general_tpu/kernels/abba.py _site_terms and
// host_window_abba_sums), so a site's terms equal numpy's bit for bit,
// NaN positions included:
//   * a boolean factor is a multiply by 1.0 or 0.0, never a select, so
//     NaN * 0 stays NaN as in numpy;
//   * np.maximum propagates NaN, and so does max_np below (fmax does not);
//   * comparisons with NaN are false, as in numpy;
//   * x ** 2 is x * x (numpy squares an array that way).
// Only the window sums (K8) add in another order than numpy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kClassic = 8;    // good, used + 6 terms (CLASSIC_CHANNELS)
constexpr int kFull = 18;      // good, used + 16 terms (FULL_CHANNELS)
enum Mode { kPolarize = 0, kFixed = 1, kMinor = 2 };

__device__ __forceinline__ double b2d(bool x) { return x ? 1.0 : 0.0; }

__device__ __forceinline__ double max_np(double a, double b) {
  return (a >= b || a != a) ? a : b;
}

__device__ __forceinline__ double f4(double p1, double p2, double p3,
                                     double p4) {
  return (1 - p1) * p2 * p3 * (1 - p4) - p1 * (1 - p2) * p3 * (1 - p4);
}

__device__ __forceinline__ double f4c(double p1, double p2, double p3,
                                      double p4) {
  return f4(p1, p2, p3, p4) + f4(1 - p1, 1 - p2, 1 - p3, 1 - p4);
}

// The K - 2 term channels of one (site, allele) pair, in the order of
// CLASSIC_CHANNELS / FULL_CHANNELS after "good" and "used".
template <int K>
__device__ __forceinline__ void allele_terms(double p1, double p2, double p3,
                                             double p4, double* t) {
  const double q1 = 1 - p1, q2 = 1 - p2, q3 = 1 - p3, q4 = 1 - p4;
  const double abba = q1 * p2 * p3 * q4;
  const double baba = p1 * q2 * p3 * q4;
  t[0] = abba - baba;                                       // num_f4
  t[1] = abba + baba;                                       // den_D
  const double pd = p2 * b2d(p2 > p3) + p3 * b2d(p3 >= p2);
  t[2] = f4(p1, pd, pd, p4);                                // den_fd
  const bool a = p3 > p1, b = p3 > p2, x = p1 > p2, y = !x;
  const double pdm1 = p3 * b2d(x && a) + p1 * b2d(!(x && a));
  const double pdm2 = p3 * b2d(y && b) + p2 * b2d(!(y && b));
  const double pdm3 = -p3 * b2d(x && a) + p3 * b2d(y && b) -
                      p1 * b2d(x && !a) + p2 * b2d(y && !b);
  t[3] = f4(pdm1, pdm2, pdm3, p4);                          // den_fdm
  t[4] = abba;                                              // ABBA
  t[5] = baba;                                              // BABA
  if constexpr (K == kFull) {
    t[6] = f4c(p1, p2, p3, p4);                             // num_f4c
    t[7] = f4(p1, p3, p3, p4);                              // den_fhom_old
    t[8] = f4c(p1, p3, p3, p4);                             // den_fhom_new
    t[9] = f4c(p1, pd, pd, p4);                             // den_fd_new
    t[10] = f4c(pdm1, pdm2, pdm3, p4);                      // den_fdm_new
    const double t11 = f4c(p1, p3, p3, p4);
    const double t12 = f4c(p4, p2, p3, p4);
    const double t21 = f4c(p3, p2, p3, p4);
    const double t22 = f4c(p1, p4, p3, p4);
    const double fdh = max_np(max_np(t11, t12), max_np(t21, t22));
    t[11] = fdh;                                            // den_fdh
    const double t31 = f4c(p1, p2, p2, p4);
    const double t32 = f4c(p1, p2, p3, p1);
    const double t41 = f4c(p1, p2, p1, p4);
    const double t42 = f4c(p1, p2, p3, p2);
    t[12] = max_np(fdh, max_np(max_np(t31, t32),
                               max_np(t41, t42)));          // den_fdh2
    const double d1 = fabs(p1 - p2);
    const double d2 = fabs(p3 - p4);
    const double dh = d1 * b2d(d1 > d2) + d2 * b2d(d2 >= d1);
    t[13] = dh * dh;                                        // den_fh
    t[14] = q1 * p2 * q3 * q4;                              // ABAA
    t[15] = p1 * q2 * q3 * q4;                              // BAAA
  }
}

// ---------------------------------------------------------------- K7
// abba_site_terms — replaces genomics_general_tpu/kernels/abba.py
// _np_minor_allele + _site_terms and the freqs step of fused_abba_flush:
//   out[s, :] = the K channels of site s, summed over its selected alleles.
// counts [S, C, 4] are the per-site counts of C membership classes (K6 on
// the class partition of the overlapping P1, P2, P3, O, union mask);
// codes[k] has bit p set when class k lies in population p (p = 4: union).
//
// Bound: bytes — C*4 counts read and K doubles written per site against a
// few dozen f64 operations on the gated sites.  Design: one thread per
// site; the 5 x 4 population counts are exact integer sums of the classes
// in registers; the gate (biallelic across the union, nonmissing / n_pop
// >= min_data for P1..O) runs on integers and one division each; the terms
// of the selected alleles (at most 2 after the gate) are added in allele
// order, which is numpy's order of the (site, allele) pairs.  A site that
// fails the gate writes zeros.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
abba_site_terms_kernel(const T* __restrict__ counts, int S, int C,
                       const int32_t* __restrict__ codes,
                       const int8_t* __restrict__ lut, double n0, double n1,
                       double n2, double n3, double min_data, int mode,
                       double* __restrict__ out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  int c[5][4];
#pragma unroll
  for (int p = 0; p < 5; ++p)
#pragma unroll
    for (int a = 0; a < 4; ++a) c[p][a] = 0;
  const T* row = counts + (size_t)s * C * 4;
  for (int k = 0; k < C; ++k) {
    const int code = __ldg(codes + k);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int v = (int)row[4 * k + a];
#pragma unroll
      for (int p = 0; p < 5; ++p) c[p][a] += ((code >> p) & 1) * v;
    }
  }
  int nm[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) nm[p] = c[p][0] + c[p][1] + c[p][2] + c[p][3];
  const int present =
      (c[4][0] > 0) + (c[4][1] > 0) + (c[4][2] > 0) + (c[4][3] > 0);
  const double npop[4] = {n0, n1, n2, n3};
  bool good = present == 2;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    good = good && ((double)nm[p] / npop[p] >= min_data);

  double* o = out + (size_t)s * K;
  if (!good) {
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = 0.0;
    return;
  }
  double f[5][4];
#pragma unroll
  for (int p = 0; p < 5; ++p)
#pragma unroll
    for (int a = 0; a < 4; ++a) f[p][a] = (double)c[p][a] / (double)nm[p];

  bool sel[4];
  if (mode == kMinor) {
    // np.argsort(union_freqs)[2] with numpy's tie order: the base-3 code of
    // the 6 pairwise comparisons (<, ==, >) indexes the LUT
    const int pi[6] = {0, 0, 0, 1, 1, 2};
    const int pj[6] = {1, 2, 3, 2, 3, 3};
    int key = 0, p3k = 1;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const double u = f[4][pi[k]], v = f[4][pj[k]];
      key += (u < v ? 0 : (u == v ? 1 : 2)) * p3k;
      p3k *= 3;
    }
    const int mi = __ldg(lut + key);
#pragma unroll
    for (int a = 0; a < 4; ++a) sel[a] = a == mi;
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      sel[a] = c[4][a] > 0 && f[3][a] == 0.0;
      if (mode == kFixed)
        sel[a] = sel[a] && (f[0][a] == 0.0 || f[0][a] == 1.0) &&
                 (f[1][a] == 0.0 || f[1][a] == 1.0) &&
                 (f[2][a] == 0.0 || f[2][a] == 1.0);
    }
  }

  double acc[K - 2];
#pragma unroll
  for (int k = 0; k < K - 2; ++k) acc[k] = 0.0;
  int used = 0;
#pragma unroll 1
  for (int a = 0; a < 4; ++a) {
    if (!sel[a]) continue;
    double t[K - 2];
    allele_terms<K>(f[0][a], f[1][a], f[2][a], f[3][a], t);
#pragma unroll
    for (int k = 0; k < K - 2; ++k) acc[k] = used ? acc[k] + t[k] : t[k];
    ++used;
  }
  o[0] = 1.0;                         // good: 0.25 x 4 in the JAX form
  o[1] = (double)used;                // used: (site, allele) pairs
#pragma unroll
  for (int k = 0; k < K - 2; ++k) o[2 + k] = acc[k];
}

// ---------------------------------------------------------------- K8
// abba_window_sums — replaces the window gather-sum of
// genomics_general_tpu/kernels/abba.py fused_abba_flush (its lax.map over
// window chunks):
//   out[w, k] = sum of terms[s, k] for s in first[w] .. first[w] + n[w] - 1.
// Windows may overlap (-s < -w), so each window reduces its own range.
//
// Bound: bytes — each window's rows of terms read, K doubles written.
// Design: one block per window; thread t adds rows first + t, first + t +
// 256, ... (a warp reads 32 consecutive rows, K doubles each) into K
// register sums; then a fixed shared-memory tree, so a window's sums are
// the same from run to run.  A range reaching outside [0, S) is clipped.
template <int K>
__global__ void __launch_bounds__(kThreads)
abba_window_sums_kernel(const double* __restrict__ terms, int S,
                        const int32_t* __restrict__ first,
                        const int32_t* __restrict__ n_sites,
                        double* __restrict__ out) {
  __shared__ double red[K][kThreads];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int f = max(first[w], 0);
  const int n = min(first[w] + n_sites[w], S) - f;
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    const double* row = terms + (size_t)(f + i) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += row[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) red[k][tid] = acc[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[k][tid] += red[k][tid + stride];
    }
    __syncthreads();
  }
  if (tid < K) out[(size_t)w * K + tid] = red[tid][0];
}

template <typename T>
void launch_site_terms(const void* counts, int S, int C, const void* codes,
                       const void* lut, const double* npop, double min_data,
                       int mode, int full, void* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((S + kThreads - 1) / kThreads);
  if (full) {
    abba_site_terms_kernel<T, kFull><<<blocks, kThreads, 0, stream>>>(
        (const T*)counts, S, C, (const int32_t*)codes, (const int8_t*)lut,
        npop[0], npop[1], npop[2], npop[3], min_data, mode, (double*)out);
  } else {
    abba_site_terms_kernel<T, kClassic><<<blocks, kThreads, 0, stream>>>(
        (const T*)counts, S, C, (const int32_t*)codes, (const int8_t*)lut,
        npop[0], npop[1], npop[2], npop[3], min_data, mode, (double*)out);
  }
}

}  // namespace

extern "C" {

// counts: [S, C, 4], uint16 when u16 != 0, else int32; codes: int32 [C];
// lut: int8 [729]; mode: 0 polarize, 1 fixed, 2 minor; out: float64 [S, K]
// with K = 18 when full != 0, else 8.
int ggt_abba_site_terms(const void* counts, int u16, int S, int C,
                        const void* codes, const void* lut, double n0,
                        double n1, double n2, double n3, double min_data,
                        int mode, int full, void* out, void* stream) {
  const double npop[4] = {n0, n1, n2, n3};
  if (u16)
    launch_site_terms<uint16_t>(counts, S, C, codes, lut, npop, min_data,
                                mode, full, out, (cudaStream_t)stream);
  else
    launch_site_terms<int32_t>(counts, S, C, codes, lut, npop, min_data,
                               mode, full, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// terms: float64 [S, K] (K = 8 or 18); first, n_sites: int32 [W];
// out: float64 [W, K].
int ggt_abba_window_sums(const void* terms, int S, int K, const void* first,
                         const void* n_sites, int W, void* out,
                         void* stream) {
  if (K == kFull)
    abba_window_sums_kernel<kFull><<<W, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)terms, S, (const int32_t*)first,
        (const int32_t*)n_sites, (double*)out);
  else if (K == kClassic)
    abba_window_sums_kernel<kClassic>
        <<<W, kThreads, 0, (cudaStream_t)stream>>>(
            (const double*)terms, S, (const int32_t*)first,
            (const int32_t*)n_sites, (double*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
