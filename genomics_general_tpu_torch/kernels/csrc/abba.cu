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
// CLASSIC_CHANNELS / FULL_CHANNELS after "good" and "used": written to
// t[0 .. K - 3] (add == 0) or added to what is there (add != 0), each as
// soon as it is computed.
template <int K>
__device__ __forceinline__ void allele_terms(double p1, double p2, double p3,
                                             double p4, double* t, int add) {
  auto put = [&](int k, double v) { t[k] = add ? t[k] + v : v; };
  const double q1 = 1 - p1, q2 = 1 - p2, q3 = 1 - p3, q4 = 1 - p4;
  const double abba = q1 * p2 * p3 * q4;
  const double baba = p1 * q2 * p3 * q4;
  put(0, abba - baba);                                       // num_f4
  put(1, abba + baba);                                       // den_D
  const double pd = p2 * b2d(p2 > p3) + p3 * b2d(p3 >= p2);
  put(2, f4(p1, pd, pd, p4));                                // den_fd
  const bool a = p3 > p1, b = p3 > p2, x = p1 > p2, y = !x;
  const double pdm1 = p3 * b2d(x && a) + p1 * b2d(!(x && a));
  const double pdm2 = p3 * b2d(y && b) + p2 * b2d(!(y && b));
  const double pdm3 = -p3 * b2d(x && a) + p3 * b2d(y && b) -
                      p1 * b2d(x && !a) + p2 * b2d(y && !b);
  put(3, f4(pdm1, pdm2, pdm3, p4));                          // den_fdm
  put(4, abba);                                              // ABBA
  put(5, baba);                                              // BABA
  if constexpr (K == kFull) {
    put(6, f4c(p1, p2, p3, p4));                             // num_f4c
    put(7, f4(p1, p3, p3, p4));                              // den_fhom_old
    put(8, f4c(p1, p3, p3, p4));                             // den_fhom_new
    put(9, f4c(p1, pd, pd, p4));                             // den_fd_new
    put(10, f4c(pdm1, pdm2, pdm3, p4));                      // den_fdm_new
    const double t11 = f4c(p1, p3, p3, p4);
    const double t12 = f4c(p4, p2, p3, p4);
    const double t21 = f4c(p3, p2, p3, p4);
    const double t22 = f4c(p1, p4, p3, p4);
    const double fdh = max_np(max_np(t11, t12), max_np(t21, t22));
    put(11, fdh);                                            // den_fdh
    const double t31 = f4c(p1, p2, p2, p4);
    const double t32 = f4c(p1, p2, p3, p1);
    const double t41 = f4c(p1, p2, p1, p4);
    const double t42 = f4c(p1, p2, p3, p2);
    put(12, max_np(fdh, max_np(max_np(t31, t32),
                               max_np(t41, t42))));          // den_fdh2
    const double d1 = fabs(p1 - p2);
    const double d2 = fabs(p3 - p4);
    const double dh = d1 * b2d(d1 > d2) + d2 * b2d(d2 >= d1);
    put(13, dh * dh);                                        // den_fh
    put(14, q1 * p2 * q3 * q4);                              // ABAA
    put(15, p1 * q2 * q3 * q4);                              // BAAA
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
// few dozen f64 operations on the gated sites.  Design: a block per tile
// of kTile consecutive sites, a thread a site.
//   * The tile's counts are one contiguous run: staged in shared memory
//     with 16-byte loads, then each thread sums its site's 5 x 4
//     population counts from there, in integers.
//   * The gate (biallelic across the union, nonmissing / n_pop >= min_data
//     for P1..O) takes one f64 division a population; the selection runs
//     on the integer counts (f == 0 is c == 0 with n > 0, f == 1 is c == n,
//     and union frequencies share their denominator, so they order as
//     their counts), which leaves at most two selected alleles a site:
//     slot 0 and slot 1, in ascending allele order.
//   * The f64 terms run in at most two passes a warp, each uniform: slot 0
//     on every lane with an allele, slot 1 where a site has two.  A pass
//     divides its four frequencies and adds each term to the site's row in
//     shared memory (slot 0's terms, plus slot 1's: numpy's order of the
//     (site, allele) pairs).  Lanes that fail the gate do no f64 work.
//   * Every row of the tile (zeros for a failed site) is written to shared
//     memory at a stride of K + 1 doubles (no bank conflicts), then the
//     block stores the tile's contiguous kTile * K doubles with 16-byte
//     streaming stores (each row is written once; K8's read of them right
//     after is no slower for it).
// A site that fails the gate writes zeros.
constexpr int kTile = 128;
// the largest staged counts tile; more classes are read from device memory
constexpr int kStageBytes = 48 * 1024;

// count c of allele a (0..3) of a population, picked without an indexed
// array (which would sit in local memory)
__device__ __forceinline__ int pick(const int (&c)[4], int a) {
  return a == 0 ? c[0] : a == 1 ? c[1] : a == 2 ? c[2] : c[3];
}

// blocks an SM: 8 (64 registers) for the classic panel, 5 (96) for the
// full one, neither spilling
template <typename T, int K>
__global__ void __launch_bounds__(kTile, K == kClassic ? 8 : 5)
abba_site_terms_kernel(const T* __restrict__ counts, int S, int C,
                       int staged, const int32_t* __restrict__ codes,
                       const int8_t* __restrict__ lut, double n0, double n1,
                       double n2, double n3, double min_data, int mode,
                       double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kTile;
  const int ns = min(kTile, S - s0);
  const int row_elems = 4 * C;
  const T* src = counts + (size_t)s0 * row_elems;
  const T* row = src + (size_t)tid * row_elems;
  if (staged) {
    T* sc = reinterpret_cast<T*>(smem);
    const int n_elems = ns * row_elems;
    int done = 0;
    if (((uintptr_t)src & 15) == 0) {
      const int nvec = (int)((size_t)n_elems * sizeof(T) / 16);
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(sc);
      for (int i = tid; i < nvec; i += kTile) d4[i] = __ldg(s4 + i);
      done = nvec * (int)(16 / sizeof(T));
    }
    for (int i = done + tid; i < n_elems; i += kTile) sc[i] = src[i];
    __syncthreads();
    row = sc + tid * row_elems;
  }
  int c[5][4];
#pragma unroll
  for (int p = 0; p < 5; ++p)
#pragma unroll
    for (int a = 0; a < 4; ++a) c[p][a] = 0;
  if (tid < ns) {
    for (int k = 0; k < C; ++k) {
      const int code = __ldg(codes + k);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int v = (int)row[4 * k + a];
#pragma unroll
        for (int p = 0; p < 5; ++p) c[p][a] += ((code >> p) & 1) * v;
      }
    }
  }
  if (staged) __syncthreads();     // the counts are read: rows take the bytes
  int nm[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) nm[p] = c[p][0] + c[p][1] + c[p][2] + c[p][3];
  const int present =
      (c[4][0] > 0) + (c[4][1] > 0) + (c[4][2] > 0) + (c[4][3] > 0);
  const double npop[4] = {n0, n1, n2, n3};
  bool good = tid < ns && present == 2;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    good = good && ((double)nm[p] / npop[p] >= min_data);

  int sel = 0;                     // bit a: allele a selected
  if (good) {
    if (mode == kMinor) {
      // np.argsort(union_freqs)[2] with numpy's tie order: the base-3 code
      // of the 6 pairwise comparisons (<, ==, >) indexes the LUT
      const int pi[6] = {0, 0, 0, 1, 1, 2};
      const int pj[6] = {1, 2, 3, 2, 3, 3};
      int key = 0, p3k = 1;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int u = c[4][pi[k]], v = c[4][pj[k]];
        key += (u < v ? 0 : (u == v ? 1 : 2)) * p3k;
        p3k *= 3;
      }
      sel = 1 << __ldg(lut + key);
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        bool on = c[4][a] > 0 && c[3][a] == 0 && nm[3] > 0;
        if (mode == kFixed) {
#pragma unroll
          for (int p = 0; p < 3; ++p)
            on = on && nm[p] > 0 && (c[p][a] == 0 || c[p][a] == nm[p]);
        }
        sel |= (int)on << a;
      }
    }
  }
  const int used = __popc(sel);
  const int a0 = __ffs(sel) - 1;
  const int a1 = __ffs(sel & (sel - 1)) - 1;

  double* o = reinterpret_cast<double*>(smem) + tid * (K + 1);
  if (tid < ns) {
    o[0] = b2d(good);              // good: 0.25 x 4 in the JAX form
    o[1] = (double)used;           // used: (site, allele) pairs
    if (used == 0) {
#pragma unroll
      for (int k = 2; k < K; ++k) o[k] = 0.0;
    }
  }
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    if (j < used) {
      const int a = j ? a1 : a0;
      allele_terms<K>((double)pick(c[0], a) / (double)nm[0],
                      (double)pick(c[1], a) / (double)nm[1],
                      (double)pick(c[2], a) / (double)nm[2],
                      (double)pick(c[3], a) / (double)nm[3], o + 2, j);
    }
  }
  __syncthreads();
  // the tile's ns rows are out[s0 .. s0 + ns): K (even) doubles a row, so a
  // 16-byte unit never straddles two rows
  const double* rows = reinterpret_cast<const double*>(smem);
  double2* dst = reinterpret_cast<double2*>(out + (size_t)s0 * K);
  for (int u = tid; u < ns * K / 2; u += kTile) {
    const int r = 2 * u / K, k = 2 * u - r * K;
    const double* from = rows + r * (K + 1) + k;
    __stcs(dst + u, make_double2(from[0], from[1]));
  }
}

// ---------------------------------------------------------------- K8
// abba_window_sums — replaces the window gather-sum of
// genomics_general_tpu/kernels/abba.py fused_abba_flush (its lax.map over
// window chunks):
//   out[w, k] = sum of terms[s, k] for s in first[w] .. first[w] + n[w] - 1.
// Windows may overlap (-s < -w), so each window reduces its own range; a
// range reaching outside [0, S) is clipped.
//
// Bound: bytes — each window's rows of terms read, K doubles written.
// Design: a window's n rows are one contiguous run of n K doubles, read as
// 16-byte column pairs, kPairs = K / 2 a row:
//   * a window takes `warps` warps (1, 2, 4 or 8; abba._K8_WARPS), each on
//     a consecutive segment of its rows, and a block of kSumWarps warps
//     holds kSumWarps / warps windows;
//   * a warp step reads kLanes consecutive pairs, kRows whole rows (32
//     pairs, 8 rows at K = 8; 27 pairs, 3 rows at K = 18), so lane l
//     always holds column pair l % kPairs; it adds its rows in order, each
//     kSumAhead loads issued before their adds;
//   * the lanes of one column pair then add in lane order (shuffles), and
//     the window's warps in warp order (K doubles a warp in shared memory).
// The order depends only on the window and `warps`, so a window's sums are
// the same bits from run to run, and whether it is launched alone or in a
// batch.  A terms tensor that starts 8 bytes past a 16-byte boundary (its
// rows too, as K is even) is read from each window's second double: pair
// q then holds columns 2q + 1 and 2q + 2 (mod K: the next row's column 0),
// and the window's first and last doubles are added on their own after
// the warps.
constexpr int kSumWarps = 8;
constexpr int kSumAhead = 8;

template <int K>
__global__ void __launch_bounds__(kSumWarps * 32)
abba_window_sums_kernel(const double* __restrict__ terms, int S,
                        const int32_t* __restrict__ first,
                        const int32_t* __restrict__ n_sites, int W,
                        int warps, double* __restrict__ out) {
  constexpr int kPairs = K / 2;
  constexpr int kRows = 32 / kPairs;
  constexpr int kLanes = kRows * kPairs;
  __shared__ double part[kSumWarps][K];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_block = kSumWarps / warps;
  const int g = warp % warps;
  // 1 when terms lies 8 bytes past a 16-byte boundary
  const int shift = (int)((reinterpret_cast<uintptr_t>(terms) >> 3) & 1);
  auto range = [&](int w, int& lo, int& n) {
    const long long f = first[w];
    lo = (int)(f > 0 ? f : 0);
    const long long hi = min(f + n_sites[w], (long long)S);
    n = hi > lo ? (int)(hi - lo) : 0;
  };
  int lo = 0, n = 0;
  const int w = blockIdx.x * per_block + warp / warps;
  if (w < W) range(w, lo, n);
  const int q = lane % kPairs;
  double2 acc = make_double2(0.0, 0.0);
  if (lane < kLanes && n > 0) {
    const int steps = (n + kRows - 1) / kRows;
    const int per = (steps + warps - 1) / warps;
    const int s1 = min(steps, (g + 1) * per);
    // row r's pair q; with the shift, the last row's pair kPairs - 1 would
    // take the column 0 of the row after the window
    const double2* pair = reinterpret_cast<const double2*>(
        terms + (size_t)lo * K + shift) + q;
    const int rows = shift && q == kPairs - 1 ? n - 1 : n;
    for (int s = g * per; s < s1; s += kSumAhead) {
      double2 v[kSumAhead];
      bool ok[kSumAhead];
#pragma unroll
      for (int u = 0; u < kSumAhead; ++u) {
        const int r = (s + u) * kRows + lane / kPairs;
        ok[u] = s + u < s1 && r < rows;
        if (ok[u]) v[u] = __ldg(pair + (size_t)r * kPairs);
      }
#pragma unroll
      for (int u = 0; u < kSumAhead; ++u) {
        if (ok[u]) {
          acc.x += v[u].x;
          acc.y += v[u].y;
        }
      }
    }
  }
  // lane q (< kPairs) adds lanes q + kPairs, q + 2 kPairs, .. in order
  double2 sum = acc;
#pragma unroll
  for (int j = 1; j < kRows; ++j) {
    sum.x += __shfl_down_sync(0xffffffffu, acc.x, j * kPairs);
    sum.y += __shfl_down_sync(0xffffffffu, acc.y, j * kPairs);
  }
  if (lane < kPairs) {
    const int c0 = 2 * lane + shift;
    part[warp][c0] = sum.x;
    part[warp][c0 + 1 == K ? 0 : c0 + 1] = sum.y;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < per_block * K; t += blockDim.x) {
    const int j = t / K;
    const int k = t - j * K;
    const int wj = blockIdx.x * per_block + j;
    if (wj >= W) continue;
    double s = part[j * warps][k];
    for (int x = 1; x < warps; ++x) s += part[j * warps + x][k];
    if (shift) {
      int lj, nj;
      range(wj, lj, nj);
      if (nj > 0 && k == 0) s += terms[(size_t)lj * K];
      if (nj > 0 && k == K - 1) s += terms[(size_t)(lj + nj) * K - 1];
    }
    out[(size_t)wj * K + k] = s;
  }
}

template <typename T>
void launch_site_terms(const void* counts, int S, int C, const void* codes,
                       const void* lut, const double* npop, double min_data,
                       int mode, int full, void* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((S + kTile - 1) / kTile);
  const size_t stage = (size_t)kTile * 4 * C * sizeof(T);
  const int staged = stage <= (size_t)kStageBytes;
  const size_t rows = (size_t)kTile * ((full ? kFull : kClassic) + 1) * 8;
  const size_t smem = staged && stage > rows ? stage : rows;
  if (full) {
    abba_site_terms_kernel<T, kFull><<<blocks, kTile, smem, stream>>>(
        (const T*)counts, S, C, staged, (const int32_t*)codes,
        (const int8_t*)lut, npop[0], npop[1], npop[2], npop[3], min_data,
        mode, (double*)out);
  } else {
    abba_site_terms_kernel<T, kClassic><<<blocks, kTile, smem, stream>>>(
        (const T*)counts, S, C, staged, (const int32_t*)codes,
        (const int8_t*)lut, npop[0], npop[1], npop[2], npop[3], min_data,
        mode, (double*)out);
  }
}

}  // namespace

extern "C" {

// counts: [S, C, 4], uint16 when u16 != 0, else int32; codes: int32 [C];
// lut: int8 [729]; mode: 0 polarize, 1 fixed, 2 minor; out: float64 [S, K]
// with K = 18 when full != 0, else 8, 16-byte aligned.
int ggt_abba_site_terms(const void* counts, int u16, int S, int C,
                        const void* codes, const void* lut, double n0,
                        double n1, double n2, double n3, double min_data,
                        int mode, int full, void* out, void* stream) {
  if ((uintptr_t)out & 15) return (int)cudaErrorInvalidValue;
  const double npop[4] = {n0, n1, n2, n3};
  if (u16)
    launch_site_terms<uint16_t>(counts, S, C, codes, lut, npop, min_data,
                                mode, full, out, (cudaStream_t)stream);
  else
    launch_site_terms<int32_t>(counts, S, C, codes, lut, npop, min_data,
                               mode, full, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// terms: float64 [S, K] (K = 8 or 18), 8-byte aligned; first, n_sites:
// int32 [W]; warps: warps a window (1, 2, 4 or 8); out: float64 [W, K].
int ggt_abba_window_sums(const void* terms, int S, int K, const void* first,
                         const void* n_sites, int W, int warps, void* out,
                         void* stream) {
  if (((uintptr_t)terms & 7) ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8))
    return (int)cudaErrorInvalidValue;
  const int per_block = kSumWarps / warps;
  const unsigned blocks = (unsigned)((W + per_block - 1) / per_block);
  if (K == kFull)
    abba_window_sums_kernel<kFull>
        <<<blocks, kSumWarps * 32, 0, (cudaStream_t)stream>>>(
            (const double*)terms, S, (const int32_t*)first,
            (const int32_t*)n_sites, W, warps, (double*)out);
  else if (K == kClassic)
    abba_window_sums_kernel<kClassic>
        <<<blocks, kSumWarps * 32, 0, (cudaStream_t)stream>>>(
            (const double*)terms, S, (const int32_t*)first,
            (const int32_t*)n_sites, W, warps, (double*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
