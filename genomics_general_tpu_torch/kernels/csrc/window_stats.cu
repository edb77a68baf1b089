// Epilogue of the fused window-statistics step for Hopper (sm_90a): float32
// pi / dxy / Fst per window from the pair counts, and the per-window,
// per-population allele counts.
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/window_stats.py).  Every launch goes on the caller's stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().
// Built with --fmad=false: every float32 product and sum is rounded on its
// own, as the plain PyTorch version rounds it, so the two agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPopThreads = 256;  // K11: 8 warps, one haplotype row each
constexpr int kRowWarps = 8;      // K10 rows pass: warps a block at most
constexpr int kRowsPerWarp = 2;   // K10 rows pass: rows a warp
constexpr int kMeanThreads = 256;  // K10 means pass: 8 warps a window
constexpr unsigned kFull = 0xffffffffu;

// The fixed-order warp sum: lane l has added its terms p = l, l + 32, ..
// in order; the lanes then add as a binary tree (lane l + stride into
// lane l, stride 16 .. 1; a butterfly leaves the same sum in every lane,
// as float addition is commutative).  window_stats._fixed_sum(x, 32)
// repeats this order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------- K10
// window_stats_tail — replaces the float32 epilogue of
// genomics_general_tpu/kernels/window_stats.py window_stats_step
// (_block_nanmean, the pi / dxy / pooled block means and Fst).  For window
// w, with dist = m / max(s, 1) and the pair (i, j) valid when i != j and
// s > 0, the mean of a block with row weights u and column weights v is
//   sum over valid pairs with u_i v_j > 0 of dist  /  sum of u_i v_j
// (0 / 0 = NaN, as in JAX).  dxy[a][b] takes u = pm[a], v = pm[b]; pi[a]
// = dxy[a][a]; pooled[a][b] takes u = v = clip(pm[a] + pm[b], 0, 1); and
//   Fst[a][b] = 1 - (w pi_a + (1 - w) pi_b) / pooled[a][b],
//   w = n_a / (n_a + n_b), n_a = sum of pm[a].
//
// Bound: bytes — each window's [h, h] counts read once.  Design: the mask's
// rows fall into membership classes (one per distinct column pm[:, i],
// rows in no population dropped; window_stats.TailClasses, built once per
// mask on the host), and every block mean is a fixed combination of
// class-pair sums: num(a, b) adds num(ci, cj) over the class pairs with
// u_a(ci) v_b(cj) > 0, den(a, b) adds u_a(ci) v_b(cj) cnt(ci, cj), cnt the
// valid pairs' count.  So each cell of m and s is read once, in two
// launches:
// - rows (tail_rows_kernel): a block per (window, band of 2 x warps rows
//   in class order), a warp a row: 16-byte loads of the row's m and s, the
//   row's dist written into a shared row at each column's place in class
//   order (NaN where the pair is not valid), then per column class a
//   fixed-order warp sum and count -> part[w][row][cj];
// - means (tail_means_kernel): a block per window sums part over each
//   class's rows into S[w][ci][cj] (a warp a class pair, fixed order),
//   then a warp per block mean adds its class pairs (fixed order over
//   ci C + cj), and Fst is formed per (a, b) once the means are written.
// Every float sum is a warp_sum over a fixed list, so a run repeats bit
// for bit and window_stats_tail_plain repeats it exactly.

// Row k of the class order (haplotype members[k]) of window w against
// every column: part_num / part_cnt [w][k][c] for each class c.
template <bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
tail_rows_kernel(const int32_t* __restrict__ m, const int32_t* __restrict__ s,
                 const int32_t* __restrict__ cls_i, int h, int C, int n_rows,
                 int bands, float* __restrict__ part_num,
                 int32_t* __restrict__ part_cnt) {
  extern __shared__ __align__(16) int32_t sm[];
  const int warps = blockDim.x / 32;
  const int32_t* members = cls_i;
  const int32_t* starts = members + n_rows;
  int* pos = sm;                                   // [h], 16-byte aligned
  int* start = pos + ((h + 3) & ~3);               // [C + 1]
  float* rowbuf = reinterpret_cast<float*>(start + C + 1) +
                  (threadIdx.x / 32) * n_rows;     // this warp's row
  const int wl = blockIdx.x / bands;
  const int band = blockIdx.x - wl * bands;
  for (int j = threadIdx.x; j < h; j += blockDim.x)
    pos[j] = cls_i[n_rows + C + 1 + j];
  for (int c = threadIdx.x; c <= C; c += blockDim.x) start[c] = starts[c];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float nan = __int_as_float(0x7fc00000);
  for (int z = 0; z < kRowsPerWarp; ++z) {
    const int k = (band * kRowsPerWarp + z) * warps + warp;
    if (k >= n_rows) break;
    const int i = members[k];
    const int32_t* mrow = m + ((size_t)wl * h + i) * h;
    const int32_t* srow = s + ((size_t)wl * h + i) * h;
    if (kVec) {
      // 4 columns a lane a load, 4 loads of m and s in flight
      for (int j0 = 4 * lane; j0 < h; j0 += 4 * 128) {
        int4 mv[4], sv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + 128 * c;
          if (j < h) {
            mv[c] = *reinterpret_cast<const int4*>(mrow + j);
            sv[c] = *reinterpret_cast<const int4*>(srow + j);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + 128 * c;
          if (j >= h) break;
          const int4 p4 = *reinterpret_cast<const int4*>(pos + j);
          const int pj[4] = {p4.x, p4.y, p4.z, p4.w};
          const int mj[4] = {mv[c].x, mv[c].y, mv[c].z, mv[c].w};
          const int sj[4] = {sv[c].x, sv[c].y, sv[c].z, sv[c].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (pj[e] >= 0)
              rowbuf[pj[e]] = (j + e != i && sj[e] > 0)
                  ? (float)mj[e] / (float)sj[e] : nan;
        }
      }
    } else {
      for (int j = lane; j < h; j += 32) {
        const int p = pos[j];
        if (p < 0) continue;
        const int sv = srow[j];
        rowbuf[p] = (j != i && sv > 0) ? (float)mrow[j] / (float)sv : nan;
      }
    }
    __syncwarp();
    const size_t out = ((size_t)wl * n_rows + k) * C;
    for (int c = 0; c < C; ++c) {
      float acc = 0.0f;
      int cnt = 0;
      for (int q = start[c] + lane; q < start[c + 1]; q += 32) {
        const float v = rowbuf[q];
        if (v == v) {
          acc += v;
          ++cnt;
        }
      }
      acc = warp_sum(acc);
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) {
        part_num[out + c] = acc;
        part_cnt[out + c] = cnt;
      }
    }
    __syncwarp();
  }
}

// Window w's class-pair sums, block means, pi and Fst.
__global__ void __launch_bounds__(kMeanThreads)
tail_means_kernel(const int32_t* __restrict__ cls_i,
                  const float* __restrict__ cls_f, int P, int C, int n_rows,
                  const float* __restrict__ part_num,
                  const int32_t* __restrict__ part_cnt,
                  float* __restrict__ s_num, int32_t* __restrict__ s_cnt,
                  float* __restrict__ pi, float* __restrict__ dxy,
                  float* __restrict__ fst) {
  const int wl = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kMeanThreads / 32;
  const int32_t* starts = cls_i + n_rows;
  const float* wgt = cls_f;                        // [C, P]
  const float* npop = cls_f + (size_t)C * P;       // [P]
  const int CC = C * C;
  float* sn = s_num + (size_t)wl * CC;
  int32_t* sc = s_cnt + (size_t)wl * CC;
  // S[ci][cj]: part over the rows of class ci, in class order
  for (int task = warp; task < CC; task += kWarps) {
    const int ci = task / C;
    const int cj = task - ci * C;
    float acc = 0.0f;
    int cnt = 0;
    for (int k = starts[ci] + lane; k < starts[ci + 1]; k += 32) {
      const size_t at = ((size_t)wl * n_rows + k) * C + cj;
      acc += part_num[at];
      cnt += part_cnt[at];
    }
    acc = warp_sum(acc);
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) {
      sn[task] = acc;
      sc[task] = cnt;
    }
  }
  __syncthreads();
  // the block means: dxy (kind 0) into dxy, pooled (kind 1) into fst
  const int PP = P * P;
  for (int task = warp; task < 2 * PP; task += kWarps) {
    const bool pooled = task >= PP;
    const int a = (task % PP) / P;
    const int b = task % P;
    float num = 0.0f;
    float den = 0.0f;
    for (int k = lane; k < CC; k += 32) {
      const int ci = k / C;
      const int cj = k - ci * C;
      float u, v;
      if (pooled) {
        u = fminf(fmaxf(wgt[ci * P + a] + wgt[ci * P + b], 0.0f), 1.0f);
        v = fminf(fmaxf(wgt[cj * P + a] + wgt[cj * P + b], 0.0f), 1.0f);
      } else {
        u = wgt[ci * P + a];
        v = wgt[cj * P + b];
      }
      const float uv = u * v;
      if (uv > 0.0f) {
        num += sn[k];
        den += uv * (float)sc[k];
      }
    }
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0)
      (pooled ? fst : dxy)[(size_t)wl * PP + a * P + b] = num / den;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < PP; t += kMeanThreads) {
    const int a = t / P;
    const int b = t % P;
    const float* d = dxy + (size_t)wl * PP;
    const float w = npop[a] / (npop[a] + npop[b]);
    const float t1 = w * d[a * P + a];
    const float t2 = (1.0f - w) * d[b * P + b];
    const float ps = t1 + t2;
    float* f = fst + (size_t)wl * PP + t;
    *f = 1.0f - ps / *f;
    if (a == b) pi[(size_t)wl * P + a] = d[t];
  }
}

// ---------------------------------------------------------------- K11
// window_pop_counts — replaces the per-window allele counts of
// window_stats_step (einsum("ph,bhsa->bpa") over the gathered one-hot):
//   out[w, p, c] = sum over rows h with pm[p, h] != 0 of
//                  #{sites of window w where row h has code c}
// (the mask is 0/1 population membership; the JAX f32 sum of 0/1 products
// is this integer).
//
// Bound: bytes — each window's sites of every row read once.  Design: one
// warp per (row, window) counts its codes in registers, reduces them with
// __reduce_add_sync, and adds the row's four counts to each population it
// belongs to with int32 atomics (exact in any order).
__global__ void __launch_bounds__(kPopThreads)
window_pop_counts_kernel(const int8_t* __restrict__ alleles, long long ld,
                         long long S, const int32_t* __restrict__ first,
                         const int32_t* __restrict__ n_sites,
                         const float* __restrict__ pm, int h, int P,
                         int32_t* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kPopThreads / 32) + threadIdx.x / 32;
  const int wl = blockIdx.y;
  if (row >= h) return;
  const long long f = first[wl];
  const int n = n_sites[wl];
  unsigned c[4] = {0u, 0u, 0u, 0u};
  const int8_t* r = alleles + (long long)row * ld;
  for (int k = lane; k < n; k += 32) {
    const long long col = f + k;
    if (col < 0 || col >= S) continue;
    const int code = r[col];
    if (code >= 0 && code <= 3) ++c[code];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = __reduce_add_sync(0xffffffffu, c[k]);
  if (lane != 0) return;
  for (int p = 0; p < P; ++p) {
    if (pm[(size_t)p * h + row] == 0.0f) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c[k]) atomicAdd(&out[((size_t)wl * P + p) * 4 + k], (int)c[k]);
  }
}

}  // namespace

extern "C" {

// m, s: int32 [nwin, h, h]; the mask's classes (window_stats.TailClasses):
// cls_i int32 [members n_rows | starts C + 1 | pos h], cls_f float32
// [weights C x P | n_pop P]; scratch int32 [2 nwin C (n_rows + C)];
// pi: float32 [nwin, P]; dxy, fst: float32 [nwin, P, P].
int ggt_window_stats_tail(const void* m, const void* s, const void* cls_i,
                          const void* cls_f, int h, int P, int C,
                          int n_rows, int nwin, void* scratch, void* pi,
                          void* dxy, void* fst, void* stream) {
  float* part_num = (float*)scratch;
  int32_t* part_cnt = (int32_t*)scratch + (size_t)nwin * n_rows * C;
  float* s_num = (float*)(part_cnt + (size_t)nwin * n_rows * C);
  int32_t* s_cnt = (int32_t*)(s_num + (size_t)nwin * C * C);
  if (n_rows > 0) {
    // as many warps a block (8 at most) as the shared rows fit; the
    // shared-memory limit raised to the device's once
    static bool raised[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    int limit = 0;
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    const bool vec = h % 4 == 0 && ((uintptr_t)m & 15) == 0 &&
                     ((uintptr_t)s & 15) == 0;
    auto kernel = vec ? tail_rows_kernel<true> : tail_rows_kernel<false>;
    if (dev >= 64 || !raised[dev]) {
      e = cudaFuncSetAttribute(tail_rows_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(tail_rows_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) raised[dev] = true;
    }
    const size_t fixed = 4 * ((size_t)((h + 3) & ~3) + C + 1);
    int warps = kRowWarps;
    while (warps > 1 && fixed + 4 * (size_t)warps * n_rows > (size_t)limit)
      --warps;
    const size_t smem = fixed + 4 * (size_t)warps * n_rows;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidConfiguration;
    const int per = warps * kRowsPerWarp;
    const int bands = (n_rows + per - 1) / per;
    kernel<<<(unsigned)bands * nwin, warps * 32, smem,
             (cudaStream_t)stream>>>(
        (const int32_t*)m, (const int32_t*)s, (const int32_t*)cls_i, h, C,
        n_rows, bands, part_num, part_cnt);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  tail_means_kernel<<<nwin, kMeanThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cls_i, (const float*)cls_f, P, C, n_rows, part_num,
      part_cnt, s_num, s_cnt, (float*)pi, (float*)dxy, (float*)fst);
  return (int)cudaGetLastError();
}

// alleles: int8 rows of ld elements, columns 0 .. S - 1 valid; first,
// n_sites: int32 [nwin]; pm: float32 [P, h]; out: int32 [nwin, P, 4],
// zeroed by the caller.
int ggt_window_pop_counts(const void* alleles, long long ld, long long S,
                          const void* first, const void* n_sites,
                          const void* pm, int h, int P, int nwin, void* out,
                          void* stream) {
  const int rows = kPopThreads / 32;
  dim3 grid((h + rows - 1) / rows, nwin);
  window_pop_counts_kernel<<<grid, kPopThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)alleles, ld, S, (const int32_t*)first,
      (const int32_t*)n_sites, (const float*)pm, h, P, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
