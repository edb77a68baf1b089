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

constexpr int kThreads = 1024;   // K10 threads per block (one window)
constexpr int kPopThreads = 256;  // K11: 8 warps, one haplotype row each

// Fixed-order block sum: thread t adds its own terms in order, then a
// binary tree over the kThreads partials (partial t += partial t + stride,
// stride halving from kThreads / 2).  The plain version
// (window_stats._fixed_sum) repeats exactly this order.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// The rows with weight > 0, in increasing order, with their weights:
// one warp, a ballot per 32 rows.
__device__ int compact(const float* __restrict__ pm, int h, int a, int b,
                       bool pooled, int* list, float* val) {
  const int lane = threadIdx.x % 32;
  int count = 0;
  for (int base = 0; base < h; base += 32) {
    const int i = base + lane;
    float u = 0.0f;
    if (i < h) {
      u = pm[(size_t)a * h + i];
      if (pooled) u = fminf(fmaxf(u + pm[(size_t)b * h + i], 0.0f), 1.0f);
    }
    const unsigned bal = __ballot_sync(0xffffffffu, u > 0.0f);
    if (u > 0.0f) {
      const int pos = count + __popc(bal & ((1u << lane) - 1u));
      list[pos] = i;
      val[pos] = u;
    }
    count += __popc(bal);
  }
  return count;
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
// Bound: bytes — each window's [h, h] counts read once.  Design: one block
// per window walks the 2 P^2 blocks in turn.  For each, one warp compacts
// the rows of u > 0 and another those of v > 0 (ballots), so a block of
// disjoint populations visits only its own pairs (about 5 h^2 pair reads
// per window over all blocks); the sums are float32 in the fixed order of
// block_sum, so a run repeats bit for bit, and Fst is formed by thread
// (a, b) once every mean of the window is in shared memory.
__global__ void __launch_bounds__(kThreads)
window_stats_tail_kernel(const int32_t* __restrict__ m,
                         const int32_t* __restrict__ s,
                         const float* __restrict__ pm, int h, int P,
                         float* __restrict__ pi, float* __restrict__ dxy,
                         float* __restrict__ fst) {
  extern __shared__ unsigned char smem[];
  int* lu = reinterpret_cast<int*>(smem);
  int* lv = lu + h;
  float* uval = reinterpret_cast<float*>(lv + h);
  float* vval = uval + h;
  float* dmean = vval + h;             // [P, P] block means
  float* pmean = dmean + P * P;        // [P, P] pooled means
  float* npop = pmean + P * P;         // [P] population sizes
  __shared__ float red[kThreads];
  __shared__ int counts[2];
  const int wl = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const size_t base = (size_t)wl * h * h;

  for (int a = 0; a < P; ++a) {
    float acc = 0.0f;
    for (int i = tid; i < h; i += kThreads) acc += pm[(size_t)a * h + i];
    const float n_a = block_sum(acc, red);
    if (tid == 0) npop[a] = n_a;
  }

  const int PP = P * P;
  for (int task = 0; task < 2 * PP; ++task) {
    const bool pooled = task >= PP;
    const int a = (task % PP) / P;
    const int b = task % P;
    if (warp == 0) {
      const int c = compact(pm, h, a, b, pooled, lu, uval);
      if (tid == 0) counts[0] = c;
    } else if (warp == 1) {
      const int c = pooled ? compact(pm, h, a, b, true, lv, vval)
                           : compact(pm, h, b, a, false, lv, vval);
      if (tid == 32) counts[1] = c;
    }
    __syncthreads();
    const long long nu = counts[0];
    const long long nv = counts[1];
    float num = 0.0f;
    float den = 0.0f;
    for (long long p = tid; p < nu * nv; p += kThreads) {
      const int iu = (int)(p / nv);
      const int jv = (int)(p % nv);
      const int i = lu[iu];
      const int j = lv[jv];
      float wgt = 0.0f;
      float d = 0.0f;
      if (i != j) {
        const int sv = s[base + (size_t)i * h + j];
        if (sv > 0) {
          wgt = uval[iu] * vval[jv];
          if (wgt > 0.0f)
            d = (float)m[base + (size_t)i * h + j] / (float)max(sv, 1);
        }
      }
      num += d;
      den += wgt;
    }
    const float tn = block_sum(num, red);
    const float td = block_sum(den, red);
    if (tid == 0) (pooled ? pmean : dmean)[a * P + b] = tn / td;
    __syncthreads();
  }

  for (int t = tid; t < PP; t += kThreads) {
    const int a = t / P;
    const int b = t % P;
    const float w = npop[a] / (npop[a] + npop[b]);
    const float t1 = w * dmean[a * P + a];
    const float t2 = (1.0f - w) * dmean[b * P + b];
    const float ps = t1 + t2;
    dxy[(size_t)wl * PP + t] = dmean[t];
    fst[(size_t)wl * PP + t] = 1.0f - ps / pmean[t];
    if (a == b) pi[(size_t)wl * P + a] = dmean[t];
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

// m, s: int32 [nwin, h, h]; pm: float32 [P, h]; pi: float32 [nwin, P];
// dxy, fst: float32 [nwin, P, P].
int ggt_window_stats_tail(const void* m, const void* s, const void* pm,
                          int h, int P, int nwin, void* pi, void* dxy,
                          void* fst, void* stream) {
  const size_t smem = (size_t)h * 16 + (size_t)(2 * P * P + P) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_stats_tail_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  window_stats_tail_kernel<<<nwin, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)m, (const int32_t*)s, (const float*)pm, h, P,
      (float*)pi, (float*)dxy, (float*)fst);
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
