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

constexpr int kPopThreads = 256;  // K11: 8 warps a block
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
// genomics_general_tpu/kernels/window_stats.py window_stats_step
// (einsum("ph,bhsa->bpa") over the gathered one-hot):
//   out[w, p, c] = sum over rows h with pm[p, h] != 0 of
//                  #{sites of window w where row h has code c}
// (the mask is 0/1 population membership; the JAX f32 sum of 0/1 products
// is this integer).  Columns outside [0, S) and codes outside 0..3 count
// as nothing.
//
// Bound: bytes — each window's sites of every row read once.  Design: the
// rows as the mask's membership classes (window_stats.TailClasses, the
// classes K10 takes: rows in class order, rows in no population dropped),
// a block per (window, band of `rows` rows):
//   * a row's window [lo, hi) is read as the aligned 16-byte vectors that
//     cover it, worked out from the row's own address (any row stride).
//     The block's threads take the band's (row, inner vector) items in
//     order, so a warp's lanes read consecutive vectors, kPopAhead loads
//     in flight a lane; then each row's first and last vector, a thread
//     each, with the bytes outside [lo, hi) forced to 0xff, which is no
//     code (the inner vectors need no mask, so the main loop has no
//     branch on it);
//   * the codes are compared four bytes a word in plain integer operations
//     (count_word: a byte is a code when its bits 2..7 are clear, and its
//     bits 0 and 1 say which), the matches added into byte-wise counters,
//     flushed to integers every kFlushVectors vectors.  Four counters in
//     scalar registers: no indexed array, nothing in local memory;
//   * a class's rows in the band are summed in the block (a warp sum, then
//     the warps in shared memory) and added to the block's sums of each
//     population the class lies in (shared memory); the block then adds
//     each nonzero population sum to out with one int32 atomic, exact in
//     any order.
// More than kPopChunk populations take a launch per kPopChunk.
constexpr int kPopAhead = 4;
constexpr int kFlushVectors = 60;  // a counter byte takes at most 4 a vector
constexpr int kPopChunk = 1024;
constexpr int kMaxRows = 1024;

// a row's window as aligned 16-byte vectors: the first at base, nv of them;
// edges: the first vector's bytes before the window (bits 0..7) and the
// last vector's bytes inside it (bits 8..15, 1..16)
struct __align__(16) RowSpan {
  const uint4* base;
  int nv;
  int edges;
};

// the codes of the 4 bytes of x into byte-wise counters: byte k of `any`
// takes 1 when byte k of x is a code 0..3, of `one`, `two`, `three` when
// it is that code
__device__ __forceinline__ void count_word(unsigned x, unsigned& any,
                                           unsigned& one, unsigned& two,
                                           unsigned& three) {
  // bit 7 of each byte of t: one of the byte's bits 2..6 is set (the sum
  // stays inside its byte)
  const unsigned t = (x & 0x7c7c7c7cu) + 0x7c7c7c7cu;
  const unsigned code = (~(t | x) & 0x80808080u) >> 7;
  const unsigned x1 = x >> 1;
  any += code;
  one += code & x & ~x1;
  two += code & ~x & x1;
  three += code & x & x1;
}

__device__ __forceinline__ void count_vector(const uint4& q, unsigned* acc) {
  count_word(q.x, acc[0], acc[1], acc[2], acc[3]);
  count_word(q.y, acc[0], acc[1], acc[2], acc[3]);
  count_word(q.z, acc[0], acc[1], acc[2], acc[3]);
  count_word(q.w, acc[0], acc[1], acc[2], acc[3]);
}

// 0xff in the bytes of the word at byte `at` of a vector that lie in
// bytes head .. tail - 1 of the vector
__device__ __forceinline__ unsigned keep_bytes(int head, int tail, int at) {
  const int lo = min(max(head - at, 0), 4);
  const int hi = min(max(tail - at, 0), 4);
  const unsigned up = hi == 4 ? 0xffffffffu : (1u << (8 * hi)) - 1u;
  const unsigned down = lo == 4 ? 0xffffffffu : (1u << (8 * lo)) - 1u;
  return up & ~down;
}

__device__ __forceinline__ int byte_sum(unsigned x) {
  x = (x & 0x00ff00ffu) + ((x >> 8) & 0x00ff00ffu);
  return (int)((x & 0xffffu) + (x >> 16));
}

__global__ void __launch_bounds__(kPopThreads)
window_pop_counts_kernel(const int8_t* __restrict__ alleles, long long ld,
                         long long S, const int32_t* __restrict__ first,
                         const int32_t* __restrict__ n_sites,
                         const int32_t* __restrict__ cls_i,
                         const float* __restrict__ wgt, int n_rows, int C,
                         int P, int p0, int pc, int rows,
                         int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  RowSpan* span = reinterpret_cast<RowSpan*>(smem);      // [rows]
  int* sums = reinterpret_cast<int*>(span + rows);       // [pc][4]
  __shared__ int red[kPopThreads / 32][4];
  __shared__ int first_class;
  const int w = blockIdx.y;
  const long long f = first[w];
  const long long lo = f > 0 ? f : 0;
  const long long hi = min(f + n_sites[w], S);
  if (hi <= lo) return;                                  // the whole block
  const int k0 = blockIdx.x * rows;
  const int nk = min(n_rows - k0, rows);
  const int32_t* members = cls_i;
  const int32_t* starts = cls_i + n_rows;
  for (int j = threadIdx.x; j < nk; j += kPopThreads) {
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(alleles + members[k0 + j] * ld + lo);
    const uintptr_t b = a + (uintptr_t)(hi - lo);
    const uintptr_t a16 = a & ~(uintptr_t)15;
    RowSpan r;
    r.base = reinterpret_cast<const uint4*>(a16);
    r.nv = (int)((b - a16 + 15) >> 4);
    r.edges = (int)(a - a16) |
              ((int)(b - a16 - 16 * (uintptr_t)(r.nv - 1)) << 8);
    span[j] = r;
  }
  for (int c = threadIdx.x; c < C; c += kPopThreads)
    if (starts[c] <= k0 && k0 < starts[c + 1]) first_class = c;
  for (int j = threadIdx.x; j < 4 * pc; j += kPopThreads) sums[j] = 0;
  __syncthreads();
  // item t of a class's rows r0 .. r1 - 1 is (row r0 + t / inner, inner
  // vector 1 + t % inner), inner = vmax - 2 for vmax the most vectors a
  // row's window can take; a thread takes t = threadIdx.x, + kPopThreads,
  // ..
  const int inner = (int)((hi - lo + 30) >> 4) - 2;
  const int step_r = inner > 0 ? kPopThreads / inner : 0;
  const int step_v = inner > 0 ? kPopThreads - step_r * inner : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = first_class; c < C && starts[c] < k0 + nk; ++c) {
    const int r0 = max(starts[c] - k0, 0);
    const int r1 = min(starts[c + 1] - k0, nk);
    // is this thread's first population in the class (read ahead)
    const bool in_c = threadIdx.x < pc &&
                      wgt[(size_t)c * P + p0 + threadIdx.x] != 0.0f;
    unsigned acc[4] = {0u, 0u, 0u, 0u};
    int tot[4] = {0, 0, 0, 0};
    int row = inner > 0 ? r0 + threadIdx.x / inner : r1;
    int v = inner > 0 ? threadIdx.x % inner : 0;
    int pending = 0;
    while (row < r1) {
      uint4 q[kPopAhead];
      bool ok[kPopAhead];
#pragma unroll
      for (int u = 0; u < kPopAhead; ++u) {
        ok[u] = false;
        if (row < r1) {
          const RowSpan rs = span[row];
          if (v < rs.nv - 2) {
            ok[u] = true;
            q[u] = __ldg(rs.base + 1 + v);
          }
        }
        row += step_r;
        v += step_v;
        if (v >= inner) {
          v -= inner;
          ++row;
        }
      }
#pragma unroll
      for (int u = 0; u < kPopAhead; ++u)
        if (ok[u]) count_vector(q[u], acc);
      pending += kPopAhead;
      if (pending >= kFlushVectors) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[i] += byte_sum(acc[i]);
          acc[i] = 0u;
        }
        pending = 0;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tot[i] += byte_sum(acc[i]);
      acc[i] = 0u;
    }
    // each row's first and last vector (one, when the window fits in one)
    for (int j = threadIdx.x; j < 2 * (r1 - r0); j += kPopThreads) {
      const RowSpan rs = span[r0 + (j >> 1)];
      const bool last = j & 1;
      if (last && rs.nv == 1) continue;
      uint4 q = __ldg(rs.base + (last ? rs.nv - 1 : 0));
      const int head = last ? 0 : rs.edges & 0xff;
      const int tail = last || rs.nv == 1 ? rs.edges >> 8 : 16;
      q.x |= ~keep_bytes(head, tail, 0);
      q.y |= ~keep_bytes(head, tail, 4);
      q.z |= ~keep_bytes(head, tail, 8);
      q.w |= ~keep_bytes(head, tail, 12);
      count_vector(q, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tot[i] = __reduce_add_sync(kFull, tot[i] + byte_sum(acc[i]));
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][i] = tot[i];
    }
    __syncthreads();
    if (threadIdx.x < pc) {
      int n4[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < kPopThreads / 32; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) n4[i] += red[k][i];
      // code 0 is the codes that are none of 1, 2, 3
      const int n0 = n4[0] - n4[1] - n4[2] - n4[3];
      for (int j = threadIdx.x; j < pc; j += kPopThreads) {
        if (j == threadIdx.x ? !in_c
                             : wgt[(size_t)c * P + p0 + j] == 0.0f)
          continue;
        sums[4 * j] += n0;
        sums[4 * j + 1] += n4[1];
        sums[4 * j + 2] += n4[2];
        sums[4 * j + 3] += n4[3];
      }
    }
    __syncthreads();
  }
  int32_t* o = out + ((size_t)w * P + p0) * 4;
  for (int j = threadIdx.x; j < 4 * pc; j += kPopThreads)
    if (sums[j] != 0) atomicAdd(o + j, sums[j]);
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
// n_sites: int32 [nwin]; the mask's classes (window_stats.TailClasses):
// cls_i int32 [members n_rows | starts C + 1 | ..], cls_f float32 [weights
// C x P | ..]; rows: rows a block (1 .. kMaxRows); out: int32 [nwin, P, 4],
// zeroed by the caller.
int ggt_window_pop_counts(const void* alleles, long long ld, long long S,
                          const void* first, const void* n_sites,
                          const void* cls_i, const void* cls_f, int n_rows,
                          int C, int P, int nwin, int rows, void* out,
                          void* stream) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || nwin == 0) return (int)cudaSuccess;
  const dim3 grid((n_rows + rows - 1) / rows, nwin);
  for (int p0 = 0; p0 < P; p0 += kPopChunk) {
    const int pc = P - p0 < kPopChunk ? P - p0 : kPopChunk;
    const size_t smem = sizeof(RowSpan) * rows + 16 * (size_t)pc;
    window_pop_counts_kernel<<<grid, kPopThreads, smem,
                               (cudaStream_t)stream>>>(
        (const int8_t*)alleles, ld, S, (const int32_t*)first,
        (const int32_t*)n_sites, (const int32_t*)cls_i, (const float*)cls_f,
        n_rows, C, P, p0, pc, rows, (int32_t*)out);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
