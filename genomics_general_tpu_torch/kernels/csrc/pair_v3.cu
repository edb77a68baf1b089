// Pairwise kernels for Hopper (sm_90a): per-window masked-Hamming pair
// counts from the wire-v3 (K1) and wire-v2 (K13) bit planes, the
// multi-allelic exception patch, and the epilogues of
// popgenWindows' distance analyses: per-block float64 sums, each
// individual's own pair, and the packed upper triangles.
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/pairdist.py).  Every launch goes on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// wrapper can raise on a refused launch.
//
// Wire layouts (kernels/transfer.py).  v3: four bit planes, each [h, Sp/32]
// little-endian 32-bit words, site 32q + t in bit t of word q; per-window
// class ranges meta int32 [7, wp] = firstB, nB, firstC, nC, firstD, nD,
// nconst.  v2: the called and alt planes in the same word layout, then
// first, n_sites int32 [wp].  Both end with the exception section ex_w
// int32 [ep] (== wp for padding entries) and ex_codes int8 [ep, h].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // K1/K13 pair tile: 32 x 32 pairs
constexpr int kWords = 32;       // words staged per plane per step
constexpr int kThreads = 256;    // 8 warps; warp y owns tile rows y + 8r
constexpr int kRowsPerThread = kTile / (kThreads / kTile);
constexpr int kExRows = 8;       // K2 rows of the pair matrix per block
constexpr int kTailThreads = 256;

// One class range of a pair tile, shared by K1 and K13: adds to the
// thread's accumulators, for its rows of the 32 x 32 tile (i0.., j0..), the
// popcounts over the words of [first, first + n) of the planes p0 (and p1),
// rows of row_words words:
//   kind 0: shared   += popc(p0_i & p0_j)
//   kind 1: mismatch += popc(p0_i ^ p0_j)
//   kind 2: shared   += popc(p0_i & p0_j),
//           mismatch += popc((p1_i ^ p1_j) & p0_i & p0_j)
// A range starts at any bit.  AND, XOR and popcount act per bit, so no
// alignment is needed: the words that overlap the range are read in place
// and the bits outside it are masked off in the first and last word
// (all-ones mask elsewhere).  n <= 0 adds nothing.  Every thread of the
// block calls it with the same range (it synchronises).  The block stages
// kWords words of its 32 row and 32 column haplotypes per plane in shared
// memory (padded rows: conflict-free column reads, broadcast row reads), so
// each word loaded from device memory feeds 32 pairs.
__device__ __forceinline__ void tile_range(
    int kind, const uint32_t* __restrict__ p0,
    const uint32_t* __restrict__ p1, int row_words, int first, int n, int h,
    int i0, int j0, uint32_t (&si)[2][kTile][kWords + 1],
    uint32_t (&sj)[2][kTile][kWords + 1], int (&acc_s)[kRowsPerThread],
    int (&acc_m)[kRowsPerThread]) {
  if (n <= 0) return;
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int q_first = first >> 5;
  const int q_last = (first + n - 1) >> 5;
  const uint32_t head = ~0u << (first & 31);
  const int tail_bits = (first + n) & 31;
  const uint32_t tail = tail_bits ? (1u << tail_bits) - 1u : ~0u;

  for (int qb = q_first; qb <= q_last; qb += kWords) {
    const int nq = min(kWords, q_last - qb + 1);
    for (int idx = threadIdx.x; idx < kTile * kWords; idx += kThreads) {
      const int r = idx / kWords;
      const int k = idx % kWords;
      const int q = qb + k;
      uint32_t mask = 0;
      if (k < nq) {
        mask = ~0u;
        if (q == q_first) mask &= head;
        if (q == q_last) mask &= tail;
      }
      const int gi = i0 + r;
      const int gj = j0 + r;
      uint32_t vi0 = 0, vi1 = 0, vj0 = 0, vj1 = 0;
      if (mask) {
        if (gi < h) {
          vi0 = p0[(size_t)gi * row_words + q] & mask;
          if (p1) vi1 = p1[(size_t)gi * row_words + q] & mask;
        }
        if (gj < h) {
          vj0 = p0[(size_t)gj * row_words + q] & mask;
          if (p1) vj1 = p1[(size_t)gj * row_words + q] & mask;
        }
      }
      si[0][r][k] = vi0;
      si[1][r][k] = vi1;
      sj[0][r][k] = vj0;
      sj[1][r][k] = vj1;
    }
    __syncthreads();
    for (int k = 0; k < nq; ++k) {
      const uint32_t b0 = sj[0][tx][k];
      const uint32_t b1 = sj[1][tx][k];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) {
        const int r = ty + rr * (kThreads / kTile);
        const uint32_t a0 = si[0][r][k];
        if (kind == 0) {
          acc_s[rr] += __popc(a0 & b0);
        } else if (kind == 1) {
          acc_m[rr] += __popc(a0 ^ b0);
        } else {
          const uint32_t both = a0 & b0;
          acc_s[rr] += __popc(both);
          acc_m[rr] += __popc((si[1][r][k] ^ b1) & both);
        }
      }
    }
    __syncthreads();
  }
}

// Writes the thread's rows of the pair tile into window wl of the
// [nwin, h, h] counts (shared plus a per-window constant).
__device__ __forceinline__ void tile_store(
    int wl, int h, int i0, int j0, int nconst,
    const int (&acc_s)[kRowsPerThread], const int (&acc_m)[kRowsPerThread],
    int32_t* __restrict__ m_out, int32_t* __restrict__ s_out) {
  const int j = j0 + threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int i = i0 + ty + rr * (kThreads / kTile);
    if (i < h && j < h) {
      const size_t o = ((size_t)wl * h + i) * h + j;
      m_out[o] = acc_m[rr];
      s_out[o] = acc_s[rr] + nconst;
    }
  }
}

// ---------------------------------------------------------------- K1
// pair_counts_v3 — replaces genomics_general_tpu/kernels/pairdist.py
// _fused_flush_pair_v3 (with _gather_bits) and kernels/transfer.py
// unpack_pair_wire_v3.  For window w and haplotypes i, j:
//   shared   = nconst[w] + popc(cB_i & cB_j) + popc(cD_i & cD_j)
//   mismatch = popc(aC_i ^ aC_j) + popc((aD_i ^ aD_j) & cD_i & cD_j)
// summed over the words of the window's class ranges (tile_range kinds 0,
// 1, 2).  Because aD is a subset of cD these equal the JAX kernel's bf16
// Gram forms (rC_i + rC_j - 2 aC.aC^T, aD.cD^T + (aD.cD^T)^T - 2 aD.aD^T)
// exactly, with no 2^24 bound on the window length.  An all-monomorphic
// window only writes nconst.
//
// Bound: popcounts.  Each pair reads each word of its window once, so the
// work is h^2 * (wordsB + wordsC + 2 wordsD) popcounts per window against
// 8 bytes of output per pair; at the main path's h = 512 that is far above
// the card's popcount:byte balance.  Design: a block owns one window and a
// 32 x 32 pair tile (tile_range stages the words).  Simple first version:
// it computes the full symmetric matrix (twice the needed popcounts) and
// stages with plain loads.
__global__ void __launch_bounds__(kThreads)
pair_counts_v3_kernel(const uint32_t* __restrict__ planes,
                      const int32_t* __restrict__ meta,
                      int h, int wb, int wc, int wd, int wp, int w0,
                      int32_t* __restrict__ m_out,
                      int32_t* __restrict__ s_out) {
  __shared__ uint32_t si[2][kTile][kWords + 1];
  __shared__ uint32_t sj[2][kTile][kWords + 1];
  const int wl = blockIdx.z;
  const int w = w0 + wl;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;

  const uint32_t* cB = planes;
  const uint32_t* aC = cB + (size_t)h * wb;
  const uint32_t* cD = aC + (size_t)h * wc;
  const uint32_t* aD = cD + (size_t)h * wd;

  int acc_s[kRowsPerThread] = {0};
  int acc_m[kRowsPerThread] = {0};
  tile_range(0, cB, nullptr, wb, meta[w], meta[wp + w], h, i0, j0, si, sj,
             acc_s, acc_m);
  tile_range(1, aC, nullptr, wc, meta[2 * wp + w], meta[3 * wp + w], h, i0,
             j0, si, sj, acc_s, acc_m);
  tile_range(2, cD, aD, wd, meta[4 * wp + w], meta[5 * wp + w], h, i0, j0,
             si, sj, acc_s, acc_m);
  tile_store(wl, h, i0, j0, meta[6 * wp + w], acc_s, acc_m, m_out, s_out);
}

// ---------------------------------------------------------------- K13
// pair_counts_v2 — replaces genomics_general_tpu/kernels/pairdist.py
// _fused_flush_pair_v2's count stage (_pair_counts_v2 with
// gather_window_code2) and kernels/transfer.py unpack_pair_wire.  For
// window w and haplotypes i, j, over the words of [first[w], first[w] +
// n_sites[w]) of the called (c) and alt (a) planes:
//   shared   = popc(c_i & c_j)
//   mismatch = popc((a_i ^ a_j) & c_i & c_j)
// K1's class-D term over one plane pair (tile_range kind 2).  The alt bits
// lie inside the called bits, so these equal the JAX bf16 Gram forms
// (c.c^T, ca.c^T + (ca.c^T)^T - 2 ca.ca^T) exactly.
//
// Bound: popcounts, h^2 * 2 * (words of the window) per window.  Design:
// K1's block per (window, 32 x 32 pair tile).  Unlike wire v3, wire v2
// ships every site of a window in both planes (v3 skips the constant
// class), so K13 does more popcounts than K1 on the same flush.
__global__ void __launch_bounds__(kThreads)
pair_counts_v2_kernel(const uint32_t* __restrict__ called,
                      const uint32_t* __restrict__ alt,
                      const int32_t* __restrict__ first,
                      const int32_t* __restrict__ n_sites, int h, int words,
                      int w0, int32_t* __restrict__ m_out,
                      int32_t* __restrict__ s_out) {
  __shared__ uint32_t si[2][kTile][kWords + 1];
  __shared__ uint32_t sj[2][kTile][kWords + 1];
  const int wl = blockIdx.z;
  const int w = w0 + wl;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  int acc_s[kRowsPerThread] = {0};
  int acc_m[kRowsPerThread] = {0};
  tile_range(2, called, alt, words, first[w], n_sites[w], h, i0, j0, si, sj,
             acc_s, acc_m);
  tile_store(wl, h, i0, j0, 0, acc_s, acc_m, m_out, s_out);
}

// ---------------------------------------------------------------- K2
// exception_patch — replaces genomics_general_tpu/kernels/pairdist.py
// _exception_patch.  Each exception entry (a multi-allelic site inside one
// window) adds 1 to shared[w, i, j] where both haplotypes are called
// (code >= 0) and 1 to mismatch[w, i, j] where they also differ.
//
// Bound: the read-modify-write of the touched windows' [h, h] counts.
// Design: one block per (entry, 8-row slab); the entry's h codes sit in
// shared memory and each thread patches pairs with int32 atomicAdd —
// integer atomics are exact and order-independent, so overlapping entries
// of one window need no ordering.  Entries outside the chunk
// [w0, w0 + nwin), and the padding entries (ex_w == wp), return at once.
__global__ void __launch_bounds__(kThreads)
exception_patch_kernel(const int32_t* __restrict__ ex_w,
                       const int8_t* __restrict__ ex_codes,
                       int h, int wp, int w0, int nwin,
                       int32_t* __restrict__ m, int32_t* __restrict__ s) {
  extern __shared__ int8_t codes[];
  const int e = blockIdx.x;
  const int w = ex_w[e];
  if (w >= wp || w < w0 || w >= w0 + nwin) return;
  const int8_t* c = ex_codes + (size_t)e * h;
  for (int t = threadIdx.x; t < h; t += blockDim.x) codes[t] = c[t];
  __syncthreads();
  const int i0 = blockIdx.y * kExRows;
  const size_t base = (size_t)(w - w0) * h * h;
  for (int t = threadIdx.x; t < kExRows * h; t += blockDim.x) {
    const int i = i0 + t / h;
    const int j = t % h;
    if (i >= h) break;
    const int ci = codes[i];
    const int cj = codes[j];
    if (ci >= 0 && cj >= 0) {
      const size_t o = base + (size_t)i * h + j;
      atomicAdd(&s[o], 1);
      if (ci != cj) atomicAdd(&m[o], 1);
    }
  }
}

// ---------------------------------------------------------------- K3
// blocks_tail — replaces the "blocks" mode of
// genomics_general_tpu/kernels/pairdist.py _modes_tail.  For each window
// and population pair (p, q):
//   sums[w, p, q] = sum over i in p, j in q, i != j, s >= max(min_sites, 1)
//                   of (double) m / (double) s
//   cnts[w, p, q] = the number of such pairs
// which is the JAX einsum("whg,ph,qg->wpq") for a 0/1 mask in which every
// haplotype row belongs to exactly one group (the wrapper checks this and
// passes the rows grouped: perm[offs[p] .. offs[p+1]) are the rows of p).
//
// Bound: bytes — 8 bytes of counts read per pair against a few f64
// operations.  Design: one block per (window, p, q) walks exactly its
// block's pairs (each count is read once over all blocks), accumulates in
// f64 in a fixed per-thread order and reduces with a fixed shared-memory
// tree: no floating-point atomics, so the sums are identical run to run.
__global__ void __launch_bounds__(kTailThreads)
blocks_tail_kernel(const int32_t* __restrict__ m,
                   const int32_t* __restrict__ s,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ offs,
                   int P, int h, int min_sites, double* __restrict__ out) {
  __shared__ double red_sum[kTailThreads];
  __shared__ long long red_cnt[kTailThreads];
  const int q = blockIdx.x;
  const int p = blockIdx.y;
  const int wl = blockIdx.z;
  const int pa = offs[p];
  const int qa = offs[q];
  const long long pn = offs[p + 1] - pa;
  const long long qn = offs[q + 1] - qa;
  const int ms = max(min_sites, 1);
  const size_t base = (size_t)wl * h * h;
  double sum = 0.0;
  long long cnt = 0;
  for (long long t = threadIdx.x; t < pn * qn; t += kTailThreads) {
    const int i = perm[pa + t / qn];
    const int j = perm[qa + t % qn];
    if (i == j) continue;
    const size_t o = base + (size_t)i * h + j;
    const int sv = s[o];
    if (sv >= ms) {
      sum += (double)m[o] / (double)sv;
      cnt += 1;
    }
  }
  red_sum[threadIdx.x] = sum;
  red_cnt[threadIdx.x] = cnt;
  __syncthreads();
  for (int stride = kTailThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      red_sum[threadIdx.x] += red_sum[threadIdx.x + stride];
      red_cnt[threadIdx.x] += red_cnt[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const size_t pq = (size_t)P * P;
    out[((size_t)wl * 2) * pq + (size_t)p * P + q] = red_sum[0];
    out[((size_t)wl * 2 + 1) * pq + (size_t)p * P + q] = (double)red_cnt[0];
  }
}

// ---------------------------------------------------------------- K4
// tri_pack — replaces the "tri" mode of genomics_general_tpu/kernels/
// pairdist.py _modes_tail.  Copies the upper triangles (i <= j, row by row:
// np.triu_indices order) of a chunk's m and s into out [nwin, 2T],
// T = h (h + 1) / 2, m half first, narrowed to uint16 when the wrapper
// knows every count is below 2^16 (each is at most its window's sites).
//
// Bound: bytes — a pure gather.  Design: one block per (row i, window);
// its threads walk j = i .. h - 1, so both the reads of row i and the
// writes of its T-segment (which starts at i h - i (i - 1) / 2) are
// consecutive addresses across a warp.
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
tri_pack_kernel(const int32_t* __restrict__ m,
                const int32_t* __restrict__ s, int h,
                T* __restrict__ out) {
  const int i = blockIdx.x;
  const int wl = blockIdx.y;
  const size_t tri = (size_t)h * (h + 1) / 2;
  const size_t row = (size_t)i * h - (size_t)i * (i - 1) / 2;
  const size_t src = ((size_t)wl * h + i) * h;
  T* om = out + (size_t)wl * 2 * tri + row;
  T* os = om + tri;
  for (int j = i + threadIdx.x; j < h; j += kTailThreads) {
    om[j - i] = (T)m[src + j];
    os[j - i] = (T)s[src + j];
  }
}

// ---------------------------------------------------------------- K5
// het_pairs — replaces the het gather of the "blocks_het" mode of
// genomics_general_tpu/kernels/pairdist.py _modes_tail:
//   out[w, k] = ((double) m[w, r1[k], r2[k]], (double) s[w, r1[k], r2[k]])
// for each individual k (r1 == r2 for a non-diploid; the host discards
// that value).  Integers below 2^31 are exact in f64.
//
// Bound: bytes — one 32-byte sector per read of m and s, 16 bytes out.
// Design: one thread per (window, individual); nothing to share.
__global__ void __launch_bounds__(kTailThreads)
het_pairs_kernel(const int32_t* __restrict__ m,
                 const int32_t* __restrict__ s,
                 const int32_t* __restrict__ r1,
                 const int32_t* __restrict__ r2, int h, int n_ind, int nwin,
                 double* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kTailThreads + threadIdx.x;
  if (t >= (long long)nwin * n_ind) return;
  const int wl = (int)(t / n_ind);
  const int k = (int)(t % n_ind);
  const size_t o = ((size_t)wl * h + r1[k]) * h + r2[k];
  out[2 * t] = (double)m[o];
  out[2 * t + 1] = (double)s[o];
}

}  // namespace

extern "C" {

// m_out, s_out: int32 [nwin, h, h] for windows w0 .. w0 + nwin - 1.
int ggt_pair_counts_v3(const void* planes, const void* meta, int h, int wb,
                       int wc, int wd, int wp, int w0, int nwin, void* m_out,
                       void* s_out, void* stream) {
  const int tiles = (h + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, nwin);
  pair_counts_v3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)planes, (const int32_t*)meta, h, wb, wc, wd, wp, w0,
      (int32_t*)m_out, (int32_t*)s_out);
  return (int)cudaGetLastError();
}

// called, alt: [h, words] 32-bit words; first, n_sites: int32 [wp];
// m_out, s_out: int32 [nwin, h, h] for windows w0 .. w0 + nwin - 1.
int ggt_pair_counts_v2(const void* called, const void* alt, const void* first,
                       const void* n_sites, int h, int words, int w0,
                       int nwin, void* m_out, void* s_out, void* stream) {
  const int tiles = (h + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, nwin);
  pair_counts_v2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)called, (const uint32_t*)alt, (const int32_t*)first,
      (const int32_t*)n_sites, h, words, w0, (int32_t*)m_out,
      (int32_t*)s_out);
  return (int)cudaGetLastError();
}

// m, s: int32 [nwin, h, h] for windows w0 .. w0 + nwin - 1, patched in place.
int ggt_exception_patch(const void* ex_w, const void* ex_codes, int ep,
                        int h, int wp, int w0, int nwin, void* m, void* s,
                        void* stream) {
  dim3 grid(ep, (h + kExRows - 1) / kExRows);
  exception_patch_kernel<<<grid, kThreads, h, (cudaStream_t)stream>>>(
      (const int32_t*)ex_w, (const int8_t*)ex_codes, h, wp, w0, nwin,
      (int32_t*)m, (int32_t*)s);
  return (int)cudaGetLastError();
}

// out: float64 [nwin, 2, P, P] (sums, then valid-pair counts).
int ggt_blocks_tail(const void* m, const void* s, const void* perm,
                    const void* offs, int P, int h, int nwin, int min_sites,
                    void* out, void* stream) {
  dim3 grid(P, P, nwin);
  blocks_tail_kernel<<<grid, kTailThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)m, (const int32_t*)s, (const int32_t*)perm,
      (const int32_t*)offs, P, h, min_sites, (double*)out);
  return (int)cudaGetLastError();
}

// out: [nwin, 2 h (h + 1) / 2], uint16 when u16 != 0, else int32.
int ggt_tri_pack(const void* m, const void* s, int h, int nwin, int u16,
                 void* out, void* stream) {
  dim3 grid(h, nwin);
  if (u16) {
    tri_pack_kernel<uint16_t><<<grid, kTailThreads, 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)m, (const int32_t*)s, h, (uint16_t*)out);
  } else {
    tri_pack_kernel<int32_t><<<grid, kTailThreads, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)m, (const int32_t*)s, h, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// out: float64 [nwin, n_ind, 2].
int ggt_het_pairs(const void* m, const void* s, const void* r1,
                  const void* r2, int h, int n_ind, int nwin, void* out,
                  void* stream) {
  const long long n = (long long)nwin * n_ind;
  const unsigned blocks = (unsigned)((n + kTailThreads - 1) / kTailThreads);
  het_pairs_kernel<<<blocks, kTailThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)m, (const int32_t*)s, (const int32_t*)r1,
      (const int32_t*)r2, h, n_ind, nwin, (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
