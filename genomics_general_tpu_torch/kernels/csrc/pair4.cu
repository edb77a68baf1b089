// General 4-state pair counts for Hopper (sm_90a): per-window masked-Hamming
// counts straight from the int8 allele matrix, for distMat --windType cat,
// the device-array and raw-upload routes of the tri counts, the long-span
// helper, the window-stats step and the mesh's window slabs (K9), for the
// mesh's row blocks of the tensor-parallel counts (K14), and the same
// counts read in place from a one-transfer flush buffer and tri-packed
// (K20).
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/pairdist.py).  The launch goes on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                  // pair tile: 64 x 64 haplotypes
constexpr int kMicro = 4;                  // each thread owns 4 x 4 pairs
constexpr int kSide = kTile / kMicro;      // 16 x 16 threads
constexpr int kThreads = kSide * kSide;    // 256
constexpr int kRows = 2 * kTile;           // staged rows: i tile, j tile
constexpr int kStage = 128;                // sites staged per step
constexpr int kGroups = kStage / 32;       // 32-site groups per step
constexpr int kRawWords = kStage / 4 + 1;  // raw row: 132 bytes (33 words)
constexpr int kPackWords = 5 * kGroups + 1;  // 4 one-hot + 1 called per group

// The staging and count loop K9, K14 and K20 share: one block counts the
// pair tile of rows i0 .. i0 + 63 and columns j0 .. j0 + 63 over sites
// lo .. hi - 1 of the window that starts at f, into thread (ty, tx)'s
// rows i0 + ty + 16 a and columns j0 + tx + 16 b.  Rows at or past h, and
// columns outside 0 .. S - 1, read as missing.  The codes come from an
// int8 matrix of rows of ld bytes (K9, K14), or with kWire from a span
// wire (kernels/transfer.py pack_span, K20): 2-bit codes in rows of c4
// bytes, then the miss bits in rows of m8 bytes (a set bit is missing).
template <bool kWire>
__device__ __forceinline__ void count_tile(
    const int8_t* __restrict__ alleles, long long ld, long long S,
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ miss,
    int c4, int m8, long long f, int lo, int hi, int h, int i0, int j0,
    uint32_t (*raw)[kRawWords], uint32_t (*packed)[kPackWords],
    int (&acc_s)[kMicro][kMicro], int (&acc_t)[kMicro][kMicro]) {
  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid % kSide;
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc_s[a][b] = acc_t[a][b] = 0;

  for (int off = lo; off < hi; off += kStage) {
    // stage: raw codes of sites off .. off + kStage - 1 of the window
    int8_t* rawb = reinterpret_cast<int8_t*>(&raw[0][0]);
    for (int idx = tid; idx < kRows * kStage; idx += kThreads) {
      const int r = idx / kStage;
      const int c = idx % kStage;
      const int row = r < kTile ? i0 + r : j0 + r - kTile;
      const long long col = f + off + c;
      int8_t v = -1;
      if (row < h && off + c < hi && col >= 0 && col < S) {
        if constexpr (kWire) {
          if (!((miss[(long long)row * m8 + (col >> 3)] >> (col & 7)) & 1))
            v = (int8_t)((codes[(long long)row * c4 + (col >> 2)] >>
                          (2 * (col & 3))) & 3);
        } else {
          v = alleles[(long long)row * ld + col];
        }
      }
      rawb[r * kRawWords * 4 + c] = v;
    }
    __syncthreads();
    // repack: task (row r, group g), g fastest, so a warp's reads of
    // raw[r][8 g + q] fall in 32 distinct banks (row pitch 33 words)
    for (int task = tid; task < kRows * kGroups; task += kThreads) {
      const int r = task / kGroups;
      const int g = task % kGroups;
      uint32_t oh[4] = {0u, 0u, 0u, 0u};
      uint32_t called = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t x = raw[r][8 * g + q];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int code = (int8_t)(x >> (8 * k));
          const int site = 4 * q + k;
          if (code >= 0) {
            called |= 1u << site;
            if (code <= 3) oh[q >> 1] |= 1u << (4 * (site & 7) + code);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) packed[r][5 * g + k] = oh[k];
      packed[r][5 * g + 4] = called;
    }
    __syncthreads();
    // count: thread (ty, tx) owns rows i0 + ty + 16 a, columns
    // j0 + tx + 16 b; the j reads hit 16 distinct banks (pitch 21 words)
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      uint32_t ci[kMicro], cj[kMicro], oi[kMicro][4], oj[kMicro][4];
#pragma unroll
      for (int a = 0; a < kMicro; ++a) {
        const uint32_t* pi = packed[ty + kSide * a] + 5 * g;
        const uint32_t* pj = packed[kTile + tx + kSide * a] + 5 * g;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          oi[a][k] = pi[k];
          oj[a][k] = pj[k];
        }
        ci[a] = pi[4];
        cj[a] = pj[4];
      }
#pragma unroll
      for (int a = 0; a < kMicro; ++a)
#pragma unroll
        for (int b = 0; b < kMicro; ++b) {
          acc_s[a][b] += __popc(ci[a] & cj[b]);
          acc_t[a][b] += __popc(oi[a][0] & oj[b][0]) +
                         __popc(oi[a][1] & oj[b][1]) +
                         __popc(oi[a][2] & oj[b][2]) +
                         __popc(oi[a][3] & oj[b][3]);
        }
    }
    __syncthreads();
  }
}

// Store one count into a cell: plainly, or with an int32 atomic add when
// the window's sites are split over blocks (the output is then zeroed).
__device__ __forceinline__ void put(int32_t* cell, int v, int atomic) {
  if (!atomic)
    *cell = v;
  else if (v)
    atomicAdd(cell, v);
}

// ---------------------------------------------------------------- K9
// pair_counts_4state — replaces genomics_general_tpu/kernels/pairdist.py
// pairwise_counts with gather_window_batch (and so _gathered_pair_counts'
// count stage).  For window w = [first, first + n) and haplotypes i, j:
//   shared(i, j)   = #sites where both codes are >= 0
//   match(i, j)    = #sites where both codes are the same one of 0..3
//   mismatch(i, j) = shared - match
// which is the JAX kernel's one-hot Gram (called . called^T minus
// onehot . onehot^T).  Missing is -1; a site outside the window, the span
// or the matrix reads as missing, so no padding is needed and each window
// is read at its own length.
//
// Bound: operations.  Every pair of the upper triangle compares every site
// of its window, while the input is read once per 64 x 64 tile.  Design: a
// block owns one window (blockIdx.z), one 64 x 64 pair tile with j >= i
// (blockIdx.x; the result is mirrored into (j, i)) and one contiguous range
// of the window's sites (blockIdx.y: split-K when the tiles alone do not
// fill the card; the splits then add their counts with int32 atomics, which
// are exact in any order).  Each step stages 128 sites of the tile's 128
// rows in shared memory with coalesced byte loads (first[w] has any
// alignment), repacks each row's 32-site group into four one-hot words
// (site k of the group in nibble k % 8 of word k / 8, bit = its code) and
// one called word, and every thread then counts its 4 x 4 pairs with AND +
// popcount in int32 registers: 5 popcounts per pair per 32 sites.
__global__ void __launch_bounds__(kThreads)
pair_counts_4state_kernel(const int8_t* __restrict__ alleles, long long ld,
                          long long S, const int32_t* __restrict__ first,
                          const int32_t* __restrict__ n_sites, int h,
                          int tiles, int split_len, int atomic,
                          int32_t* __restrict__ m_out,
                          int32_t* __restrict__ s_out) {
  __shared__ uint32_t raw[kRows][kRawWords];
  __shared__ uint32_t packed[kRows][kPackWords];
  const int wl = blockIdx.z;

  // upper-triangle tile (ti <= tj), row by row
  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;

  const int n = n_sites[wl];
  const int lo = blockIdx.y * split_len;
  const int hi = min(n, lo + split_len);
  if (atomic && lo >= hi) return;          // the zeroed output stands

  int acc_s[kMicro][kMicro];
  int acc_t[kMicro][kMicro];
  count_tile<false>(alleles, ld, S, nullptr, nullptr, 0, 0, first[wl], lo,
                    hi, h, i0, j0, raw, packed, acc_s, acc_t);

  // write (i, j) and, off the diagonal tiles, the mirror (j, i); a diagonal
  // tile computes both (i, j) and (j, i) itself, so each cell is written
  // once per block
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;
  const size_t base = (size_t)wl * h * h;
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty + kSide * a;
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int j = j0 + tx + kSide * b;
      if (i >= h || j >= h) continue;
      const int sv = acc_s[a][b];
      const int mv = sv - acc_t[a][b];
      put(&s_out[base + (size_t)i * h + j], sv, atomic);
      put(&m_out[base + (size_t)i * h + j], mv, atomic);
      if (ti != tj) {
        put(&s_out[base + (size_t)j * h + i], sv, atomic);
        put(&m_out[base + (size_t)j * h + i], mv, atomic);
      }
    }
  }
}

// --------------------------------------------------------------- K14
// pair_counts_4state_rows — replaces the row-sharded pair counts of
// genomics_general_tpu/parallel/mesh.py sharded_pair_counts_tp (the JAX
// gather_window_batch + pairwise_counts with the [W, H, H] output's rows
// split over the mesh): K9's counts for the rectangle of rows r0 .. r1 - 1
// and all h columns of every window, into [nwin, r1 - r0, h].
//
// Bound: operations, as K9's, over the rectangle.  Design: K9's staging
// and count loop (count_tile) on full rectangular 64 x 64 tiles with no
// mirror: blockIdx.x walks the row tiles of [r0, r1) times the column tiles
// of [0, h); rows past r1 are counted with the tile but not written, rows
// and columns past h read as missing.  The site split and its atomics are
// K9's.
__global__ void __launch_bounds__(kThreads)
pair_counts_4state_rows_kernel(const int8_t* __restrict__ alleles,
                               long long ld, long long S,
                               const int32_t* __restrict__ first,
                               const int32_t* __restrict__ n_sites, int h,
                               int r0, int r1, int col_tiles, int split_len,
                               int atomic, int32_t* __restrict__ m_out,
                               int32_t* __restrict__ s_out) {
  __shared__ uint32_t raw[kRows][kRawWords];
  __shared__ uint32_t packed[kRows][kPackWords];
  const int wl = blockIdx.z;
  const int i0 = r0 + (blockIdx.x / col_tiles) * kTile;
  const int j0 = (blockIdx.x % col_tiles) * kTile;

  const int n = n_sites[wl];
  const int lo = blockIdx.y * split_len;
  const int hi = min(n, lo + split_len);
  if (atomic && lo >= hi) return;          // the zeroed output stands

  int acc_s[kMicro][kMicro];
  int acc_t[kMicro][kMicro];
  count_tile<false>(alleles, ld, S, nullptr, nullptr, 0, 0, first[wl], lo,
                    hi, h, i0, j0, raw, packed, acc_s, acc_t);

  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;
  const int rows = r1 - r0;
  const size_t base = (size_t)wl * rows * h;
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty + kSide * a;
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int j = j0 + tx + kSide * b;
      if (i >= r1 || j >= h) continue;
      const int sv = acc_s[a][b];
      const size_t o = base + (size_t)(i - r0) * h + j;
      put(&s_out[o], sv, atomic);
      put(&m_out[o], sv - acc_t[a][b], atomic);
    }
  }
}

// --------------------------------------------------------------- K20
// flush_pair_counts — replaces genomics_general_tpu/kernels/pairdist.py
// _fused_flush_pair_counts with transfer.unpack_flush_buffer: the
// one-transfer flush buffer
//   [2-bit codes h x sp/4 | miss bits h x sp/8 | first i32[wp] | n i32[wp]]
// is read in place (no unpacked [h, sp] matrix), each window w counts its
// sites first[w] .. first[w] + min(n[w], s_max) - 1 (the JAX gather keeps
// s_max slots) as K9 does, and the upper triangles (i <= j,
// np.triu_indices order) of mismatch and shared go straight into row w of
// out [wp, 2T], T = h (h + 1) / 2, m half then s half, as uint16 (s_max <
// 2^16) or int32: one kernel, one output, no [W, h, h] intermediate.
//
// Bound: operations, as K9's.  Design: K9's tiles and count loop
// (count_tile) with the span wire's codes decoded in the staging step; the
// window metadata is read as bytes, since it starts unaligned when sp is
// not a multiple of 32.  Each upper-triangle tile writes its cells with
// i <= j (a diagonal tile's lower half is its mirror); windows with no
// sites (pad windows past W, empty windows) write zero rows.  No site
// split: each cell has one writer.
__device__ __forceinline__ int load_i32(const uint8_t* p) {
  return (int)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
               ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
flush_pair_counts_kernel(const uint8_t* __restrict__ buf, int h, int sp,
                         int wp, int w0, int s_max, int tiles,
                         Out* __restrict__ out) {
  __shared__ uint32_t raw[kRows][kRawWords];
  __shared__ uint32_t packed[kRows][kPackWords];
  const int wl = w0 + blockIdx.z;
  const int c4 = sp / 4;
  const int m8 = sp / 8;
  const uint8_t* miss = buf + (size_t)h * c4;
  const uint8_t* meta = miss + (size_t)h * m8;
  const int f = load_i32(meta + 4 * (size_t)wl);
  const int n = min(load_i32(meta + 4 * ((size_t)wp + wl)), s_max);

  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;

  int acc_s[kMicro][kMicro];
  int acc_t[kMicro][kMicro];
  count_tile<true>(nullptr, 0, sp, buf, miss, c4, m8, f, 0, max(n, 0), h, i0,
                   j0, raw, packed, acc_s, acc_t);

  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;
  const long long T = (long long)h * (h + 1) / 2;
  Out* row = out + (size_t)wl * 2 * T;
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
    const int i = i0 + ty + kSide * a;
    const long long t0 = (long long)i * h - (long long)i * (i - 1) / 2 - i;
#pragma unroll
    for (int b = 0; b < kMicro; ++b) {
      const int j = j0 + tx + kSide * b;
      if (i >= h || j >= h || j < i) continue;
      const int sv = acc_s[a][b];
      row[t0 + j] = (Out)(sv - acc_t[a][b]);
      row[T + t0 + j] = (Out)sv;
    }
  }
}

}  // namespace

extern "C" {

// alleles: int8 rows of ld elements, columns 0 .. S - 1 valid; first,
// n_sites: int32 [nwin]; m_out, s_out: int32 [nwin, h, h], zeroed by the
// caller when splits > 1 (the splits then add with atomics).
int ggt_pair_counts_4state(const void* alleles, long long ld, long long S,
                           const void* first, const void* n_sites, int h,
                           int nwin, int splits, int split_len, void* m_out,
                           void* s_out, void* stream) {
  const int tiles = (h + kTile - 1) / kTile;
  dim3 grid(tiles * (tiles + 1) / 2, splits, nwin);
  pair_counts_4state_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)alleles, ld, S, (const int32_t*)first,
      (const int32_t*)n_sites, h, tiles, split_len, splits > 1 ? 1 : 0,
      (int32_t*)m_out, (int32_t*)s_out);
  return (int)cudaGetLastError();
}

// As ggt_pair_counts_4state for rows r0 .. r1 - 1 (0 <= r0 < r1 <= h) and
// all h columns: m_out, s_out int32 [nwin, r1 - r0, h].
int ggt_pair_counts_4state_rows(const void* alleles, long long ld,
                                long long S, const void* first,
                                const void* n_sites, int h, int r0, int r1,
                                int nwin, int splits, int split_len,
                                void* m_out, void* s_out, void* stream) {
  const int row_tiles = (r1 - r0 + kTile - 1) / kTile;
  const int col_tiles = (h + kTile - 1) / kTile;
  dim3 grid(row_tiles * col_tiles, splits, nwin);
  pair_counts_4state_rows_kernel<<<grid, kThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const int8_t*)alleles, ld, S, (const int32_t*)first,
      (const int32_t*)n_sites, h, r0, r1, col_tiles, split_len,
      splits > 1 ? 1 : 0, (int32_t*)m_out, (int32_t*)s_out);
  return (int)cudaGetLastError();
}

// buf: a flush buffer of h rows, sp sites and wp windows; windows w0 ..
// w0 + nwin - 1 (nwin <= 65535) into rows w0 .. of out [wp, 2T], uint16
// when u16 != 0, else int32.
int ggt_flush_pair_counts(const void* buf, int h, int sp, int wp, int w0,
                          int nwin, int s_max, int u16, void* out,
                          void* stream) {
  const int tiles = (h + kTile - 1) / kTile;
  dim3 grid(tiles * (tiles + 1) / 2, 1, nwin);
  if (u16) {
    flush_pair_counts_kernel<uint16_t><<<grid, kThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const uint8_t*)buf, h, sp, wp, w0, s_max, tiles, (uint16_t*)out);
  } else {
    flush_pair_counts_kernel<int32_t><<<grid, kThreads, 0,
                                        (cudaStream_t)stream>>>(
        (const uint8_t*)buf, h, sp, wp, w0, s_max, tiles, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
